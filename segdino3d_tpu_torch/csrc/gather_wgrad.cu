// K4: gather weight gradient, dW[slot(o)] = sum_r A[ia[o, r]]^T @ B[ib[o, r]].
//
// Replaces the weight-gradient half of segdino3d_tpu/ops/sparse_conv.py:
// _subm_conv_bwd (dW = X^T gather(dY), sparse_conv.py:346-361) and the
// weight gradients XLA derives for sparse_conv.py:down_conv and up_conv.
// On the training path it runs once per conv of the Res16UNet34C:
//   subm (46 k3 convs):  A = X, ia = nbr, B = dY            (dW[o] = sum_i X[nbr[o,i]]^T dY[i])
//   stem (k5, 259->32):  A = X, B = dY, ib = nbr, mirror    (gathers the 32-wide side)
//   down (4):            A = X_fine, ia = child, B = dY
//   up (4):              A = x_coarse, B = dF, ib = child
// `mirror` writes offset o's sum to slot n_off - 1 - o: for a centred odd
// kernel in canonical order nbr[o, j] = i <=> nbr[n_off-1-o, i] = j, so
// dW[o] = sum_j X[j]^T dY[nbr[n_off-1-o, j]] and the wide input is read
// without a gather (the JAX package's reason at sparse_conv.py:318-320).
//
// What bounds it: operations.  2 * live_pairs * Cin * Cout fp32 FMAs over
// inputs of a few MB that stay in the 50 MB L2.  This first version uses
// fp32 FMAs (67 TFLOP/s), not tensor cores.
//
// Design: a GEMM of M = Cin by N = Cout whose reduction axis is the table's
// rows.  One block owns a BM x BN tile of one offset's dW and one split of
// the rows; it walks its rows in chunks of BK, skips a chunk in which no row
// has a live (A, B) pair (the K1 tile skip, here per chunk and offset),
// gathers the chunk's A and B rows into shared memory as fp32 and
// accumulates TM x TN sums per thread in registers.  Determinism without
// atomics: each split writes its partial dW to a scratch the wrapper
// allocates (splits x n_off x Cin x Cout fp32, bounded by the wrapper), and
// a second pass adds the splits in ascending order.  With one split the
// first pass writes dW directly.
//
// Contract: A (rows_a, Cin) and B (rows_b, Cout) share one dtype (fp32 or
// bf16), rows contiguous; ia, ib (n_off, R) int32 with -1 for "no row", or
// null for the identity (then A, resp. B, has at least R rows); partial
// (splits, n_off, Cin, Cout) fp32, or out itself when splits == 1; out
// (n_off, Cin, Cout) fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 4;   // Cin rows of dW per thread
constexpr int TN = 4;   // Cout columns of dW per thread
constexpr int BK = 16;  // table rows per shared-memory chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int BM, int BN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
wgrad_partial_kernel(const T* __restrict__ a, const int32_t* __restrict__ ia,
                     const T* __restrict__ b, const int32_t* __restrict__ ib,
                     float* __restrict__ partial, int rows, int cin, int cout,
                     int n_off, int rows_per_split, int mirror) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kColGroups = BN / TN;
  __shared__ __align__(16) float As[BK][BM + 4];  // As[k][m] = A[row k][m0 + m]
  __shared__ __align__(16) float Bs[BK][BN];      // Bs[k][n] = B[row k][n0 + n]
  __shared__ int sa[BK], sb[BK];

  const int n_col_tiles = (cout + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_col_tiles) * BM;
  const int n0 = (blockIdx.x % n_col_tiles) * BN;
  const int split = blockIdx.y;
  const int o = blockIdx.z;
  const int r_begin = split * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;
  const int ty = tid / kColGroups;
  const int32_t* __restrict__ ia_o = ia ? ia + (int64_t)o * rows : nullptr;
  const int32_t* __restrict__ ib_o = ib ? ib + (int64_t)o * rows : nullptr;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    int hit = 0;
    if (tid < BK) {
      const int r = r0 + tid;
      int ra = -1, rb = -1;
      if (r < r_end) {
        ra = ia_o ? ia_o[r] : r;
        rb = ib_o ? ib_o[r] : r;
      }
      hit = ra >= 0 && rb >= 0;
      sa[tid] = hit ? ra : -1;
      sb[tid] = hit ? rb : -1;
    }
    // the barrier also publishes sa / sb to the whole block
    if (!__syncthreads_or(hit)) continue;
    for (int e = tid; e < BK * BM; e += kThreads) {
      const int k = e / BM, m = e % BM;
      const int s = sa[k];
      As[k][m] = (s >= 0 && m0 + m < cin) ? to_f(a[(int64_t)s * cin + m0 + m]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int k = e / BN, n = e % BN;
      const int s = sb[k];
      Bs[k][n] = (s >= 0 && n0 + n < cout) ? to_f(b[(int64_t)s * cout + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av4 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float av[TM] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[TN] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int slot = mirror ? n_off - 1 - o : o;
  float* __restrict__ dst =
      partial + ((int64_t)split * n_off + slot) * (int64_t)cin * cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= cin) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < cout) dst[(int64_t)m * cout + n] = acc[i][j];
    }
  }
}

// out[e] = sum over splits s, in ascending order, of partial[s][e]
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int64_t n, int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[(int64_t)s * n + e];
  out[e] = acc;
}

template <typename T, int BM, int BN>
cudaError_t launch_tiles(const void* a, const void* ia, const void* b,
                         const void* ib, float* partial, int rows, int cin,
                         int cout, int n_off, int splits, int mirror,
                         cudaStream_t stream) {
  const int rows_per_split = ((rows + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid(((cin + BM - 1) / BM) * ((cout + BN - 1) / BN), splits, n_off);
  wgrad_partial_kernel<T, BM, BN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(a), static_cast<const int32_t*>(ia),
      static_cast<const T*>(b), static_cast<const int32_t*>(ib), partial, rows,
      cin, cout, n_off, rows_per_split, mirror);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* a, const void* ia, const void* b, const void* ib,
                   float* partial, float* out, int rows, int cin, int cout,
                   int n_off, int splits, int mirror, cudaStream_t stream) {
  // BN = 32 serves Cout <= 32 (the stem and level 1) with 128 threads
  cudaError_t err = cout <= 32
      ? launch_tiles<T, 64, 32>(a, ia, b, ib, partial, rows, cin, cout, n_off,
                                splits, mirror, stream)
      : launch_tiles<T, 64, 64>(a, ia, b, ib, partial, rows, cin, cout, n_off,
                                splits, mirror, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t n = (int64_t)n_off * cin * cout;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, n,
                                                                   splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `partial` must be `out` when splits is
// 1.  Returns the first failed launch's cudaError_t, or 0.
extern "C" int gather_wgrad(const void* a, const void* ia, const void* b,
                            const void* ib, void* partial, void* out, int rows,
                            int cin, int cout, int n_off, int splits, int mirror,
                            int dtype, void* stream) {
  if (n_off == 0 || cin == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (rows == 0) return static_cast<int>(
      cudaMemsetAsync(o, 0, sizeof(float) * (size_t)n_off * cin * cout, s));
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(a, ia, b, ib, p, o, rows, cin, cout, n_off, splits,
                              mirror, s)
      : launch<float>(a, ia, b, ib, p, o, rows, cin, cout, n_off, splits, mirror,
                      s);
  return static_cast<int>(err);
}
