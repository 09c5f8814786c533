// K11: block conv weight gradient, dW[o] = sum over occupied cells c of
// halo(x)[c + o]^T @ dY[c].
//
// Replaces the weight-gradient half of segdino3d_tpu/ops/block_dense.py:
// _chunked_conv_bwd (:414-433: the dense conv's own weight VJP per block
// chunk, summed under lax.scan).  On the training path it runs once per
// block conv of the Res16UNet34C: the 46 k3 convs of the BasicBlocks and
// the dense k5 stem (259 -> 32).
//
// What bounds it: operations.  2 * pairs * Cin * Cout fp32 FMAs, a pair
// being an occupied cell and an offset whose source cell exists, over
// inputs of tens of MB.  This first version uses fp32 FMAs (67 TFLOP/s), not
// tensor cores.
//
// Design: a GEMM of M = Cin by N = Cout whose reduction axis is the cells.
// dY is zero at unoccupied cells (the forward masked them), so only occupied
// cells are reduced: one thread block owns a BM x BN tile of one offset's
// dW and one split of the blocks; for each block it lists the block's
// occupied cells in ascending order (one warp, a ballot per 32 cells;
// blocks with none are skipped), then walks them in chunks of BK, staging
// the chunk's halo rows of x (the cells shifted by the offset, read from the
// block's or its shell neighbour's core through the same halo addressing as
// K10, block_tile.cuh) and its dY rows in shared memory as fp32; a chunk in
// which no shifted cell exists is skipped.  Each thread accumulates TM x TN
// sums in registers.  Determinism without atomics, as K4: each split writes
// its partial dW to a scratch the wrapper allocates (splits x k^3 x Cin x
// Cout fp32, bounded by the wrapper), and a second pass adds the splits in
// ascending order.  With one split the first pass writes dW directly.
//
// Contract: x (n_blocks * edge^3, Cin) and dy (n_blocks * edge^3, Cout)
// share one dtype (fp32 or bf16), rows contiguous; block_nbr (26, n_blocks)
// int32; occ (n_blocks * edge^3,) bytes; partial (splits, k^3, Cin, Cout)
// fp32, or out itself when splits == 1; out (k^3, Cin, Cout) fp32; edge^3 a
// multiple of 32 and at most 512.
#include "block_tile.cuh"

namespace {

using bdt::to_f;

constexpr int TM = 4;    // Cin rows of dW per thread
constexpr int TN = 4;    // Cout columns of dW per thread
constexpr int BK = 16;   // cells per shared-memory chunk
constexpr int kMaxCells = 512;

template <typename T, int BM, int BN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
block_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const int32_t* __restrict__ block_nbr,
                           const uint8_t* __restrict__ occ, float* __restrict__ partial,
                           int n_blocks, int edge, int k, int cin, int cout,
                           int blocks_per_split) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kColGroups = BN / TN;
  __shared__ __align__(16) float As[BK][BM + 4];  // As[r][m] = x[halo row r][m0 + m]
  __shared__ __align__(16) float Bs[BK][BN];      // Bs[r][n] = dy[cell r][n0 + n]
  __shared__ int cellq[kMaxCells];                // occupied cells, ascending
  __shared__ int sa[BK], sb[BK];
  __shared__ int n_occ;

  const int n_col_tiles = (cout + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_col_tiles) * BM;
  const int n0 = (blockIdx.x % n_col_tiles) * BN;
  const int split = blockIdx.y;
  const int o = blockIdx.z;
  const int h = (k - 1) / 2;
  const int sx = o / (k * k) - h, sy = (o / k) % k - h, sz = o % k - h;
  const int cells = edge * edge * edge;
  const int b_begin = split * blocks_per_split;
  const int b_end = min(n_blocks, b_begin + blocks_per_split);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid % kColGroups;
  const int ty = tid / kColGroups;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int b = b_begin; b < b_end; ++b) {
    if (tid < 32) {
      int count = 0;
      for (int c0 = 0; c0 < cells; c0 += 32) {
        const int on = occ[(int64_t)b * cells + c0 + lane] != 0;
        const unsigned mask = __ballot_sync(0xffffffffu, on);
        if (on) cellq[count + __popc(mask & ((1u << lane) - 1u))] = c0 + lane;
        count += __popc(mask);
      }
      if (lane == 0) n_occ = count;
    }
    __syncthreads();
    const int nb = n_occ;
    for (int r0 = 0; r0 < nb; r0 += BK) {
      int hit = 0;
      if (tid < BK) {
        const int r = r0 + tid;
        int ra = -1;
        int rb = -1;
        if (r < nb) {
          const int c = cellq[r];
          ra = bdt::halo_row(block_nbr, n_blocks, b, edge, c / (edge * edge) + sx,
                             (c / edge) % edge + sy, c % edge + sz);
          rb = b * cells + c;
        }
        hit = ra >= 0;
        sa[tid] = hit ? ra : -1;
        sb[tid] = hit ? rb : -1;
      }
      // the barrier also publishes sa / sb to the whole block
      if (!__syncthreads_or(hit)) continue;
      for (int e = tid; e < BK * BM; e += kThreads) {
        const int r = e / BM, m = e % BM;
        const int s = sa[r];
        As[r][m] = (s >= 0 && m0 + m < cin) ? to_f(x[(int64_t)s * cin + m0 + m]) : 0.f;
      }
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int r = e / BN, n = e % BN;
        const int s = sb[r];
        Bs[r][n] = (s >= 0 && n0 + n < cout) ? to_f(dy[(int64_t)s * cout + n0 + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < BK; ++r) {
        const float4 av4 = *reinterpret_cast<const float4*>(&As[r][ty * TM]);
        const float4 bv4 = *reinterpret_cast<const float4*>(&Bs[r][tx * TN]);
        const float av[TM] = {av4.x, av4.y, av4.z, av4.w};
        const float bv[TN] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    __syncthreads();  // before cellq and n_occ are rewritten for the next block
  }

  float* __restrict__ dst = partial + ((int64_t)split * k * k * k + o) * (int64_t)cin * cout;
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
sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out, int64_t n,
                  int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[(int64_t)s * n + e];
  out[e] = acc;
}

template <typename T, int BM, int BN>
cudaError_t launch_tiles(const void* x, const void* dy, const void* nbr, const void* occ,
                         float* partial, int n_blocks, int edge, int k, int cin, int cout,
                         int splits, cudaStream_t stream) {
  const int per_split = (n_blocks + splits - 1) / splits;
  const dim3 grid(((cin + BM - 1) / BM) * ((cout + BN - 1) / BN), splits, k * k * k);
  block_wgrad_partial_kernel<T, BM, BN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(occ), partial,
      n_blocks, edge, k, cin, cout, per_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const void* nbr, const void* occ,
                   float* partial, float* out, int n_blocks, int edge, int k, int cin,
                   int cout, int splits, cudaStream_t stream) {
  // BN = 32 serves Cout <= 32 (the stem and level 1) with 128 threads
  cudaError_t err = cout <= 32
      ? launch_tiles<T, 64, 32>(x, dy, nbr, occ, partial, n_blocks, edge, k, cin, cout,
                                splits, stream)
      : launch_tiles<T, 64, 64>(x, dy, nbr, occ, partial, n_blocks, edge, k, cin, cout,
                                splits, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t n = (int64_t)k * k * k * cin * cout;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, n,
                                                                   splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `partial` must be `out` when splits is
// 1.  Returns the first failed launch's cudaError_t, or 0.
extern "C" int block_wgrad(const void* x, const void* dy, const void* block_nbr,
                           const void* occ, void* partial, void* out, int n_blocks,
                           int edge, int k, int cin, int cout, int splits, int dtype,
                           void* stream) {
  if (cin == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int cells = edge * edge * edge;
  if (cells % 32 != 0 || cells > kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return static_cast<int>(
      cudaMemsetAsync(o, 0, sizeof(float) * (size_t)k * k * k * cin * cout, s));
  float* p = static_cast<float*>(partial);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(x, dy, block_nbr, occ, p, o, n_blocks, edge, k, cin, cout,
                              splits, s)
      : launch<float>(x, dy, block_nbr, occ, p, o, n_blocks, edge, k, cin, cout, splits,
                      s);
  return static_cast<int>(err);
}
