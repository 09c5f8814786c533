// K1: gather-GEMM sparse convolution, out[i] = sum_o x[nbr[o, i]] @ W[o].
//
// Replaces segdino3d_tpu/ops/sparse_conv.py:_subm_conv_impl (both its
// im2col branch and its matmul-first branch) and, through the plan's
// (8, V_coarse) child table, sparse_conv.py:down_conv.  On the main path it
// runs the k5 stem (125 offsets, 259 -> 32), the 46 k3 convs of the
// BasicBlocks and the 4 stride-2 down convs; in training also their input
// gradients (the k3 convs' by the mirror identity, the up convs' over the
// child table).
//
// What bounds it: operations, 2 * live pairs * Cin * Cout fp32 FMAs over
// inputs of a few to a hundred MB.  Only about a fifth of the stem's (row,
// offset) pairs and a third to a half of the k3 tables' hold a neighbour,
// and the small levels have a few hundred rows.  Design (pair-major):
//   1. the pairs: per offset, the rows that have a neighbour there, in
//      ascending order (K4's list, gather_pairs in gather_wgrad.cu, built
//      once per table and kept by the caller, sparse_conv.py:cached_pairs;
//      its count stays on the card);
//   2. the products: a work item is 64 consecutive pairs of one offset and
//      one column tile, so every item but an offset's last is a full
//      64-row GEMM tile, and even a level of a few hundred rows makes
//      hundreds of items.  Persistent thread blocks, as many as fit on the
//      SMs, take items by an atomic ticket that the block taking the last
//      ticket resets.  An item gathers its 64 source rows and multiplies
//      them on the pipelined tile core of gather_tile.cuh (fp32 FMAs, bf16
//      mma.sync), and writes the products to a pair-major fp32 buffer, row
//      p = (the offset's first pair) + j, and p into an (n_off, V) map at
//      (o, row);
//   3. the sum: each row adds its products in ascending offset order,
//      through the map, four threads a row, and writes the output (zeros
//      outside valid).
// So an output's sum is its offsets' products (each over Cin in ascending
// slices) added in ascending offset order, the plain version's order; no
// float atomics, so two calls are bit-equal.  Measured against a schedule
// of 64-row tiles that compact each tile's live rows per offset in shared
// memory (PERF.md §6): that one's stages hold ~29 rows of the stem's
// and ~22 of level 0's, and wait on their gathers.
//
// Contract: x (V_in, Cin), w (n_off, Cin, Cout) and out (V, Cout) share
// one dtype (fp32 or bf16), rows contiguous; nbr (n_off, V) int32, -1 for
// an absent neighbour; valid (V,) bytes; pairs gather_pairs' list of nbr
// (n_off x V rows, n_off counts, the ticket); pos (n_off, V) int32 scratch;
// partial (n_off * V, gather_conv_pair_stride(Cout)) fp32 scratch.  Rows
// outside valid are written as 0.
#include "gather_tile.cuh"

namespace {

using gtt::BM;
using gtt::Elt;
using gtt::kThreads;

using gtt::pair_bn;

// The pair-major rows hold Cout rounded up to the column tile.
__host__ __device__ __forceinline__ int pair_stride(int cout) {
  const int bn = pair_bn(cout);
  return (cout + bn - 1) / bn * bn;
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
conv_products_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                     const T* __restrict__ w, const int32_t* __restrict__ list,
                     const int32_t* __restrict__ counts, int32_t* __restrict__ ticket,
                     int32_t* __restrict__ pos, float* __restrict__ partial, int v, int cin,
                     int cout, int n_off) {
  using S = gtt::Smem<T, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);
  int* const s_src = reinterpret_cast<int*>(stage + 2 * S::kStage);  // [BM]
  int* const s_first = s_src + BM;                                  // [n_off + 1]
  int* const s_group = s_first + n_off + 1;                         // [n_off + 1]
  __shared__ int s_item;

  const int tid = threadIdx.x;
  gtt::pair_prefixes(counts, n_off, s_first, s_group);
  const int n_col = (cout + BN - 1) / BN, ld = n_col * BN;
  const bool vec_a = cin % Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = cout % Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  gtt::Part<T, BN> part;
  const int n_items = s_group[n_off] * n_col;

  for (;;) {
    if (tid == 0) s_item = atomicAdd(ticket, 1);
    __syncthreads();  // also: the last item's reads of shared memory are done
    const int item = s_item;
    if (item >= n_items) {
      // the last ticket taken: every block is done with the counter
      if (tid == 0 && item == n_items + (int)gridDim.x - 1) *ticket = 0;
      break;
    }
    const gtt::Item it = gtt::decode_item(item, s_first, s_group, n_off, n_col);
    const int o = it.o, j0 = it.j0, live = it.live, ct = it.ct;
    if (tid < live) {
      const int r = list[(int64_t)o * v + j0 + tid];
      if (ct == 0) pos[(int64_t)o * v + r] = s_first[o] + j0 + tid;
      s_src[tid] = nbr[(int64_t)o * v + r];
    }
    __syncthreads();
    gtt::products<T, BN>(part, stage, x, w, s_src, live, o, ct * BN, cin, cout, vec_a, vec_b);
    part.store(partial + (int64_t)(s_first[o] + j0) * ld + ct * BN, ld, live);
  }
}

// out[r][c .. c + 7] = sum over the offsets o ascending with nbr[o][r] >= 0
// of partial[pos[o][r]][c .. c + 7], 0 outside valid: four threads a row,
// eight columns each (c = 32 blockIdx.y + 8 (tid % 4)), so a quad reads a
// pair's 32 products as one 128-byte line; the offsets' loads eight at a
// time
template <typename T>
__global__ void __launch_bounds__(128)
conv_pair_sum_kernel(const int32_t* __restrict__ nbr, const int32_t* __restrict__ pos,
                     const float* __restrict__ partial, int ld,
                     const uint8_t* __restrict__ valid, T* __restrict__ out, int v, int cout,
                     int n_off) {
  const int64_t r = (int64_t)blockIdx.x * 32 + threadIdx.x / 4;
  const int c = 32 * blockIdx.y + (threadIdx.x % 4) * 8;
  if (r >= v) return;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  if (valid[r]) {
    for (int o0 = 0; o0 < n_off; o0 += 8) {
      int p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = o0 + i < n_off && nbr[(int64_t)(o0 + i) * v + r] >= 0
            ? pos[(int64_t)(o0 + i) * v + r] : -1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (p[i] < 0) continue;
        const float4* src = reinterpret_cast<const float4*>(partial + (int64_t)p[i] * ld + c);
        const float4 a = src[0], b = src[1];
        acc[0] += a.x;
        acc[1] += a.y;
        acc[2] += a.z;
        acc[3] += a.w;
        acc[4] += b.x;
        acc[5] += b.y;
        acc[6] += b.z;
        acc[7] += b.w;
      }
    }
  }
  T* const row = out + r * cout;
  if (c < cout) gtt::store4(row, c, cout, make_float4(acc[0], acc[1], acc[2], acc[3]));
  if (c + 4 < cout) gtt::store4(row, c + 4, cout, make_float4(acc[4], acc[5], acc[6], acc[7]));
}

template <typename T, int BN>
cudaError_t launch(const T* x, const int32_t* nbr, const T* w, const uint8_t* valid,
                   int32_t* pairs, int32_t* pos, float* partial, T* out, int v, int cin,
                   int cout, int n_off, cudaStream_t s) {
  auto kernel = conv_products_kernel<T, BN>;
  const size_t smem = sizeof(T) * 2 * gtt::Smem<T, BN>::kStage +
                      sizeof(int) * (BM + 2 * (n_off + 1));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // resident thread blocks per SM, by shared-memory size (the offset count)
  static size_t known_smem[4] = {0, 0, 0, 0};
  static int known_fit[4] = {0, 0, 0, 0};
  int fit = 0, slot = 0;
  for (; slot < 4 && known_smem[slot] != 0; ++slot)
    if (known_smem[slot] == smem) fit = known_fit[slot];
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    if (slot < 4) {
      known_smem[slot] = smem;
      known_fit[slot] = fit;
    }
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  // the items of a table whose every pair is live; the count is on the card
  const int n_col = (cout + BN - 1) / BN;
  const int64_t max_items = (int64_t)((v + BM - 1) / BM) * n_off * n_col;
  const int grid = max_items < (int64_t)sms * fit ? (int)max_items : sms * fit;
  const int64_t n_list = (int64_t)n_off * v;
  kernel<<<grid, kThreads, smem, s>>>(x, nbr, w, pairs, pairs + n_list, pairs + n_list + n_off,
                                      pos, partial, v, cin, cout, n_off);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_pair_sum_kernel<T><<<dim3((v + 31) / 32, (cout + 31) / 32), 128, 0, s>>>(
      nbr, pos, partial, n_col * BN, valid, out, v, cout, n_off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bn(const void* x, const void* nbr, const void* w, const void* valid,
                      void* pairs, void* pos, void* partial, void* out, int v, int cin,
                      int cout, int n_off, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  const int32_t* nb = static_cast<const int32_t*>(nbr);
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  int32_t* pl = static_cast<int32_t*>(pairs);
  int32_t* ps = static_cast<int32_t*>(pos);
  float* pt = static_cast<float*>(partial);
  switch (pair_bn(cout)) {
    case 32:
      return launch<T, 32>(xt, nb, wt, va, pl, ps, pt, ot, v, cin, cout, n_off, s);
    case 96:
      return launch<T, 96>(xt, nb, wt, va, pl, ps, pt, ot, v, cin, cout, n_off, s);
    default:
      return launch<T, 64>(xt, nb, wt, va, pl, ps, pt, ot, v, cin, cout, n_off, s);
  }
}

}  // namespace

// The row width of the partial buffer for Cout.
extern "C" int gather_conv_pair_stride(int cout) { return pair_stride(cout); }

// dtype: 0 = float32, 1 = bfloat16.  Returns the launches' cudaError_t.
extern "C" int gather_gemm_conv(const void* x, const void* nbr, const void* w,
                                const void* valid, void* pairs, void* pos, void* partial,
                                void* out, int v, int cin, int cout, int n_off, int dtype,
                                void* stream) {
  if (v == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch_bn<__nv_bfloat16>(x, nbr, w, valid, pairs, pos, partial, out, v, cin, cout,
                                 n_off, s)
      : launch_bn<float>(x, nbr, w, valid, pairs, pos, partial, out, v, cin, cout, n_off, s);
  return static_cast<int>(err);
}
