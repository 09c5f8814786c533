// K2: transposed stride-2 convolution, fine[i] = x[parent[i]] @ W[kpos[i]].
//
// Replaces segdino3d_tpu/ops/sparse_conv.py:up_conv (the 4 up convs of the
// Res16UNet34C decoder: 256->256, 256->128, 128->96, 96->96) and, with
// transposed W, the input gradient of its down_conv (the 4 down convs' dX
// in training).
//
// What bounds it: operations, 2 * live fine rows * Cin * Cout fp32 FMAs,
// each fine row's input read once through its parent.  Design: the fine
// rows of slot k are exactly the pairs (coarse row j, fine row child[k, j])
// of the fine level's (8, V_coarse) child table, so the kernel takes that
// table's per-offset pair list (K4's, gather_pairs in gather_wgrad.cu,
// cached per table and shared with K1's down conv and K4's dW,
// sparse_conv.py:cached_pairs).  A work item is 64 consecutive pairs of
// one slot and one column tile (K1's pair_bn: 96 for Cout 96); persistent
// blocks take items on K1's ticket (gather_tile.cuh), gather the 64
// coarse rows x[j] and multiply them on K1's pipelined tile core (fp32
// FMAs, bf16 mma.sync, fp32 sums over Cin in ascending 32-channel slices).
// Each fine row has exactly one pair, so each product is stored straight
// to out[child[k, j]] in the output dtype: no pair-major buffer and no sum
// pass.  The rows with no pair (outside valid, or without a parent) are
// written 0 by the same launch, before the items: a thread per row,
// grid-stride.  No atomics on floats, so two calls are bit-equal.
//
// Contract: x (V_coarse, Cin), w (8, Cin, Cout), out (V_fine, Cout) share
// one dtype (fp32 or bf16), rows contiguous; child (8, V_coarse) int32, the
// fine row of (slot, coarse row) or -1, holding each fine row i with
// valid[i] and parent[i] >= 0 once (a pair whose fine row is not valid is
// skipped); pairs gather_pairs' list of child (8 x V_coarse rows, 8
// counts, the ticket); parent (V_fine,) int32; valid (V_fine,) bytes.
#include "gather_tile.cuh"

namespace {

using gtt::BM;
using gtt::Elt;
using gtt::kThreads;

constexpr int kSlots = 8;

// out[r][0 .. Cout) = 0
template <typename T>
__device__ __forceinline__ void zero_row(T* __restrict__ o, int cout) {
  if ((cout * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    for (int c = 0; c < cout; c += 16 / sizeof(T))
      *reinterpret_cast<uint4*>(o + c) = make_uint4(0, 0, 0, 0);
    return;
  }
  for (int c = 0; c < cout; ++c) o[c] = T(0.f);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
up_conv_kernel(const T* __restrict__ x, const int32_t* __restrict__ child,
               const T* __restrict__ w, const int32_t* __restrict__ list,
               const int32_t* __restrict__ counts, int32_t* __restrict__ ticket,
               const int32_t* __restrict__ parent, const uint8_t* __restrict__ valid,
               T* __restrict__ out, int vc, int vf, int cin, int cout) {
  using S = gtt::Smem<T, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);
  int* const s_src = reinterpret_cast<int*>(stage + 2 * S::kStage);  // [BM] coarse rows
  int* const s_dst = s_src + BM;                                    // [BM] fine rows
  __shared__ int s_first[kSlots + 1], s_group[kSlots + 1], s_item;

  const int tid = threadIdx.x;
  // the rows no pair writes
  for (int64_t r = (int64_t)blockIdx.x * kThreads + tid; r < vf;
       r += (int64_t)gridDim.x * kThreads)
    if (!valid[r] || parent[r] < 0) zero_row(out + r * cout, cout);

  gtt::pair_prefixes(counts, kSlots, s_first, s_group);
  const int n_col = (cout + BN - 1) / BN;
  const bool vec_a = cin % Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = cout % Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  gtt::Part<T, BN> part;
  const int n_items = s_group[kSlots] * n_col;
  for (;;) {
    if (tid == 0) s_item = atomicAdd(ticket, 1);
    __syncthreads();  // also: the last item's reads of shared memory are done
    const int item = s_item;
    if (item >= n_items) {
      // the last ticket taken: every block is done with the counter
      if (tid == 0 && item == n_items + (int)gridDim.x - 1) *ticket = 0;
      break;
    }
    const gtt::Item it = gtt::decode_item(item, s_first, s_group, kSlots, n_col);
    if (tid < it.live) {
      const int j = list[(int64_t)it.o * vc + it.j0 + tid];
      const int f = child[(int64_t)it.o * vc + j];
      s_src[tid] = j;
      s_dst[tid] = valid[f] ? f : -1;
    }
    __syncthreads();
    gtt::products<T, BN>(part, stage, x, w, s_src, it.live, it.o, it.ct * BN, cin, cout, vec_a,
                         vec_b);
    part.store_rows(out, s_dst, it.live, it.ct * BN, cout);
  }
}

template <typename T, int BN>
cudaError_t launch(const T* x, const int32_t* child, const T* w, int32_t* pairs,
                   const int32_t* parent, const uint8_t* valid, T* out, int vc, int vf, int cin,
                   int cout, cudaStream_t s) {
  auto kernel = up_conv_kernel<T, BN>;
  constexpr size_t smem = sizeof(T) * 2 * gtt::Smem<T, BN>::kStage + sizeof(int) * 2 * BM;
  static int fit = 0;  // resident blocks per SM
  cudaError_t err;
  if (fit == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  // the items of a child table whose every slot is full; the count is on
  // the card
  const int n_col = (cout + BN - 1) / BN;
  const int64_t max_items = (int64_t)((vc + BM - 1) / BM) * kSlots * n_col;
  const int64_t fill = (int64_t)sms * fit;
  const int grid = (int)(max_items < fill ? (max_items > 0 ? max_items : 1) : fill);
  const int64_t n_list = (int64_t)kSlots * vc;
  kernel<<<grid, kThreads, smem, s>>>(x, child, w, pairs, pairs + n_list, pairs + n_list + kSlots,
                                      parent, valid, out, vc, vf, cin, cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bn(const void* x, const void* child, const void* w, void* pairs,
                      const void* parent, const void* valid, void* out, int vc, int vf, int cin,
                      int cout, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  const int32_t* ch = static_cast<const int32_t*>(child);
  const int32_t* pa = static_cast<const int32_t*>(parent);
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  int32_t* pl = static_cast<int32_t*>(pairs);
  switch (gtt::pair_bn(cout)) {
    case 32:
      return launch<T, 32>(xt, ch, wt, pl, pa, va, ot, vc, vf, cin, cout, s);
    case 96:
      return launch<T, 96>(xt, ch, wt, pl, pa, va, ot, vc, vf, cin, cout, s);
    default:
      return launch<T, 64>(xt, ch, wt, pl, pa, va, ot, vc, vf, cin, cout, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int up_conv(const void* x, const void* child, const void* w, void* pairs,
                       const void* parent, const void* valid, void* out, int vc, int vf,
                       int cin, int cout, int dtype, void* stream) {
  if (vf == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch_bn<__nv_bfloat16>(x, child, w, pairs, parent, valid, out, vc, vf, cin, cout, s)
      : launch_bn<float>(x, child, w, pairs, parent, valid, out, vc, vf, cin, cout, s);
  return static_cast<int>(err);
}
