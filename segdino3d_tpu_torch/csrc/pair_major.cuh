// The pair-major products shared by K1 (gather_gemm_conv.cu) and K10's
// live-pair path (block_conv.cu): the work items of a per-offset list of
// (row, offset) pairs, each item's products written to a pair-major fp32
// buffer, which the caller's sum kernel adds in ascending offset order.
//
// An item is 64 consecutive pairs of one offset and one column tile, so
// every item but an offset's last is a full 64-row GEMM tile.  Persistent
// thread blocks take items by an atomic ticket that the block taking the
// last ticket resets.  An item's 64 source rows come from the caller's
// `Source` (source(o, j, ct, p): the source row of pair j of offset o, p
// its row in the buffer; K1 also records p in its index map there), and
// its products go to buffer rows p = (the offset's first pair) + j:
// fp32 and bf16 on gather_tile.cuh's core (FMAs, mma.sync), bf16 at the
// wide stems on wgmma_tile.cuh's warpgroup core.  (The ticket loop and its
// shared slot stay in one inlined body: taking items through a helper
// that held the slot by pointer cost K1 12% at level 0.)
#pragma once

#include "gather_tile.cuh"
#include "wgmma_tile.cuh"

namespace pmc {

// dynamic shared memory of products<T, BN>: two stages, the item's source
// rows and the two prefixes of the counts
template <typename T, int BN>
size_t smem_bytes(int n_off) {
  return sizeof(T) * 2 * gtt::Smem<T, BN>::kStage + sizeof(int) * (gtt::BM + 2 * (n_off + 1));
}
// and of products_wg<BN>: the ring, the same tables
template <int BN>
size_t smem_bytes_wg(int n_off) {
  return wgc::Ring<BN>::kBytes + sizeof(int) * (gtt::BM + 2 * (n_off + 1));
}

template <typename T, int BN, class Source>
__device__ __forceinline__ void products(const T* __restrict__ x, const T* __restrict__ w,
                                         const int32_t* __restrict__ counts,
                                         int32_t* __restrict__ ticket,
                                         float* __restrict__ partial, int cin, int cout,
                                         int n_off, const Source& source) {
  using S = gtt::Smem<T, BN>;
  using gtt::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);
  int* const s_src = reinterpret_cast<int*>(stage + 2 * S::kStage);  // [BM]
  int* const s_first = s_src + BM;                                  // [n_off + 1]
  int* const s_group = s_first + n_off + 1;                         // [n_off + 1]
  __shared__ int s_item;

  const int tid = threadIdx.x;
  gtt::pair_prefixes(counts, n_off, s_first, s_group);
  const int n_col = (cout + BN - 1) / BN, ld = n_col * BN;
  const bool vec_a = cin % gtt::Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = cout % gtt::Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
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
    if (tid < live) s_src[tid] = source(o, j0 + tid, ct, s_first[o] + j0 + tid);
    __syncthreads();
    gtt::products<T, BN>(part, stage, x, w, s_src, live, o, ct * BN, cin, cout, vec_a, vec_b);
    part.store(partial + (int64_t)(s_first[o] + j0) * ld + ct * BN, ld, live);
  }
}

// The same items on the warpgroup core (bf16): each item's Cin in
// 64-channel stages through the ring of wgmma_tile.cuh
template <int BN, class Source>
__device__ __forceinline__ void products_wg(const wgc::bf16* __restrict__ x,
                                            const wgc::bf16* __restrict__ w,
                                            const int32_t* __restrict__ counts,
                                            int32_t* __restrict__ ticket,
                                            float* __restrict__ partial, int cin, int cout,
                                            int n_off, bool vec_a, bool vec_b,
                                            const Source& source) {
  using gtt::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const ring = wgc::ring_base(smem);
  int* const s_src = reinterpret_cast<int*>(smem + wgc::Ring<BN>::kBytes);  // [BM]
  int* const s_first = s_src + BM;                                          // [n_off + 1]
  int* const s_group = s_first + n_off + 1;                                 // [n_off + 1]
  __shared__ int s_item;
  const int tid = threadIdx.x;
  gtt::pair_prefixes(counts, n_off, s_first, s_group);
  const int n_col = (cout + BN - 1) / BN, ld = n_col * BN;
  const int n_kc = (cin + wgc::BK - 1) / wgc::BK;
  const int n_items = s_group[n_off] * n_col;
  float acc[BN / 2];
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
    if (tid < BM)
      s_src[tid] = tid < live ? source(o, j0 + tid, ct, s_first[o] + j0 + tid) : -1;
    __syncthreads();
    auto stage = [&](int st) { return wgc::Stage{s_src, o, st * wgc::BK}; };
    wgc::mainloop<BN>(acc, ring, x, w, n_kc, stage, ct * BN, cin, cout, vec_a, vec_b);
    wgc::store_f32<BN>(acc, partial + (int64_t)(s_first[o] + j0) * ld + ct * BN, ld, live);
  }
}

}  // namespace pmc
