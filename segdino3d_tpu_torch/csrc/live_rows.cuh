// K10's live-pair conv in row groups (block_conv.cu:block_conv_live): one
// kernel sums every offset's products into a group of listed rows, with no
// pair-major buffer and no second pass.
//
// The live-pair list (block_conv.cu:block_live_pairs) keeps, per offset o
// and in list order, the listed rows whose source cell is occupied; its
// count pass stores one bit per (offset, listed row), whether that pair is
// live, and its list pass, per offset and 32-row word of the list, how
// many of the offset's pairs come before the word (`starts`).  So the
// pairs of the listed rows i0 .. i0 + R - 1 (i0 a multiple of R, R a
// multiple of 32) at offset o are the contiguous range
// [starts[o][i0 / 32], + the group's set bits) of offset o's list, and the
// j-th pair of that range belongs to the group's row at the j-th set bit.
//
// A work item is a group of R listed rows and one BN-column tile.
// Persistent thread blocks take items by the list's atomic ticket, which
// the block taking the last ticket resets.  An item loads its rows, its
// bits and its ranges' starts, zeroes an fp32 accumulator of R x BN in
// shared memory, then walks its offsets in ascending order, each offset's
// range in chunks of up to 64 pairs.  A chunk's Cin runs in 32-channel
// stages on gather_tile.cuh's core (K1's): each stage gathers the chunk's
// source rows' slice with cp.async into padded shared rows (the sources
// themselves copied into a ring of slots two stages earlier) and the
// offset's weight slice beside them, the next stage's copies in flight, one
// barrier a stage; fp32 on FMAs, bf16 on mma.sync.m16n8k16, only the
// 16-row groups that hold pairs.  When a chunk's last stage is done, each
// thread adds its pairs' products, complete over Cin, into their rows'
// accumulators (each (pair, column) is one thread's; the next stage's
// barrier orders the next chunk's adds after these; a row's 8-column
// groups are permuted by the row so that the rows of one add spread over
// the banks).  Finally every listed row of the group is written once,
// rounded to the output type (0 where it has no live pair).
//
// Order of the sums: each pair's product over Cin is summed over the
// stages in order (fp32: an FMA chain over the slices, then the channels,
// ascending, from 0); each row's accumulator starts at 0 and takes its
// pairs' products in ascending offset order.  In fp32 that is the row-tile
// path's order without its exact zeros (a pair whose source is outside the
// occupancy multiplies a zero row), so the result equals the row tiles'
// bit for bit.  bf16 sums in fp32 and rounds once, on the store.  No float
// atomics: two calls are bit-equal.
//
// What bounds it: the products, 2 x pairs x Cin x Cout operations, over
// inputs read once and each listed row written once; the pair-major form
// beside it (pair_major.cuh) also writes and reads every pair's fp32
// products (384 bytes a pair at Cout 96).  What holds it back (PERF.md
// section 6): an item walks its ~27 offsets in turn (125 at the k5 stem),
// each a chunk of the third of its rows that pair there, so a stage does a
// part of a tile's products for a whole stage's latency, barrier and
// weight slice, and a level's work is a few hundred such chains, where the
// pair-major form runs thousands of full 64-pair items side by side; the
// accumulator (R x BN fp32) holds blocks an SM to two or three; fp32 is
// FMA-bound on the partly filled chunks.  It beat the row tiles and the
// pair-major form at the bf16 dX of the largest level, where a group's
// chunks fill best.  (The
// bf16 row tiles' wgmma core in its place, and other group sizes and
// stage rings, lost: PERF.md.)
#pragma once

#include "gather_tile.cuh"

namespace lrc {

using gtt::BK;
using gtt::BM;
constexpr int kThreads = gtt::kThreads;

// The rows a group: fp32 64, bf16 128 (the paired measurement's best)
template <typename T>
struct Group {
  static constexpr int R = sizeof(T) == 2 ? 128 : 64;
};

// The live-pair list as the kernel reads it (block_conv.cu:LiveWs): the
// sources (n_off x cap), per offset the bits (a word per 32 listed rows,
// `words` a offset) and the pairs before each word.
struct Pairs {
  const int32_t* src;
  const uint32_t* bits;
  const int32_t* starts;
  int64_t words;
  int cap;
};

// the slots of the chunks' sources in shared memory (see conv)
constexpr int kSlots = 4;

// dynamic shared memory: two stages, the accumulator (R x BN), then the
// bits (n_off x R / 32), the ranges' starts and counts (n_off each), the
// chunk table (n_off x R / 64), the rows (R) and the chunks' sources
// (kSlots x 64)
template <typename T, int BN>
size_t smem_bytes(int n_off) {
  constexpr int R = Group<T>::R;
  return sizeof(T) * 2 * gtt::Smem<T, BN>::kStage + sizeof(float) * R * BN +
         sizeof(int) * ((size_t)n_off * (R / 32 + 2 + R / BM) + R + kSlots * BM);
}

// The position of the n-th (from 0) set bit of m; n < popc(m).
__device__ __forceinline__ int nth_bit(uint32_t m, int n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const uint32_t lo = m & ((1u << s) - 1u);
    const int c = __popc(lo);
    if (n >= c) {
      n -= c;
      m >>= s;
      pos += s;
    } else {
      m = lo;
    }
  }
  return pos;
}

// The group row of the n-th set bit of a group's W words (shared memory).
template <int W>
__device__ __forceinline__ int group_row(const uint32_t* __restrict__ bits, int n) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int c = __popc(bits[w]);
    if (n < c) return w * 32 + nth_bit(bits[w], n);
    n -= c;
  }
  return -1;
}

// The accumulator holds row i's columns in groups of 8, group g at
// (g ^ (i % 4)) * 8: the rows a warp's adds touch at once spread over the
// banks (BN / 8 is a multiple of 4, so the groups stay inside the row).
__device__ __forceinline__ int acc_col(int row, int col) {
  return ((col >> 3) ^ (row & 3)) << 3 | (col & 7);
}

// acc[row of pair j0 + e][col] += the part's entry e, for e < live.
// fp32: thread (tx, ty) = (tid % 8, tid / 8) holds entries ty + 16 i,
// columns 32 j4 + 4 tx .. + 3.
template <int BN, int W>
__device__ __forceinline__ void add_part(const gtt::Part<float, BN>& part,
                                         float* __restrict__ acc,
                                         const uint32_t* __restrict__ bits, int j0, int live) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = ty + 16 * i;
    if (e >= live) continue;
    const int row = group_row<W>(bits, j0 + e);
    float* const a = acc + row * BN;
#pragma unroll
    for (int j4 = 0; j4 < BN / 32; ++j4) {
      float4* const p = reinterpret_cast<float4*>(a + acc_col(row, j4 * 32 + tx * 4));
      float4 s = *p;
      s.x += part.v[i][4 * j4];
      s.y += part.v[i][4 * j4 + 1];
      s.z += part.v[i][4 * j4 + 2];
      s.w += part.v[i][4 * j4 + 3];
      *p = s;
    }
  }
}
// bf16 (mma.sync's fragments): v[t][2 h + q] is entry 16 w + lane / 4 +
// 8 h, column 8 t + 2 (lane % 4) + q
template <int BN, int W>
__device__ __forceinline__ void add_part(const gtt::Part<__nv_bfloat16, BN>& part,
                                         float* __restrict__ acc,
                                         const uint32_t* __restrict__ bits, int j0, int live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int e = 16 * warp + lane / 4 + 8 * hh;
    if (e >= live) continue;
    const int row = group_row<W>(bits, j0 + e);
    float* const a = acc + row * BN + 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      float2* const p = reinterpret_cast<float2*>(a + ((t ^ (row & 3)) << 3));
      float2 s = *p;
      s.x += part.v[t][2 * hh];
      s.y += part.v[t][2 * hh + 1];
      *p = s;
    }
  }
}

// out[list[i]] for the listed rows i0 .. i0 + R - 1 of every group: see the
// header.  list/count: the row list the pairs were built on (at most
// row_cap rows of it listed); w (n_off, Cin, Cout).
//
// The schedule, phase p from -2: wait for the copies issued in phase p - 1,
// one barrier, then (one copy group) the sources of the chunk that starts
// at stage p + 2, with 4-byte cp.async copies into its slot (-1 past its
// pairs), and stage p + 1's copies, which read the sources of their chunk
// (fetched a phase earlier or before, so landed); then stage p's products,
// and at a chunk's last stage its adds.  A stage buffer is reused two
// stages on, a source slot kSlots chunks on; both were last read before an
// earlier phase's barrier.
template <typename T, int BN>
__device__ __forceinline__ void conv(const T* __restrict__ x, const T* __restrict__ w,
                                     const int32_t* __restrict__ list,
                                     const int32_t* __restrict__ count, const Pairs pairs,
                                     int32_t* __restrict__ ticket, T* __restrict__ out,
                                     int row_cap, int cin, int cout, int n_off) {
  using S = gtt::Smem<T, BN>;
  constexpr int R = Group<T>::R, W = R / 32, CH = R / BM;
  constexpr int KQ = sizeof(T) == 2 ? 16 : 4;  // the products' channel step
  static_assert(R % BM == 0 && (BN / 8) % 4 == 0, "whole chunks; whole column groups");
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);
  float* const s_acc = reinterpret_cast<float*>(stage + 2 * S::kStage);  // [R][BN]
  uint32_t* const s_bits = reinterpret_cast<uint32_t*>(s_acc + R * BN);  // [n_off][W]
  int* const s_start = reinterpret_cast<int*>(s_bits + n_off * W);      // [n_off]
  int* const s_cnt = s_start + n_off;                                    // [n_off]
  int* const s_chunk = s_cnt + n_off;                                    // [n_off * CH]
  int* const s_row = s_chunk + n_off * CH;                               // [R]
  int* const s_src = s_row + R;                                          // [kSlots][BM]
  __shared__ int s_item, s_chunks;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_list = min(*count, row_cap);
  const int n_col = (cout + BN - 1) / BN;
  const int n_items = (n_list + R - 1) / R * n_col;
  const int n_kc = (cin + BK - 1) / BK;
  const bool vec_a = cin % gtt::Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = cout % gtt::Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  gtt::Part<T, BN> part;

  for (;;) {
    if (tid == 0) s_item = atomicAdd(ticket, 1);
    __syncthreads();  // also: the last item's reads of shared memory are done
    const int item = s_item;
    if (item >= n_items) {
      // the last ticket taken: every block is done with the counter
      if (tid == 0 && item == n_items + (int)gridDim.x - 1) *ticket = 0;
      break;
    }
    const int i0 = item / n_col * R, n0 = item % n_col * BN;
    for (int i = tid; i < R; i += kThreads) s_row[i] = i0 + i < n_list ? list[i0 + i] : -1;
    for (int e = tid; e < n_off * W; e += kThreads)
      s_bits[e] = pairs.bits[e / W * pairs.words + i0 / 32 + e % W];
    for (int o = tid; o < n_off; o += kThreads)
      s_start[o] = min(pairs.starts[o * pairs.words + i0 / 32], pairs.cap);
    for (int e = tid * 4; e < R * BN; e += kThreads * 4)
      *reinterpret_cast<float4*>(s_acc + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    // each offset's range: the group's set bits, cut at the list's capacity
    for (int o = tid; o < n_off; o += kThreads) {
      int c = 0;
#pragma unroll
      for (int q = 0; q < W; ++q) c += __popc(s_bits[o * W + q]);
      s_cnt[o] = min(c, pairs.cap - s_start[o]);
    }
    __syncthreads();
    if (warp == 0) {  // the chunks: offsets ascending, each range in 64s
      int n = 0;
      for (int o0 = 0; o0 < n_off; o0 += 32) {
        const int o = o0 + lane;
        const int nc = o < n_off ? (s_cnt[o] + BM - 1) / BM : 0;
        int incl = nc;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int u = __shfl_up_sync(0xFFFFFFFFu, incl, d);
          if (lane >= d) incl += u;
        }
        for (int c = 0; c < nc; ++c) s_chunk[n + incl - nc + c] = o << 16 | c * BM;
        n += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
      if (lane == 0) s_chunks = n;
    }
    __syncthreads();
    const int n_stages = s_chunks * n_kc;
    // chunk c: offset o, its first pair j0 in the range; returns its pairs
    auto chunk = [&](int c, int& o, int& j0) {
      const int ch = s_chunk[c];
      o = ch >> 16;
      j0 = ch & 0xFFFF;
      return min(BM, s_cnt[o] - j0);
    };
    auto fetch_sources = [&](int st) {  // where a chunk starts at stage st
      if (st >= n_stages || st % n_kc != 0) return;
      const int c = st / n_kc;
      int o, j0;
      const int live = chunk(c, o, j0);
      int* const slot = s_src + c % kSlots * BM;
      if (tid < live)
        wgt::cp_async4(slot + tid, pairs.src + (int64_t)o * pairs.cap + s_start[o] + j0 + tid, 4);
      else if (tid < BM)
        slot[tid] = -1;
    };
    auto copy = [&](int st) {
      if (st < 0 || st >= n_stages) return;
      const int c = st / n_kc;
      int o, j0;
      const int live = chunk(c, o, j0);
      T* const As = stage + st % 2 * S::kStage;
      gtt::load_stage<T, BN>(As, As + BM * S::AST, x, w + (int64_t)o * cin * cout,
                             s_src + c % kSlots * BM, live, (live + 15) / 16 * 16,
                             st % n_kc * BK, n0, cin, cout, vec_a, vec_b);
    };
    part.zero();
    for (int st = -2; st < n_stages; ++st) {
      wgt::cp_async_wait_all();
      __syncthreads();  // stage st and the next chunk's sources are visible
      fetch_sources(st + 2);
      copy(st + 1);
      wgt::cp_async_commit();
      if (st < 0) continue;
      int o, j0;
      const int live = chunk(st / n_kc, o, j0), kc = st % n_kc;
      const int k_end = min(BK, cin - kc * BK);
      const T* const As = stage + st % 2 * S::kStage;
      part.compute(As, As + BM * S::AST, (live + 15) / 16, (k_end + KQ - 1) / KQ * KQ);
      if (kc == n_kc - 1) {
        add_part<BN, W>(part, s_acc, s_bits + o * W, j0, live);
        part.zero();
      }
    }
    __syncthreads();  // every chunk's adds are in
    for (int e = tid; e < R * (BN / 4); e += kThreads) {
      const int i = e / (BN / 4), c = e % (BN / 4) * 4;
      const int row = s_row[i];
      if (row < 0 || n0 + c >= cout) continue;
      gtt::store4(out + (int64_t)row * cout, n0 + c, cout,
                  *reinterpret_cast<const float4*>(s_acc + i * BN + acc_col(i, c)));
    }
  }
}

}  // namespace lrc
