// The row-group form of K1 (gather_gemm_conv.cu:gather_conv_rows) and of
// K10's live-pair conv (block_conv.cu:block_conv_live): one kernel sums
// every offset's products into a group of rows, with no pair-major buffer,
// no index map, no offset chunks and no carry.
//
// Both pair lists keep, per offset o and in row order, the rows that pair
// there (K1: the table rows r with nbr[o][r] >= 0, gather_wgrad.cu:
// gather_pairs; K10: the listed rows whose source cell is occupied,
// block_conv.cu:block_live_pairs); their count passes store one bit per
// (offset, row), whether that pair is live, and their list passes, per
// offset and 32-row word, how many of the offset's pairs come before the
// word (`starts`).  So the pairs of the rows i0 .. i0 + R - 1 (i0 a
// multiple of R, R a multiple of 32) at offset o are the contiguous range
// [starts[o][i0 / 32], + the group's set bits) of offset o's list, and the
// j-th pair of that range belongs to the group's row at the j-th set bit.
//
// A work item is a group of R rows and one BN-column tile.  Persistent
// thread blocks take items by the list's atomic ticket, which the block
// taking the last ticket resets.  An item loads its rows, its bits and its
// ranges' starts, zeroes an fp32 accumulator of R x BN in shared memory,
// then walks its offsets in ascending order, each offset's range in chunks
// of up to 64 pairs.  A chunk's source rows come from the caller's
// `Src`: K10 copies them from its list's src with cp.async, K1 reads
// nbr[o][row] at the chunk's rows.  A chunk's Cin runs in 32-channel stages
// on gather_tile.cuh's core (K1's pair-major core): each stage gathers the
// chunk's source rows' slice with cp.async into padded shared rows (the
// sources themselves fetched into a ring of slots two stages earlier) and
// the offset's weight slice beside them, the next stage's copies in
// flight, one barrier a stage; fp32 on FMAs, bf16 on mma.sync.m16n8k16,
// only the 16-row groups that hold pairs.  When a chunk's last stage is
// done, each thread adds its pairs' products, complete over Cin, into their
// rows' accumulators (each (pair, column) is one thread's; the next
// stage's barrier orders the next chunk's adds after these; a row's
// 8-column groups are permuted by the row so that the rows of one add
// spread over the banks).  Finally every row of the group is written once,
// rounded to the output type: 0 where it has no live pair, and (K1) 0
// outside `valid`.
//
// The group size R is one constant per dtype (Group: fp32 64, bf16 128,
// the paired measurement's best; groups of 192 rows, filled so that an
// offset's pairs fill about one 64-pair tile, lost in both dtypes, and so
// did K1's bf16 wide stems on the warpgroup core: PERF.md section 6).
//
// Order of the sums: each pair's product over Cin is summed over the
// stages in order (fp32: an FMA chain over the slices, then the channels,
// ascending, from 0), the pair-major products' chain (pair_major.cuh); each
// row's accumulator starts at 0 and takes its pairs' products in ascending
// offset order, as the pair-major sum adds them, chunked or not.  So in
// fp32 the row groups equal the pair-major form bit for bit (and K10's the
// row-tile path's).  bf16 sums in fp32 and rounds once, on the store.  No
// float atomics: two calls are bit-equal.
//
// What bounds it: the products, 2 x pairs x Cin x Cout operations, over
// inputs read once and each row written once; the pair-major form beside it
// also writes and reads every pair's fp32 products (384 bytes a pair at
// Cout 96), and past SEGDINO_CONV_CHUNK_MB an fp32 carry of every row each
// chunk.  What holds the groups back (PERF.md section 6): an item walks
// its offsets in turn, each a chunk of the pairs its rows have there.  At
// the sizes that leave two blocks an SM an offset's pairs fill about half
// a 64-pair chunk (a third of a k3 table's rows pair at an offset, a fifth
// of the k5 stem's, fewer where rows are padding), and larger groups spill
// an offset's last few pairs into a second chunk, so a stage pays a whole
// stage's latency, barrier and weight slice for about half a tile's
// products: per SM about twice the pair-major form's stages.  fp32, on
// FMAs, lost at every scale measured (1.1-2.4x); bf16, whose products are
// cheap, won where the pair-major form's buffer and chunks cost most: K1's
// k3 convs of large tables (ops/narrow.py:K1_ROW_GROUPS_MIN_CAP), K10's dX
// from 65,536 listed rows.
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

// The pair list's word tables as the kernel reads them: per offset the
// bits (a word per 32 rows, `words` a offset) and the offset's pairs before
// each word (uncapped); `cap` bounds an offset's list.
struct Words {
  const uint32_t* bits;
  const int32_t* starts;
  int64_t words;
  int cap;
};

// K10's rows: a row list of at most `cap` listed rows, written where listed
struct ListRows {
  const int32_t* list;
  const int32_t* count;
  int cap;
  __device__ __forceinline__ int n() const { return min(*count, cap); }
  __device__ __forceinline__ int row(int i) const { return list[i]; }
};
// K1's: every row of the table, its sum where valid, else 0 (row -2 - r)
struct TableRows {
  const uint8_t* valid;
  int v;
  __device__ __forceinline__ int n() const { return v; }
  __device__ __forceinline__ int row(int i) const { return valid[i] ? i : -2 - i; }
};

// K10's sources: pair p of offset o's list, copied with cp.async
struct ListSrc {
  static constexpr bool kByRow = false;
  const int32_t* src;
  int cap;
  __device__ __forceinline__ void fetch(int* slot, int o, int p, int) const {
    wgt::cp_async4(slot, src + (int64_t)o * cap + p, 4);
  }
};
// K1's: the table's neighbour of row r at offset o
struct TableSrc {
  static constexpr bool kByRow = true;
  const int32_t* nbr;
  int v;
  __device__ __forceinline__ void fetch(int* slot, int o, int, int r) const {
    *slot = nbr[(int64_t)o * v + r];
  }
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
// An item's tables in shared memory (see smem_bytes)
struct Tables {
  float* acc;       // [R][BN]
  uint32_t* bits;   // [n_off][R / 32]
  int* start;       // [n_off]
  int* cnt;         // [n_off]
  int* chunk;       // [n_off * ceil(R / 64)]
  int* row;         // [R]
  int* src;         // [kSlots][BM]
  __device__ Tables(unsigned char* base, int n_off, int rows, int bn) {
    acc = reinterpret_cast<float*>(base);
    bits = reinterpret_cast<uint32_t*>(acc + rows * bn);
    start = reinterpret_cast<int*>(bits + n_off * (rows / 32));
    cnt = start + n_off;
    chunk = cnt + n_off;
    row = chunk + n_off * (rows / BM);
    src = row + rows;
  }
};

// Item setup for the group of rows i0 .. i0 + R - 1: its rows (-1 past the
// list), bits (0 past the tables' words), each offset's range (start, count
// cut at the list's capacity), the chunk table (offsets ascending, each
// range in 64s: offset << 16 | its first pair) and a zero accumulator of
// BN columns.  Every thread calls it; it ends with a barrier.  Returns the
// chunks.
template <int R, class Rows>
__device__ __forceinline__ int setup(const Tables& s, const Rows& rows, const Words& pw,
                                     int n_list, int i0, int bn, int n_off,
                                     int* __restrict__ s_chunks) {
  constexpr int W = R / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t w0 = i0 / 32;
  for (int i = tid; i < R; i += kThreads) s.row[i] = i0 + i < n_list ? rows.row(i0 + i) : -1;
  for (int e = tid; e < n_off * W; e += kThreads) {
    const int o = e / W, q = e % W;
    s.bits[e] = w0 + q < pw.words ? pw.bits[o * pw.words + w0 + q] : 0u;
  }
  for (int o = tid; o < n_off; o += kThreads)
    s.start[o] = min(pw.starts[o * pw.words + w0], pw.cap);
  for (int e = tid * 4; e < R * bn; e += kThreads * 4)
    *reinterpret_cast<float4*>(s.acc + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // each offset's range: the group's set bits, cut at the list's capacity
  for (int o = tid; o < n_off; o += kThreads) {
    int c = 0;
#pragma unroll
    for (int q = 0; q < W; ++q) c += __popc(s.bits[o * W + q]);
    s.cnt[o] = min(c, pw.cap - s.start[o]);
  }
  __syncthreads();
  if (warp == 0) {  // the chunks: offsets ascending, each range in 64s
    int n = 0;
    for (int o0 = 0; o0 < n_off; o0 += 32) {
      const int o = o0 + lane;
      const int nc = o < n_off ? (s.cnt[o] + BM - 1) / BM : 0;
      int incl = nc;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += u;
      }
      for (int c = 0; c < nc; ++c) s.chunk[n + incl - nc + c] = o << 16 | c * BM;
      n += __shfl_sync(0xFFFFFFFFu, incl, 31);
    }
    if (lane == 0) *s_chunks = n;
  }
  __syncthreads();
  return *s_chunks;
}

// Chunk c's offset o and first pair j0 (in the offset's range); returns its
// pairs.
__device__ __forceinline__ int chunk_of(const Tables& s, int c, int& o, int& j0) {
  const int ch = s.chunk[c];
  o = ch >> 16;
  j0 = ch & 0xFFFF;
  return min(BM, s.cnt[o] - j0);
}

// Chunk c's source rows into `slot` (threads below 64; -1 past its pairs):
// K10's copied from the list (cp.async), K1's read from the table at the
// chunk's rows.
template <int W, class Src>
__device__ __forceinline__ void fetch_chunk(const Tables& s, const Src& src, int* slot, int c,
                                            int i0) {
  const int tid = threadIdx.x;
  int o, j0;
  const int live = chunk_of(s, c, o, j0);
  if (tid < live) {
    if constexpr (Src::kByRow)
      src.fetch(slot + tid, o, 0, i0 + group_row<W>(s.bits + o * W, j0 + tid));
    else
      src.fetch(slot + tid, o, s.start[o] + j0 + tid, 0);
  } else if (tid < BM) {
    slot[tid] = -1;
  }
}

// The group's rows written once: row r >= 0 its sum, r <= -2 (row -2 - r)
// zeros, -1 nothing; columns n0 .. n0 + BN - 1 below Cout.
template <typename T, int BN, int R>
__device__ __forceinline__ void store_group(const Tables& s, T* __restrict__ out, int n0,
                                            int cout) {
  for (int e = threadIdx.x; e < R * (BN / 4); e += kThreads) {
    const int i = e / (BN / 4), c = e % (BN / 4) * 4;
    const int r = s.row[i];
    if (r == -1 || n0 + c >= cout) continue;
    const float4 v = r >= 0 ? *reinterpret_cast<const float4*>(s.acc + i * BN + acc_col(i, c))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    gtt::store4(out + (int64_t)(r >= 0 ? r : -2 - r) * cout, n0 + c, cout, v);
  }
}

// out at the rows of every group of Group<T>::R rows: see the header.  w (n_off, Cin, Cout).
//
// The schedule, phase p from -2: wait for the copies issued in phase p - 1,
// one barrier, then (one copy group) the sources of the chunk that starts
// at stage p + 2 into its slot (-1 past its pairs), and stage p + 1's
// copies, which read the sources of their chunk (fetched a phase earlier or
// before, so landed); then stage p's products, and at a chunk's last stage
// its adds.  A stage buffer is reused two stages on, a source slot kSlots
// chunks on; both were last read before an earlier phase's barrier.
template <typename T, int BN, class Rows, class Src>
__device__ __forceinline__ void conv(const T* __restrict__ x, const T* __restrict__ w,
                                     const Rows rows, const Words pw, const Src src,
                                     int32_t* __restrict__ ticket, T* __restrict__ out, int cin,
                                     int cout, int n_off) {
  using S = gtt::Smem<T, BN>;
  constexpr int KQ = sizeof(T) == 2 ? 16 : 4;  // the products' channel step
  constexpr int R = Group<T>::R;
  constexpr int W = R / 32;
  static_assert(R % BM == 0 && (BN / 8) % 4 == 0, "whole chunks; whole column groups");
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);
  const Tables s(reinterpret_cast<unsigned char*>(stage + 2 * S::kStage), n_off, R, BN);
  __shared__ int s_item, s_chunks;

  const int tid = threadIdx.x;
  const int n_list = rows.n();
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
    const int n_stages = setup<R>(s, rows, pw, n_list, i0, BN, n_off, &s_chunks) * n_kc;
    auto fetch_sources = [&](int st) {  // where a chunk starts at stage st
      if (st >= n_stages || st % n_kc != 0) return;
      const int c = st / n_kc;
      fetch_chunk<W>(s, src, s.src + c % kSlots * BM, c, i0);
    };
    auto copy = [&](int st) {
      if (st < 0 || st >= n_stages) return;
      const int c = st / n_kc;
      int o, j0;
      const int live = chunk_of(s, c, o, j0);
      T* const As = stage + st % 2 * S::kStage;
      gtt::load_stage<T, BN>(As, As + BM * S::AST, x, w + (int64_t)o * cin * cout,
                             s.src + c % kSlots * BM, live, (live + 15) / 16 * 16,
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
      const int live = chunk_of(s, st / n_kc, o, j0), kc = st % n_kc;
      const int k_end = min(BK, cin - kc * BK);
      const T* const As = stage + st % 2 * S::kStage;
      part.compute(As, As + BM * S::AST, (live + 15) / 16, (k_end + KQ - 1) / KQ * KQ);
      if (kc == n_kc - 1) {
        add_part<BN, W>(part, s.acc, s.bits + o * W, j0, live);
        part.zero();
      }
    }
    __syncthreads();  // every chunk's adds are in
    store_group<T, BN, R>(s, out, n0, cout);
  }
}

}  // namespace lrc
