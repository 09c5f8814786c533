// K7: the neighbour tables of a pyramid, by probing K6's tables.
//
// Replaces segdino3d_tpu/ops/sparse_conv.py:_neighbor_table
// (sparse_conv.py:64), with the border guard of
// segdino3d_tpu/ops/keys.py:neighbor_wrap_masks (keys.py:85).  Each output
// is an (n_off, v) offset-major table, out[o, i] = the voxel at coords[i] +
// offset o, -1 where absent, for rows past the level's count, and for a
// neighbour whose id lies at or past the level's capacity (dropped by an
// overflow).  On the main path one launch builds every table of a device
// plan: the 125 x V0 stem table (k5) and one 27 x V_l table (k3) per level.
//
// What bounds it: the probes.  The stem table's output is 46 MB at V0 =
// 92,160, but each probe reads a random 32-byte sector of the key array
// (and one of the value array on a hit), and a probe chain is a dependent
// pair of loads, so a thread that probes one offset at a time waits on
// latency.  K6's table (2^18 slots, 2 MB) stays in L2.
//
// Design:
//   * half the probes.  In itertools.product order offset n-1-o is -offset
//     o, and the table is an involution on live rows: out[o, i] = j  <=>
//     out[n-1-o, j] = i (both ids below the count and the capacity).  The
//     first n/2 offsets are probed, each hit j of row i at offset o also
//     writes out[n-1-o, j] = i (a bijection: no atomics), and the centre is
//     the row's own id while it is live.  This is the JAX package's
//     transpose-scatter (sparse_conv.py:110-124) without its fault past the
//     cap: a hit counts only when i < count and j < v, as a direct lookup
//     gives.  A cell of the mirrored half that no hit names stays -1: the C
//     entry sets the mirrored halves to -1 with one cudaMemsetAsync first,
//     because a hit may land in any row, so no thread block owns a cell of
//     that half;
//   * one thread per row over a group of up to 8 offsets: the row's four
//     coordinates are read once and stay in registers, the group's first
//     slots are read together, then the rare collision chains, then the
//     hits' values together, so 8 independent probes are in flight a
//     thread.  First-half stores are coalesced along rows (out[o * v + i]);
//   * a k5 table's 27 offsets with every |d| <= 1 also fill a k3 table of
//     the same level (mirrored half included), through the host's k5 -> k3
//     offset map (sparse_conv.subset_offsets): level 0's k3 table needs no
//     probes of its own;
//   * one launch for a plan: a flat list of work items (table, 256-row
//     tile, offset group), the tables' descriptors passed by value.
// A field outside its bit range packs to the sentinel
// (coord_hash::pack_key), which is the meaning of the JAX wrap masks, and a
// sentinel never matches.  Offsets are computed from the kernel size.
//
// Contract (per table): coords (4, v) int32 SoA (b, x, y, z) of the level;
// num (1,) int32 on the card, the level's voxel count (may exceed v); k
// odd, at most 7; tkeys/tvals K6's table of the level with values
// remapped to voxel ids (K8), t_size slots; out (k^3, v) int32 whose
// mirrored half (rows n/2 + 1 ..) is all -1 on entry (the C entry's
// memset); sub null or (27, v) int32 with its mirrored half -1 on entry.
#include <cuda_runtime.h>
#include <stdint.h>

#include "coord_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;          // offsets one thread probes at once
constexpr int kMaxTables = 8;
constexpr int kMaxOffsets = 343;   // k <= 7

struct Table {
  const int32_t* coords;
  const int32_t* num;
  const uint32_t* tkeys;
  const int32_t* tvals;
  int32_t* out;
  int32_t* sub;
  int v, k, mask, group, n_groups, first_item;
};

struct Params {
  Table t[kMaxTables];
  int n_tables;
  int8_t sub_of[kMaxOffsets];  // a sub table's offset of each offset, or -1
};

__global__ void __launch_bounds__(kThreads)
neighbor_kernel(const __grid_constant__ Params p) {
  const int item = blockIdx.x;
  Table t = p.t[0];
#pragma unroll
  for (int q = 1; q < kMaxTables; ++q)
    if (q < p.n_tables && item >= p.t[q].first_item) t = p.t[q];
  const int local = item - t.first_item;
  const int grp = local % t.n_groups;
  const int i = (local / t.n_groups) * kThreads + threadIdx.x;
  const int v = t.v;
  if (i >= v) return;
  const int k = t.k, n_off = k * k * k, half = n_off / 2, r = k / 2;
  const bool live = i < *t.num;
  if (grp == 0) {
    t.out[(int64_t)half * v + i] = live ? i : -1;
    if (t.sub != nullptr) t.sub[13 * (int64_t)v + i] = live ? i : -1;
  }
  const int o0 = grp * t.group;
  const int cnt = min(t.group, half - o0);
  int b = 0, x = 0, y = 0, z = 0;
  if (live) {
    b = t.coords[i];
    x = t.coords[(int64_t)v + i];
    y = t.coords[2 * (int64_t)v + i];
    z = t.coords[3 * (int64_t)v + i];
  }
  uint32_t key[kGroup], slot[kGroup], seen[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int o = o0 + u;
    key[u] = coord_hash::kEmptyKey;
    if (live && u < cnt)
      key[u] = coord_hash::pack_key(b, x + o / (k * k) - r, y + (o / k) % k - r,
                                    z + o % k - r);
    slot[u] = coord_hash::hash_slot(key[u], t.mask);
  }
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
    seen[u] = key[u] != coord_hash::kEmptyKey ? t.tkeys[slot[u]] : coord_hash::kEmptyKey;
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {  // collision chains, rare at K6's load
    for (uint32_t q = 0; q < (uint32_t)t.mask && seen[u] != key[u] &&
                         seen[u] != coord_hash::kEmptyKey; ++q) {
      slot[u] = (slot[u] + 1) & (uint32_t)t.mask;
      seen[u] = t.tkeys[slot[u]];
    }
  }
  int32_t id[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    id[u] = key[u] != coord_hash::kEmptyKey && seen[u] == key[u] ? t.tvals[slot[u]] : -1;
    if (id[u] >= v) id[u] = -1;
  }
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (u >= cnt) continue;
    const int o = o0 + u;
    t.out[(int64_t)o * v + i] = id[u];
    if (id[u] >= 0) t.out[(int64_t)(n_off - 1 - o) * v + id[u]] = i;
    if (t.sub != nullptr) {
      const int s = p.sub_of[o];
      if (s >= 0) {
        t.sub[(int64_t)s * v + i] = id[u];
        if (id[u] >= 0) t.sub[(int64_t)(26 - s) * v + id[u]] = i;
      }
    }
  }
}

}  // namespace

// desc: n_tables rows of 9 int64 (coords, num, tkeys, tvals, out, sub, v,
// k, t_size); sub_of: a k^3 int32 map of the tables that have a sub table
// (null when none has); fill, fill_bytes: the range set to -1 first (it
// holds every mirrored half).  Returns the first failed call's cudaError_t.
extern "C" int neighbor_tables(const void* desc, int n_tables, const void* sub_of,
                               void* fill, long long fill_bytes, void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* d = static_cast<const int64_t*>(desc);
  Params p = {};
  p.n_tables = n_tables;
  int items = 0, sub_k = 0;
  for (int q = 0; q < n_tables; ++q, d += 9) {
    Table& t = p.t[q];
    t.coords = reinterpret_cast<const int32_t*>(d[0]);
    t.num = reinterpret_cast<const int32_t*>(d[1]);
    t.tkeys = reinterpret_cast<const uint32_t*>(d[2]);
    t.tvals = reinterpret_cast<const int32_t*>(d[3]);
    t.out = reinterpret_cast<int32_t*>(d[4]);
    t.sub = reinterpret_cast<int32_t*>(d[5]);
    t.v = static_cast<int>(d[6]);
    t.k = static_cast<int>(d[7]);
    t.mask = static_cast<int>(d[8]) - 1;
    if (t.k < 1 || t.k % 2 == 0 || t.k * t.k * t.k > kMaxOffsets || t.v < 0)
      return cudaErrorInvalidValue;
    if (t.sub != nullptr) {
      if (sub_of == nullptr || (sub_k != 0 && sub_k != t.k)) return cudaErrorInvalidValue;
      sub_k = t.k;
    }
    const int half = t.k * t.k * t.k / 2;
    t.n_groups = half > 0 ? (half + kGroup - 1) / kGroup : 1;
    t.group = (half + t.n_groups - 1) / t.n_groups;
    t.first_item = items;
    items += (t.v + kThreads - 1) / kThreads * t.n_groups;
  }
  if (sub_k != 0) {
    const int32_t* m = static_cast<const int32_t*>(sub_of);
    for (int o = 0; o < sub_k * sub_k * sub_k; ++o) p.sub_of[o] = static_cast<int8_t>(m[o]);
  }
  if (fill_bytes > 0) {
    const cudaError_t err = cudaMemsetAsync(fill, 0xFF, static_cast<size_t>(fill_bytes), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (items == 0) return 0;
  neighbor_kernel<<<items, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of an empty kernel: the floor under the time of K7 and of the
// other kernels of a few microseconds, timed beside them.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
