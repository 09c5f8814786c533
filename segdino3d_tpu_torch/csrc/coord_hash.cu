// K6: coordinate hash, uint32 key -> the smallest row that carries it.
//
// Replaces segdino3d_tpu/ops/hashing.py:build_hash (hashing.py:56) and
// lookup_hash (:84), the four-table claim-and-evict hash of the JAX plan
// engine.  Only the map has to match: each key maps to the smallest row
// that carries it, a miss gives -1.  On the main path it runs once per
// pyramid level: 120,000 point keys into a 2^18-slot table at level 0,
// then each level's voxel keys (2x-coarsened) into the next level's table.
// Both callers (voxelize, downsample) look up exactly the keys they have
// just inserted, to find each row's winner: the row that K8 compacts.
//
// What bounds it: a chain of dependent round trips to L2, not bytes: a
// key's compare-and-swap, its minimum, a grid-wide wait, the winner's
// read.  The table (2 MB at level 0) stays in L2; at level 0 the
// 240,000 atomics queue there, and each grid-wide wait costs about a
// launch.  So a level takes a few microseconds whatever its key count
// (PERF.md §6 row 9).
//
// Design: open addressing with linear probing in one table of
// next_pow2(2 * capacity) slots (the JAX table size), a key array and a
// value array (coord_hash.cuh).  Build and lookup of the same keys are one
// cooperative launch whose grid is sized from the occupancy query, so
// every block is resident and may wait for the others:
//   1. clear the table and the overflow flag; wait for the grid;
//   2. insert: a thread claims a slot with atomicCAS(empty -> key) on the
//      key array, or joins its own key there, then atomicMin on the same
//      slot of the value array keeps the smallest row, so the map is the
//      same whatever order the threads run in (the slot a key lands in may
//      differ; lookups do not depend on it).  The thread writes the slot
//      into its row of the output; wait for the grid;
//   3. each row reads the value of the slot it wrote: its winner.  No
//      second probe chain.
// A key that finds no free slot in t_size probes sets the overflow flag
// and gets -1; that happens only when the table is full, which is the
// "pathological case" of the JAX docstring.  lookup_kernel probes for
// other queries.
//
// Contract: keys (n,) int64 holding uint32 keys, kEmptyKey = no row;
// tkeys (t_size,) uint32 and tvals (t_size,) int32 scratch the build
// initialises itself; overflow one bool; winner (n,) int32.  Lookup:
// queries (n,) int64, out (n,) int32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coord_hash.cuh"

namespace cg = cooperative_groups;

namespace {

using coord_hash::kEmptyKey;
constexpr int kThreads = 1024;   // fewer blocks arriving at each grid wait
constexpr int kLookupThreads = 256;
constexpr int32_t kNoRow = 0x7FFFFFFF;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
build_lookup_kernel(const int64_t* __restrict__ keys, int n,
                    uint32_t* __restrict__ tkeys,
                    int32_t* __restrict__ tvals, uint32_t mask,
                    uint8_t* __restrict__ overflow,
                    int32_t* __restrict__ winner) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  for (uint32_t i = first; i <= mask; i += stride) {
    tkeys[i] = kEmptyKey;
    tvals[i] = kNoRow;
  }
  if (first == 0) *overflow = 0;
  grid.sync();
  for (int i = first; i < n; i += stride) {
    const uint32_t key = static_cast<uint32_t>(keys[i]);
    int32_t at = -1;
    if (key != kEmptyKey) {
      uint32_t slot = coord_hash::hash_slot(key, mask);
      for (uint32_t p = 0; p <= mask; ++p) {
        const uint32_t prev = atomicCAS(&tkeys[slot], kEmptyKey, key);
        if (prev == kEmptyKey || prev == key) {
          atomicMin(&tvals[slot], i);
          at = static_cast<int32_t>(slot);
          break;
        }
        slot = (slot + 1) & mask;
      }
      if (at < 0) *overflow = 1;   // every writer writes the same byte
    }
    winner[i] = at;
  }
  grid.sync();
  for (int i = first; i < n; i += stride) {
    const int32_t at = winner[i];
    // past L1: the atomics of other blocks wrote the value
    winner[i] = at >= 0 ? __ldcg(&tvals[at]) : -1;
  }
}

__global__ void __launch_bounds__(kLookupThreads)
lookup_kernel(const int64_t* __restrict__ queries, int n,
              const uint32_t* __restrict__ tkeys,
              const int32_t* __restrict__ tvals, uint32_t mask,
              int32_t* __restrict__ out) {
  const int i = blockIdx.x * kLookupThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = coord_hash::probe(tkeys, tvals, mask,
                             static_cast<uint32_t>(queries[i]));
}

// blocks of build_lookup_kernel that fit on the card at once, per device
int resident_blocks() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, build_lookup_kernel, kThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

}  // namespace

// Initialise the table, insert rows 0..n-1 and write each row's winner,
// in one cooperative launch.  t_size must be a power of two.  Returns the
// launch's cudaError_t.
extern "C" int coord_hash_build(const void* keys, int n, void* tkeys,
                                void* tvals, int t_size, void* overflow,
                                void* winner, void* stream) {
  const int resident = resident_blocks();
  if (resident <= 0) return static_cast<int>(cudaErrorLaunchFailure);
  const int work = n > t_size ? n : t_size;
  int blocks = (work + kThreads - 1) / kThreads;
  blocks = blocks < resident ? blocks : resident;
  blocks = blocks > 0 ? blocks : 1;
  const int64_t* k = static_cast<const int64_t*>(keys);
  uint32_t* tk = static_cast<uint32_t*>(tkeys);
  int32_t* tv = static_cast<int32_t*>(tvals);
  uint32_t mask = static_cast<uint32_t>(t_size - 1);
  uint8_t* of = static_cast<uint8_t*>(overflow);
  int32_t* w = static_cast<int32_t*>(winner);
  void* args[] = {&k, &n, &tk, &tv, &mask, &of, &w};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(build_lookup_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int coord_hash_lookup(const void* queries, int n, const void* tkeys,
                                 const void* tvals, int t_size, void* out,
                                 void* stream) {
  if (n == 0) return 0;
  lookup_kernel<<<(n + kLookupThreads - 1) / kLookupThreads, kLookupThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(queries), n,
      static_cast<const uint32_t*>(tkeys), static_cast<const int32_t*>(tvals),
      static_cast<uint32_t>(t_size - 1), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
