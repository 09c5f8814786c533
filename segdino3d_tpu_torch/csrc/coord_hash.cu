// K6: coordinate hash, uint32 key -> the smallest row that carries it.
//
// Replaces segdino3d_tpu/ops/hashing.py:build_hash (hashing.py:56) and
// lookup_hash (:84), the four-table claim-and-evict hash of the JAX plan
// engine.  Only the map has to match: each key maps to the smallest row
// that carries it, a miss gives -1.  On the main path it runs once per
// pyramid level: 120,000 point keys into a 2^18-slot table at level 0,
// then each level's voxel keys (2x-coarsened) into the next level's table.
//
// What bounds it: bytes, and the latency of dependent probes.  An insert is
// one atomicCAS on the key slot plus one atomicMin on the value; a lookup
// reads slots until its key or an empty slot.  At the table's load (about
// 0.3 at level 0) a probe chain is one or two slots long.
//
// Design: open addressing with linear probing in one table of
// next_pow2(2 * capacity) slots (the JAX table size).  A thread claims a
// slot with atomicCAS(empty -> key); a thread that finds its own key there
// joins it.  Then atomicMin on the value keeps the smallest row, so the
// table's map is the same whatever order the threads run in (the slot a key
// lands in may differ; lookups do not depend on it).  A key that finds no
// free slot in t_size probes sets the overflow flag; that happens only when
// the table is full, which is the "pathological case" of the JAX docstring.
//
// Contract: keys (n,) int64 holding uint32 keys, kEmptyKey = invalid row;
// tkeys (t_size,) uint32 and tvals (t_size,) int32 scratch the insert
// initialises itself; overflow (1,) int32.  Lookup: queries (n,) int64,
// out (n,) int32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "coord_hash.cuh"

namespace {

using coord_hash::kEmptyKey;
constexpr int kThreads = 256;
constexpr int32_t kNoRow = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads)
init_kernel(uint32_t* __restrict__ tkeys, int32_t* __restrict__ tvals,
            int t_size, int32_t* __restrict__ overflow) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < t_size) {
    tkeys[i] = kEmptyKey;
    tvals[i] = kNoRow;
  }
  if (i == 0) *overflow = 0;
}

__global__ void __launch_bounds__(kThreads)
insert_kernel(const int64_t* __restrict__ keys, int n,
              uint32_t* __restrict__ tkeys, int32_t* __restrict__ tvals,
              uint32_t mask, int32_t* __restrict__ overflow) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t key = static_cast<uint32_t>(keys[i]);
  if (key == kEmptyKey) return;
  uint32_t slot = coord_hash::hash_slot(key, mask);
  for (uint32_t p = 0; p <= mask; ++p) {
    const uint32_t prev = atomicCAS(&tkeys[slot], kEmptyKey, key);
    if (prev == kEmptyKey || prev == key) {
      atomicMin(&tvals[slot], i);
      return;
    }
    slot = (slot + 1) & mask;
  }
  atomicExch(overflow, 1);
}

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const int64_t* __restrict__ queries, int n,
              const uint32_t* __restrict__ tkeys,
              const int32_t* __restrict__ tvals, uint32_t mask,
              int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = coord_hash::probe(tkeys, tvals, mask,
                             static_cast<uint32_t>(queries[i]));
}

unsigned blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Initialise the table and insert rows 0..n-1.  t_size must be a power of
// two.  Returns the launches' cudaError_t.
extern "C" int coord_hash_insert(const void* keys, int n, void* tkeys,
                                 void* tvals, int t_size, void* overflow,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* tk = static_cast<uint32_t*>(tkeys);
  int32_t* tv = static_cast<int32_t*>(tvals);
  int32_t* of = static_cast<int32_t*>(overflow);
  init_kernel<<<blocks(t_size), kThreads, 0, s>>>(tk, tv, t_size, of);
  if (n > 0)
    insert_kernel<<<blocks(n), kThreads, 0, s>>>(
        static_cast<const int64_t*>(keys), n, tk, tv,
        static_cast<uint32_t>(t_size - 1), of);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int coord_hash_lookup(const void* queries, int n, const void* tkeys,
                                 const void* tvals, int t_size, void* out,
                                 void* stream) {
  if (n == 0) return 0;
  lookup_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(queries), n,
      static_cast<const uint32_t*>(tkeys), static_cast<const int32_t*>(tvals),
      static_cast<uint32_t>(t_size - 1), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
