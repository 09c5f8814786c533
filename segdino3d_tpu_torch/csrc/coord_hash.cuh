// Shared by K6 (coord_hash.cu) and K7 (neighbor_table.cu): the key layout
// of ops/keys.py and the open-addressing table's slot function and probe.
//
// Table: t_size (a power of two) uint32 key slots and int32 value slots.
// An empty key slot holds kEmptyKey, the key sentinel, which no valid
// coordinate packs to.  Keys are placed by linear probing from
// hash_slot(key); a slot, once claimed, is never emptied, so a lookup that
// meets an empty slot before its key proves the key absent.
#pragma once
#include <stdint.h>

namespace coord_hash {

constexpr uint32_t kEmptyKey = 0xFFFFFFFFu;
constexpr int kBBits = 3, kXBits = 10, kYBits = 10, kZBits = 9;

// ops/keys.py:pack_columns_u32 for one coordinate: kEmptyKey where a field
// is out of range (this is what keys.neighbor_wrap_masks guards in JAX).
__device__ __forceinline__ uint32_t pack_key(int b, int x, int y, int z) {
  if (b < 0 || b >= (1 << kBBits) || x < 0 || x >= (1 << kXBits) || y < 0 ||
      y >= (1 << kYBits) || z < 0 || z >= (1 << kZBits))
    return kEmptyKey;
  return (static_cast<uint32_t>(b) << (kXBits + kYBits + kZBits)) |
         (static_cast<uint32_t>(x) << (kYBits + kZBits)) |
         (static_cast<uint32_t>(y) << kZBits) | static_cast<uint32_t>(z);
}

// the JAX package's table-0 mix (segdino3d_tpu/ops/hashing.py:_hash)
__device__ __forceinline__ uint32_t hash_slot(uint32_t key, uint32_t mask) {
  uint32_t x = key * 0x9E3779B1u;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 13;
  return x & mask;
}

// value stored with ``key``, or -1 when it is absent
__device__ __forceinline__ int32_t probe(const uint32_t* __restrict__ tkeys,
                                         const int32_t* __restrict__ tvals,
                                         uint32_t mask, uint32_t key) {
  if (key == kEmptyKey) return -1;
  uint32_t slot = hash_slot(key, mask);
  for (uint32_t p = 0; p <= mask; ++p) {
    const uint32_t k = tkeys[slot];
    if (k == key) return tvals[slot];
    if (k == kEmptyKey) return -1;
    slot = (slot + 1) & mask;
  }
  return -1;
}

}  // namespace coord_hash
