// K7: neighbour tables of a pyramid level, by probing K6's table.
//
// Replaces segdino3d_tpu/ops/sparse_conv.py:_neighbor_table
// (sparse_conv.py:64), with the border guard of
// segdino3d_tpu/ops/keys.py:neighbor_wrap_masks (keys.py:85).  Output:
// the (n_off, V) offset-major table, out[o, i] = the voxel at coords[i] +
// offset o, -1 where absent, for rows past the level's count, and for a
// neighbour whose id lies at or past the level's capacity (dropped by an
// overflow).  On the main path: the 125 x V0 stem table (k5) and one
// 27 x V_l table (k3) per level.
//
// What bounds it: bytes and the latency of the probes (one or two slots
// each at the table's load).  The output, 4 bytes per (offset, row), is
// the largest stream: 125 x 76k x 4 = 38 MB at level 0 for the stem.
//
// Design: one thread per (row, offset), rows along x so the coordinate
// reads and the table row writes are coalesced.  The thread forms the
// neighbour's coordinate; a field outside its bit range packs to the
// sentinel (coord_hash::pack_key), which is the meaning of the JAX wrap
// masks, and a sentinel never matches.  Every offset is looked up
// directly: the JAX package's mirror of the second half (sparse_conv.py
// :110-124) gives the identical table and would cost a transpose-scatter.
// Offsets follow itertools.product(range(-r, r + 1), repeat=3) and are
// computed from the kernel size, so no offset array is copied to the card.
//
// Contract: coords (4, v) int32 SoA (b, x, y, z) of the level; num (1,)
// int32 on the card, the level's voxel count (may exceed v); k odd;
// tkeys/tvals K6's table of the level with values remapped to voxel ids
// (K8); out (k^3, v) int32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "coord_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
neighbor_kernel(const int32_t* __restrict__ coords,
                const int32_t* __restrict__ num, int v, int k,
                const uint32_t* __restrict__ tkeys,
                const int32_t* __restrict__ tvals, uint32_t mask,
                int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= v) return;
  const int o = blockIdx.y;
  const int r = k / 2;
  const int dx = o / (k * k) - r, dy = (o / k) % k - r, dz = o % k - r;
  int32_t id = -1;
  if (i < *num) {
    const uint32_t key = coord_hash::pack_key(
        coords[i], coords[(int64_t)v + i] + dx,
        coords[2 * (int64_t)v + i] + dy, coords[3 * (int64_t)v + i] + dz);
    id = coord_hash::probe(tkeys, tvals, mask, key);
    if (id >= v) id = -1;
  }
  out[(int64_t)o * v + i] = id;
}

}  // namespace

// Returns the launch's cudaError_t.
extern "C" int neighbor_table(const void* coords, const void* num, int v,
                              int k, const void* tkeys, const void* tvals,
                              int t_size, void* out, void* stream) {
  if (v == 0) return 0;
  const dim3 grid((v + kThreads - 1) / kThreads, k * k * k);
  neighbor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coords), static_cast<const int32_t*>(num), v,
      k, static_cast<const uint32_t*>(tkeys), static_cast<const int32_t*>(tvals),
      static_cast<uint32_t>(t_size - 1), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
