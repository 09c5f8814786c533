// Shared halo addressing of the block-dense kernels (block_conv.cu, block_wgrad.cu).
//
// Features live as flat dense rows, (n_blocks * edge^3, C): block b's cell
// (lx, ly, lz) is row b * edge^3 + lx * edge^2 + ly * edge + lz.  A cell at
// core coordinates (qx, qy, qz) of block b, each in [-edge, 2 * edge), lies
// in b itself or in one of its 26 shell neighbours, and is read straight
// from that block's core: block_nbr (26, n_blocks) in
// itertools.product(-1, 0, 1)^3 order without the centre, -1 where absent.
// A diagonal neighbour is reached directly, never through a face
// neighbour's halo, so an absent face block cannot hide a present diagonal
// one (segdino3d_tpu/ops/block_dense.py:161-165).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bdt {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The dense row of core coordinates (qx, qy, qz) of block b, or -1.
__device__ __forceinline__ int halo_row(const int32_t* __restrict__ block_nbr,
                                        int n_blocks, int b, int edge, int qx,
                                        int qy, int qz) {
  const int dx = qx < 0 ? -1 : (qx >= edge ? 1 : 0);
  const int dy = qy < 0 ? -1 : (qy >= edge ? 1 : 0);
  const int dz = qz < 0 ? -1 : (qz >= edge ? 1 : 0);
  int src = b;
  if (dx | dy | dz) {
    int d = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1);
    d -= d > 13;  // the centre is not in the table
    src = block_nbr[(int64_t)d * n_blocks + b];
    if (src < 0) return -1;
  }
  const int lx = qx - dx * edge, ly = qy - dy * edge, lz = qz - dz * edge;
  return ((src * edge + lx) * edge + ly) * edge + lz;
}

// The source of dense row `row` at offset o of a k^3 kernel (K10's and
// K11's narrow paths): the cell shifted by o - h, through the block halo
// (halo_row's addressing without its branch, so that what stays live while
// the shell block's id loads is the cell's index; the branchy form ran
// slower in K10)
template <int E, int K>
struct HaloSrc {
  static constexpr bool kAhead = false;
  const int32_t* __restrict__ nbr;
  int n_blocks;
  __device__ __forceinline__ int operator()(int row, int o) const {
    constexpr int H = (K - 1) / 2, E3 = E * E * E;
    const int b = row / E3, c = row % E3;
    const int qx = c / (E * E) + o / (K * K) - H, qy = (c / E) % E + (o / K) % K - H,
              qz = c % E + o % K - H;
    const int dx = (qx >= E) - (qx < 0), dy = (qy >= E) - (qy < 0), dz = (qz >= E) - (qz < 0);
    const int cell = ((qx - dx * E) * E + qy - dy * E) * E + qz - dz * E;
    const int d = (dx + 1) * 9 + (dy + 1) * 3 + dz + 1;   // 13: the block itself
    const int blk = d == 13 ? b : nbr[(int64_t)(d - (d > 13)) * n_blocks + b];
    return blk < 0 ? -1 : blk * E3 + cell;
  }
};

}  // namespace bdt
