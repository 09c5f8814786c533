// Shared tile loop of the gather convolutions (gather_gemm_conv.cu, up_conv.cu).
//
// One block owns a BM x BN tile of output rows x output channels and keeps
// its fp32 sums in registers (TM x TN per thread, 256 threads).  For every
// kernel offset o in ascending order it asks the caller's index source which
// input row feeds each of its BM output rows (-1 = no row), skips the offset
// when no row of the tile has one, and otherwise walks Cin in BK-wide chunks:
// the BM gathered input rows and the BK x BN slice of W[o] are loaded into
// registers, staged in shared memory as fp32 and multiplied with plain
// FMAs, the next chunk's loads in flight during this chunk's FMAs.  The
// order of the sums is fixed (offsets, then Cin chunks, then k inside a
// chunk), so a run is deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sdt {

constexpr int kThreads = 256;
constexpr int TM = 4;   // output rows per thread
constexpr int TN = 4;   // output channels per thread
constexpr int BK = 16;  // input channels per shared-memory chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Tile shapes: (BM, BN) with (BM / TM) * (BN / TN) == kThreads.
// BN = 32 serves Cout <= 32 (the stem and level 1); BN = 64 the rest.
template <int BM, int BN>
struct TileShape {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile must use 256 threads");
  static_assert(BM * BK % kThreads == 0, "whole A chunks per thread");
  static constexpr int kColGroups = BN / TN;
};

// Loads chunk [k0, k0 + BK) of the gathered rows and of W[o] into
// registers: thread tid holds A elements e = tid + i * kThreads (row e / BK,
// channel e % BK) and B elements (channel e / BN, output e % BN); zeros
// outside the rows, Cin and Cout.
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ x, const T* __restrict__ wo, int cin, int cout,
    int col0, int k0, const int* sidx, float (&ra)[BM * BK / kThreads],
    float (&rb)[(BK * BN + kThreads - 1) / kThreads]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BM * BK / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int s = sidx[e / BK];
    const int kk = k0 + e % BK;
    ra[i] = (s >= 0 && kk < cin) ? to_f(x[(int64_t)s * cin + kk]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < (BK * BN + kThreads - 1) / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int kk = k0 + e / BN, nn = col0 + e % BN;
    rb[i] = (e < BK * BN && kk < cin && nn < cout)
        ? to_f(wo[(int64_t)kk * cout + nn]) : 0.f;
  }
}

// Accumulates sum_o x[src(o, r)] @ w[o][:, col0:col0+BN] into acc for the
// tile's BM rows.  `src(o, r)` must be callable by threads r < BM and return
// an input row index or -1.  Every thread of the block must call this.
template <typename T, int BM, int BN, typename Src>
__device__ __forceinline__ void gather_gemm_tile(
    const T* __restrict__ x, const T* __restrict__ w, int cin, int cout,
    int n_off, int col0, const Src& src, float (&acc)[TM][TN]) {
  __shared__ __align__(16) float As[BK][BM + 4];  // As[k][m]: k-major
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int sidx[BM];

  constexpr int kALoads = BM * BK / kThreads;
  constexpr int kBLoads = (BK * BN + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  const int tx = tid % TileShape<BM, BN>::kColGroups;
  const int ty = tid / TileShape<BM, BN>::kColGroups;

  for (int o = 0; o < n_off; ++o) {
    int hit = 0;
    if (tid < BM) {
      const int s = src(o, tid);
      sidx[tid] = s;
      hit = s >= 0;
    }
    // the barrier also publishes sidx to the whole block
    if (!__syncthreads_or(hit)) continue;

    const T* __restrict__ wo = w + (int64_t)o * cin * cout;
    // register-staged chunks: every load of a chunk is in flight at once,
    // and the next chunk's loads overlap this chunk's FMAs
    float ra[kALoads], rb[kBLoads];
    load_chunk<T, BM, BN>(x, wo, cin, cout, col0, 0, sidx, ra, rb);
    for (int k0 = 0; k0 < cin; k0 += BK) {
#pragma unroll
      for (int i = 0; i < kALoads; ++i) {
        const int e = tid + i * kThreads;
        As[e % BK][e / BK] = ra[i];
      }
#pragma unroll
      for (int i = 0; i < kBLoads; ++i) {
        const int e = tid + i * kThreads;
        if (e < BK * BN) Bs[e / BN][e % BN] = rb[i];
      }
      __syncthreads();
      if (k0 + BK < cin)
        load_chunk<T, BM, BN>(x, wo, cin, cout, col0, k0 + BK, sidx, ra, rb);
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
}

// Writes the tile: out[row(r)][col0 + c] = valid ? acc : 0.  `row(r)` maps a
// tile row to its output row, or -1 past the end.
template <typename T, int BM, int BN, typename Row>
__device__ __forceinline__ void store_tile(
    T* __restrict__ out, const uint8_t* __restrict__ valid, int cout, int col0,
    const Row& row, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % TileShape<BM, BN>::kColGroups;
  const int ty = tid / TileShape<BM, BN>::kColGroups;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row(ty * TM + i);
    if (r < 0) continue;
    const bool keep = valid[r] != 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c < cout) out[(int64_t)r * cout + c] = from_f<T>(keep ? acc[i][j] : 0.f);
    }
  }
}

}  // namespace sdt
