// K12: slot sum of the degree-compacted k5 stem.
//
//   out[i, :] = valid[i] ? sum_{d < D, slots[d, i] >= 0} y2[slots[d, i], :]
//                        + sum_{p: ov_dst[p] = i, ov_src[p] >= 0} y2[ov_src[p], :]
//                        : 0
//
// Replaces segdino3d_tpu/ops/sparse_conv.py:stem_compact_conv's slot scan and
// overflow segment-sum (:404-413), after its wide product y = X @ W_flat
// (a plain dense matmul, torch.matmul in the port).  y2 is y read as
// (V * 125, Cout): row j * 125 + o holds voxel j's features times offset o's
// weights, so each occupied (neighbour, offset) pair of voxel i is one row.
// On the main path it runs once per eval forward on a compacted-stem plan.
//
// What bounds it: bytes.  One add per gathered element.  It reads each
// occupied slot row and overflow row once (a voxel has ~28 of 125 on
// ScanNet-like surfaces), the slot table, the overflow pairs, and writes
// each output row once.
//
// Design: one warp per voxel row, lanes over the Cout channels, so each
// gathered row is one coalesced read (128 B at Cout = 32 in fp32).  Lane d
// of the warp loads slot d of a chunk of 32 and the chunk's rows are summed
// in slot order with a fully unrolled shuffle loop, so the 32 row loads of a
// chunk are independent and in flight together.  The plan writes the
// overflow pairs voxel-major (native/sparseplan/sparseplan.cpp:328-366), so
// a voxel's pairs are one contiguous run of the sorted ov_dst: the warp
// finds its start with a 32-way search (32 probes per step, ~4 steps for a
// million pairs) and walks it 32 pairs at a time.  Each output is summed in
// one fixed order in fp32: deterministic, no atomics.
//
// Contract: y2 (R, cout) fp32 or bf16, contiguous, cout <= 128; slots (D, V)
// int32 in [-1, R); ov_src (P,) int32 in [-1, R); ov_dst (P,) int32,
// ascending, V at padding; valid (V,) bool; out (V, cout) in y2's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// First p in [0, n) with dst[p] >= key (n if none); dst ascending.  Every
// lane of the warp returns the same value.
__device__ __forceinline__ int64_t warp_lower_bound(const int32_t* __restrict__ dst,
                                                    int64_t n, int32_t key, int lane) {
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t q = lo + lane * step;
    const bool below = q < hi && dst[q] < key;
    const int c = __popc(__ballot_sync(kFull, below));  // a prefix of lanes
    if (c == 0) return lo;
    const int64_t last = lo + (int64_t)(c - 1) * step;
    hi = min(lo + (int64_t)c * step, hi);
    lo = last + 1;
  }
  const int64_t q = lo + lane;
  const bool below = q < hi && dst[q] < key;
  return lo + __popc(__ballot_sync(kFull, below));
}

// NPL channels per lane: lane l owns channels l, l + 32, ...
template <typename T, int NPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
stem_slot_sum_kernel(const T* __restrict__ y2, const int32_t* __restrict__ slots,
                     const int32_t* __restrict__ ov_src, const int32_t* __restrict__ ov_dst,
                     const bool* __restrict__ valid, T* __restrict__ out, int v, int d_cap,
                     int64_t p_cap, int cout) {
  const int i = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (i >= v) return;
  const int lane = threadIdx.x % 32;
  float acc[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) acc[k] = 0.f;
  const bool live = valid[i];
  if (live) {
    for (int d0 = 0; d0 < d_cap; d0 += 32) {
      const int s = d0 + lane < d_cap ? slots[(int64_t)(d0 + lane) * v + i] : -1;
      if (__ballot_sync(kFull, s >= 0) == 0) continue;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = __shfl_sync(kFull, s, j);
        if (r >= 0) {
          const T* row = y2 + (int64_t)r * cout;
#pragma unroll
          for (int k = 0; k < NPL; ++k) {
            const int c = lane + 32 * k;
            if (c < cout) acc[k] += to_f<T>(row[c]);
          }
        }
      }
    }
    if (p_cap > 0) {
      for (int64_t p0 = warp_lower_bound(ov_dst, p_cap, i, lane); p0 < p_cap; p0 += 32) {
        const int64_t p = p0 + lane;
        const bool mine = p < p_cap && ov_dst[p] == i;
        const int s = mine ? ov_src[p] : -1;
        const unsigned m = __ballot_sync(kFull, mine);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = __shfl_sync(kFull, s, j);
          if (r >= 0) {
            const T* row = y2 + (int64_t)r * cout;
#pragma unroll
            for (int k = 0; k < NPL; ++k) {
              const int c = lane + 32 * k;
              if (c < cout) acc[k] += to_f<T>(row[c]);
            }
          }
        }
        if (m != kFull) break;  // the run ended inside this chunk
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int c = lane + 32 * k;
    if (c < cout) out[(int64_t)i * cout + c] = from_f<T>(live ? acc[k] : 0.f);
  }
}

template <typename T, int NPL>
cudaError_t launch(const void* y2, const void* slots, const void* ov_src, const void* ov_dst,
                   const void* valid, void* out, int v, int d_cap, int p_cap, int cout,
                   cudaStream_t stream) {
  const unsigned grid = (unsigned)((v + kWarpsPerBlock - 1) / kWarpsPerBlock);
  stem_slot_sum_kernel<T, NPL><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(y2), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(ov_src), static_cast<const int32_t*>(ov_dst),
      static_cast<const bool*>(valid), static_cast<T*>(out), v, d_cap, p_cap, cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* y2, const void* slots, const void* ov_src, const void* ov_dst,
                     const void* valid, void* out, int v, int d_cap, int p_cap, int cout,
                     cudaStream_t stream) {
  if (cout <= 32)
    return launch<T, 1>(y2, slots, ov_src, ov_dst, valid, out, v, d_cap, p_cap, cout, stream);
  if (cout <= 64)
    return launch<T, 2>(y2, slots, ov_src, ov_dst, valid, out, v, d_cap, p_cap, cout, stream);
  return launch<T, 4>(y2, slots, ov_src, ov_dst, valid, out, v, d_cap, p_cap, cout, stream);
}

}  // namespace

// dtype: 0 fp32, 1 bf16.  Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for cout outside [1, 128] or another dtype.
extern "C" int stem_slot_sum(const void* y2, const void* slots, const void* ov_src,
                             const void* ov_dst, const void* valid, void* out, int v,
                             int d_cap, int p_cap, int cout, int dtype, void* stream) {
  if (v == 0) return 0;
  if (cout < 1 || cout > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(y2, slots, ov_src, ov_dst, valid, out, v, d_cap, p_cap, cout, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(y2, slots, ov_src, ov_dst, valid, out, v, d_cap, p_cap,
                                  cout, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
