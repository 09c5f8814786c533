// K9: slot gather, out[j] = x[idx[j]], a zero row where idx[j] < 0.
//
// Replaces segdino3d_tpu/ops/block_dense.py:scatter_to_dense (its scatter
// of voxel rows into flat dense rows, :80-93) and gather_from_dense with the
// bijection take and its VJP (:96-129).  The port runs both directions as
// gathers: entering a block-dense stage gathers through the plan's inverse
// table slot_vox (every dense row written once, no memset and no scatter;
// vox_slot is injective on valid voxels, so this equals the scatter), and
// leaving it gathers through vox_slot.  Each one's gradient is the other.
// On the main path it moves every stage's features between the voxel and
// the dense layout: 18 launches per eval forward.
//
// What bounds it: bytes.  It reads each gathered row once and writes each
// output row once, and does no arithmetic.  The design moves rows in the
// widest unit their length allows (16-byte vectors for the U-Net's 32-384
// channels, 4 or 2 bytes for the 259-channel stem input), neighbouring
// threads on neighbouring units of one row, so loads and stores coalesce.
//
// Contract: x (rows_in rows) and out (n rows) hold rows of row_bytes bytes,
// contiguous; idx (n,) int32 in [-1, rows_in).  The unit is the widest of
// 16, 8, 4, 2 and 1 bytes that divides row_bytes and both addresses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ uint4 zero<uint4>() { return make_uint4(0, 0, 0, 0); }
template <> __device__ __forceinline__ uint2 zero<uint2>() { return make_uint2(0, 0); }
template <> __device__ __forceinline__ uint32_t zero<uint32_t>() { return 0u; }
template <> __device__ __forceinline__ uint16_t zero<uint16_t>() { return 0; }
template <> __device__ __forceinline__ uint8_t zero<uint8_t>() { return 0; }

template <typename V>
__global__ void __launch_bounds__(256)
slot_gather_kernel(const V* __restrict__ x, const int32_t* __restrict__ idx,
                   V* __restrict__ out, int64_t n, int units) {
  const int64_t total = n * units;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = e / units;
    const int u = (int)(e - r * units);
    const int s = idx[r];
    out[e] = s >= 0 ? x[(int64_t)s * units + u] : zero<V>();
  }
}

template <typename V>
cudaError_t launch(const void* x, const void* idx, void* out, int64_t n, int row_bytes,
                   cudaStream_t stream) {
  const int units = row_bytes / (int)sizeof(V);
  const int64_t total = n * units;
  const int64_t blocks = (total + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);
  slot_gather_kernel<V><<<grid, 256, 0, stream>>>(
      static_cast<const V*>(x), static_cast<const int32_t*>(idx), static_cast<V*>(out),
      n, units);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t.
extern "C" int slot_gather(const void* x, const void* idx, void* out, int n,
                           int row_bytes, void* stream) {
  if (n == 0 || row_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  cudaError_t err;
  if (a % 16 == 0)
    err = launch<uint4>(x, idx, out, n, row_bytes, s);
  else if (a % 8 == 0)
    err = launch<uint2>(x, idx, out, n, row_bytes, s);
  else if (a % 4 == 0)
    err = launch<uint32_t>(x, idx, out, n, row_bytes, s);
  else if (a % 2 == 0)
    err = launch<uint16_t>(x, idx, out, n, row_bytes, s);
  else
    err = launch<uint8_t>(x, idx, out, n, row_bytes, s);
  return static_cast<int>(err);
}
