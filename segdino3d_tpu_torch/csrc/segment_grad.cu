// K5: gradient of the fused voxel -> point -> superpoint pooling.
//
//   dvox[v, c] = sum over members p of voxel v with 0 <= seg[p] < S of g[seg[p], c]
//
// where the wrapper passes g = dS / count (the superpoint-mean gradient
// already divided by each superpoint's point count).  Replaces the XLA
// autodiff of segdino3d_tpu/ops/voxelize.py:devoxelize (a gather, whose
// transpose is a scatter-add into the voxel table) followed by
// segdino3d_tpu/ops/scatter.py:segment_mean_stack (scatter.py:49-73).  On
// the training path it runs once per backward: (1,536, 96) superpoint
// gradients into the (V0, 96) U-Net output.
//
// What bounds it: bytes.  One add per gathered element, far below the
// card's operations-per-byte balance.  It is a gather-scale-reduce over CSR
// rows with no matrix product, so CUDA and Triton would do the same work;
// it is CUDA so that it builds with the other kernels (one nvcc, no Triton
// compile at first call).
//
// Design: the voxel CSR (offsets, members) is the one the forward's voxel
// mean builds (a stable sort of the point -> voxel map), so each voxel's
// points are known without atomics and are added in one fixed order.  One
// warp per voxel, lanes over columns: each member reads one coalesced row
// of g.  A voxel holds a few points (1.6 on average on the main-path scene),
// so no row needs chunking.
//
// Contract: offsets (V + 1,) int64, members (offsets[V],) int64 point ids;
// seg (N,) int32 superpoint ids (ids outside [0, S) contribute nothing);
// g (S, C) fp32; out (V, C) fp32 or bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
csr_gather_sum_kernel(const int64_t* __restrict__ offsets,
                      const int64_t* __restrict__ members,
                      const int32_t* __restrict__ seg, const float* __restrict__ g,
                      T* __restrict__ out, int num_rows, int num_segments,
                      int cols) {
  const int v = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (v >= num_rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t b = offsets[v], e = offsets[v + 1];
  for (int c = lane; c < cols; c += 32) {
    float acc = 0.f;
    for (int64_t p = b; p < e; ++p) {
      const int s = seg[members[p]];
      if (s >= 0 && s < num_segments) acc += g[(int64_t)s * cols + c];
    }
    out[(int64_t)v * cols + c] = from_f<T>(acc);
  }
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int segment_grad(const void* offsets, const void* members,
                            const void* seg, const void* g, void* out,
                            int num_rows, int num_segments, int cols,
                            int out_dtype, void* stream) {
  if (num_rows == 0 || cols == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int64_t* mem = static_cast<const int64_t*>(members);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  const float* gf = static_cast<const float*>(g);
  if (out_dtype == 1)
    csr_gather_sum_kernel<__nv_bfloat16><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
        off, mem, sg, gf, static_cast<__nv_bfloat16*>(out), num_rows,
        num_segments, cols);
  else
    csr_gather_sum_kernel<float><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
        off, mem, sg, gf, static_cast<float*>(out), num_rows, num_segments,
        cols);
  return static_cast<int>(cudaGetLastError());
}
