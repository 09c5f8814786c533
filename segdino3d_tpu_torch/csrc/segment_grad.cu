// K5: gradient of the fused voxel -> point -> superpoint pooling.
//
//   dvox[v, c] = sum over members p of voxel v with 0 <= seg[p] < S of
//                g[seg[p], c] / max(count[seg[p]], 1)
//
// where g is the superpoint-mean gradient and count[s] the point count of
// superpoint s (the superpoint CSR's offsets[s + 1] - offsets[s]).  Each
// quotient is computed in fp32 before it is added, the correctly rounded
// quotient the plain version computes (the build has no fast-math flags).
// Replaces the XLA autodiff of segdino3d_tpu/ops/voxelize.py:devoxelize (a
// gather, whose transpose is a scatter-add into the voxel table) followed
// by segdino3d_tpu/ops/scatter.py:segment_mean_stack (scatter.py:49-73).
// On the training path it runs once per backward, the pool's whole
// backward: (1,536, 96) superpoint gradients, read in place as a column
// slice of the pool's (1,536, 102) gradient, into the (V0, 96) U-Net
// output.
//
// What bounds it: bytes, in principle.  The output, 35 MB at V0 = 92,160
// in fp32, is written once; g (0.6 MB) stays in L2.  One add and one
// division per gathered element, far below the card's operations-per-byte
// balance.  In practice the gathers take longer than the stores: the
// members' 46 MB of g rows come from L2, each behind three dependent loads
// (offsets, members, superpoint ids), and the kernel takes about three
// times a plain fill of its output (PERF.md §6 row 6d).
//
// Design: the voxel CSR (offsets, members) is the one the forward's voxel
// mean builds (a stable sort of the point -> voxel map), so each voxel's
// points are known without atomics and are added in ascending point order:
// two calls are bit-equal.  A group of G lanes (a power of two) takes one
// voxel, each lane a run of 4 columns (or 1 where the column count is not
// a multiple of 4) at up to kRuns places of the row, so a warp takes 32 / G
// voxels (C = 96: 8 lanes x 3 float4 runs, 4 voxels a warp).  The group
// loads its voxel's members, their superpoint ids and counts once, a
// member a lane, and broadcasts them with __shfl_sync; then each member's
// g row is read as runs of 16 bytes (8 or 4 where the row stride does not
// allow 16) and the group's 16-byte (bf16: 8-byte) stores are coalesced.
//
// Contract: offsets (V + 1,) int64, members (offsets[V],) int64 point ids;
// seg (N,) int32 superpoint ids (ids outside [0, S) contribute nothing);
// g fp32 rows of ld floats, columns 0..C-1 read; sp_offsets (S + 1,) int64;
// out (V, C) fp32 or bf16, contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRuns = 4;   // column runs a lane keeps summing in registers

template <int W> struct Acc;
template <> struct Acc<4> { using type = float4; };
template <> struct Acc<1> { using type = float; };

__device__ __forceinline__ void add_quot(float4& a, float4 q, float c) {
  a.x += q.x / c;
  a.y += q.y / c;
  a.z += q.z / c;
  a.w += q.w / c;
}
__device__ __forceinline__ void add_quot(float& a, float q, float c) { a += q / c; }

// the run of W columns at p; align: the bytes every row start is aligned to
template <int W> __device__ __forceinline__ typename Acc<W>::type load_run(const float* p, int align);
template <> __device__ __forceinline__ float4 load_run<4>(const float* p, int align) {
  if (align >= 16) return __ldg(reinterpret_cast<const float4*>(p));
  if (align >= 8) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    const float2 b = __ldg(reinterpret_cast<const float2*>(p) + 1);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}
template <> __device__ __forceinline__ float load_run<1>(const float* p, int) { return __ldg(p); }

__device__ __forceinline__ void store_run(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 bits;
  bits.x = *reinterpret_cast<uint32_t*>(&lo);
  bits.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = bits;
}
__device__ __forceinline__ void store_run(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_run(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
segment_grad_kernel(const int64_t* __restrict__ offsets,
                    const int64_t* __restrict__ members,
                    const int32_t* __restrict__ seg, const float* __restrict__ g,
                    int64_t ld, int g_align, const int64_t* __restrict__ sp_offsets,
                    T* __restrict__ out, int num_rows, int num_segments, int cols,
                    int group) {
  using A = typename Acc<W>::type;
  const int lane = threadIdx.x % 32;
  const int lig = lane & (group - 1);
  const int v = (blockIdx.x * kThreads + threadIdx.x) / group;
  if (v >= num_rows) return;   // whole groups leave together
  const unsigned gmask = (group == 32 ? 0xFFFFFFFFu : (1u << group) - 1u)
                         << (lane & ~(group - 1));
  const int64_t b = offsets[v], e = offsets[v + 1];
  const int runs = cols / W;
  for (int r0 = 0; r0 < runs; r0 += group * kRuns) {   // one pass for C <= 512
    A acc[kRuns] = {};
    for (int64_t p0 = b; p0 < e; p0 += group) {
      int s = -1;
      float cnt = 1.f;
      if (p0 + lig < e) {
        const int t = seg[members[p0 + lig]];
        if (t >= 0 && t < num_segments) {
          s = t;
          const int64_t c = sp_offsets[t + 1] - sp_offsets[t];
          cnt = static_cast<float>(c > 1 ? c : 1);
        }
      }
      const int n = static_cast<int>(e - p0 < group ? e - p0 : group);
      for (int j = 0; j < n; ++j) {   // the members in ascending order
        const int sj = __shfl_sync(gmask, s, j, group);
        const float cj = __shfl_sync(gmask, cnt, j, group);
        if (sj < 0) continue;
        const float* row = g + sj * ld;
#pragma unroll
        for (int u = 0; u < kRuns; ++u) {
          const int r = r0 + u * group + lig;
          if (r < runs) add_quot(acc[u], load_run<W>(row + r * W, g_align), cj);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      const int r = r0 + u * group + lig;
      if (r < runs) store_run(out + (int64_t)v * cols + r * W, acc[u]);
    }
  }
}

template <typename T>
void launch(const int64_t* off, const int64_t* mem, const int32_t* sg, const float* gf,
            int64_t ld, const int64_t* spo, T* out, int num_rows, int num_segments,
            int cols, cudaStream_t s) {
  const bool vec = cols % 4 == 0;
  const int runs = vec ? cols / 4 : cols;
  int group = 1;
  while (group < 32 && group * kRuns < runs) group *= 2;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(gf);
  const int64_t row_bytes = ld * 4;
  const int g_align = (addr % 16 == 0 && row_bytes % 16 == 0)  ? 16
                      : (addr % 8 == 0 && row_bytes % 8 == 0) ? 8
                                                              : 4;
  const int per_block = kThreads / group;
  const unsigned grid = (num_rows + per_block - 1) / per_block;
  if (vec)
    segment_grad_kernel<T, 4><<<grid, kThreads, 0, s>>>(
        off, mem, sg, gf, ld, g_align, spo, out, num_rows, num_segments, cols, group);
  else
    segment_grad_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        off, mem, sg, gf, ld, g_align, spo, out, num_rows, num_segments, cols, group);
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int segment_grad(const void* offsets, const void* members,
                            const void* seg, const void* g, long long ld,
                            const void* sp_offsets, void* out, int num_rows,
                            int num_segments, int cols, int out_dtype,
                            void* stream) {
  if (num_rows == 0 || cols == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int64_t* mem = static_cast<const int64_t*>(members);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  const float* gf = static_cast<const float*>(g);
  const int64_t* spo = static_cast<const int64_t*>(sp_offsets);
  if (out_dtype == 1)
    launch(off, mem, sg, gf, ld, spo, static_cast<__nv_bfloat16*>(out), num_rows,
           num_segments, cols, s);
  else
    launch(off, mem, sg, gf, ld, spo, static_cast<float*>(out), num_rows,
           num_segments, cols, s);
  return static_cast<int>(cudaGetLastError());
}
