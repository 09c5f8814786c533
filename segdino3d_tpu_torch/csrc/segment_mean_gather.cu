// K3: deterministic segment mean with an optional fused row gather.
//
//   out[s, :cg]      = mean over members p of segment s of g[gidx[p]]  (0 if gidx[p] < 0)
//   out[s, cg:cg+cd] = mean over members p of segment s of d[p]
//
// Replaces segdino3d_tpu/ops/scatter.py:segment_mean / segment_mean_stack
// and, fused, segdino3d_tpu/ops/voxelize.py:devoxelize.  On the main path it
// runs twice per forward: the point -> voxel feature mean (d = the (N, 259)
// early-fused point features, no g), and the voxel -> point -> superpoint
// pooling (g = the (V0, 96) U-Net output gathered through the point ->
// voxel inverse map, d = the two 3-column centroid sets), which never
// materialises the (N, 96) point features the TPU version built.
//
// What bounds it: bytes.  It does one add per input element, far below the
// card's operations-per-byte balance; the least traffic is each input row
// read once and each output row written once.
//
// Design: segments arrive as CSR over a stable sort of the segment ids
// (members, offsets), and segment s is cut into chunks of at most `chunk`
// members, numbered chunk_offsets[s] .. chunk_offsets[s + 1] - 1.  Pass 1
// gives each chunk one block (the grid is an upper bound on the chunk
// count, so the host never waits for it; a block finds its segment by a
// binary search over chunk_offsets), whose threads spread over the columns
// and add the chunk's member rows in order (each row read as one coalesced
// row); pass 2 gives each segment one block that adds its chunk sums in
// order and divides by the count.  Chunks bound
// the serial work of one block however skewed the segments are: a
// superpoint of a floor or a wall holds thousands of points, while the mean
// holds ~80.  No atomics: one fixed sum order on every run.
//
// Contract: offsets (S + 1,) int64, members (offsets[S],) int64 point ids;
// chunk_offsets (S + 1,) int64 with chunk_offsets[s + 1] - chunk_offsets[s]
// = ceil(count_s / chunk); max_chunks >= chunk_offsets[S]; g (Vg, cg) and
// d (N, cd) fp32 or bf16 (either may be absent: cg or cd 0); gidx (N,)
// int32 or null (identity); partial (max_chunks, cg + cd) fp32 scratch;
// out (S, cg + cd) fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TG, typename TD>
__global__ void __launch_bounds__(128)
chunk_sums_kernel(const int64_t* __restrict__ offsets,
                  const int64_t* __restrict__ chunk_offsets, int num_segments,
                  int chunk, const int64_t* __restrict__ members,
                  const TG* __restrict__ g, const int32_t* __restrict__ gidx,
                  const TD* __restrict__ d, float* __restrict__ partial, int cg,
                  int cd) {
  const int64_t k = blockIdx.x;
  if (k >= chunk_offsets[num_segments]) return;
  // the segment s with chunk_offsets[s] <= k < chunk_offsets[s + 1]
  int lo = 0, hi = num_segments - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (chunk_offsets[mid] <= k) lo = mid; else hi = mid - 1;
  }
  const int64_t b = offsets[lo] + (k - chunk_offsets[lo]) * chunk;
  const int64_t e = min(b + chunk, offsets[lo + 1]);
  const int ctot = cg + cd;
  for (int c = threadIdx.x; c < ctot; c += blockDim.x) {
    float acc = 0.f;
    if (c < cg) {
      for (int64_t p = b; p < e; ++p) {
        const int64_t pt = members[p];
        const int64_t row = gidx ? static_cast<int64_t>(gidx[pt]) : pt;
        if (row >= 0) acc += to_f(g[row * cg + c]);
      }
    } else {
      const int cc = c - cg;
      for (int64_t p = b; p < e; ++p) acc += to_f(d[members[p] * cd + cc]);
    }
    partial[k * ctot + c] = acc;
  }
}

__global__ void __launch_bounds__(128)
segment_means_kernel(const int64_t* __restrict__ offsets,
                     const int64_t* __restrict__ chunk_offsets,
                     const float* __restrict__ partial, float* __restrict__ out,
                     int ctot) {
  const int s = blockIdx.x;
  const int64_t n = offsets[s + 1] - offsets[s];
  const float cnt = static_cast<float>(n > 0 ? n : 1);
  const int64_t kb = chunk_offsets[s], ke = chunk_offsets[s + 1];
  for (int c = threadIdx.x; c < ctot; c += blockDim.x) {
    float acc = 0.f;
    for (int64_t k = kb; k < ke; ++k) acc += partial[k * ctot + c];
    out[static_cast<int64_t>(s) * ctot + c] = acc / cnt;
  }
}

template <typename TG, typename TD>
cudaError_t launch(const void* offsets, const void* members,
                   const void* chunk_offsets, int max_chunks, int chunk,
                   const void* g, const void* gidx, const void* d, void* partial,
                   void* out, int num_segments, int cg, int cd,
                   cudaStream_t stream) {
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int64_t* coff = static_cast<const int64_t*>(chunk_offsets);
  if (max_chunks > 0) {
    chunk_sums_kernel<TG, TD><<<max_chunks, 128, 0, stream>>>(
        off, coff, num_segments, chunk, static_cast<const int64_t*>(members),
        static_cast<const TG*>(g), static_cast<const int32_t*>(gidx),
        static_cast<const TD*>(d), static_cast<float*>(partial), cg, cd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  segment_means_kernel<<<num_segments, 128, 0, stream>>>(
      off, coff, static_cast<const float*>(partial), static_cast<float*>(out),
      cg + cd);
  return cudaGetLastError();
}

}  // namespace

// g_dtype, d_dtype: 0 = float32, 1 = bfloat16.  Returns the first failed
// launch's cudaError_t, or 0.
extern "C" int segment_mean_gather(const void* offsets, const void* members,
                                   const void* chunk_offsets, int max_chunks,
                                   int chunk, const void* g, const void* gidx,
                                   const void* d, void* partial, void* out,
                                   int num_segments, int cg, int cd, int g_dtype,
                                   int d_dtype, void* stream) {
  if (num_segments == 0 || cg + cd == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SDT_LAUNCH(TG, TD)                                                    \
  launch<TG, TD>(offsets, members, chunk_offsets, max_chunks, chunk, g, gidx, \
                 d, partial, out, num_segments, cg, cd, s)
  if (g_dtype == 1 && d_dtype == 1)
    err = SDT_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  else if (g_dtype == 1)
    err = SDT_LAUNCH(__nv_bfloat16, float);
  else if (d_dtype == 1)
    err = SDT_LAUNCH(float, __nv_bfloat16);
  else
    err = SDT_LAUNCH(float, float);
#undef SDT_LAUNCH
  return static_cast<int>(err);
}
