// K8: first-occurrence compaction of hash winners into voxel ids.
//
// Replaces the body of segdino3d_tpu/ops/voxelize.py:voxelize after its
// hash (voxelize.py:72-96: winners, jnp.cumsum of the winner flags, the
// inverse map, the scatter of the winners' coordinates, the remap of the
// hash's values) and the same steps of
// segdino3d_tpu/ops/sparse_conv.py:_downsample (:138-158), with the
// parent links and kernel positions of build_conv_plan.  On the main path
// it runs once per pyramid level: 120,000 points -> ~76k voxels, then each
// level's voxels -> the next level's.
//
// A row r is a winner when the hash's smallest row for its key is r itself
// (winner[r] == r).  Voxel ids follow the winners in row order: the id of
// winner r is the number of winners before it, an exclusive prefix sum.
//
// What bounds it: bytes (a few int32 per row, no arithmetic to speak of).
//
// Design: three launches on one stream.
//   1. count: each block counts the winners of its 1,024 rows;
//   2. scan + scatter: each block adds the counts of the blocks before it
//      (at most a few hundred), then scans its rows in order with warp
//      ballots, writes each winner's id and, for ids below the capacity,
//      its coordinates (x, y, z shifted right by ``shift``: 0 for
//      voxelize, 1 for a 2x downsample); the last block writes the count;
//   3. gather: each row's inverse id (its winner's id, -1 for no winner or
//      an id at or past the capacity), its kernel position
//      ((x&1)<<2 | (y&1)<<1 | (z&1)) when asked, the level's validity and
//      zero coordinates past the count, and the hash's values remapped
//      from rows to voxel ids into a new table (the input hash is left as
//      it was, so a call can be repeated on it).
// The ids depend only on row order, never on thread order.  The count
// stays on the card: nothing waits for it.
//
// Contract: winner (n,) int32, -1 = none; coords (4, n) int32 SoA
// (b, x, y, z); counts (ceil(n / 1024),) and vid (n,) int32 scratch;
// num (1,) int32; inverse (n,) int32; kpos (n,) int32 or null;
// out_coords (4, cap) int32; valid (cap,) bool; tvals (t_size,) int32 or
// null, K6's smallest rows (0x7FFFFFFF in an empty slot), and tvals_out
// (t_size,) int32 their voxel ids (-1 in an empty slot).  A stored row is
// the smallest of its key, hence a winner, so its ``vid`` is written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;
constexpr int kRowsPerBlock = kThreads * kChunks;

__device__ __forceinline__ bool is_winner(const int32_t* __restrict__ winner,
                                          int i, int n) {
  return i < n && winner[i] == i;
}

__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_sums[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ winner, int n,
             int32_t* __restrict__ counts) {
  __shared__ int warp_sums[kWarps];
  int c = 0;
  for (int j = 0; j < kChunks; ++j)
    c += is_winner(winner, blockIdx.x * kRowsPerBlock + j * kThreads +
                   threadIdx.x, n);
  const int total = block_sum(c, warp_sums);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
scan_scatter_kernel(const int32_t* __restrict__ winner,
                    const int32_t* __restrict__ coords, int n, int shift,
                    int cap, const int32_t* __restrict__ counts,
                    int32_t* __restrict__ vid, int32_t* __restrict__ out_coords,
                    int32_t* __restrict__ num) {
  __shared__ int warp_sums[kWarps];
  int part = 0;
  for (int k = threadIdx.x; k < blockIdx.x; k += kThreads) part += counts[k];
  int running = block_sum(part, warp_sums);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = 0; j < kChunks; ++j) {
    const int i = blockIdx.x * kRowsPerBlock + j * kThreads + threadIdx.x;
    const bool w = is_winner(winner, i, n);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, w);
    if (lane == 0) warp_sums[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int k = 0; k < kWarps; ++k) {
      before += k < warp ? warp_sums[k] : 0;
      total += warp_sums[k];
    }
    if (w) {
      const int v = running + before + __popc(ballot & ((1u << lane) - 1u));
      vid[i] = v;
      if (v < cap) {
        out_coords[v] = coords[i];
        for (int d = 1; d < 4; ++d)
          out_coords[(int64_t)d * cap + v] = coords[(int64_t)d * n + i] >> shift;
      }
    }
    running += total;
    __syncthreads();
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *num = running;
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int32_t* __restrict__ winner,
              const int32_t* __restrict__ coords, int n, int cap,
              const int32_t* __restrict__ vid, const int32_t* __restrict__ num,
              int32_t* __restrict__ inverse, int32_t* __restrict__ kpos,
              int32_t* __restrict__ out_coords, bool* __restrict__ valid,
              const int32_t* __restrict__ tvals,
              int32_t* __restrict__ tvals_out, int t_size) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const int w = winner[i];
    int r = w >= 0 ? vid[w] : -1;
    inverse[i] = r < cap ? r : -1;
    if (kpos != nullptr)
      kpos[i] = ((coords[(int64_t)n + i] & 1) << 2) |
                ((coords[2 * (int64_t)n + i] & 1) << 1) |
                (coords[3 * (int64_t)n + i] & 1);
  }
  if (i < cap) {
    const bool live = i < *num;
    valid[i] = live;
    if (!live)
      for (int d = 0; d < 4; ++d) out_coords[(int64_t)d * cap + i] = 0;
  }
  if (tvals != nullptr && i < t_size) {
    const int32_t v = tvals[i];   // 0x7FFFFFFF in an empty slot
    tvals_out[i] = v >= 0 && v < n ? vid[v] : -1;
  }
}

}  // namespace

// Returns the launches' cudaError_t.
extern "C" int voxel_compact(const void* winner, const void* coords, int n,
                             int shift, int cap, void* counts, void* vid,
                             void* num, void* inverse, void* kpos,
                             void* out_coords, void* valid,
                             const void* tvals, void* tvals_out, int t_size,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* w = static_cast<const int32_t*>(winner);
  const int32_t* c = static_cast<const int32_t*>(coords);
  int32_t* cnt = static_cast<int32_t*>(counts);
  int32_t* v = static_cast<int32_t*>(vid);
  int32_t* oc = static_cast<int32_t*>(out_coords);
  const int nblocks = n > 0 ? (n + kRowsPerBlock - 1) / kRowsPerBlock : 1;
  count_kernel<<<nblocks, kThreads, 0, s>>>(w, n, cnt);
  scan_scatter_kernel<<<nblocks, kThreads, 0, s>>>(
      w, c, n, shift, cap, cnt, v, oc, static_cast<int32_t*>(num));
  int rows = n > cap ? n : cap;
  if (tvals != nullptr && t_size > rows) rows = t_size;
  if (rows > 0)
    gather_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        w, c, n, cap, v, static_cast<const int32_t*>(num),
        static_cast<int32_t*>(inverse), static_cast<int32_t*>(kpos), oc,
        static_cast<bool*>(valid), static_cast<const int32_t*>(tvals),
        static_cast<int32_t*>(tvals_out), t_size);
  return static_cast<int>(cudaGetLastError());
}
