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
// (winner[r] == r).  Voxel ids follow the winners in row order: vid(r) is
// the number of winners among rows 0..r, less one (the id of a winner).
//
// What bounds it: bytes (a few int32 per row, no arithmetic to speak of);
// at the main path's sizes, launches.  Design: two launches on one stream,
// no grid-wide wait and no scratch that needs zeroing:
//   1. flags: each thread block takes 1,024 rows; a warp ballot per 32 rows
//      gives the word of winner bits, and the block writes each word, each
//      word's count of winners before it in the block, and its own count;
//   2. finish: each thread block adds up the per-block counts (a few
//      hundred) into their prefix in shared memory, so that vid(r) of any
//      row is that prefix, the word's prefix and a popcount of the word:
//      O(1) reads.  Then, one element per thread over the rows, the
//      capacity and the hash's slots: each row's inverse id (its winner's
//      id, -1 for no winner or an id at or past the capacity), its kernel
//      position ((x&1)<<2 | (y&1)<<1 | (z&1)) when asked, and, for a winner
//      below the capacity, its coordinates (x, y, z shifted right by
//      ``shift``: 0 for voxelize, 1 for a 2x downsample); the level's
//      validity and zero coordinates past the count; the hash's values
//      remapped from rows to voxel ids into a new table (the input hash is
//      left as it was, so a call can be repeated on it); and the count.
// The ids depend only on row order, never on thread order.  The count
// stays on the card: nothing waits for it.
//
// Contract: winner (n,) int32, -1 = none; coords (4, n) int32 SoA
// (b, x, y, z); ws int32 scratch: num (1), then per 32-row word its winner
// bits and the winners before it in its 1,024-row block (ceil(n / 32) each),
// then each block's count (ceil(n / 1024)); inverse (n,) int32; kpos (n,)
// int32 or null; out_coords (4, cap) int32; valid (cap,) bool; tvals
// (t_size,) int32 or null, K6's smallest rows (0x7FFFFFFF in an empty
// slot), and tvals_out (t_size,) int32 their voxel ids (-1 in an empty
// slot).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 1024;
constexpr int kWordsPerBlock = kRowsPerBlock / 32;

struct Scratch {
  int32_t* num;
  uint32_t* bits;     // (words,) winner bits
  int32_t* before;    // (words,) winners before the word in its block
  int32_t* counts;    // (blocks,) winners per block
};

__device__ __forceinline__ Scratch scratch(int32_t* ws, int n) {
  const int words = (n + 31) / 32;
  return {ws, reinterpret_cast<uint32_t*>(ws + 1), ws + 1 + words, ws + 1 + 2 * words};
}

__global__ void __launch_bounds__(kThreads)
flags_kernel(const int32_t* __restrict__ winner, int n, int32_t* __restrict__ ws) {
  __shared__ int word_count[kWordsPerBlock];
  const Scratch sc = scratch(ws, n);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int words = (n + 31) / 32;
#pragma unroll
  for (int j = 0; j < kRowsPerBlock / kThreads; ++j) {
    const int i = blockIdx.x * kRowsPerBlock + j * kThreads + threadIdx.x;
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, i < n && winner[i] == i);
    const int word = blockIdx.x * kWordsPerBlock + j * kWarps + warp;
    if (lane == 0) {
      word_count[j * kWarps + warp] = __popc(bal);
      if (word < words) sc.bits[word] = bal;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int c = word_count[lane];
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += u;
    }
    const int word = blockIdx.x * kWordsPerBlock + lane;
    if (word < words) sc.before[word] = incl - c;
    if (lane == 31) sc.counts[blockIdx.x] = incl;
  }
}

// in place: counts[0..nb) -> their exclusive prefix; returns the total
__device__ int block_prefix(int* counts, int nb) {
  __shared__ int warp_sums[kWarps];
  const int per = (nb + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per, hi = min(lo + per, nb);
  int part = 0;
  for (int i = lo; i < hi; ++i) part += counts[i];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - part, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    run += w < warp ? warp_sums[w] : 0;
    total += warp_sums[w];
  }
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const int32_t* __restrict__ winner, const int32_t* __restrict__ coords,
              int n, int shift, int cap, int32_t* __restrict__ ws,
              int32_t* __restrict__ inverse, int32_t* __restrict__ kpos,
              int32_t* __restrict__ out_coords, bool* __restrict__ valid,
              const int32_t* __restrict__ tvals, int32_t* __restrict__ tvals_out,
              int t_size, int elems) {
  extern __shared__ int prefix[];  // (blocks,) winners before each block
  const Scratch sc = scratch(ws, n);
  const int nb = n > 0 ? (n + kRowsPerBlock - 1) / kRowsPerBlock : 0;
  for (int i = threadIdx.x; i < nb; i += kThreads) prefix[i] = sc.counts[i];
  __syncthreads();
  const int total = block_prefix(prefix, nb);
  // the number of winners among rows 0..r, less one
  auto vid = [&](int r) {
    const int word = r >> 5;
    const unsigned upto = (2u << (r & 31)) - 1u;   // bits 0..r&31
    return prefix[r >> 10] + sc.before[word] + __popc(sc.bits[word] & upto) - 1;
  };
  if (blockIdx.x == 0 && threadIdx.x == 0) *sc.num = total;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < elems; i += gridDim.x * kThreads) {
    if (i < n) {
      const int w = winner[i];
      const int r = w >= 0 ? vid(w) : -1;
      inverse[i] = r < cap ? r : -1;
      if (w == i && r < cap) {
        out_coords[r] = coords[i];
        for (int d = 1; d < 4; ++d)
          out_coords[(int64_t)d * cap + r] = coords[(int64_t)d * n + i] >> shift;
      }
      if (kpos != nullptr)
        kpos[i] = ((coords[(int64_t)n + i] & 1) << 2) |
                  ((coords[2 * (int64_t)n + i] & 1) << 1) |
                  (coords[3 * (int64_t)n + i] & 1);
    }
    if (i < cap) {
      const bool live = i < total;
      valid[i] = live;
      if (!live)
        for (int d = 0; d < 4; ++d) out_coords[(int64_t)d * cap + i] = 0;
    }
    if (tvals != nullptr && i < t_size) {
      const int32_t v = tvals[i];   // 0x7FFFFFFF in an empty slot
      tvals_out[i] = v >= 0 && v < n ? vid(v) : -1;
    }
  }
}

}  // namespace

// Returns the launches' cudaError_t.
extern "C" int voxel_compact(const void* winner, const void* coords, int n,
                             int shift, int cap, void* ws, void* inverse,
                             void* kpos, void* out_coords, void* valid,
                             const void* tvals, void* tvals_out, int t_size,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* w = static_cast<const int32_t*>(winner);
  int32_t* wsi = static_cast<int32_t*>(ws);
  const int nb = n > 0 ? (n + kRowsPerBlock - 1) / kRowsPerBlock : 0;
  if (nb > 0) flags_kernel<<<nb, kThreads, 0, s>>>(w, n, wsi);
  int elems = n > cap ? n : cap;
  if (tvals != nullptr && t_size > elems) elems = t_size;
  elems = elems > 1 ? elems : 1;   // one thread writes the count
  const size_t smem = sizeof(int) * (size_t)nb;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  finish_kernel<<<(elems + kThreads - 1) / kThreads, kThreads, smem, s>>>(
      w, static_cast<const int32_t*>(coords), n, shift, cap, wsi,
      static_cast<int32_t*>(inverse), static_cast<int32_t*>(kpos),
      static_cast<int32_t*>(out_coords), static_cast<bool*>(valid),
      static_cast<const int32_t*>(tvals), static_cast<int32_t*>(tvals_out), t_size,
      elems);
  return static_cast<int>(cudaGetLastError());
}
