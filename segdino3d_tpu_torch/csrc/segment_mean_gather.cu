// K3: deterministic segment mean over column sources, one launch a call.
//
//   out[s, col0_k + c] = mean over the members p of segment s of
//                        src_k[row_k(p), c]
//
// with row_k(p) = p for a direct source and gidx[p] for a gathered one (a
// row -1 adds nothing but counts).  Replaces
// segdino3d_tpu/ops/scatter.py:segment_mean / segment_mean_stack and,
// fused, segdino3d_tpu/ops/voxelize.py:devoxelize.  On the main path it
// runs twice per forward: the point -> voxel feature mean (two direct
// sources, the colour columns 3:6 of the (N, 6) points and the (N, 256)
// 2D features in their own dtype, so the (N, 259) concatenation is never
// written), and the voxel -> point -> superpoint pooling (the (V0, 96)
// U-Net output gathered through the point -> voxel inverse map, plus the
// two 3-column centroid sets), which never materialises the (N, 96) point
// features the TPU version built.
//
// What bounds it: bytes.  One add per input element, far below the card's
// operations-per-byte balance; the least traffic is each needed input
// element read once and each output row written once.
//
// Design: segments arrive as CSR over a stable sort of the segment ids
// (members ascending within a segment; `sorted` holds each member's
// segment id) and are cut into chunks on the member array's 32-member
// blocks: a segment's chunk j is its members in block floor(offsets[s] /
// 32) + j.  A work item is one block, one warp (four a thread block): its
// lanes load the block's member ids, segment ids (and for a gathered
// source the gathered rows) once, coalesced, and the first member's lane of
// each segment its offsets; then the warp walks the 32 members in order,
// each lane adding its column units (16 bytes of a row whose rows are
// 16-byte aligned, else one element; up to three a lane and pass) and
// reading the rows two members at a time, and at the end of each
// segment's run in the block writes it: the mean, for a segment within the
// block (nearly every voxel), else the run's sums as a partial row (slot 2
// k + 1 of block k if the segment goes on past the block, else slot 2 k),
// staged in shared memory and stored by consecutive lanes (each lane's own
// 4-byte stores, 16 bytes apart, cost 0.18 of the voxel mean's 0.30 ms).
// The warp whose arrival on a segment's counter completes it adds the
// partials in chunk order (lanes across the columns, eight chunks' loads in
// flight), writes the mean and resets the counter.  Items past the blocks
// write the zero rows of the empty segments, 32 segments an item.  So a
// segment's sum runs over its members in ascending order, then over its
// chunks in order: no float atomics, two calls are bit-equal.  (A first
// design gave each chunk of each segment its own warp: the voxel mean's
// ~1.3 members a voxel left it latency-bound at 0.23 ms.)
//
// Every element is rounded to bf16 before it is added where the source
// asks for it (flag kRound), as `feats.to(torch.bfloat16)` rounds it.
//
// The CSR's own kernels (segment_csr_keys, segment_csr_offsets) run
// around torch.sort: the kept ids as int32 keys, then each segment's first
// member by a binary search over the sorted keys, the counters zeroed.
//
// Contract: offsets (S + 1,) int64, members (N,) int64 row ids, sorted
// (N,) int32 their segment ids (S past offsets[S]); counters (S,) int32,
// zero on entry and left zero; partial (2 ceil(N / 32), ctot) fp32
// scratch; gidx (N,) int32, or null when no source is gathered; up to
// kMaxSrc sources: a base pointer (row 0, its first column), the bytes
// between rows, a column count and flags (dtype in bits 0-3: 0 fp32, 1
// bf16, 2 fp16; kGathered, kRound, kVec: rows 16-byte aligned and at least
// one 16-byte run); the output (S, ld) fp32, ld >= ctot, holds the
// sources' columns side by side in order and zeros in columns ctot .. ld - 1
// (the backbone's fp32 stem rows at their 16-byte pitch, ops/narrow.py:
// row_pitch, written here so that no second pass widens them).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;    // members per work item: one a lane
constexpr int kWarps = 4;     // work items per block
constexpr int kUnits = 3;     // column units per lane and pass
constexpr int kGroup = 2;     // members read at once
constexpr int kStageCols = 32 * kUnits * 8;  // a pass's columns at most
constexpr int kMaxSrc = 8;

constexpr int kGathered = 1 << 4;
constexpr int kRound = 1 << 5;
constexpr int kVec = 1 << 6;

struct Sources {
  const unsigned char* ptr[kMaxSrc];
  long long stride[kMaxSrc];  // bytes
  int cols[kMaxSrc];
  int flags[kMaxSrc];
  int unit0[kMaxSrc + 1];     // the sources' first units; unit0[n] = all
  int col0[kMaxSrc];          // the sources' first output columns
  int n, ctot;
  int ld;                     // the output's row stride, columns: ctot or more
};

__host__ __device__ __forceinline__ int elt_bytes(int flags) {
  return (flags & 15) == 0 ? 4 : 2;
}
// the elements of one unit
__host__ __device__ __forceinline__ int vec_width(int flags) {
  return 16 / elt_bytes(flags);
}
__host__ __device__ __forceinline__ int n_units(int cols, int flags) {
  return (flags & kVec) ? cols / vec_width(flags) + cols % vec_width(flags) : cols;
}

// A lane's column unit: `width` elements from column `col` of its source.
struct Unit {
  const unsigned char* base;  // row 0, the unit's first column
  long long stride;
  int flags, width, ocol;     // width 0: no unit
};

__device__ __forceinline__ Unit unit_at(const Sources& src, int u) {
  Unit t{nullptr, 0, 0, 0, 0};
  if (u >= src.unit0[src.n]) return t;
  int k = 0;
  while (u >= src.unit0[k + 1]) ++k;
  const int f = src.flags[k], local = u - src.unit0[k];
  const int vw = vec_width(f), n_vec = (f & kVec) ? src.cols[k] / vw : 0;
  const int col = local < n_vec ? local * vw : n_vec * vw + (local - n_vec);
  t.base = src.ptr[k] + (long long)col * elt_bytes(f);
  t.stride = src.stride[k];
  t.flags = f;
  t.width = local < n_vec ? vw : 1;
  t.ocol = src.col0[k] + col;
  return t;
}

__device__ __forceinline__ float rounded(float v, int flags) {
  return (flags & kRound) ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// the unit of row `row`, raw: 16 bytes, or one element in .x
__device__ __forceinline__ uint4 load_unit(const Unit& t, long long row) {
  const unsigned char* a = t.base + row * t.stride;
  if (t.width > 1) return __ldg(reinterpret_cast<const uint4*>(a));
  uint4 r{0, 0, 0, 0};
  r.x = elt_bytes(t.flags) == 4 ? __ldg(reinterpret_cast<const unsigned*>(a))
                                : __ldg(reinterpret_cast<const unsigned short*>(a));
  return r;
}

__device__ __forceinline__ float to_f(unsigned short bits, int dtype) {
  return dtype == 1 ? __bfloat162float(__ushort_as_bfloat16(bits))
                    : __half2float(__ushort_as_half(bits));
}

// acc[i] += element i of the raw unit, rounded as its source asks
__device__ __forceinline__ void add_unit(float (&acc)[8], const Unit& t, const uint4& r) {
  const int dtype = t.flags & 15;
  if (dtype == 0) {
    const float e[4] = {__uint_as_float(r.x), __uint_as_float(r.y), __uint_as_float(r.z),
                        __uint_as_float(r.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < t.width) acc[i] += rounded(e[i], t.flags);
    return;
  }
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < t.width)
      acc[i] += rounded(to_f(static_cast<unsigned short>(w[i / 2] >> (16 * (i % 2))), dtype),
                        t.flags);
}

// stage[ocol - c_lo + i] = acc[i]
__device__ __forceinline__ void stage_unit(float* __restrict__ stage, const Unit& t, int c_lo,
                                           const float (&acc)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < t.width) stage[t.ocol - c_lo + i] = acc[i];
}

constexpr int kCols = 4;    // the finishing pass: columns a lane
constexpr int kBatch = 8;   // the finishing pass: chunks read at once

// Partial slot of segment [b0, e0)'s chunk in block k.
__device__ __forceinline__ int64_t chunk_slot(int64_t k, int64_t e0) {
  return 2 * k + (e0 > (k + 1) * kChunk ? 1 : 0);
}

// The mean of segment s from its partials, in chunk order; resets its
// counter.  Every lane of the warp calls it.
__device__ __forceinline__ void finish(const Sources& src, const float* __restrict__ partial,
                                       float* __restrict__ out, int* __restrict__ counters,
                                       int s, int64_t b0, int64_t e0) {
  const int lane = threadIdx.x & 31;
  const int64_t k0 = b0 / kChunk;
  const int n_chunks = (int)((e0 - 1) / kChunk - k0 + 1);
  float* const row = out + (int64_t)s * src.ld;
  for (int c0 = 0; c0 < src.ctot; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int j0 = 0; j0 < n_chunks; j0 += kBatch) {
      float v[kBatch][kCols];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int j = j0 + q;
        const float* pr = partial + chunk_slot(k0 + j, e0) * src.ctot;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = c0 + lane + 32 * c;
          v[q][c] = j < n_chunks && col < src.ctot ? __ldcg(pr + col) : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (j0 + q < n_chunks)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[c] += v[q][c];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < src.ctot) row[col] = acc[c] / (float)(e0 - b0);
    }
  }
  for (int c = src.ctot + lane; c < src.ld; c += 32) row[c] = 0.f;
  if (lane == 0) counters[s] = 0;
}

// Arrive on segment s's counter; true for the warp that completes it.
__device__ __forceinline__ bool arrive(int* __restrict__ counters, int s, int64_t b0,
                                       int64_t e0) {
  __threadfence();
  __syncwarp();
  const int n_chunks = (int)((e0 - 1) / kChunk - b0 / kChunk + 1);
  int last = 0;
  if ((threadIdx.x & 31) == 0) last = atomicAdd(counters + s, 1) == n_chunks - 1;
  last = __shfl_sync(0xffffffffu, last, 0);
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(kWarps * 32)
segment_mean_kernel(const int64_t* __restrict__ offsets, const int64_t* __restrict__ members,
                    const int32_t* __restrict__ sorted, int* __restrict__ counters,
                    float* __restrict__ partial, const int32_t* __restrict__ gidx,
                    const Sources src, float* __restrict__ out, int num_segments, int n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_blocks) {
    // 32 segments: the zero rows of the empty ones
    const int64_t s0 = (item - n_blocks) * 32;
    const int64_t s = s0 + lane;
    const bool empty = s < num_segments && offsets[s] == offsets[s + 1];
    unsigned mask = __ballot_sync(0xffffffffu, empty);
    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      float* const row = out + (s0 + l) * src.ld;
      for (int c = lane; c < src.ld; c += 32) row[c] = 0.f;
    }
    return;
  }
  const int64_t base = item * kChunk, kept = offsets[num_segments];
  if (base >= kept) return;  // uniform over the warp
  const int cnt = (int)min((int64_t)kChunk, kept - base);
  // the block's members, one a lane, and each run's offsets at its start
  int p = -1, sg = -1, gp = -1;
  if (lane < cnt) {
    p = (int)members[base + lane];
    sg = sorted[base + lane];
    if (gidx != nullptr) gp = gidx[p];
  }
  const int prev = __shfl_up_sync(0xffffffffu, sg, 1);
  const int next = __shfl_down_sync(0xffffffffu, sg, 1);
  const bool starts = lane < cnt && (lane == 0 || prev != sg);
  const bool ends = lane < cnt && (lane == cnt - 1 || next != sg);
  const unsigned end_mask = __ballot_sync(0xffffffffu, ends);
  int64_t ob = 0, oe = 0;
  if (starts) {
    ob = offsets[sg];
    oe = offsets[sg + 1];
  }
  const int n_total = src.unit0[src.n];
  // a run's row is staged here, then written out by consecutive lanes
  __shared__ float s_stage[kWarps][kStageCols];
  float* const stage = s_stage[threadIdx.x >> 5];

  for (int u0 = 0; u0 < n_total; u0 += 32 * kUnits) {
    Unit t[kUnits];
    float acc[kUnits][8];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      t[k] = unit_at(src, u0 + lane + 32 * k);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[k][i] = 0.f;
    }
    // the pass's columns [c_lo, c_hi): its units' columns, in order
    const int c_lo = __shfl_sync(0xffffffffu, t[0].ocol, 0);
    const Unit t_end = unit_at(src, min(u0 + 32 * kUnits, n_total) - 1);
    const int c_hi = t_end.ocol + t_end.width;
    int run = 0;  // the lane where the current run starts
    for (int m0 = 0; m0 < cnt; m0 += kGroup) {
      uint4 raw[kGroup][kUnits];
      bool live[kGroup][kUnits];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int m = m0 + g;
        const int pm = __shfl_sync(0xffffffffu, p, m & 31);
        const int gm = __shfl_sync(0xffffffffu, gp, m & 31);
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
          const int row = (t[k].flags & kGathered) ? gm : pm;
          live[g][k] = m < cnt && t[k].width > 0 && row >= 0;
          if (live[g][k]) raw[g][k] = load_unit(t[k], row);
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int m = m0 + g;
        if (m >= cnt) break;
#pragma unroll
        for (int k = 0; k < kUnits; ++k)
          if (live[g][k]) add_unit(acc[k], t[k], raw[g][k]);
        if (!((end_mask >> m) & 1)) continue;
        // the run [run, m] of segment s ends: its mean or its partial
        const int s = __shfl_sync(0xffffffffu, sg, m);
        const int64_t b0 = __shfl_sync(0xffffffffu, ob, run);
        const int64_t e0 = __shfl_sync(0xffffffffu, oe, run);
        const bool whole = b0 >= base && e0 <= base + kChunk;
        float* const dst = whole ? out + (int64_t)s * src.ld
                                 : partial + chunk_slot(item, e0) * src.ctot;
        const float div = whole ? (float)(e0 - b0) : 1.f;
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
          if (t[k].width > 0) stage_unit(stage, t[k], c_lo, acc[k]);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[k][i] = 0.f;
        }
        __syncwarp();
        for (int c = c_lo + lane; c < c_hi; c += 32) dst[c] = stage[c - c_lo] / div;
        // the row's last pass: its pitch columns
        if (whole && c_hi == src.ctot)
          for (int c = c_hi + lane; c < src.ld; c += 32) dst[c] = 0.f;
        __syncwarp();
        run = m + 1;
      }
    }
  }
  // the runs that began before the block or go on past it: the first
  // and the last
  const int s_first = __shfl_sync(0xffffffffu, sg, 0);
  const int64_t b_first = __shfl_sync(0xffffffffu, ob, 0);
  const int64_t e_first = __shfl_sync(0xffffffffu, oe, 0);
  const int last_start = 31 - __clz(__ballot_sync(0xffffffffu, starts));
  const int s_last = __shfl_sync(0xffffffffu, sg, last_start);
  const int64_t b_last = __shfl_sync(0xffffffffu, ob, last_start);
  const int64_t e_last = __shfl_sync(0xffffffffu, oe, last_start);
  if (b_first < base || e_first > base + kChunk) {
    if (arrive(counters, s_first, b_first, e_first))
      finish(src, partial, out, counters, s_first, b_first, e_first);
  }
  if (s_last != s_first && e_last > base + kChunk) {
    if (arrive(counters, s_last, b_last, e_last))
      finish(src, partial, out, counters, s_last, b_last, e_last);
  }
}

// keys[i] = seg[i] where valid[i] and 0 <= seg[i] < S, else S
template <typename I>
__global__ void csr_keys_kernel(const I* __restrict__ seg, const uint8_t* __restrict__ valid,
                                int n, int num_segments, int32_t* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const I v = seg[i];
  const bool keep = v >= 0 && v < (I)num_segments && (valid == nullptr || valid[i]);
  keys[i] = keep ? (int32_t)v : num_segments;
}

// offsets[s] = the first i with sorted[i] >= s (n if none), s in [0, S];
// counters[s] = 0
__global__ void csr_offsets_kernel(const int32_t* __restrict__ sorted, int n, int num_segments,
                                   int64_t* __restrict__ offsets, int32_t* __restrict__ counters) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s > num_segments) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (sorted[mid] < s) lo = mid + 1; else hi = mid;
  }
  offsets[s] = lo;
  if (s < num_segments) counters[s] = 0;
}

}  // namespace

// ptrs, strides (bytes), cols, flags: n_src host arrays, one entry a
// source; out_ld the output's row stride in columns (at least the
// sources' columns); n the rows of members.  Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for too many sources or too
// narrow an output row.
extern "C" int segment_mean_gather(const void* offsets, const void* members, const void* sorted,
                                   void* counters, void* partial, const void* gidx, int n_src,
                                   const void* const* ptrs, const long long* strides,
                                   const int* cols, const int* flags, void* out, int out_ld,
                                   int num_segments, int n, void* stream) {
  if (n_src < 1 || n_src > kMaxSrc) return static_cast<int>(cudaErrorInvalidValue);
  Sources src{};
  src.n = n_src;
  int units = 0, col = 0;
  for (int k = 0; k < n_src; ++k) {
    src.ptr[k] = static_cast<const unsigned char*>(ptrs[k]);
    src.stride[k] = strides[k];
    src.cols[k] = cols[k];
    src.flags[k] = flags[k];
    src.unit0[k] = units;
    src.col0[k] = col;
    units += n_units(cols[k], flags[k]);
    col += cols[k];
  }
  src.unit0[n_src] = units;
  src.ctot = col;
  src.ld = out_ld;
  if (out_ld < col) return static_cast<int>(cudaErrorInvalidValue);
  if (num_segments == 0 || col == 0) return 0;
  const int n_blocks = (n + kChunk - 1) / kChunk;
  const long long items = (long long)n_blocks + (num_segments + 31) / 32;
  segment_mean_kernel<<<(unsigned)((items + kWarps - 1) / kWarps), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(members),
      static_cast<const int32_t*>(sorted), static_cast<int*>(counters),
      static_cast<float*>(partial), static_cast<const int32_t*>(gidx), src,
      static_cast<float*>(out), num_segments, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The CSR's sort keys: seg (n,) int32 (seg64 0) or int64 (seg64 1), valid
// (n,) bytes or null; keys (n,) int32.
extern "C" int segment_csr_keys(const void* seg, int seg64, const void* valid, int n,
                                int num_segments, void* keys, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + 255) / 256;
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  int32_t* k = static_cast<int32_t*>(keys);
  if (seg64)
    csr_keys_kernel<<<blocks, 256, 0, st>>>(static_cast<const int64_t*>(seg), va, n,
                                            num_segments, k);
  else
    csr_keys_kernel<<<blocks, 256, 0, st>>>(static_cast<const int32_t*>(seg), va, n,
                                            num_segments, k);
  return static_cast<int>(cudaGetLastError());
}

// The CSR's offsets (S + 1,) int64 from the sorted keys (n,) int32, and
// its counters (S,) int32 zeroed.
extern "C" int segment_csr_offsets(const void* sorted, int n, int num_segments, void* offsets,
                                   void* counters, void* stream) {
  csr_offsets_kernel<<<(num_segments + 256) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sorted), n, num_segments, static_cast<int64_t*>(offsets),
      static_cast<int32_t*>(counters));
  return static_cast<int>(cudaGetLastError());
}
