// K10: block convolution of flat dense rows, computed at the rows of a mask.
//
// Replaces segdino3d_tpu/ops/block_dense.py:halo_pad (:152-232) with
// _conv_valid and dense_subm_conv (:243-308), and the chunked conv's
// forward (_chunked_conv_cd, :358-387).  Features live as flat dense rows
// (n_blocks * edge^3, C) (block_tile.cuh).  out[c] = sum_o x[src(c, o)] @
// W[o] over the k^3 offsets o, src(c, o) being the cell at c's position
// shifted by o - h (h = (k - 1) / 2), in c's block or in one of its 26 shell
// neighbours (a cell of an absent neighbour reads as zero): the VALID conv
// of the halo-padded block.  With a mask, rows outside it are zero.  On the
// main path it runs the 46 k3 convs of the BasicBlocks (block-dense levels)
// under the occupancy mask, the training plan's dense k5 stem (259 -> 32),
// and, with offset-flipped, channel-transposed weights, every block conv's
// input gradient (the mirror identity of _chunked_conv_bwd, :396-412) under
// the k-dilation of the occupancy (block_dilate below), outside which that
// gradient is zero.
//
// What bounds it: operations, 2 * rows * k^3 * Cin * Cout over inputs of
// tens of MB.  Blocks are ~22% full at level 0, so computing the masked
// rows only is most of the gain; then the products.  Design:
//   1. the row list: two small launches compact the mask's rows, in row
//      order, which is block-major, into a list whose count stays on the
//      card (no host sync); its capacity is the level's dense row count.
//      Without a mask the list names every row.  The wrappers build a
//      level's lists once and pass them to every conv of the level
//      (block_conv_rows): the occupancy's (block_rows) for the forward
//      and for K11, and the k-dilation's (block_dilate, which writes the
//      mask and the list pass's per-block counts in one pass) for the dX
//      role.  block_conv builds a list inside the call for a caller with
//      none;
//   2. the conv: thread blocks resident on every SM take 64-row tiles of
//      the list by an atomic ticket, so a tile spans the masked cells of
//      several blocks.  The block that takes the last ticket resets it to
//      0, so a list serves any number of convs in turn (and K11).  A tile's source-row table (k^3 x 64, through
//      bdt::halo_row) is built once in shared memory with the offsets at
//      which some row has a source, and serves every column tile (when a
//      level has too few tiles to fill the card, each column tile is a work
//      item of its own, and narrow ones: BN 32).  The
//      (offset, 32-channel slice) stages run through a two-buffer cp.async
//      pipeline: each stage copies the 64 source rows' slice and the
//      offset's 32 x BN weight slice with 16-byte copies into padded,
//      bank-conflict-free rows (zero-filled past the rows, Cin and Cout;
//      4-byte copies, or plain loads in bf16, when Cin or Cout breaks the
//      16-byte alignment), at one barrier per stage, the next stage's copies
//      in flight during this one's products.  fp32 multiplies with FMAs,
//      each thread an interleaved TM x TN sub-tile.  The caller zeroes the
//      output first when it passes a mask.
// The order of each fp32 output's sums is fixed whatever tile or thread
// block computes it: an offset's products over Cin (slices, then channels,
// ascending) into a partial sum, the partials added in ascending offset
// order, as the plain version adds its per-offset products.  This keeps
// the kernel's rounding close to the plain version's, which a small
// training step amplifies (PERF.md section 6).  No atomics touch the
// output, so a run is deterministic.
//
// bf16 (the wide path's bf16 calls): the same row lists, ticket, tiles and
// source tables, on the warpgroup core of wgmma_tile.cuh.  The stage loop
// of the fp32 kernel, with mma.sync, lost to cuDNN's bf16 conv3d at the
// small levels (L3 384 -> 256: 152 items of 324 stages, each behind a
// full barrier, 2 x 4 mma.sync a warp) and at the dense stem (Cin 259:
// 2-byte loads).  Now a tile's (active offset, 64-channel) stages run
// through a four-buffer cp.async ring into the swizzled layouts wgmma
// reads, two stages' copies in flight during a stage's four
// wgmma.m64nBNk16 (BN = Cout up to 128); where a level's (tile, column
// tile) items are fewer than two per resident block, each tile's active
// offsets are cut into up to 16 contiguous groups, each group's fp32
// partial goes to a scratch the wrapper allocates at the level's capacity
// (block_conv_split_cap), and group_sum_kernel adds the groups in
// ascending order and writes bf16: no float atomics, so two calls are
// bit-equal.  Each output's sum runs over the stages in order in one fp32
// accumulator (no per-offset partials: the bf16 tolerance is one rounding
// of the output).  The stems' rows reach it at an aligned pitch (264 for
// Cin 259, ops/narrow.py:row_pitch); a row that breaks 16-byte alignment
// is copied element by element, and the wrapper counts such calls.
//
// The narrow path (narrow != 0, for a few input channels: the Baseline's
// dense k5 stem, rgb 3 -> 32; ops/narrow.py picks it from the shape): the
// stage loop above, at Cin 3, ran 125 stages a tile behind as many
// barriers, each copying 64 rows of which 3 lanes of 32 were real and a
// 32 x BN weight slice of which 29 rows were zero.  The narrow path keeps
// the row list, the ticket, the mask and unmasked variants, edge 4 / 8 and
// k 3 / 5, and runs tiles of 128 listed rows on narrow_tile.cuh's core:
// the weight staged once per block, each chunk of offsets gathered through
// the block halo (bdt::HaloSrc) straight into an im2col tile (no per-offset
// stages), the fp32 sums in the order above.
//
// The live-pair path (block_conv_live, for a conv whose caller states its
// input zero outside the mask: the flagship's dense k5 stem in training,
// 259 -> 32, whose input comes straight from K9's scatter to dense rows;
// ops/narrow.py:live_path picks it): the row tiles above run every offset
// at which some row of a 64-row tile has a source block, about 125 offsets
// x 76,239 rows at the stem, though only 28 of a row's 125 sources are
// occupied (4.5x the work).  A source cell outside the mask holds a zero
// row, so its pair adds exact zeros and is skipped.  block_live_pairs
// builds, in one pass over the occupied-row list (a count and a list
// launch, per offset and block of listed rows), per offset and in list
// order the listed rows whose source cell through the block halo is in
// the mask (src, dst) and, per (offset, listed row), its pair's index
// (map); the counts stay on the card, and the wrappers build it once per
// level and step for the stem's forward and K11's dW.  The conv then runs
// K1's pair-major form over it (pair_major.cuh, shared with
// gather_gemm_conv.cu): items of 64 pairs of one offset and a column tile,
// x[src] @ W[o] on gather_tile.cuh's FMA core (fp32) or wgmma_tile.cuh's
// warpgroup core (bf16, the 264 pitch) into a pair-major fp32 buffer
// (k^3 * cap rows, cap the list's capacity: 1.47 GB at the stem, as K1's),
// then live_sum_kernel adds each listed row's products in ascending offset
// order through the map.  Each offset's
// product over Cin is summed as in the row tiles and the partials are
// added in the same order without the zeros, so the fp32 result equals
// the row-tile path's bit for bit; no float atomics.
//
// Contract: x (n_blocks * edge^3, Cin), w (k^3, Cin, Cout) and out
// (n_blocks * edge^3, Cout) share one dtype (fp32 or bf16), rows
// contiguous; block_nbr (26, n_blocks) int32; mask (n_blocks * edge^3,)
// bytes or null; ws int32 scratch of n_rows + 2 + ceil(n_rows / 4096)
// (block_dense.py:row_workspace): the list, its count, the tile ticket
// (0 between calls), the list pass's per-block counts; edge in {4, 8}, k
// in {3, 5}.
//
// block_dilate, the dX role's output mask, replaces no JAX op: JAX's dX
// (_chunked_conv_bwd, :396) is unmasked.  What bounds it: the mask's bytes,
// read once, written once (0.4 us at level 0), far below one launch.  It
// once ran a thread per row over up to 27 dependent (block_nbr, mask)
// load pairs, with divergent early exits; now a thread block stages 64
// bricks (8 at edge 8) as bit rows with three aligned word loads per
// padded z-row and dilates them separably with shifts and ORs (see
// dilate_kernel).
#include "block_tile.cuh"
#include "narrow_tile.cuh"
#include "pair_major.cuh"

namespace {

using bdt::from_f;

// ---------------------------------------------------------------------------
// the row list
// ---------------------------------------------------------------------------

constexpr int kListThreads = 256;
constexpr int kListRows = kListThreads * 16;   // rows per thread block, 16 a thread

// bit i set when row r0 + i is in the mask (every row below n_rows when
// there is no mask)
__device__ __forceinline__ unsigned row_flags(const uint8_t* __restrict__ mask,
                                              int64_t r0, int n_rows) {
  unsigned m = 0;
  if (mask != nullptr && r0 + 16 <= n_rows &&
      (reinterpret_cast<uintptr_t>(mask + r0) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(mask + r0);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      m |= (((words[i / 4] >> (8 * (i % 4))) & 0xFFu) != 0u ? 1u : 0u) << i;
    return m;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const bool in = r0 + i < n_rows && (mask == nullptr || mask[r0 + i] != 0);
    m |= (in ? 1u : 0u) << i;
  }
  return m;
}

// exclusive prefix of v over the thread block, in thread order; *total is
// the block's sum
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int i = 0; i < kListThreads / 32; ++i) {
    before += i < warp ? warp_sums[i] : 0;
    sum += warp_sums[i];
  }
  __syncthreads();
  *total = sum;
  return before + incl - v;
}

__global__ void __launch_bounds__(kListThreads)
count_rows_kernel(const uint8_t* __restrict__ mask, int n_rows,
                  int32_t* __restrict__ counts) {
  __shared__ int warp_sums[kListThreads / 32];
  const int64_t r0 = (int64_t)blockIdx.x * kListRows + threadIdx.x * 16;
  int total;
  block_exclusive_scan(__popc(row_flags(mask, r0, n_rows)), warp_sums, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kListThreads)
list_rows_kernel(const uint8_t* __restrict__ mask, int n_rows,
                 const int32_t* __restrict__ counts, int32_t* __restrict__ rows,
                 int32_t* __restrict__ count, int32_t* __restrict__ ticket) {
  __shared__ int warp_sums[kListThreads / 32];
  int part = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += kListThreads) part += counts[i];
  int prefix;
  block_exclusive_scan(part, warp_sums, &prefix);
  const int64_t r0 = (int64_t)blockIdx.x * kListRows + threadIdx.x * 16;
  unsigned m = row_flags(mask, r0, n_rows);
  int total;
  int pos = prefix + block_exclusive_scan(__popc(m), warp_sums, &total);
  while (m) {
    rows[pos++] = (int32_t)(r0 + __ffs(m) - 1);
    m &= m - 1;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    *count = prefix + total;
    *ticket = 0;
  }
}

// ws: rows (n_rows), count, ticket, per-block counts
cudaError_t launch_rows(const void* mask, int32_t* ws, int n_rows, cudaStream_t s) {
  const int blocks = n_rows > 0 ? (n_rows + kListRows - 1) / kListRows : 1;
  int32_t* counts = ws + n_rows + 2;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  count_rows_kernel<<<blocks, kListThreads, 0, s>>>(m, n_rows, counts);
  list_rows_kernel<<<blocks, kListThreads, 0, s>>>(m, n_rows, counts, ws,
                                                   ws + n_rows, ws + n_rows + 1);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the k-dilation of a mask, with its row list's per-block counts
// ---------------------------------------------------------------------------

// One thread block per list block of kListRows rows: 64 bricks of edge 4 or
// 8 of edge 8.  Each brick's 26 shell neighbours are read once; each
// z-row of the halo-padded brick (E + K - 1 cells along z at fixed padded
// x, y) is read as up to three aligned E-byte words of the mask (its own
// block's and its two z-neighbours') into a bit row in shared memory, and
// the dilation runs as three 1-D ORs of width K over bits (z, then y, then
// x).  Each output z-row is one E-byte store; the block's count of dilated
// rows goes to counts[blockIdx.x], where list_rows_kernel reads it.
template <int E>
struct ZWord;
template <> struct ZWord<4> { using T = uint32_t; };
template <> struct ZWord<8> { using T = uint64_t; };

template <int E, int K>
__global__ void __launch_bounds__(kListThreads)
dilate_kernel(const uint8_t* __restrict__ mask, const int32_t* __restrict__ nbr,
              uint8_t* __restrict__ out, int32_t* __restrict__ counts, int n_blocks) {
  using W = typename ZWord<E>::T;
  constexpr int H = (K - 1) / 2, P = E + K - 1, E3 = E * E * E;
  constexpr int BPB = kListRows / E3;   // bricks per thread block
  constexpr uint32_t kRow = (1u << E) - 1u;
  __shared__ int s_src[BPB][27];        // the brick and its shell, d = 13 itself
  __shared__ uint16_t s_z[BPB][P][P];   // bit z: dilated along z, at padded (x, y)
  __shared__ uint16_t s_y[BPB][P][E];   // then along y
  __shared__ int warp_sums[kListThreads / 32];
  const int tid = threadIdx.x, b0 = blockIdx.x * BPB;
  const int nb = min(BPB, n_blocks - b0);
  for (int e = tid; e < nb * 27; e += kListThreads) {
    const int bb = e / 27, d = e % 27;
    s_src[bb][d] = d == 13 ? b0 + bb : nbr[(int64_t)(d - (d > 13)) * n_blocks + b0 + bb];
  }
  __syncthreads();
  for (int e = tid; e < nb * P * P; e += kListThreads) {
    const int bb = e / (P * P), qx = (e / P) % P - H, qy = e % P - H;
    const int dx = qx < 0 ? -1 : (qx >= E ? 1 : 0), dy = qy < 0 ? -1 : (qy >= E ? 1 : 0);
    const int lx = qx - dx * E, ly = qy - dy * E;
    const int* const src = &s_src[bb][(dx + 1) * 9 + (dy + 1) * 3];  // dz = -1, 0, 1
    W w[3];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz)
      w[dz] = src[dz] < 0 ? W(0)
                          : *reinterpret_cast<const W*>(
                                mask + (((int64_t)src[dz] * E + lx) * E + ly) * E);
    uint32_t cells[3];  // bit c: cell z = c of that block's z-row is set
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      cells[dz] = 0;
#pragma unroll
      for (int c = 0; c < E; ++c)
        cells[dz] |= ((w[dz] >> (8 * c)) & 0xFF) != 0 ? 1u << c : 0u;
    }
    // bit p: padded z = p, i.e. core z = p - H
    const uint32_t row = (cells[0] >> (E - H)) | (cells[1] << H) |
                         ((cells[2] & ((1u << H) - 1u)) << (H + E));
    uint32_t d = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) d |= row >> t;
    s_z[bb][qx + H][qy + H] = static_cast<uint16_t>(d & kRow);
  }
  __syncthreads();
  for (int e = tid; e < nb * P * E; e += kListThreads) {
    const int bb = e / (P * E), px = (e / E) % P, y = e % E;
    uint32_t d = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) d |= s_z[bb][px][y + t];
    s_y[bb][px][y] = static_cast<uint16_t>(d);
  }
  __syncthreads();
  int count = 0;
  for (int e = tid; e < nb * E * E; e += kListThreads) {
    const int bb = e / (E * E), x = (e / E) % E, y = e % E;
    uint32_t d = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) d |= s_y[bb][x + t][y];
    W o = 0;
#pragma unroll
    for (int c = 0; c < E; ++c) o |= W((d >> c) & 1u) << (8 * c);
    *reinterpret_cast<W*>(out + (int64_t)(b0 + bb) * E3 + (x * E + y) * E) = o;
    count += __popc(d);
  }
  int total;
  block_exclusive_scan(count, warp_sums, &total);
  if (tid == 0) counts[blockIdx.x] = total;
}

template <int E, int K>
cudaError_t launch_dilate(const uint8_t* mask, const int32_t* nbr, uint8_t* out,
                          int32_t* ws, int n_blocks, cudaStream_t s) {
  const int n_rows = n_blocks * E * E * E;
  const int blocks = (n_rows + kListRows - 1) / kListRows;
  int32_t* counts = ws + n_rows + 2;
  dilate_kernel<E, K><<<blocks, kListThreads, 0, s>>>(mask, nbr, out, counts, n_blocks);
  list_rows_kernel<<<blocks, kListThreads, 0, s>>>(out, n_rows, counts, ws, ws + n_rows,
                                                   ws + n_rows + 1);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the conv
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int BM = 64;   // list rows per tile
constexpr int BK = 32;   // input channels per stage
constexpr int kFewTiles = 512;
constexpr int kMaxGroups = 16;   // the bf16 conv's offset groups, at most

template <typename T> struct Elt;
template <> struct Elt<float> { static constexpr int kVec = 4, kPad = 4; };

template <typename T, int BN>
struct Smem {
  static constexpr int AST = BK + Elt<T>::kPad;   // A row stride (elements)
  static constexpr int BST = BN + Elt<T>::kPad;   // B row stride
  static constexpr int kStage = BM * AST + BK * BST;  // elements, a multiple of 8
  // two stages, then the source table (n_off x BM), the rows (BM), the
  // offset flags and the active offsets (n_off each)
  static size_t bytes(int n_off) {
    return sizeof(T) * 2 * (size_t)kStage +
           sizeof(int) * ((size_t)n_off * BM + BM + 2 * (size_t)n_off);
  }
};

// fp32 FMA sub-tiles: thread (tx, ty) owns rows ty + RG * i (i < TM) and
// columns (j / 4) * 4 * CG + tx * 4 + j % 4 (j < TN), so a quarter warp's
// 16-byte reads of a B row are contiguous
template <int BN>
struct Fma {
  static constexpr int TN = BN / 8;
  static constexpr int CG = BN / TN;
  static constexpr int RG = kThreads / CG;
  static constexpr int TM = BM / RG;
  static_assert(CG * 4 * (TN / 4) == BN && RG * TM == BM, "tile");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one element of a slice that breaks 16-byte alignment: a 4-byte async copy
__device__ __forceinline__ void copy_one(float* dst, const float* src, bool ok,
                                         const float* any) {
  cp_async4(dst, ok ? src : any, ok ? 4 : 0);
}

// Stage (o, k0): A[r][kk] = x[src[r]][k0 + kk], B[kk][n] = w[o][k0 + kk][n0 + n]
template <typename T, int BN>
__device__ __forceinline__ void load_stage(T* __restrict__ As, T* __restrict__ Bs,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           const int* __restrict__ src, int o,
                                           int k0, int n0, int cin, int cout,
                                           bool vec_a, bool vec_b) {
  using S = Smem<T, BN>;
  constexpr int V = Elt<T>::kVec;
  const int tid = threadIdx.x;
  if (vec_a) {
    constexpr int P = BK / V;
    static_assert(BM * P % kThreads == 0, "whole copies per thread");
#pragma unroll
    for (int i = 0; i < BM * P / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e / P, c = (e % P) * V;
      const int s = src[r];
      const bool ok = s >= 0 && k0 + c < cin;
      cp_async16(As + r * S::AST + c, ok ? x + (int64_t)s * cin + k0 + c : x, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int s = src[r];
      copy_one(As + r * S::AST + c, x + (int64_t)s * cin + k0 + c,
               s >= 0 && k0 + c < cin, x);
    }
  }
  const T* __restrict__ wo = w + (int64_t)o * cin * cout;
  if (vec_b) {
    constexpr int P = BN / V;
    static_assert(BK * P % kThreads == 0, "whole copies per thread");
#pragma unroll
    for (int i = 0; i < BK * P / kThreads; ++i) {
      const int e = tid + i * kThreads, kk = e / P, n = (e % P) * V;
      const bool ok = k0 + kk < cin && n0 + n < cout;
      cp_async16(Bs + kk * S::BST + n, ok ? wo + (int64_t)(k0 + kk) * cout + n0 + n : w,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, n = e % BN;
      copy_one(Bs + kk * S::BST + n, wo + (int64_t)(k0 + kk) * cout + n0 + n,
               k0 + kk < cin && n0 + n < cout, w);
    }
  }
}

// fp32: acc[i][j] += sum_kk A[ty + RG i][kk] * B[kk][col j]
template <int BN>
__device__ __forceinline__ void compute_stage(const float* __restrict__ As,
                                              const float* __restrict__ Bs,
                                              float (&acc)[Fma<BN>::TM][Fma<BN>::TN]) {
  using F = Fma<BN>;
  using S = Smem<float, BN>;
  const int tx = threadIdx.x % F::CG, ty = threadIdx.x / F::CG;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    float4 a[F::TM];
#pragma unroll
    for (int i = 0; i < F::TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty + F::RG * i) * S::AST + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float b[F::TN];
#pragma unroll
      for (int j4 = 0; j4 < F::TN / 4; ++j4) {
        const float4 v = *reinterpret_cast<const float4*>(
            Bs + (kk + q) * S::BST + j4 * 4 * F::CG + tx * 4);
        b[4 * j4] = v.x;
        b[4 * j4 + 1] = v.y;
        b[4 * j4 + 2] = v.z;
        b[4 * j4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < F::TM; ++i) {
        const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < F::TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

template <typename T, int BN> struct Acc;
template <int BN> struct Acc<float, BN> {
  float v[Fma<BN>::TM][Fma<BN>::TN];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < Fma<BN>::TM; ++i)
#pragma unroll
      for (int j = 0; j < Fma<BN>::TN; ++j) v[i][j] = 0.f;
  }
  __device__ __forceinline__ void add(const Acc& p) {
#pragma unroll
    for (int i = 0; i < Fma<BN>::TM; ++i)
#pragma unroll
      for (int j = 0; j < Fma<BN>::TN; ++j) v[i][j] += p.v[i][j];
  }
  // out[rows[r]][n0 + col] for the thread's rows and columns
  __device__ __forceinline__ void store(float* __restrict__ out, const int* __restrict__ rows,
                                        int n0, int cout) const {
    using F = Fma<BN>;
    const int tx = threadIdx.x % F::CG, ty = threadIdx.x / F::CG;
    const bool vec = cout % 4 == 0;
#pragma unroll
    for (int i = 0; i < F::TM; ++i) {
      const int row = rows[ty + F::RG * i];
      if (row < 0) continue;
      float* __restrict__ o = out + (int64_t)row * cout;
#pragma unroll
      for (int j4 = 0; j4 < F::TN / 4; ++j4) {
        const int c = n0 + j4 * 4 * F::CG + tx * 4;
        if (vec && c + 3 < cout) {
          *reinterpret_cast<float4*>(o + c) =
              make_float4(v[i][4 * j4], v[i][4 * j4 + 1], v[i][4 * j4 + 2], v[i][4 * j4 + 3]);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (c + jj < cout) o[c + jj] = v[i][4 * j4 + jj];
        }
      }
    }
  }
};
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
block_conv_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                  const T* __restrict__ w, const int32_t* __restrict__ list,
                  const int32_t* __restrict__ count, int32_t* __restrict__ ticket,
                  T* __restrict__ out, int n_blocks, int edge, int k, int cin,
                  int cout) {
  using S = Smem<T, BN>;
  constexpr int V = Elt<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);
  const int n_off = k * k * k;
  int* const s_src = reinterpret_cast<int*>(stage + 2 * S::kStage);  // [n_off][BM]
  int* const s_row = s_src + n_off * BM;                              // [BM]
  int* const s_hit = s_row + BM;                                      // [n_off]
  int* const s_off = s_hit + n_off;                                   // [n_off]
  __shared__ int s_item, s_active;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = (k - 1) / 2, e3 = edge * edge * edge;
  const int n_list = *count;
  const int n_tiles = (n_list + BM - 1) / BM;
  const int n_col = (cout + BN - 1) / BN;
  // too few tiles to fill the resident thread blocks: one column tile per
  // work item, else a tile with all its column tiles
  const int col_split = n_tiles < (int)gridDim.x ? n_col : 1;
  const int n_items = n_tiles * col_split;
  const int n_kc = (cin + BK - 1) / BK;
  const bool vec_a = cin % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = cout % V == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  for (;;) {
    if (tid == 0) s_item = atomicAdd(ticket, 1);
    __syncthreads();  // also: the last item's reads of shared memory are done
    const int item = s_item;
    if (item >= n_items) {
      // the last ticket taken: every block is done with the counter
      if (tid == 0 && item == n_items + (int)gridDim.x - 1) *ticket = 0;
      break;
    }
    const int m0 = item / col_split * BM;
    if (tid < BM) s_row[tid] = m0 + tid < n_list ? list[m0 + tid] : -1;
    for (int o = tid; o < n_off; o += kThreads) s_hit[o] = 0;
    __syncthreads();
    // the source table, once per tile; n_off * BM is a multiple of 32, so
    // each warp's lanes share one offset per step
    for (int e = tid; e < n_off * BM; e += kThreads) {
      const int o = e / BM, row = s_row[e % BM];
      int s = -1;
      if (row >= 0) {
        const int b = row / e3, c = row % e3;
        s = bdt::halo_row(nbr, n_blocks, b, edge, c / (edge * edge) + o / (k * k) - h,
                          (c / edge) % edge + (o / k) % k - h, c % edge + o % k - h);
      }
      s_src[e] = s;
      if (__any_sync(0xFFFFFFFFu, s >= 0) && lane == 0) s_hit[o] = 1;
    }
    __syncthreads();
    if (warp == 0) {  // the offsets with a source, ascending
      int n = 0;
      for (int o0 = 0; o0 < n_off; o0 += 32) {
        const bool hit = o0 + lane < n_off && s_hit[o0 + lane];
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, hit);
        if (hit) s_off[n + __popc(bal & ((1u << lane) - 1u))] = o0 + lane;
        n += __popc(bal);
      }
      if (lane == 0) s_active = n;
    }
    __syncthreads();
    const int n_stages = s_active * n_kc;
    const int c_first = col_split == 1 ? 0 : item % col_split;
    const int c_end = col_split == 1 ? n_col : c_first + 1;
    for (int ct = c_first; ct < c_end; ++ct) {
      const int n0 = ct * BN;
      // one offset's products go to part, then part is added to acc: the
      // plain version's order (one product per offset, summed ascending)
      Acc<T, BN> acc, part;
      acc.zero();
      part.zero();
      if (n_stages > 0) {
        load_stage<T, BN>(stage, stage + BM * S::AST, x, w, s_src + s_off[0] * BM,
                          s_off[0], 0, n0, cin, cout, vec_a, vec_b);
        cp_async_commit();
      }
      for (int st = 0; st < n_stages; ++st) {
        cp_async_wait_all();
        __syncthreads();  // stage st is visible; stage st - 1's buffer is free
        T* const cur = stage + (st & 1) * S::kStage;
        if (st + 1 < n_stages) {
          T* const nxt = stage + ((st + 1) & 1) * S::kStage;
          const int o = s_off[(st + 1) / n_kc];
          load_stage<T, BN>(nxt, nxt + BM * S::AST, x, w, s_src + o * BM, o,
                            ((st + 1) % n_kc) * BK, n0, cin, cout, vec_a, vec_b);
          cp_async_commit();
        }
        compute_stage<BN>(cur, cur + BM * S::AST, part.v);
        if ((st + 1) % n_kc == 0) {
          acc.add(part);
          part.zero();
        }
      }
      acc.store(out, s_row, n0, cout);
      __syncthreads();  // before the next column tile's first copies
    }
  }
}

template <typename T, int BN>
cudaError_t launch_conv(const void* x, const void* nbr, const void* w, int32_t* ws,
                        void* out, int n_blocks, int edge, int k, int cin, int cout,
                        cudaStream_t s) {
  auto kernel = block_conv_kernel<T, BN>;
  const size_t smem = Smem<T, BN>::bytes(k * k * k);
  const int n_rows = n_blocks * edge * edge * edge;
  const int64_t max_items = (int64_t)(n_rows + BM - 1) / BM * ((cout + BN - 1) / BN);
  int grid = 0;
  cudaError_t err = ntt::grid_of(kernel, kThreads, smem, max_items, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(nbr),
      static_cast<const T*>(w), ws, ws + n_rows, ws + n_rows + 1, static_cast<T*>(out),
      n_blocks, edge, k, cin, cout);
  return cudaGetLastError();
}

// BN: Cout itself up to 96 (rounded up to 32, 64 or 96), else 64; 32 on a
// level of fewer than 512 capacity tiles (a few hundred rows at a quarter
// fill), so that its column tiles spread over the SMs
template <typename T>
cudaError_t launch_bn(const void* x, const void* nbr, const void* w, int32_t* ws,
                      void* out, int n_blocks, int edge, int k, int cin, int cout,
                      cudaStream_t s) {
  const int max_tiles = (n_blocks * edge * edge * edge + BM - 1) / BM;
  if (cout <= 32 || max_tiles < kFewTiles)
    return launch_conv<T, 32>(x, nbr, w, ws, out, n_blocks, edge, k, cin, cout, s);
  if (cout <= 64 || cout > 96)
    return launch_conv<T, 64>(x, nbr, w, ws, out, n_blocks, edge, k, cin, cout, s);
  return launch_conv<T, 96>(x, nbr, w, ws, out, n_blocks, edge, k, cin, cout, s);
}

// ---------------------------------------------------------------------------
// the bf16 conv: warpgroup tiles (wgmma_tile.cuh)
// ---------------------------------------------------------------------------

// Work items are (tile, column tile, group): a tile's active offsets are
// cut into S contiguous groups.  S is 1 where the level's items number at
// least `target` (two per SM); else up to `split_cap` (the wrapper's
// scratch) so that they do.  Both this kernel and the group sum derive S
// from the row count on the card, the same way.  (Two per resident block
// instead split L0's and L1's levels too, and lost there: a second launch
// and the partials' round trip for items that already filled the card.)
__device__ __forceinline__ int wg_groups(int n_list, int n_col, int target,
                                        int split_cap) {
  const int base = (n_list + wgc::BM - 1) / wgc::BM * n_col;
  if (base == 0 || split_cap <= 1) return 1;
  return min(split_cap, max(1, (target + base - 1) / base));
}

// A tile's source table in shared memory: s_src[o][i] the dense row of row
// s_row[i]'s cell shifted by offset o through the block halo, -1 where none.
__device__ __forceinline__ void halo_table(int* __restrict__ s_src, const int* __restrict__ s_row,
                                           const int32_t* __restrict__ nbr, int n_blocks,
                                           int edge, int k, int n_off) {
  const int h = (k - 1) / 2, e3 = edge * edge * edge;
  for (int e = threadIdx.x; e < n_off * wgc::BM; e += wgc::kThreads) {
    const int o = e / wgc::BM, row = s_row[e % wgc::BM];
    int s = -1;
    if (row >= 0) {
      const int b = row / e3, c = row % e3;
      s = bdt::halo_row(nbr, n_blocks, b, edge, c / (edge * edge) + o / (k * k) - h,
                        (c / edge) % edge + (o / k) % k - h, c % edge + o % k - h);
    }
    s_src[e] = s;
  }
}

template <int BN>
__global__ void __launch_bounds__(wgc::kThreads)
block_conv_wg_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ nbr,
                     const __nv_bfloat16* __restrict__ w, const int32_t* __restrict__ list,
                     const int32_t* __restrict__ count, int32_t* __restrict__ ticket,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ scratch,
                     int n_rows, int n_blocks, int edge, int k, int cin, int cout,
                     int target, int split_cap, int vec_a, int vec_b) {
  using wgc::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const ring = wgc::ring_base(smem);
  const int n_off = k * k * k;
  int* const s_src = reinterpret_cast<int*>(smem + wgc::Ring<BN>::kBytes);  // [n_off][BM]
  int* const s_row = s_src + n_off * BM;                                    // [BM]
  int* const s_hit = s_row + BM;                                            // [n_off]
  int* const s_act = s_hit + n_off;                                         // [n_off]
  __shared__ int s_item, s_n_act;

  const int tid = threadIdx.x;
  const int n_list = *count;
  const int n_tiles = (n_list + BM - 1) / BM, n_col = (cout + BN - 1) / BN;
  const int groups = wg_groups(n_list, n_col, target, split_cap);
  const int n_items = n_tiles * n_col * groups;
  const int n_kc = (cin + wgc::BK - 1) / wgc::BK;
  const int64_t ld = (int64_t)n_col * BN;
  float acc[BN / 2];

  for (;;) {
    if (tid == 0) s_item = atomicAdd(ticket, 1);
    __syncthreads();  // also: the last item's reads of shared memory are done
    const int item = s_item;
    if (item >= n_items) {
      // the last ticket taken: every block is done with the counter
      if (tid == 0 && item == n_items + (int)gridDim.x - 1) *ticket = 0;
      break;
    }
    const int g = item % groups, ct = item / groups % n_col, m0 = item / groups / n_col * BM;
    if (tid < BM) s_row[tid] = m0 + tid < n_list ? list[m0 + tid] : -1;
    __syncthreads();
    halo_table(s_src, s_row, nbr, n_blocks, edge, k, n_off);
    __syncthreads();
    const int n_act = wgc::active_offsets(s_src, n_off, s_hit, s_act, &s_n_act);
    const int a0 = g * n_act / groups, a1 = (g + 1) * n_act / groups;
    auto stage = [&](int st) {
      const int o = s_act[a0 + st / n_kc];
      return wgc::Stage{s_src + o * BM, o, st % n_kc * wgc::BK};
    };
    wgc::mainloop<BN>(acc, ring, x, w, (a1 - a0) * n_kc, stage, ct * BN, cin, cout,
                      vec_a != 0, vec_b != 0);
    if (groups == 1)
      wgc::store_rows<BN>(acc, out, s_row, ct * BN, cout);
    else
      wgc::store_f32<BN>(acc, scratch + ((int64_t)g * n_rows + m0) * ld + ct * BN, ld,
                         min(BM, n_list - m0));
  }
}

// out[list[i]][c] = the groups' partials of list entry i added in ascending
// group order, rounded to bf16; nothing when the conv ran one group.  A
// thread adds 4 columns of one entry.
__global__ void __launch_bounds__(256)
group_sum_kernel(const float* __restrict__ scratch, const int32_t* __restrict__ list,
                 const int32_t* __restrict__ count, __nv_bfloat16* __restrict__ out, int n_rows,
                 int cout, int bn, int target, int split_cap) {
  const int n_list = *count, n_col = (cout + bn - 1) / bn;
  const int groups = wg_groups(n_list, n_col, target, split_cap);
  if (groups == 1) return;
  const int64_t ld = (int64_t)n_col * bn, q = ld / 4;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < (int64_t)n_list * q;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = e / q;
    const int c = (int)(e % q) * 4;
    if (c >= cout) continue;
    float4 s = *reinterpret_cast<const float4*>(scratch + i * ld + c);
    for (int g = 1; g < groups; ++g) {
      const float4 p = *reinterpret_cast<const float4*>(scratch + ((int64_t)g * n_rows + i) * ld + c);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    __nv_bfloat16* const o = out + (int64_t)list[i] * cout + c;
    const float v[4] = {s.x, s.y, s.z, s.w};
    for (int j = 0; j < 4 && c + j < cout; ++j) o[j] = __float2bfloat16(v[j]);
  }
}

template <int BN>
size_t wg_smem(int n_off) {
  return wgc::Ring<BN>::kBytes + sizeof(int) * ((size_t)n_off * wgc::BM + wgc::BM + 2 * n_off);
}

// the items the bf16 conv aims at: two per SM
cudaError_t wg_target(int* target) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached = 2 * sms;
  }
  *target = cached;
  return cudaSuccess;
}

// the resident blocks of the bf16 kernel at this shape, its item target,
// and the groups its scratch must hold (1: none)
template <int BN>
cudaError_t wg_grid(int n_rows, int k, int cout, int* grid, int* target, int* split_cap) {
  const int n_off = k * k * k;
  const int64_t cap_items = (int64_t)(n_rows + wgc::BM - 1) / wgc::BM * ((cout + BN - 1) / BN);
  cudaError_t err = ntt::grid_of(block_conv_wg_kernel<BN>, wgc::kThreads, wg_smem<BN>(n_off),
                                 INT32_MAX, grid);
  if (err == cudaSuccess) err = wg_target(target);
  if (err != cudaSuccess) return err;
  // a level's rows at a quarter of its cells (the levels' fill is 20-35%):
  // groups where those would not reach the target
  const int64_t est = cap_items / 4 > 0 ? cap_items / 4 : 1;
  const int64_t want = (*target + est - 1) / est;
  *split_cap = want < 1 ? 1 : want > kMaxGroups ? kMaxGroups : (int)want;
  return cudaSuccess;
}

template <int BN>
cudaError_t launch_wg(const void* x, const void* nbr, const void* w, int32_t* ws, void* out,
                      float* scratch, int split_cap, int n_blocks, int edge, int k, int cin,
                      int cout, cudaStream_t s) {
  const int n_rows = n_blocks * edge * edge * edge;
  int grid = 0, target = 0, cap = 0;
  cudaError_t err = wg_grid<BN>(n_rows, k, cout, &grid, &target, &cap);
  if (err != cudaSuccess) return err;
  if (split_cap > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  const bool vec_a = cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = cout % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  block_conv_wg_kernel<BN><<<grid, wgc::kThreads, wg_smem<BN>(k * k * k), s>>>(
      xb, static_cast<const int32_t*>(nbr), static_cast<const __nv_bfloat16*>(w), ws,
      ws + n_rows, ws + n_rows + 1, ob, scratch, n_rows, n_blocks, edge, k, cin, cout, target,
      split_cap, vec_a, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess || split_cap <= 1) return err;
  group_sum_kernel<<<264, 256, 0, s>>>(scratch, ws, ws + n_rows, ob, n_rows, cout, BN, target,
                                       split_cap);
  return cudaGetLastError();
}

cudaError_t wg_conv(const void* x, const void* nbr, const void* w, int32_t* ws, void* out,
                    float* scratch, int split_cap, int n_blocks, int edge, int k, int cin,
                    int cout, cudaStream_t s) {
  switch (wgc::pick_bn(cout)) {
    case 32:
      return launch_wg<32>(x, nbr, w, ws, out, scratch, split_cap, n_blocks, edge, k, cin, cout, s);
    case 64:
      return launch_wg<64>(x, nbr, w, ws, out, scratch, split_cap, n_blocks, edge, k, cin, cout, s);
    case 96:
      return launch_wg<96>(x, nbr, w, ws, out, scratch, split_cap, n_blocks, edge, k, cin, cout, s);
    default:
      return launch_wg<128>(x, nbr, w, ws, out, scratch, split_cap, n_blocks, edge, k, cin, cout,
                            s);
  }
}

// the groups the bf16 conv's scratch must hold at this shape (1: none)
cudaError_t wg_split_cap(int n_rows, int k, int cout, int* cap) {
  int grid = 0, target = 0;
  switch (wgc::pick_bn(cout)) {
    case 32: return wg_grid<32>(n_rows, k, cout, &grid, &target, cap);
    case 64: return wg_grid<64>(n_rows, k, cout, &grid, &target, cap);
    case 96: return wg_grid<96>(n_rows, k, cout, &grid, &target, cap);
    default: return wg_grid<128>(n_rows, k, cout, &grid, &target, cap);
  }
}

// ---------------------------------------------------------------------------
// the narrow path
// ---------------------------------------------------------------------------

template <typename T, int E, int K>
__global__ void __launch_bounds__(ntt::kThreads)
block_conv_narrow_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                         const T* __restrict__ w, const int32_t* __restrict__ list,
                         const int32_t* __restrict__ count, int32_t* __restrict__ ticket,
                         T* __restrict__ out, int n_blocks, int cin, int cout) {
  constexpr int n_off = K * K * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const ntt::Layout l = ntt::layout(n_off, cin, cout, sizeof(T) == 2);
  const ntt::Smem<T> s(smem, l);
  const bdt::HaloSrc<E, K> src{nbr, n_blocks};
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int n_list = *count, n_tiles = (n_list + ntt::BM - 1) / ntt::BM;
  ntt::stage_weights<T>(s, l, w, n_off, cin, cout);
  for (;;) {
    if (tid == 0) s_item = atomicAdd(ticket, 1);
    __syncthreads();  // also: the last tile's stores are done with s.row
    const int item = s_item;
    if (item >= n_tiles) {
      // the last ticket taken: every block is done with the counter
      if (tid == 0 && item == n_tiles + (int)gridDim.x - 1) *ticket = 0;
      break;
    }
    if (tid < ntt::BM) {
      const int m = item * ntt::BM + tid;
      s.row[tid] = s.key[tid] = m < n_list ? list[m] : -1;
    }
    __syncthreads();
    ntt::tile<T>(s, l, x, src, out, n_off, cin, cout);
  }
}

template <typename T, int E, int K>
cudaError_t launch_narrow(const void* x, const void* nbr, const void* w, int32_t* ws,
                          void* out, int n_blocks, int cin, int cout, cudaStream_t s) {
  auto kernel = block_conv_narrow_kernel<T, E, K>;
  const size_t smem = ntt::smem_bytes(K * K * K, cin, cout, sizeof(T) == 2);
  const int n_rows = n_blocks * E * E * E;
  int grid = 0;
  cudaError_t err =
      ntt::grid_of(kernel, ntt::kThreads, smem, (n_rows + ntt::BM - 1) / ntt::BM, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ntt::kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(nbr), static_cast<const T*>(w),
      ws, ws + n_rows, ws + n_rows + 1, static_cast<T*>(out), n_blocks, cin, cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t narrow_conv(const void* x, const void* nbr, const void* w, int32_t* ws, void* out,
                        int n_blocks, int edge, int k, int cin, int cout, cudaStream_t s) {
  auto launch = edge == 4 ? (k == 3 ? launch_narrow<T, 4, 3> : launch_narrow<T, 4, 5>)
                          : (k == 3 ? launch_narrow<T, 8, 3> : launch_narrow<T, 8, 5>);
  return launch(x, nbr, w, ws, out, n_blocks, cin, cout, s);
}

// ---------------------------------------------------------------------------
// the live-pair path: the live-pair list, the products, the sum
// ---------------------------------------------------------------------------

// The live-pair list's workspace (block_dense.py:live_workspace_size), for
// n_off offsets and a capacity of `cap` listed rows: src, dst and map
// (n_off x cap each), the counts (n_off), a ticket, the list passes'
// per-block counts (n_off x blocks), then the count pass's live bits
// (n_off x blocks x kListRows / 32 words).
struct LiveWs {
  int32_t *src, *dst, *map, *counts, *ticket, *block_counts;
  uint32_t* bits;
  __host__ __device__ LiveWs(int32_t* ws, int n_off, int cap) {
    const int64_t n = (int64_t)n_off * cap;
    const int blocks = cap > 0 ? (cap + kListRows - 1) / kListRows : 1;
    src = ws;
    dst = ws + n;
    map = ws + 2 * n;
    counts = ws + 3 * n;
    ticket = counts + n_off;
    block_counts = ticket + 1;
    bits = reinterpret_cast<uint32_t*>(block_counts + (int64_t)n_off * blocks);
  }
};

// The list passes walk a block's kListRows listed rows as 8 warps x 16
// chunks of 32 consecutive rows (a lane a row, so that a warp's loads of
// the row list and stores of the map are 128-byte lines).
constexpr int kChunks = kListRows / (kListThreads / 32) / 32;   // 16 a warp
static_assert(kChunks * 32 * (kListThreads / 32) == kListRows, "the passes' chunks");

// grid (blocks, n_off): the bits of each chunk of listed rows whose source
// cell at offset o is occupied, and each block's count of them
template <int E, int K>
__global__ void __launch_bounds__(kListThreads)
count_live_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ count,
                  const uint8_t* __restrict__ occ, bdt::HaloSrc<E, K> halo, int cap,
                  LiveWs ws) {
  __shared__ int warp_sums[kListThreads / 32];
  const int o = blockIdx.y, n_list = min(*count, cap);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i0 = (int64_t)blockIdx.x * kListRows + warp * kChunks * 32;
  uint32_t* const bits = ws.bits + ((int64_t)o * gridDim.x + blockIdx.x) * (kListRows / 32) +
                         warp * kChunks;
  int n = 0;
#pragma unroll 4
  for (int c = 0; c < kChunks; ++c) {
    const int64_t i = i0 + c * 32 + lane;
    const int r = i < n_list ? rows[i] : -1;
    const int src = r >= 0 ? halo(r, o) : -1;
    const unsigned live = __ballot_sync(0xFFFFFFFFu, src >= 0 && occ[src] != 0);
    if (lane == 0) bits[c] = live;
    n += __popc(live);
  }
  int total;
  block_exclusive_scan(lane == 0 ? n : 0, warp_sums, &total);
  if (threadIdx.x == 0) ws.block_counts[(int64_t)o * gridDim.x + blockIdx.x] = total;
}

// the pairs in list order: each block's offset over the blocks before it,
// each warp's over the warps before it, each lane's over the chunk's bits
// below it; the sources resolved again for the live rows alone
template <int E, int K>
__global__ void __launch_bounds__(kListThreads)
list_live_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ count,
                 bdt::HaloSrc<E, K> halo, int cap, LiveWs ws) {
  __shared__ int warp_sums[kListThreads / 32];
  const int o = blockIdx.y, n_list = min(*count, cap);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* oc = ws.block_counts + (int64_t)o * gridDim.x;
  const uint32_t* const bits = ws.bits +
      ((int64_t)o * gridDim.x + blockIdx.x) * (kListRows / 32) + warp * kChunks;
  int part = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += kListThreads) part += oc[i];
  int prefix;
  block_exclusive_scan(part, warp_sums, &prefix);
  const uint32_t mine = lane < kChunks ? bits[lane] : 0u;
  int n = __popc(mine);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(0xFFFFFFFFu, n, d);
  int total;
  int pos = prefix + block_exclusive_scan(lane == 0 ? n : 0, warp_sums, &total);
  pos = __shfl_sync(0xFFFFFFFFu, pos, 0);
  const int64_t i0 = (int64_t)blockIdx.x * kListRows + warp * kChunks * 32;
  const int64_t base = (int64_t)o * cap;
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < kChunks; ++c) {
    const int64_t i = i0 + c * 32 + lane;
    const uint32_t live = __shfl_sync(0xFFFFFFFFu, mine, c);
    const bool in = (live >> lane) & 1u;
    const int p = pos + __popc(live & below);
    if (i < n_list) ws.map[base + i] = in ? p : -1;
    if (in) {
      const int r = rows[i];
      ws.src[base + p] = halo(r, o);
      ws.dst[base + p] = r;
    }
    pos += __popc(live);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    ws.counts[o] = prefix + total;
    if (o == 0) *ws.ticket = 0;
  }
}

template <int E, int K>
cudaError_t launch_live_list(const int32_t* rows_ws, const uint8_t* occ, const int32_t* nbr,
                             int32_t* live_ws, int n_blocks, int cap, cudaStream_t s) {
  const int n_rows = n_blocks * E * E * E, n_off = K * K * K;
  const bdt::HaloSrc<E, K> halo{nbr, n_blocks};
  const dim3 grid(cap > 0 ? (cap + kListRows - 1) / kListRows : 1, n_off);
  const LiveWs ws(live_ws, n_off, cap);
  count_live_kernel<E, K><<<grid, kListThreads, 0, s>>>(rows_ws, rows_ws + n_rows, occ, halo,
                                                        cap, ws);
  list_live_kernel<E, K><<<grid, kListThreads, 0, s>>>(rows_ws, rows_ws + n_rows, halo, cap,
                                                       ws);
  return cudaGetLastError();
}

// pair j of offset o: its source row in the list
struct ListSource {
  const int32_t* src;
  int cap;
  __device__ __forceinline__ int operator()(int o, int j, int, int) const {
    return src[(int64_t)o * cap + j];
  }
};

// the products of the live pairs (pair_major.cuh, K1's form): fp32 on the
// FMA core, bf16 on the warpgroup core
template <int BN>
__global__ void __launch_bounds__(gtt::kThreads)
live_products_kernel(const float* __restrict__ x, const float* __restrict__ w, LiveWs ws,
                     float* __restrict__ partial, int cap, int cin, int cout, int n_off) {
  pmc::products<float, BN>(x, w, ws.counts, ws.ticket, partial, cin, cout, n_off,
                           ListSource{ws.src, cap});
}

template <int BN>
__global__ void __launch_bounds__(wgc::kThreads)
live_products_wg_kernel(const wgc::bf16* __restrict__ x, const wgc::bf16* __restrict__ w,
                        LiveWs ws, float* __restrict__ partial, int cap, int cin, int cout,
                        int n_off, int vec_a, int vec_b) {
  pmc::products_wg<BN>(x, w, ws.counts, ws.ticket, partial, cin, cout, n_off, vec_a != 0,
                       vec_b != 0, ListSource{ws.src, cap});
}

// out[rows[i]][c .. c + 7] = the live products of listed row i added in
// ascending offset order (through map), four threads a row, eight columns
// each (c = 32 blockIdx.y + 8 (tid % 4)), the offsets' map reads eight at
// a time; first[] (the pairs before each offset) is a scan of the counts
template <typename T>
__global__ void __launch_bounds__(kListThreads)
live_sum_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ count, LiveWs ws,
                const float* __restrict__ partial, int ld, T* __restrict__ out, int cap,
                int cout, int n_off) {
  __shared__ int warp_sums[kListThreads / 32];
  __shared__ int s_first[kListThreads];
  const int tid = threadIdx.x;
  int total;
  const int first = block_exclusive_scan(tid < n_off ? ws.counts[tid] : 0, warp_sums, &total);
  s_first[tid] = first;
  __syncthreads();
  const int n_list = min(*count, cap);
  const int64_t i = (int64_t)blockIdx.x * (kListThreads / 4) + tid / 4;
  const int c = 32 * blockIdx.y + (tid % 4) * 8;
  if (i >= n_list || c >= cout) return;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int o0 = 0; o0 < n_off; o0 += 8) {
    int p[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      p[t] = o0 + t < n_off ? ws.map[(int64_t)(o0 + t) * cap + i] : -1;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (p[t] < 0) continue;
      const float4* src =
          reinterpret_cast<const float4*>(partial + (int64_t)(s_first[o0 + t] + p[t]) * ld + c);
      const float4 a = src[0], b = src[1];
      acc[0] += a.x;
      acc[1] += a.y;
      acc[2] += a.z;
      acc[3] += a.w;
      acc[4] += b.x;
      acc[5] += b.y;
      acc[6] += b.z;
      acc[7] += b.w;
    }
  }
  T* const row = out + (int64_t)rows[i] * cout;
  gtt::store4(row, c, cout, make_float4(acc[0], acc[1], acc[2], acc[3]));
  if (c + 4 < cout) gtt::store4(row, c + 4, cout, make_float4(acc[4], acc[5], acc[6], acc[7]));
}

// the pair-major buffer's row width for Cout (a multiple of 32)
int live_stride(int cout, int dtype) {
  const int bn = dtype == 1 ? wgc::pick_bn(cout) : gtt::pair_bn(cout);
  return (cout + bn - 1) / bn * bn;
}

template <int BN>
cudaError_t live_products(const void* x, const void* w, const LiveWs& ws, float* partial,
                          int cap, int cin, int cout, int n_off, int dtype, cudaStream_t s) {
  const int n_col = (cout + BN - 1) / BN;
  const int64_t max_items = (int64_t)((cap + gtt::BM - 1) / gtt::BM) * n_off * n_col;
  int grid = 0;
  if (dtype == 1) {
    auto kernel = live_products_wg_kernel<BN>;
    const size_t smem = pmc::smem_bytes_wg<BN>(n_off);
    cudaError_t err = ntt::grid_of(kernel, wgc::kThreads, smem, max_items, &grid);
    if (err != cudaSuccess) return err;
    const int vec_a = cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const int vec_b = cout % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    kernel<<<grid, wgc::kThreads, smem, s>>>(static_cast<const wgc::bf16*>(x),
                                             static_cast<const wgc::bf16*>(w), ws, partial, cap,
                                             cin, cout, n_off, vec_a, vec_b);
    return cudaGetLastError();
  }
  if constexpr (BN <= 96) {
    auto kernel = live_products_kernel<BN>;
    const size_t smem = pmc::smem_bytes<float, BN>(n_off);
    cudaError_t err = ntt::grid_of(kernel, gtt::kThreads, smem, max_items, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, gtt::kThreads, smem, s>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(w), ws, partial, cap,
                                             cin, cout, n_off);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

cudaError_t live_conv(const void* x, const void* w, const int32_t* rows_ws, int32_t* live_ws,
                      float* partial, void* out, int n_rows, int cap, int n_off, int cin,
                      int cout, int dtype, cudaStream_t s) {
  const LiveWs ws(live_ws, n_off, cap);
  const int bn = dtype == 1 ? wgc::pick_bn(cout) : gtt::pair_bn(cout);
  cudaError_t err;
  switch (bn) {
    case 32: err = live_products<32>(x, w, ws, partial, cap, cin, cout, n_off, dtype, s); break;
    case 64: err = live_products<64>(x, w, ws, partial, cap, cin, cout, n_off, dtype, s); break;
    case 96: err = live_products<96>(x, w, ws, partial, cap, cin, cout, n_off, dtype, s); break;
    default: err = live_products<128>(x, w, ws, partial, cap, cin, cout, n_off, dtype, s);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((cap + kListThreads / 4 - 1) / (kListThreads / 4), (cout + 31) / 32);
  const int ld = live_stride(cout, dtype);
  if (dtype == 1)
    live_sum_kernel<__nv_bfloat16><<<grid, kListThreads, 0, s>>>(
        rows_ws, rows_ws + n_rows, ws, partial, ld, static_cast<__nv_bfloat16*>(out), cap, cout,
        n_off);
  else
    live_sum_kernel<float><<<grid, kListThreads, 0, s>>>(
        rows_ws, rows_ws + n_rows, ws, partial, ld, static_cast<float*>(out), cap, cout, n_off);
  return cudaGetLastError();
}

}  // namespace

// The row list alone: ws[0:count] the mask's rows ascending (every row
// when mask is null), ws[n_rows] the count.  Returns the launches'
// cudaError_t.
extern "C" int block_rows(const void* mask, void* ws, int n_rows, void* stream) {
  return static_cast<int>(launch_rows(mask, static_cast<int32_t*>(ws), n_rows,
                                      static_cast<cudaStream_t>(stream)));
}

// out[r] = 1 where row r's k^3 window (through block_nbr) holds a masked
// row, and in ws (block_rows' layout) the list of out's rows, as
// block_rows gives it.  mask and out 8-byte aligned.  Returns the launches'
// cudaError_t.
extern "C" int block_dilate(const void* mask, const void* block_nbr, void* out, void* ws,
                            int n_blocks, int edge, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* wsi = static_cast<int32_t*>(ws);
  if (n_blocks == 0) return static_cast<int>(launch_rows(out, wsi, 0, s));
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int32_t* nbr = static_cast<const int32_t*>(block_nbr);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaError_t err = cudaErrorInvalidValue;
  if (edge == 4 && k == 3) err = launch_dilate<4, 3>(m, nbr, o, wsi, n_blocks, s);
  if (edge == 4 && k == 5) err = launch_dilate<4, 5>(m, nbr, o, wsi, n_blocks, s);
  if (edge == 8 && k == 3) err = launch_dilate<8, 3>(m, nbr, o, wsi, n_blocks, s);
  if (edge == 8 && k == 5) err = launch_dilate<8, 5>(m, nbr, o, wsi, n_blocks, s);
  return static_cast<int>(err);
}

namespace {

cudaError_t conv(const void* x, const void* nbr, const void* w, int32_t* ws, void* out,
                 void* scratch, int split_cap, int n_blocks, int edge, int k, int cin, int cout,
                 int dtype, int narrow, cudaStream_t s) {
  if (narrow && (cin < 1 || cin > ntt::kMaxCin)) return cudaErrorInvalidValue;
  if (narrow)
    return dtype == 1
        ? narrow_conv<__nv_bfloat16>(x, nbr, w, ws, out, n_blocks, edge, k, cin, cout, s)
        : narrow_conv<float>(x, nbr, w, ws, out, n_blocks, edge, k, cin, cout, s);
  if (dtype == 1)
    return wg_conv(x, nbr, w, ws, out, static_cast<float*>(scratch), split_cap, n_blocks, edge,
                   k, cin, cout, s);
  return launch_bn<float>(x, nbr, w, ws, out, n_blocks, edge, k, cin, cout, s);
}

}  // namespace

// The offset groups the bf16 conv's scratch must hold at this shape: 1
// (no scratch), or up to kMaxGroups, each (n_blocks * edge^3) x (Cout
// rounded up to the column tile) fp32.  Negative: a cudaError_t.
extern "C" int block_conv_split_cap(int n_blocks, int edge, int k, int cout) {
  int cap = 1;
  const cudaError_t err = wg_split_cap(n_blocks * edge * edge * edge, k, cout, &cap);
  return err == cudaSuccess ? cap : -static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16; mask may be null (every row); narrow:
// the narrow path; scratch and split_cap: the bf16 conv's offset groups
// (block_conv_split_cap; a test may ask for more or fewer), scratch null
// when split_cap is 1.  Rows outside the mask are left as they are: the
// caller zeroes out first.  Returns the launches' cudaError_t.
extern "C" int block_conv(const void* x, const void* block_nbr, const void* w,
                          const void* mask, void* ws, void* out, void* scratch, int split_cap,
                          int n_blocks, int edge, int k, int cin, int cout, int dtype,
                          int narrow, void* stream) {
  if (n_blocks == 0 || cout == 0) return 0;
  if ((edge != 4 && edge != 8) || (k != 3 && k != 5)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* wsi = static_cast<int32_t*>(ws);
  cudaError_t err = launch_rows(mask, wsi, n_blocks * edge * edge * edge, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(conv(x, block_nbr, w, wsi, out, scratch, split_cap, n_blocks, edge, k,
                               cin, cout, dtype, narrow, s));
}

// The live-pair list of an occupied-row list (block_rows' ws of n_blocks *
// edge^3 rows) into live_ws (block_dense.py:live_workspace_size of k^3
// offsets and `cap` listed rows, cap >= the list's count): per offset, in
// ascending list order, the listed rows whose source cell through the
// block halo is occupied in mask (src: the source row, dst: the listed
// row), map[o][i] the pair of listed row i at offset o (-1: none), the
// counts, a zero ticket.  Two launches; the counts stay on the card.
// Returns the launches' cudaError_t.
extern "C" int block_live_pairs(const void* rows_ws, const void* mask, const void* block_nbr,
                                void* live_ws, int n_blocks, int edge, int k, int cap,
                                void* stream) {
  if ((edge != 4 && edge != 8) || (k != 3 && k != 5) || cap < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* rows = static_cast<const int32_t*>(rows_ws);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int32_t* nbr = static_cast<const int32_t*>(block_nbr);
  int32_t* ws = static_cast<int32_t*>(live_ws);
  cudaError_t err = cudaErrorInvalidValue;
  if (edge == 4 && k == 3) err = launch_live_list<4, 3>(rows, m, nbr, ws, n_blocks, cap, s);
  if (edge == 4 && k == 5) err = launch_live_list<4, 5>(rows, m, nbr, ws, n_blocks, cap, s);
  if (edge == 8 && k == 3) err = launch_live_list<8, 3>(rows, m, nbr, ws, n_blocks, cap, s);
  if (edge == 8 && k == 5) err = launch_live_list<8, 5>(rows, m, nbr, ws, n_blocks, cap, s);
  return static_cast<int>(err);
}

// The row width of the live-pair path's fp32 buffer for Cout.  dtype: 0 =
// float32, 1 = bfloat16.
extern "C" int block_conv_live_stride(int cout, int dtype) { return live_stride(cout, dtype); }

// The conv on its live pairs: out[r] = sum over listed row r's live pairs
// (o ascending) of x[src] @ w[o], for x zero outside the mask the list was
// built on.  rows_ws: the occupied-row list (n_rows rows); live_ws: its
// live-pair list (block_live_pairs, its ticket 0, as every call leaves
// it); partial: (k^3 * cap, block_conv_live_stride) fp32 scratch.  Rows
// outside the list are left as they are (the caller zeroes out).  Returns
// the launches' cudaError_t.
extern "C" int block_conv_live(const void* x, const void* w, const void* rows_ws, void* live_ws,
                               void* partial, void* out, int n_rows, int cap, int k, int cin,
                               int cout, int dtype, void* stream) {
  if (cap == 0 || cout == 0) return 0;
  if ((k != 3 && k != 5) || cin < 1) return cudaErrorInvalidValue;
  return static_cast<int>(live_conv(x, w, static_cast<const int32_t*>(rows_ws),
                                    static_cast<int32_t*>(live_ws), static_cast<float*>(partial),
                                    out, n_rows, cap, k * k * k, cin, cout, dtype,
                                    static_cast<cudaStream_t>(stream)));
}

// The same over a row list built before (block_rows or block_dilate into
// ws, its ticket 0, as every conv leaves it): no list passes.
extern "C" int block_conv_rows(const void* x, const void* block_nbr, const void* w,
                               void* ws, void* out, void* scratch, int split_cap, int n_blocks,
                               int edge, int k, int cin, int cout, int dtype, int narrow,
                               void* stream) {
  if (n_blocks == 0 || cout == 0) return 0;
  if ((edge != 4 && edge != 8) || (k != 3 && k != 5)) return cudaErrorInvalidValue;
  return static_cast<int>(conv(x, block_nbr, w, static_cast<int32_t*>(ws), out, scratch,
                               split_cap, n_blocks, edge, k, cin, cout, dtype, narrow,
                               static_cast<cudaStream_t>(stream)));
}
