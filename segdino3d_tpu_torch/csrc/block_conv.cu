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
//      each thread an interleaved TM x TN sub-tile; bf16 with
//      mma.sync.m16n8k16 tensor-core tiles (ldmatrix), fp32 sums.  The
//      caller zeroes the output first when it passes a mask.
// The order of each output's sums is fixed whatever tile or thread block
// computes it: an offset's products over Cin (slices, then channels,
// ascending) into a partial sum, the partials added in ascending offset
// order, as the plain version adds its per-offset products.  This keeps
// the kernel's rounding close to the plain version's, which a small
// training step amplifies (PERF.md section 6).  No atomics touch the
// output, so a run is deterministic.
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

template <typename T> struct Elt;
template <> struct Elt<float> { static constexpr int kVec = 4, kPad = 4; };
template <> struct Elt<__nv_bfloat16> { static constexpr int kVec = 8, kPad = 8; };

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
// in fp32, a plain load in bf16 (no async copy is narrower than 4 bytes)
__device__ __forceinline__ void copy_one(float* dst, const float* src, bool ok,
                                         const float* any) {
  cp_async4(dst, ok ? src : any, ok ? 4 : 0);
}
__device__ __forceinline__ void copy_one(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                         bool ok, const __nv_bfloat16*) {
  *dst = ok ? *src : from_f<__nv_bfloat16>(0.f);
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: warp w owns rows 16 w .. 16 w + 15 and every column, BN / 8 n8 tiles
template <int BN>
__device__ __forceinline__ void compute_stage(const __nv_bfloat16* __restrict__ As,
                                              const __nv_bfloat16* __restrict__ Bs,
                                              float (&acc)[BN / 8][4]) {
  using S = Smem<__nv_bfloat16, BN>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, As + (16 * warp + (lane & 15)) * S::AST + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < BN / 8; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Bs + (kk + (lane & 15)) * S::BST + nt * 8 + (lane >> 4) * 8);
      mma_bf16(acc[nt], a, b[0], b[1]);
      mma_bf16(acc[nt + 1], a, b[2], b[3]);
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
template <int BN> struct Acc<__nv_bfloat16, BN> {
  float v[BN / 8][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[t][q] = 0.f;
  }
  __device__ __forceinline__ void add(const Acc& p) {
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[t][q] += p.v[t][q];
  }
  // mma accumulator: v[t][2 h + e] is row 16 w + lane / 4 + 8 h, column
  // t * 8 + 2 (lane % 4) + e
  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ out,
                                        const int* __restrict__ rows, int n0,
                                        int cout) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bool pair = cout % 2 == 0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rows[16 * warp + lane / 4 + 8 * hh];
      if (row < 0) continue;
      __nv_bfloat16* __restrict__ o = out + (int64_t)row * cout;
#pragma unroll
      for (int t = 0; t < BN / 8; ++t) {
        const int c = n0 + t * 8 + 2 * (lane % 4);
        if (pair && c + 1 < cout) {
          *reinterpret_cast<__nv_bfloat162*>(o + c) =
              __floats2bfloat162_rn(v[t][2 * hh], v[t][2 * hh + 1]);
        } else {
          if (c < cout) o[c] = from_f<__nv_bfloat16>(v[t][2 * hh]);
          if (c + 1 < cout) o[c + 1] = from_f<__nv_bfloat16>(v[t][2 * hh + 1]);
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
  const int n_off = k * k * k;
  const size_t smem = Smem<T, BN>::bytes(n_off);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  static int per_sm[2] = {0, 0};  // resident thread blocks per SM, k = 3 and 5
  int& fit = per_sm[k == 5];
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  const int n_rows = n_blocks * edge * edge * edge;
  const int64_t max_items = (int64_t)(n_rows + BM - 1) / BM * ((cout + BN - 1) / BN);
  const int grid = max_items < sms * fit ? (int)max_items : sms * fit;
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
                 int n_blocks, int edge, int k, int cin, int cout, int dtype,
                 cudaStream_t s) {
  return dtype == 1
      ? launch_bn<__nv_bfloat16>(x, nbr, w, ws, out, n_blocks, edge, k, cin, cout, s)
      : launch_bn<float>(x, nbr, w, ws, out, n_blocks, edge, k, cin, cout, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mask may be null (every row).  Rows
// outside the mask are left as they are: the caller zeroes out first.
// Returns the launches' cudaError_t.
extern "C" int block_conv(const void* x, const void* block_nbr, const void* w,
                          const void* mask, void* ws, void* out, int n_blocks, int edge,
                          int k, int cin, int cout, int dtype, void* stream) {
  if (n_blocks == 0 || cout == 0) return 0;
  if ((edge != 4 && edge != 8) || (k != 3 && k != 5)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* wsi = static_cast<int32_t*>(ws);
  cudaError_t err = launch_rows(mask, wsi, n_blocks * edge * edge * edge, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(conv(x, block_nbr, w, wsi, out, n_blocks, edge, k, cin, cout,
                               dtype, s));
}

// The same over a row list built before (block_rows or block_dilate into
// ws, its ticket 0, as every conv leaves it): no list passes.
extern "C" int block_conv_rows(const void* x, const void* block_nbr, const void* w,
                               void* ws, void* out, int n_blocks, int edge, int k, int cin,
                               int cout, int dtype, void* stream) {
  if (n_blocks == 0 || cout == 0) return 0;
  if ((edge != 4 && edge != 8) || (k != 3 && k != 5)) return cudaErrorInvalidValue;
  return static_cast<int>(conv(x, block_nbr, w, static_cast<int32_t*>(ws), out, n_blocks,
                               edge, k, cin, cout, dtype,
                               static_cast<cudaStream_t>(stream)));
}
