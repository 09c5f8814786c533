// The narrow-input weight-gradient core of K4 (gather_wgrad.cu) and K11
// (block_wgrad.cu): dW[o] = sum_r x[src(r, o)]^T @ dY[r] over a list of
// rows r when Cin is a few channels (the Baseline's k5 stem, rgb 3 -> 32).
//
// The wide core (wgrad_tile.cuh) runs one work item per (split, offset, M
// tile, N tile).  At Cin 3 that gives Cin its 64-row M tile, so 61 of 64
// A-columns of every stage are zero, and each of the 125 offsets stages
// every listed dY row again: about 125 x 12 MB through shared memory for
// 12,000 outputs.  K4 also built a pair list of the whole 125 x 92,160
// table for itself alone (K1's narrow forward takes none).  This core is
// the transpose of the JAX package's im2col form
// (segdino3d_tpu/ops/sparse_conv.py:346-358: dW as X^T of the im2col
// patch): one product of K = rows over M = n_off * Cin and N = Cout, tiled
// for Hopper.  What bounds it: the gathers, a (row, offset) source and its
// Cin values each, as in the narrow forward (narrow_tile.cuh), and in fp32
// the FMAs, 2 * rows * n_off * Cin * Cout (every offset of every listed
// row is multiplied; an absent source is a zero row), with their shared
// loads; a block's gathers and products alternate behind its barriers and
// overlap only across the SM's blocks.  The design:
//   * a work item is (a chunk of G offsets, a column tile of 32, a split
//     of rows); the chunks are the narrow forward's (ntt::layout: G * Cin
//     at most 48 packed channels in fp32, 64 in bf16; 8 chunks at Cin 3),
//     the splits the wide core's (wgt::split_of over the row count and the
//     scratch's split capacity, on the card, so no count leaves it), the
//     capacity cut to what keeps every item resident at once (the items
//     of a split cost alike, so a second, partial wave takes as long as
//     the first).  One thread block an item, no ticket: the grid is
//     (chunks x column tiles, splits), and a block past the splits in use
//     returns at once;
//   * a block walks its split's rows in tiles of BM = 128: it stages the
//     tile's dY rows (BM x 32, 16-byte async copies) and gathers the
//     im2col tile of the chunk's G offsets (BM x G * Cin) with
//     narrow_tile.cuh's loads (place), each thread one row's G sources,
//     eight at a time: K4 through its table (ntt::TableSrc), K11 through
//     the halo (bdt::HaloSrc).  Resolving K4's sources a tile ahead, as
//     K1's forward does, held 16 more registers across the products,
//     spilled and ran slower.  dY is so read once per chunk (8 times at
//     Cin 3), not once per offset;
//   * the block holds the chunk's (G * Cin) x 32 block of dW in registers
//     across its rows: fp32 on FMAs, thread t the dW rows 3 (t / 8) + {0,
//     1, 2} and columns 4 (t % 8) + {0..3}, 12 sums over the rows in
//     ascending order (3 scalar and one 16-byte shared load to 12 FMAs);
//     bf16 on mma.sync.m16n8k16 with the rows as the K axis (ldmatrix.trans
//     of both k-major tiles), fp32 sums, warp w the columns 8 w .. 8 w + 7
//     of every 16-row M tile;
//   * each split writes its partial into the wide core's scratch (splits x
//     n_off x Cin x Cout fp32), and wgt::sum_splits_kernel adds the
//     partials of each offset in ascending split order.  No float atomics,
//     so two calls give bit-equal dW.
// So an fp32 dW entry is: per split, its rows' products added in ascending
// row order (one FMA each), then the splits added in ascending order.
#pragma once

#include "narrow_tile.cuh"
#include "wgrad_tile.cuh"

namespace nwt {

constexpr int BM = ntt::BM;          // rows a tile (the K axis)
constexpr int BN = ntt::BN;          // dW columns a column tile
constexpr int kThreads = ntt::kThreads;
static_assert(kThreads == BM, "a thread gathers one row of a tile");
static_assert(BN == 32, "fp32: 8 column groups of 4; bf16: 4 warps of 8 columns");

// The shared-memory layout of a shape: the narrow forward's chunks and
// im2col tile (no weight), then the dY tile.  ops/narrow.py:wgrad_layout
// mirrors it.
struct Layout {
  ntt::Layout l;   // g, kc, ast, chunks (kp = 0: no weight rows)
  int dst;         // the dY tile's row stride, elements
  int col_tiles;
};

__host__ __device__ __forceinline__ Layout layout(int n_off, int cin, int cout, bool bf16) {
  Layout w;
  w.l = ntt::layout(n_off, cin, cout, bf16);
  w.l.kp = 0;
  w.dst = bf16 ? BN + 8 : BN;   // bf16: 80-byte rows, 8 ldmatrix rows in 8 bank groups
  w.col_tiles = (cout + BN - 1) / BN;
  return w;
}

// Dynamic shared memory of a block: the im2col tile and the dY tile (at
// most 41,472 bytes in fp32, 28,672 in bf16: under the 48 KB default).
__host__ __device__ __forceinline__ size_t smem_bytes(int n_off, int cin, int cout,
                                                      bool bf16) {
  const Layout w = layout(n_off, cin, cout, bf16);
  return (bf16 ? 2 : 4) * (size_t)BM * (w.l.ast + w.dst);
}

// This thread's row `key` (-1: none) at offsets u0 .. u0 + P - 1 of chunk
// (o0, g): the sources, -1 where absent or past the chunk.
template <int P, class Src>
__device__ __forceinline__ void resolve(int (&sr)[P], int key, const Src& src, int o0, int g,
                                        int u0) {
#pragma unroll
  for (int u = 0; u < P; ++u)
    sr[u] = key >= 0 && u0 + u < g ? src(key, o0 + u0 + u) : -1;
}

// This thread's row of the im2col tile (row slot threadIdx.x), its
// sources resolved eight at a time and each eight's rows loaded before the
// next eight resolve, then zeros to the chunk's kc.  Returns whether one
// of its sources exists.  (narrow_tile.cuh's gather, which reads each
// row's key from the tile slots in shared memory, ran slower here.)
template <typename T, int CIN, class Src>
__device__ __forceinline__ int gather_row(const ntt::Smem<T>& s, const ntt::Layout& l,
                                          const T* __restrict__ x, const Src& src, int key,
                                          int o0, int g) {
  int any = 0;
#pragma unroll 1
  for (int u0 = 0; u0 < ntt::kPairs; u0 += 8) {
    int part[8];
    nwt::resolve<8>(part, key, src, o0, g, u0);
    any |= ntt::place<T, CIN, 8>(s, l, x, part, g, u0);
  }
  T* const a = s.a + threadIdx.x * l.ast;
  for (int j = g * CIN; j < l.kc; ++j) a[j] = ntt::zero<T>();
  return any;
}

template <typename T, class Src>
__device__ __forceinline__ int fill_row(const ntt::Smem<T>& s, const ntt::Layout& l,
                                        const T* __restrict__ x, const Src& src, int key,
                                        int o0, int g, int cin) {
  switch (cin) {
    case 1: return gather_row<T, 1>(s, l, x, src, key, o0, g);
    case 2: return gather_row<T, 2>(s, l, x, src, key, o0, g);
    case 3: return gather_row<T, 3>(s, l, x, src, key, o0, g);
    case 4: return gather_row<T, 4>(s, l, x, src, key, o0, g);
    case 5: return gather_row<T, 5>(s, l, x, src, key, o0, g);
    case 6: return gather_row<T, 6>(s, l, x, src, key, o0, g);
    case 7: return gather_row<T, 7>(s, l, x, src, key, o0, g);
    default: return gather_row<T, 8>(s, l, x, src, key, o0, g);
  }
}

// The dY tile: dyt[i][c] = dy[rows.key(p0 + i)][n0 + c] for i < n, zero
// past n or Cout; 16-byte async copies where Cout and dy's address allow,
// else plain loads.
template <typename T, class Rows>
__device__ __forceinline__ void stage_dy(T* __restrict__ dyt, int dst, const T* __restrict__ dy,
                                         const Rows& rows, int p0, int n, int n0, int cout,
                                         bool vec) {
  constexpr int V = 16 / sizeof(T), P = BN / V;   // 16-byte pieces a row
  if (vec) {
    for (int e = threadIdx.x; e < BM * P; e += kThreads) {
      const int i = e / P, c = (e % P) * V;
      const int r = i < n ? rows.key(p0 + i) : -1;
      const bool ok = r >= 0 && n0 + c < cout;
      wgt::cp_async16(dyt + i * dst + c, ok ? dy + (int64_t)r * cout + n0 + c : dy,
                      ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
      const int i = e / BN, c = e % BN;
      const int r = i < n ? rows.key(p0 + i) : -1;
      dyt[i * dst + c] =
          r >= 0 && n0 + c < cout ? dy[(int64_t)r * cout + n0 + c] : ntt::zero<T>();
    }
  }
  wgt::cp_async_commit();
}

template <typename T> struct Acc;

// fp32: v[i][j] is dW row 3 (tid / 8) + i of the chunk, column n0 + 4
// (tid % 8) + j
template <> struct Acc<float> {
  float v[3][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
  }
  // rows 0 .. n - 1 of the tiles, ascending; a dW row past kc reads
  // column kc - 1 and is never stored
  __device__ __forceinline__ void rows(const float* __restrict__ a,
                                       const float* __restrict__ dyt, const Layout& w, int n) {
    const int mg = threadIdx.x / 8, ng = threadIdx.x % 8;
    int m[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) m[i] = min(3 * mg + i, w.l.kc - 1);
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float* const ak = a + k * w.l.ast;
      const float4 b4 = *reinterpret_cast<const float4*>(dyt + k * w.dst + 4 * ng);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float av = ak[m[i]];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = fmaf(av, b[j], v[i][j]);
      }
    }
  }
  // into out's dW rows 0 .. used - 1 (the chunk's, row (o - o0) * Cin + c)
  __device__ __forceinline__ void store(float* __restrict__ out, int used, int n0,
                                        int cout) const {
    const int mg = threadIdx.x / 8, ng = threadIdx.x % 8;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int m = 3 * mg + i;
      if (m >= used) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 4 * ng + j;
        if (c < cout) out[(int64_t)m * cout + c] = v[i][j];
      }
    }
  }
};

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// bf16: mma accumulators, v[t][2 h + e] is dW row 16 t + lane / 4 + 8 h of
// the chunk, column n0 + 8 warp + 2 (lane % 4) + e
template <> struct Acc<__nv_bfloat16> {
  float v[4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[t][q] = 0.f;
  }
  // rows 0 .. n - 1 in steps of 16 (the tiles are zero past n); both tiles
  // k-major, so A's row-major fragments and B's column-major ones both
  // come from ldmatrix.trans (as wgrad_tile.cuh's MmaAcc)
  __device__ __forceinline__ void rows(const __nv_bfloat16* __restrict__ a,
                                       const __nv_bfloat16* __restrict__ dyt, const Layout& w,
                                       int n) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int m_tiles = w.l.kc / 16;
    // A: matrix q = lane / 8 holds m + 8 (q & 1), k + 8 (q >> 1)
    const int ak = (lane & 7) + ((lane >> 4) << 3), am = ((lane >> 3) & 1) * 8;
    for (int kk = 0; kk < n; kk += 16) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, dyt + (kk + (lane & 15)) * w.dst + 8 * warp);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < m_tiles) {
          uint32_t af[4];
          ntt::ldmatrix_x4_trans(af, a + (kk + ak) * w.l.ast + 16 * t + am);
          ntt::mma_bf16(v[t], af, b[0], b[1]);
        }
      }
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ out, int used, int n0,
                                        int cout) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * t + lane / 4 + 8 * h;
        if (m >= used) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + 8 * warp + 2 * (lane % 4) + e;
          if (c < cout) out[(int64_t)m * cout + c] = v[t][2 * h + e];
        }
      }
  }
};

// One work item, blockIdx = (chunk x column tile, split).  `Rows` gives
// count(), the listed rows (the same on every thread), and key(p), list
// entry p < count (the row r: dY's row and the sources' key).  `Src` is a
// narrow_tile.cuh source; its kAhead is not read (each thread resolves its
// row's sources eight at a time).  `partial` is (splits, n_off, Cin, Cout)
// fp32, or dW itself with one split.
template <typename T, class Src, class Rows>
__device__ __forceinline__ void run_item(const T* __restrict__ x, const T* __restrict__ dy,
                                         const Src& src, const Rows& rows,
                                         float* __restrict__ partial, int n_off, int cin,
                                         int cout, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout w = layout(n_off, cin, cout, sizeof(T) == 2);
  const ntt::Smem<T> s(smem, w.l);   // the im2col tile at the base
  T* const dyt = s.a + BM * w.l.ast;
  const int split = blockIdx.y;
  const int count = rows.count();
  const wgt::Split sp = wgt::split_of(count, splits);
  if (split >= (sp.used > 0 ? sp.used : 1)) return;   // split 0 always writes
  const int c = blockIdx.x / w.col_tiles, n0 = (int)(blockIdx.x % w.col_tiles) * BN;
  const int o0 = c * w.l.g, g = min(w.l.g, n_off - o0);
  const int p_begin = split * sp.per, p_end = min(count, p_begin + sp.per);
  const bool vec = cout % (16 / (int)sizeof(T)) == 0 &&
                   (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  auto key_of = [&](int p) { return p < p_end ? rows.key(p) : -1; };

  Acc<T> acc;
  acc.zero();
  for (int p0 = p_begin; p0 < p_end; p0 += BM) {
    const int n = min(BM, p_end - p0);
    __syncthreads();   // the last tile's products are done with both tiles
    stage_dy<T>(dyt, w.dst, dy, rows, p0, n, n0, cout, vec);
    const int any = fill_row<T>(s, w.l, x, src, key_of(p0 + threadIdx.x), o0, g, cin);
    wgt::cp_async_wait_all();
    if (__syncthreads_or(any)) acc.rows(s.a, dyt, w, n);
  }
  acc.store(partial + ((int64_t)split * n_off + o0) * cin * cout, g * cin, n0, cout);
}

// The split capacity a launch uses: at most the scratch's `splits`, and
// at most as many as keep every item resident at once (one wave: the
// items of a split cost alike, so a second, partial wave would take as
// long as the first).
template <class Kernel>
cudaError_t wave_splits(Kernel kernel, size_t smem, int items_per_split, int splits,
                        int* cap) {
  int slots = 0;
  const cudaError_t err = ntt::grid_of(kernel, kThreads, smem, INT32_MAX, &slots);
  if (err != cudaSuccess) return err;
  const int fit = slots / items_per_split;
  *cap = fit < 1 ? 1 : (fit < splits ? fit : splits);
  return cudaSuccess;
}

// Launches `kernel` (the caller's __global__ wrapper of run_item, whose
// last argument is the split capacity) over the items, then, where the
// scratch is not dW itself, the split sum into `out`.
template <typename T, class Rows, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, const Rows& rows, float* partial, float* out, int n_off,
                   int cin, int cout, int splits, cudaStream_t stream, Args... args) {
  if (cin < 1 || cin > ntt::kMaxCin || splits < 1) return cudaErrorInvalidValue;
  const bool bf16 = sizeof(T) == 2;
  const Layout w = layout(n_off, cin, cout, bf16);
  const size_t smem = smem_bytes(n_off, cin, cout, bf16);
  const int items = w.l.chunks * w.col_tiles;
  int cap = 1;
  cudaError_t err = wave_splits(kernel, smem, items, splits, &cap);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(items, cap), kThreads, smem, stream>>>(args..., cap);
  if ((err = cudaGetLastError()) != cudaSuccess || partial == out) return err;
  const int64_t n = (int64_t)n_off * cin * cout;
  wgt::sum_splits_kernel<Rows><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, out, rows, n_off, cin, cout, cap, 0);
  return cudaGetLastError();
}

}  // namespace nwt
