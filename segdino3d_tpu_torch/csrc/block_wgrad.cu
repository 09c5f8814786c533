// K11: block conv weight gradient, dW[o] = sum over occupied cells c of
// halo(x)[c + o]^T @ dY[c].
//
// Replaces the weight-gradient half of segdino3d_tpu/ops/block_dense.py:
// _chunked_conv_bwd (:414-433: the dense conv's own weight VJP per block
// chunk, summed under lax.scan).  On the training path it runs once per
// block conv of the Res16UNet34C: the 46 k3 convs of the BasicBlocks and
// the dense k5 stem (259 -> 32), on the live-pair path below in fp32.
//
// What bounds it: operations, 2 * pairs * Cin * Cout fp32 FMAs, a pair
// being an occupied cell and an offset whose source block exists (the
// op's contract: the source cell may be unoccupied, and feats is not
// promised zero there, except where the caller states it: the live-pair
// path below, whose pairs have an occupied source), over inputs of tens
// of MB.
//
// Design: dY is zero at unoccupied cells (the forward masked them), so
// only occupied cells are reduced.  Their list is the level's occupied-row
// list, in row order (block_rows in block_conv.cu, built once per level
// and step by the wrapper and kept on the level's tables; its count stays
// on the card).  The reduction is the shared weight-gradient tile core
// (wgrad_tile.cuh): pair p of offset o is listed row r = rows[p], its B row
// r itself and its A row the cell at r's position shifted by o, read
// through the block halo (bdt::halo_row, cut in two so that the neighbour
// table's read is not waited for; -1, a zero row, where the source block is
// absent).  A chunk of 32 listed rows spans several dense blocks.
// The list's ticket (the word after its count) orders the work items.
//
// The narrow path (block_wgrad_narrow, for a few input channels: the
// Baseline's dense k5 stem, 3 -> 32; ops/narrow.py picks it from the
// shape): on the core above Cin 3 took a 64-row M tile (61 zero A-columns
// a stage), and each of the 125 offsets staged every listed dY row again.
// The narrow path walks the same occupied-row list (its count read on the
// card, its ticket unused) on narrow_wgrad.cuh's core: tiles of 128 listed
// rows, each chunk of offsets gathered into an im2col tile through the
// block halo (bdt::HaloSrc, eight sources at a time), the chunk's dW block
// held in registers, the splits' partials added in order by the split sum.
//
// The live-pair path (block_wgrad_live, for an input its caller states
// zero outside the occupancy: every block conv's dW in training,
// ops/narrow.py:live_path picks it): the pairs above include every
// occupied cell's source in an existing block, about 3x the pairs with an
// occupied source (3.3x at the stem), and a source outside the occupancy
// holds a zero row.  The level's live-pair list of
// block_conv.cu:block_live_pairs (built once per level, kernel size and
// step, shared with the forward convs) names only the pairs whose source
// is occupied (A row src, B row dst); the same tile core reduces them,
// fp32 on FMAs and bf16 on mma.sync.  In fp32 the splits are the row-tile
// path's splits of the listed rows (a binary search of each offset's
// listed rows finds a split's first pair), so that each split adds the
// same nonzero products in the same order and the dW equals the row-tile
// path's bit for bit; that costs the k5 stem 1.75 -> 1.97 ms (75 splits
// of 1,024 listed rows an offset, where 17 of 1,024 live pairs were
// enough: PERF.md row 8d').  bf16 keeps the live pairs' own splits (the
// stem 0.47 ms against 0.76 with the row splits).  Two forms on Hopper's
// warpgroup core (wgmma.m64n32k16 with A transposed, the pairs staged as
// MN-major rows) ran slower at 264 -> 32 in bf16 and were dropped
// (PERF.md section 6, rows 6s / 8ds).
//
// Contract: x (n_blocks * edge^3, Cin) and dy (n_blocks * edge^3, Cout)
// share one dtype (fp32 or bf16), rows contiguous; block_nbr (26, n_blocks)
// int32; ws the occupied-row list (block_rows: rows, count, ticket; the
// ticket 0 on entry, and left 0); partial (splits, k^3, Cin, Cout) fp32,
// or out itself when splits == 1; out (k^3, Cin, Cout) fp32.
#include "block_tile.cuh"
#include "narrow_wgrad.cuh"
#include "wgrad_tile.cuh"

namespace {

struct HaloPairs {
  const int32_t* list;   // occupied rows, ascending
  const int32_t* n;      // how many
  const int32_t* nbr;    // (26, n_blocks)
  int n_blocks, edge, k;

  __device__ __forceinline__ int count(int) const { return *n; }
  __device__ __forceinline__ int key(int, int p) const { return list[p]; }
  // {the source cell's block (-1: absent), its direction from r's block}
  __device__ __forceinline__ int2 fetch(int o, int r) const {
    const int e3 = edge * edge * edge, h = (k - 1) / 2;
    const int b = r / e3, c = r % e3;
    const int qx = c / (edge * edge) + o / (k * k) - h;
    const int qy = (c / edge) % edge + (o / k) % k - h;
    const int qz = c % edge + o % k - h;
    const int dx = qx < 0 ? -1 : (qx >= edge ? 1 : 0);
    const int dy = qy < 0 ? -1 : (qy >= edge ? 1 : 0);
    const int dz = qz < 0 ? -1 : (qz >= edge ? 1 : 0);
    int d = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1);
    if (d == 13) return make_int2(b, d);
    d -= d > 13;  // the centre is not in the table
    return make_int2(nbr[(int64_t)d * n_blocks + b], d + (d >= 13));
  }
  // the rows: bdt::halo_row, with the neighbour read by fetch
  __device__ __forceinline__ void finish(int o, int r, int2 f, int& ra, int& rb) const {
    rb = r;
    if (f.x < 0) {
      ra = -1;
      return;
    }
    const int h = (k - 1) / 2, c = r % (edge * edge * edge);
    const int dx = f.y / 9 - 1, dy = (f.y / 3) % 3 - 1, dz = f.y % 3 - 1;
    const int lx = c / (edge * edge) + o / (k * k) - h - dx * edge;
    const int ly = (c / edge) % edge + (o / k) % k - h - dy * edge;
    const int lz = c % edge + o % k - h - dz * edge;
    ra = ((f.x * edge + lx) * edge + ly) * edge + lz;
  }
};

// the live-pair path: the pairs of block_live_pairs (block_conv.cu), per
// offset the listed rows whose source cell is occupied, A row the source
// and B row the listed row; the list's ticket orders the work items.  With
// by_rows (fp32) the splits are the row-tile path's (HaloPairs above):
// split s of offset o holds the live pairs of the listed rows s * per ..
// (s + 1) * per - 1, found by a binary search of the offset's listed rows
// (ascending), so that each split sums the row-tile path's nonzero
// products in its order; else (bf16, whose mma sums differ from the row
// tiles' anyway) the live pairs' own splits, fewer partials to write.
struct LivePairs {
  const int32_t* src;    // (n_off, cap) source rows
  const int32_t* dst;    // (n_off, cap) listed rows, ascending
  const int32_t* n;      // (n_off,) how many
  const int32_t* list;   // the occupied-row list the pairs were built on
  const int32_t* n_list; // its count
  int cap;
  bool by_rows;

  __device__ __forceinline__ int count(int o) const { return n[o]; }
  __device__ __forceinline__ int key(int, int p) const { return p; }
  __device__ __forceinline__ int2 fetch(int o, int p) const {
    const int64_t e = (int64_t)o * cap + p;
    return make_int2(src[e], dst[e]);
  }
  __device__ __forceinline__ void finish(int, int, int2 f, int& ra, int& rb) const {
    ra = f.x;
    rb = f.y;
  }
  __device__ __forceinline__ int split_count(int o) const {
    return by_rows ? *n_list : n[o];
  }
  // the first pair of split boundary i: with by_rows the first pair of
  // offset o whose listed row is list entry i or later, else pair i
  __device__ __forceinline__ int split_first(int o, int i) const {
    const int c = n[o];
    if (!by_rows) return min(i, c);
    if (i >= *n_list) return c;
    const int r = list[i];
    const int32_t* d = dst + (int64_t)o * cap;
    int lo = 0, hi = c;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (d[mid] < r) lo = mid + 1;
      else hi = mid;
    }
    return lo;
  }
};

template <typename T, int BM, int BN, class Pairs>
__global__ void __launch_bounds__(wgt::Tile<T, BM, BN>::kBlock,
                                  wgt::Tile<T, BM, BN>::kMinBlocks)
block_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, Pairs pairs,
                   int32_t* __restrict__ ticket, float* __restrict__ partial, int cin,
                   int cout, int n_off, int splits) {
  wgt::run_tiles<T, BM, BN>(x, dy, pairs, ticket, partial, cin, cout, n_off, splits, 0);
}

template <typename T, int BM, int BN, class Pairs>
cudaError_t launch(const void* x, const void* dy, const Pairs& pairs, int32_t* ticket,
                   float* partial, float* out, int cin, int cout, int n_off, int splits,
                   cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  return wgt::launch_tiles<T, BM, BN>(block_wgrad_kernel<T, BM, BN, Pairs>, pairs, partial,
                                      out, cin, cout, n_off, splits, 0, s, xt, dyt, pairs,
                                      ticket, partial, cin, cout, n_off, splits);
}

// the tile by width: Cout 32 (the stem 259 -> 32 in one 288-row tile, or
// 64 rows), 64, 96 (96 or 128 rows), else 128 x 128
template <typename T, class Pairs>
cudaError_t launch_width(const void* x, const void* dy, const Pairs& pairs, int32_t* ticket,
                         float* partial, float* out, int cin, int cout, int n_off, int splits,
                         cudaStream_t s) {
  if (cout <= 32)
    return cin <= 64
        ? launch<T, 64, 32>(x, dy, pairs, ticket, partial, out, cin, cout, n_off, splits, s)
        : launch<T, 288, 32>(x, dy, pairs, ticket, partial, out, cin, cout, n_off, splits, s);
  if (cout <= 64)
    return launch<T, 64, 64>(x, dy, pairs, ticket, partial, out, cin, cout, n_off, splits, s);
  if (cout <= 96)
    return cin <= 96
        ? launch<T, 96, 96>(x, dy, pairs, ticket, partial, out, cin, cout, n_off, splits, s)
        : launch<T, 128, 96>(x, dy, pairs, ticket, partial, out, cin, cout, n_off, splits, s);
  return launch<T, 128, 128>(x, dy, pairs, ticket, partial, out, cin, cout, n_off, splits, s);
}

// ---------------------------------------------------------------------------
// the narrow path
// ---------------------------------------------------------------------------

// the occupied-row list: its rows in order, the count on the card
struct ListedRows {
  const int32_t* list;
  const int32_t* n;
  __device__ __forceinline__ int count(int = 0) const { return *n; }
  __device__ __forceinline__ int key(int p) const { return list[p]; }
};

template <typename T, int E, int K>
__global__ void __launch_bounds__(nwt::kThreads)
block_wgrad_narrow_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const int32_t* __restrict__ nbr, ListedRows rows,
                          float* __restrict__ partial, int n_blocks, int cin, int cout,
                          int splits) {
  nwt::run_item<T>(x, dy, bdt::HaloSrc<E, K>{nbr, n_blocks}, rows, partial, K * K * K, cin,
                   cout, splits);
}

template <typename T, int E, int K>
cudaError_t launch_narrow(const void* x, const void* dy, const void* nbr, const ListedRows& rows,
                          float* partial, float* out, int n_blocks, int cin, int cout,
                          int splits, cudaStream_t s) {
  return nwt::launch<T>(block_wgrad_narrow_kernel<T, E, K>, rows, partial, out, K * K * K, cin,
                        cout, splits, s, static_cast<const T*>(x), static_cast<const T*>(dy),
                        static_cast<const int32_t*>(nbr), rows, partial, n_blocks, cin, cout);
}

template <typename T>
cudaError_t narrow_wgrad(const void* x, const void* dy, const void* nbr, const ListedRows& rows,
                         float* partial, float* out, int n_blocks, int edge, int k, int cin,
                         int cout, int splits, cudaStream_t s) {
  auto launch = edge == 4 ? (k == 3 ? launch_narrow<T, 4, 3> : launch_narrow<T, 4, 5>)
                          : (k == 3 ? launch_narrow<T, 8, 3> : launch_narrow<T, 8, 5>);
  return launch(x, dy, nbr, rows, partial, out, n_blocks, cin, cout, splits, s);
}

}  // namespace

// ws: the occupied-row list of block_rows (n_rows = n_blocks * edge^3 rows,
// then the count and the ticket).  dtype: 0 = float32, 1 = bfloat16.
// `partial` must be `out` when splits is 1.  Returns the first failed
// launch's cudaError_t, or 0.
extern "C" int block_wgrad(const void* x, const void* dy, const void* block_nbr, void* ws,
                           void* partial, void* out, int n_blocks, int edge, int k,
                           int cin, int cout, int splits, int dtype, void* stream) {
  if (cin == 0 || cout == 0) return 0;
  if ((edge != 4 && edge != 8) || (k != 3 && k != 5) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int n_off = k * k * k;
  if (n_blocks == 0)
    return static_cast<int>(
        cudaMemsetAsync(o, 0, sizeof(float) * (size_t)n_off * cin * cout, s));
  const int n_rows = n_blocks * edge * edge * edge;
  int32_t* w = static_cast<int32_t*>(ws);
  const HaloPairs pairs{w, w + n_rows, static_cast<const int32_t*>(block_nbr), n_blocks,
                        edge, k};
  float* p = static_cast<float*>(partial);
  cudaError_t err = dtype == 1
      ? launch_width<__nv_bfloat16>(x, dy, pairs, w + n_rows + 1, p, o, cin, cout, n_off,
                                    splits, s)
      : launch_width<float>(x, dy, pairs, w + n_rows + 1, p, o, cin, cout, n_off, splits,
                            s);
  return static_cast<int>(err);
}

// K11's narrow path: the contract of block_wgrad (its list's ticket not
// used) on narrow_wgrad.cuh's core.  Returns the first failed launch's
// cudaError_t, or 0.
extern "C" int block_wgrad_narrow(const void* x, const void* dy, const void* block_nbr,
                                  void* ws, void* partial, void* out, int n_blocks, int edge,
                                  int k, int cin, int cout, int splits, int dtype,
                                  void* stream) {
  if (cin == 0 || cout == 0) return 0;
  if ((edge != 4 && edge != 8) || (k != 3 && k != 5) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (n_blocks == 0)
    return static_cast<int>(
        cudaMemsetAsync(o, 0, sizeof(float) * (size_t)k * k * k * cin * cout, s));
  const int n_rows = n_blocks * edge * edge * edge;
  const int32_t* w = static_cast<const int32_t*>(ws);
  const ListedRows rows{w, w + n_rows};
  float* p = static_cast<float*>(partial);
  cudaError_t err = dtype == 1
      ? narrow_wgrad<__nv_bfloat16>(x, dy, block_nbr, rows, p, o, n_blocks, edge, k, cin,
                                    cout, splits, s)
      : narrow_wgrad<float>(x, dy, block_nbr, rows, p, o, n_blocks, edge, k, cin, cout,
                            splits, s);
  return static_cast<int>(err);
}

// K11 on live pairs (x zero outside the mask the list was built on): dW[o]
// = sum over offset o's live pairs of x[src]^T @ dy[dst], on the tile core
// above, in fp32 in the row-tile path's splits of the listed rows (bf16:
// in the live pairs' own).  rows_ws: the occupied-row list (n_rows rows)
// the pairs were built on; live_ws: block_live_pairs' list (k^3 offsets,
// pair_cap pairs an offset, its ticket 0 on entry and left 0); splits: as
// block_wgrad's at the same shape.  `partial` must be `out` when splits
// is 1.  dtype: 0 = float32, 1 = bfloat16.  Returns the first failed
// launch's cudaError_t, or 0.
extern "C" int block_wgrad_live(const void* x, const void* dy, const void* rows_ws, int n_rows,
                                void* live_ws, void* partial, void* out, int pair_cap, int k,
                                int cin, int cout, int splits, int dtype, void* stream) {
  if (cin == 0 || cout == 0) return 0;
  if ((k != 3 && k != 5) || splits < 1 || pair_cap < 0 || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int n_off = k * k * k;
  if (pair_cap == 0)
    return static_cast<int>(
        cudaMemsetAsync(o, 0, sizeof(float) * (size_t)n_off * cin * cout, s));
  int32_t* w = static_cast<int32_t*>(live_ws);
  const int32_t* rows = static_cast<const int32_t*>(rows_ws);
  const int64_t n = (int64_t)n_off * pair_cap;
  const LivePairs pairs{w, w + n, w + 2 * n, rows, rows + n_rows, pair_cap,
                        dtype == 0};
  int32_t* ticket = w + 2 * n + n_off;
  float* p = static_cast<float*>(partial);
  cudaError_t err = dtype == 1
      ? launch_width<__nv_bfloat16>(x, dy, pairs, ticket, p, o, cin, cout, n_off, splits, s)
      : launch_width<float>(x, dy, pairs, ticket, p, o, cin, cout, n_off, splits, s);
  return static_cast<int>(err);
}
