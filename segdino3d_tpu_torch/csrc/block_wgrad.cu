// K11: block conv weight gradient, dW[o] = sum over occupied cells c of
// halo(x)[c + o]^T @ dY[c].
//
// Replaces the weight-gradient half of segdino3d_tpu/ops/block_dense.py:
// _chunked_conv_bwd (:414-433: the dense conv's own weight VJP per block
// chunk, summed under lax.scan).  On the training path it runs once per
// block conv of the Res16UNet34C: the 46 k3 convs of the BasicBlocks and
// the dense k5 stem (259 -> 32).
//
// What bounds it: operations, 2 * pairs * Cin * Cout fp32 FMAs, a pair
// being an occupied cell and an offset whose source block exists (the
// op's contract: the source cell may be unoccupied, and feats is not
// promised zero there), over inputs of tens of MB.
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
// Contract: x (n_blocks * edge^3, Cin) and dy (n_blocks * edge^3, Cout)
// share one dtype (fp32 or bf16), rows contiguous; block_nbr (26, n_blocks)
// int32; ws the occupied-row list (block_rows: rows, count, ticket; the
// ticket 0 on entry, and left 0); partial (splits, k^3, Cin, Cout) fp32,
// or out itself when splits == 1; out (k^3, Cin, Cout) fp32.
#include "block_tile.cuh"
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

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(wgt::Tile<T, BM, BN>::kBlock,
                                  wgt::Tile<T, BM, BN>::kMinBlocks)
block_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, HaloPairs pairs,
                   int32_t* __restrict__ ticket, float* __restrict__ partial, int cin,
                   int cout, int n_off, int splits) {
  wgt::run_tiles<T, BM, BN>(x, dy, pairs, ticket, partial, cin, cout, n_off, splits, 0);
}

template <typename T, int BM, int BN>
cudaError_t launch(const void* x, const void* dy, const HaloPairs& pairs, int32_t* ticket,
                   float* partial, float* out, int cin, int cout, int n_off, int splits,
                   cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  return wgt::launch_tiles<T, BM, BN>(block_wgrad_kernel<T, BM, BN>, pairs, partial, out,
                                      cin, cout, n_off, splits, 0, s, xt, dyt, pairs,
                                      ticket, partial, cin, cout, n_off, splits);
}

// the tile by width: Cout 32 (the stem 259 -> 32 in one 288-row tile, or
// 64 rows), 64, 96 (96 or 128 rows), else 128 x 128
template <typename T>
cudaError_t launch_width(const void* x, const void* dy, const HaloPairs& pairs,
                         int32_t* ticket, float* partial, float* out, int cin, int cout,
                         int n_off, int splits, cudaStream_t s) {
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
