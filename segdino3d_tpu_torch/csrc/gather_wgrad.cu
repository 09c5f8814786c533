// K4: gather weight gradient, dW[slot(o)] = sum_r A[ia[o, r]]^T @ B[ib[o, r]].
//
// Replaces the weight-gradient half of segdino3d_tpu/ops/sparse_conv.py:
// _subm_conv_bwd (dW = X^T gather(dY), sparse_conv.py:346-361) and the
// weight gradients XLA derives for sparse_conv.py:down_conv and up_conv.
// On the training path it runs once per conv of the Res16UNet34C:
//   subm (46 k3 convs):  A = X, ia = nbr, B = dY            (dW[o] = sum_i X[nbr[o,i]]^T dY[i])
//   stem (k5, 259->32):  A = X, B = dY, ib = nbr, mirror    (gathers the 32-wide side)
//   down (4):            A = X_fine, ia = child, B = dY
//   up (4):              A = x_coarse, B = dF, ib = child
// `mirror` writes offset o's sum to slot n_off - 1 - o: for a centred odd
// kernel in canonical order nbr[o, j] = i <=> nbr[n_off-1-o, i] = j, so
// dW[o] = sum_j X[j]^T dY[nbr[n_off-1-o, j]] and the wide input is read
// without a gather (the JAX package's reason at sparse_conv.py:318-320).
//
// What bounds it: operations, 2 * live_pairs * Cin * Cout fp32 FMAs over
// inputs of a few MB that stay in the 50 MB L2; a live pair is a row r
// where both sides hold a row at offset o.
//
// Design: a dead pair adds a zero row, so only live pairs are reduced.
// gather_pairs lists, per offset, the rows r where ia[o, r] and ib[o, r]
// (an absent table being the identity) are both >= 0, in ascending r: a
// count pass and a list pass (per-block counts, then each block's offset
// by a sum over the blocks before it), the counts left on the card.  The
// count pass also stores one bit per (offset, row), whether the pair is
// live, and the list pass per offset and 32-row word the pairs before the
// word: K1's row groups (live_rows.cuh) find each group's pairs there.  The
// wrapper builds the list once per table and step (a cache keyed on the
// table).  The reduction is the shared weight-gradient tile core
// (wgrad_tile.cuh) over those lists; its ticket is the word after the
// counts, zeroed by the list pass.
//
// The narrow path (gather_wgrad_narrow, for a few input channels: the
// Baseline's k5 stem, 3 -> 32, whose step runs the unmirrored form A = X,
// ia = nbr, B = dY; ops/narrow.py picks it from the shape): on the core
// above Cin 3 took a 64-row M tile (61 zero A-columns a stage) and each of
// the 125 offsets staged every live dY row again, from a pair list of the
// whole table that only this call needed.  The narrow path takes no pair
// list: narrow_wgrad.cuh's core walks every row of the table in tiles of
// 128, each chunk of offsets gathered into an im2col tile straight from
// the table (ntt::TableSrc, eight sources at a time), the chunk's dW block
// held in registers, the splits' partials added in order by the split
// sum.
//
// Contract: A (rows_a, Cin) and B (rows_b, Cout) share one dtype (fp32 or
// bf16), rows contiguous; ia, ib (n_off, R) int32 with -1 for "no row", or
// null for the identity (then A, resp. B, has at least R rows); ws the
// pair list (gather_pairs: n_off x R rows, n_off counts, the ticket, then
// the per-block counts, bits and starts); partial (splits, n_off, Cin,
// Cout) fp32, or out itself when splits == 1; out (n_off, Cin, Cout) fp32.
#include "narrow_wgrad.cuh"
#include "wgrad_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// the pair list
// ---------------------------------------------------------------------------

constexpr int kListThreads = 256;
constexpr int kListRows = kListThreads * 16;   // rows per thread block, 16 a thread
constexpr int kListWords = kListRows / 32;     // 32-row words per thread block

// bit i set when row r0 + i has a live pair at offset o
__device__ __forceinline__ unsigned live_flags(const int32_t* __restrict__ ia,
                                               const int32_t* __restrict__ ib, int o,
                                               int64_t r0, int rows) {
  const int32_t* a = ia ? ia + (int64_t)o * rows : nullptr;
  const int32_t* b = ib ? ib + (int64_t)o * rows : nullptr;
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int64_t r = r0 + i;
    const bool live = r < rows && (a == nullptr || a[r] >= 0) && (b == nullptr || b[r] >= 0);
    m |= (live ? 1u : 0u) << i;
  }
  return m;
}

// exclusive prefix of v over the thread block, in thread order; *total is
// the block's sum
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += u;
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

// grid (blocks, n_off): counts[o * blocks + blockIdx.x], and each 32-row
// word's live bits (bit i: row 32 word + i), bits[o * words + word]; an
// even thread's 16 rows are its word's low half, the next thread's the
// high half
__global__ void __launch_bounds__(kListThreads)
count_pairs_kernel(const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
                   int rows, int32_t* __restrict__ counts, uint32_t* __restrict__ bits) {
  __shared__ int warp_sums[kListThreads / 32];
  const int o = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * kListRows + threadIdx.x * 16;
  const unsigned m = live_flags(ia, ib, o, r0, rows);
  const unsigned hi = __shfl_down_sync(0xFFFFFFFFu, m, 1);
  if ((threadIdx.x & 1) == 0)
    bits[(int64_t)o * gridDim.x * kListWords + r0 / 32] = m | hi << 16;
  int total;
  block_exclusive_scan(__popc(m), warp_sums, &total);
  if (threadIdx.x == 0) counts[(int64_t)o * gridDim.x + blockIdx.x] = total;
}

// the list, and each word's pairs before it (starts[o * words + word], the
// position of an even thread's first pair)
__global__ void __launch_bounds__(kListThreads)
list_pairs_kernel(const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
                  int rows, const int32_t* __restrict__ counts, int32_t* __restrict__ list,
                  int32_t* __restrict__ n_pairs, int32_t* __restrict__ ticket,
                  int32_t* __restrict__ starts) {
  __shared__ int warp_sums[kListThreads / 32];
  const int o = blockIdx.y;
  const int32_t* oc = counts + (int64_t)o * gridDim.x;
  int part = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += kListThreads) part += oc[i];
  int prefix;
  block_exclusive_scan(part, warp_sums, &prefix);
  const int64_t r0 = (int64_t)blockIdx.x * kListRows + threadIdx.x * 16;
  unsigned m = live_flags(ia, ib, o, r0, rows);
  int total;
  int pos = prefix + block_exclusive_scan(__popc(m), warp_sums, &total);
  if ((threadIdx.x & 1) == 0) starts[(int64_t)o * gridDim.x * kListWords + r0 / 32] = pos;
  int32_t* ol = list + (int64_t)o * rows;
  while (m) {
    ol[pos++] = (int32_t)(r0 + __ffs(m) - 1);
    m &= m - 1;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    n_pairs[o] = prefix + total;
    if (o == 0) *ticket = 0;
  }
}

// ---------------------------------------------------------------------------
// the reduction
// ---------------------------------------------------------------------------

struct ListPairs {
  const int32_t* list;  // (n_off, R) live rows per offset, ascending
  const int32_t* n;     // (n_off,) how many
  const int32_t* ia;    // (n_off, R) or null
  const int32_t* ib;
  int cap;              // R, the table's rows

  __device__ __forceinline__ int count(int o) const { return n[o]; }
  __device__ __forceinline__ int key(int o, int p) const {
    return list[(int64_t)o * cap + p];
  }
  __device__ __forceinline__ int2 fetch(int o, int r) const {
    const int64_t e = (int64_t)o * cap + r;
    return make_int2(ia ? ia[e] : r, ib ? ib[e] : r);
  }
  __device__ __forceinline__ void finish(int, int, int2 f, int& ra, int& rb) const {
    ra = f.x;
    rb = f.y;
  }
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(wgt::Tile<T, BM, BN>::kBlock,
                                  wgt::Tile<T, BM, BN>::kMinBlocks)
gather_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b, ListPairs pairs,
                    int32_t* __restrict__ ticket, float* __restrict__ partial, int cin,
                    int cout, int n_off, int splits, int mirror) {
  wgt::run_tiles<T, BM, BN>(a, b, pairs, ticket, partial, cin, cout, n_off, splits,
                            mirror);
}

template <typename T, int BM, int BN>
cudaError_t launch(const void* a, const void* b, const ListPairs& pairs, int32_t* ticket,
                   float* partial, float* out, int cin, int cout, int n_off, int splits,
                   int mirror, cudaStream_t s) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  return wgt::launch_tiles<T, BM, BN>(gather_wgrad_kernel<T, BM, BN>, pairs, partial, out,
                                      cin, cout, n_off, splits, mirror, s, at, bt, pairs,
                                      ticket, partial, cin, cout, n_off, splits, mirror);
}

// the tile by width, as K11 picks it (block_wgrad.cu)
template <typename T>
cudaError_t launch_width(const void* a, const void* b, const ListPairs& pairs,
                         int32_t* ticket, float* partial, float* out, int cin, int cout,
                         int n_off, int splits, int mirror, cudaStream_t s) {
  if (cout <= 32)
    return cin <= 64 ? launch<T, 64, 32>(a, b, pairs, ticket, partial, out, cin, cout,
                                         n_off, splits, mirror, s)
                     : launch<T, 288, 32>(a, b, pairs, ticket, partial, out, cin, cout,
                                          n_off, splits, mirror, s);
  if (cout <= 64)
    return launch<T, 64, 64>(a, b, pairs, ticket, partial, out, cin, cout, n_off, splits,
                             mirror, s);
  if (cout <= 96)
    return cin <= 96 ? launch<T, 96, 96>(a, b, pairs, ticket, partial, out, cin, cout,
                                         n_off, splits, mirror, s)
                     : launch<T, 128, 96>(a, b, pairs, ticket, partial, out, cin, cout,
                                          n_off, splits, mirror, s);
  return launch<T, 128, 128>(a, b, pairs, ticket, partial, out, cin, cout, n_off, splits,
                             mirror, s);
}

// ---------------------------------------------------------------------------
// the narrow path
// ---------------------------------------------------------------------------

// every row of the table, in order
struct TableRows {
  int rows;
  __device__ __forceinline__ int count(int = 0) const { return rows; }
  __device__ __forceinline__ int key(int p) const { return p; }
};

template <typename T>
__global__ void __launch_bounds__(nwt::kThreads)
gather_wgrad_narrow_kernel(const T* __restrict__ a, const int32_t* __restrict__ ia,
                           const T* __restrict__ b, float* __restrict__ partial, int rows,
                           int cin, int cout, int n_off, int splits) {
  nwt::run_item<T>(a, b, ntt::TableSrc{ia, rows}, TableRows{rows}, partial, n_off, cin, cout,
                   splits);
}

template <typename T>
cudaError_t launch_narrow(const void* a, const void* ia, const void* b, float* partial,
                          float* out, int rows, int cin, int cout, int n_off, int splits,
                          cudaStream_t s) {
  return nwt::launch<T>(gather_wgrad_narrow_kernel<T>, TableRows{rows}, partial, out, n_off,
                        cin, cout, splits, s, static_cast<const T*>(a),
                        static_cast<const int32_t*>(ia), static_cast<const T*>(b), partial,
                        rows, cin, cout, n_off);
}

}  // namespace

// The per-offset live-pair list into ws (n_off * rows + n_off + 1 +
// n_off * blocks * (1 + 2 * 128) int32, blocks = ceil(rows / 4096)): rows,
// counts, ticket, per-block counts, then per offset and 32-row word the
// count pass's live bits and the list pass's pairs before the word
// (sparse_conv.py:pair_workspace_size; K1's row groups read both,
// live_rows.cuh).  Returns the launches' cudaError_t.
extern "C" int gather_pairs(const void* ia, const void* ib, void* ws, int rows, int n_off,
                            void* stream) {
  if (n_off == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* w = static_cast<int32_t*>(ws);
  const int blocks = rows > 0 ? (rows + kListRows - 1) / kListRows : 1;
  int32_t* n_pairs = w + (int64_t)n_off * rows;
  int32_t* counts = n_pairs + n_off + 1;
  uint32_t* bits = reinterpret_cast<uint32_t*>(counts + (int64_t)n_off * blocks);
  int32_t* starts = counts + (int64_t)n_off * blocks * (1 + kListWords);
  const dim3 grid(blocks, n_off);
  const int32_t* a = static_cast<const int32_t*>(ia);
  const int32_t* b = static_cast<const int32_t*>(ib);
  count_pairs_kernel<<<grid, kListThreads, 0, s>>>(a, b, rows, counts, bits);
  list_pairs_kernel<<<grid, kListThreads, 0, s>>>(a, b, rows, counts, w, n_pairs,
                                                  n_pairs + n_off, starts);
  return static_cast<int>(cudaGetLastError());
}

// ws: gather_pairs' list for these tables.  dtype: 0 = float32, 1 =
// bfloat16.  `partial` must be `out` when splits is 1.  Returns the first
// failed launch's cudaError_t, or 0.
extern "C" int gather_wgrad(const void* a, const void* ia, const void* b, const void* ib,
                            void* ws, void* partial, void* out, int rows, int cin,
                            int cout, int n_off, int splits, int mirror, int dtype,
                            void* stream) {
  if (n_off == 0 || cin == 0 || cout == 0) return 0;
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (rows == 0)
    return static_cast<int>(
        cudaMemsetAsync(o, 0, sizeof(float) * (size_t)n_off * cin * cout, s));
  int32_t* w = static_cast<int32_t*>(ws);
  int32_t* n_pairs = w + (int64_t)n_off * rows;
  const ListPairs pairs{w, n_pairs, static_cast<const int32_t*>(ia),
                        static_cast<const int32_t*>(ib), rows};
  cudaError_t err = dtype == 1
      ? launch_width<__nv_bfloat16>(a, b, pairs, n_pairs + n_off, p, o, cin, cout, n_off,
                                    splits, mirror, s)
      : launch_width<float>(a, b, pairs, n_pairs + n_off, p, o, cin, cout, n_off, splits,
                            mirror, s);
  return static_cast<int>(err);
}

// The narrow path's dynamic shared memory a block (ops/narrow.py:
// wgrad_smem_bytes computes the same; K11's narrow path uses it too).
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int narrow_wgrad_smem(int n_off, int cin, int cout, int dtype) {
  return static_cast<int>(nwt::smem_bytes(n_off, cin, cout, dtype == 1));
}

// K4's narrow path: dW[o] = sum_r a[ia[o, r]]^T @ b[r] over every row r <
// rows of ia (n_off, rows) (b has at least `rows` rows), no pair list.
// partial (splits, n_off, Cin, Cout) fp32, or `out` itself when splits is
// 1; out (n_off, Cin, Cout) fp32.  dtype: 0 = float32, 1 = bfloat16.
// Returns the first failed launch's cudaError_t, or 0.
extern "C" int gather_wgrad_narrow(const void* a, const void* ia, const void* b, void* partial,
                                   void* out, int rows, int cin, int cout, int n_off,
                                   int splits, int dtype, void* stream) {
  if (n_off == 0 || cin == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (rows == 0)
    return static_cast<int>(
        cudaMemsetAsync(o, 0, sizeof(float) * (size_t)n_off * cin * cout, s));
  cudaError_t err = dtype == 1
      ? launch_narrow<__nv_bfloat16>(a, ia, b, p, o, rows, cin, cout, n_off, splits, s)
      : launch_narrow<float>(a, ia, b, p, o, rows, cin, cout, n_off, splits, s);
  return static_cast<int>(err);
}
