// K1: gather-GEMM sparse convolution, out[i] = sum_o x[nbr[o, i]] @ W[o].
//
// Replaces segdino3d_tpu/ops/sparse_conv.py:_subm_conv_impl (both its
// im2col branch and its matmul-first branch) and, through the plan's
// (8, V_coarse) child table, sparse_conv.py:down_conv.  On the main path it
// runs the k5 stem (125 offsets, 259 -> 32), the 46 k3 convs of the
// BasicBlocks and the 4 stride-2 down convs; in training also their input
// gradients (the k3 convs' by the mirror identity, the up convs' over the
// child table).
//
// What bounds it: operations, 2 * live pairs * Cin * Cout fp32 FMAs over
// inputs of a few to a hundred MB.  Only about a fifth of the stem's (row,
// offset) pairs and a third to a half of the k3 tables' hold a neighbour,
// and the small levels have a few hundred rows.  Design (pair-major):
//   1. the pairs: per offset, the rows that have a neighbour there, in
//      ascending order (K4's list, gather_pairs in gather_wgrad.cu, built
//      once per table and kept by the caller, sparse_conv.py:cached_pairs;
//      its count stays on the card);
//   2. the products (pair_major.cuh, shared with K10's live-pair path): a
//      work item is 64 consecutive pairs of one offset and one column
//      tile, so every item but an offset's last is a full 64-row GEMM
//      tile, and even a level of a few hundred rows makes hundreds of
//      items.  Persistent thread blocks, as many as fit on the SMs, take
//      items by an atomic ticket that the block taking the last ticket
//      resets.  An item gathers its 64 source rows and multiplies them on
//      the pipelined tile core of gather_tile.cuh (fp32 FMAs, bf16
//      mma.sync), and writes the products to a pair-major fp32 buffer, row
//      p = (the offset's first pair) + j, and p into an (n_off, V) map at
//      (o, row);
//   3. the sum: each row adds its products in ascending offset order,
//      through the map, four threads a row, and writes the output (zeros
//      outside valid).
// The buffer holds the live pairs, at most V rows an offset: 1.47 GB at
// the flagship's k5 stem if every pair were live (125 x 92,160 x 32 fp32),
// ~10 GB for a batch of 8 such scenes (past 2^31 floats).  So the wrapper
// may run the offsets in consecutive chunks [o_begin, o_end)
// (sparse_conv.py:pair_major_chunks, under SEGDINO_CONV_CHUNK_MB): sized
// by V rows an offset, or where those would be many, by the list's live
// pairs and the index map, the counts read to the host once per list.
// Each chunk's products go to a buffer of its own live pairs (row p =
// the chunk's pairs of the offsets before o + j) with its own index map,
// and its sum adds them onto an fp32 carry (V, pair stride) that the
// chunk before wrote, in ascending offset order; the last chunk writes
// the output.  A row's sum is then the same fp32 additions in the same
// order as in one chunk, so the chunked output is bit-equal to the
// unchunked one.  A chunk before the last skips the rows without a pair
// in it (the carry starts zero), so a row's carry moves once per chunk it
// has pairs in.
// So an output's sum is its offsets' products (each over Cin in ascending
// slices) added in ascending offset order, the plain version's order; no
// float atomics, so two calls are bit-equal.  Measured against a schedule
// of 64-row tiles that compact each tile's live rows per offset in shared
// memory (PERF.md §6): that one's stages hold ~29 rows of the stem's
// and ~22 of level 0's, and wait on their gathers.
//
// Contract: x (V_in, Cin), w (n_off, Cin, Cout) and out (V, Cout) share
// one dtype (fp32 or bf16), rows contiguous; nbr (n_off, V) int32, -1 for
// an absent neighbour; valid (V,) bytes; pairs gather_pairs' list of nbr
// (n_off x V rows, n_off counts, the ticket); a chunk [o_begin, o_end) of
// the offsets, with pos ((o_end - o_begin), V) int32 scratch, partial
// (the chunk's live pairs, counts[o_begin] + ... + counts[o_end - 1],
// gather_conv_pair_stride(Cout)) fp32 scratch and,
// unless the chunk is all the offsets, carry (V, the same stride) fp32,
// zero before the first chunk: read where o_begin > 0, written where
// o_end < n_off (out then is not).
// Rows outside valid are written as 0.
//
// The bf16 wide stems (gather_conv_wg, ops/narrow.py:wide_stem: Cin above
// 256 into Cout 32, the flagship's k5 259 -> 32 and the v2 model's k3 262
// -> 32): at Cin 259 the mma.sync core copied the rows element by element
// and its two-buffer stages sat behind a barrier each 32 channels, so the
// bf16 stem ran slower than fp32 and lost to a gather and cuBLAS.  The
// stems now reach K1 at an aligned pitch (264, zero past Cin; in fp32 260
// and 264, so the fp32 core stages them in 16-byte copies too) and run on
// the warpgroup core (wgmma_tile.cuh: 64-channel stages in a four-buffer
// cp.async ring, wgmma.m64n32k16) in the pair-major form above (the items
// and the pair-major buffer, Cin in stages).  An output-stationary form
// (64-row tiles walking the offsets some row has a neighbour at: no pair
// list or buffer, products at dead cells) was slower at both stems, by up
// to three times, and was dropped (PERF.md section 6).
//
// The row-group form (gather_conv_rows, ops/narrow.py:gather_form picks it
// by role, dtype and table size): the pair-major buffer moves every pair's
// fp32 products twice, 2.2 GB each way at a batch of 8 scenes' level-0 k3
// conv (5.6 M pairs at 96 columns), and past SEGDINO_CONV_CHUNK_MB its
// chunks move an fp32 carry of every row once a chunk besides (27 chunks
// of 240 MB there).  The row groups (live_rows.cuh, shared with K10's
// live-pair path) keep the products in shared memory: an item is a group of
// consecutive table rows and a column tile, each offset's pairs of the
// group one range of the pair list (the list's per-word bits and starts,
// gather_wgrad.cu:gather_pairs), their sources read from nbr, their
// products added into the group's fp32 accumulator in ascending offset
// order; one launch, no index map, no chunks, no carry, only the output
// allocated.  fp32 sums each product and each row in the pair-major form's
// order, so the two are bit-equal.  It won the paired measurement only at
// the bf16 k3 convs of large tables (the batch of 8's level 0: 2.33 against
// 5.42 ms in 27 chunks and 2.98 in one), where the rule takes it; the
// pair-major form keeps fp32, the stems and the batch-1 tables (live_rows.cuh
// says why).
//
// The narrow path (gather_conv_narrow, for a few input channels: the
// Baseline's k5 stem, rgb 3 -> 32; ops/narrow.py picks it from the shape):
// at Cin 3 every pair's 32 products are ten times as wide as its input, and
// the pair-major buffer moved ~274 MB each way, against ~58 MB of table and
// output.  So the narrow path takes no pair list, no map and no buffer:
// one launch over tiles of 128 consecutive rows on narrow_tile.cuh's core,
// each row's sources read straight from nbr (a warp reads one offset's 32
// consecutive rows, one 128-byte line), rows outside valid gathering
// nothing (their output is 0).  The tiles cost alike (every row runs every
// chunk its tile touches), so persistent blocks stride over them without a
// ticket, and no scratch is allocated.
#include "live_rows.cuh"
#include "narrow_tile.cuh"
#include "pair_major.cuh"

namespace {

using gtt::BM;
using gtt::kThreads;

using gtt::pair_bn;

// The pair-major rows hold Cout rounded up to the column tile.
__host__ __device__ __forceinline__ int pair_stride(int cout) {
  const int bn = pair_bn(cout);
  return (cout + bn - 1) / bn * bn;
}

// pair j of offset o: the row list[o][j]'s neighbour there; its buffer row
// goes to the index map once (on the first column tile)
struct TableSource {
  const int32_t* list;
  const int32_t* nbr;
  int32_t* pos;
  int v;
  __device__ __forceinline__ int operator()(int o, int j, int ct, int p) const {
    const int r = list[(int64_t)o * v + j];
    if (ct == 0) pos[(int64_t)o * v + r] = p;
    return nbr[(int64_t)o * v + r];
  }
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
conv_products_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                     const T* __restrict__ w, const int32_t* __restrict__ list,
                     const int32_t* __restrict__ counts, int32_t* __restrict__ ticket,
                     int32_t* __restrict__ pos, float* __restrict__ partial, int v, int cin,
                     int cout, int n_off) {
  pmc::products<T, BN>(x, w, counts, ticket, partial, cin, cout, n_off,
                       TableSource{list, nbr, pos, v});
}

// out[r][c .. c + 7] = sum over the offsets o ascending with nbr[o][r] >= 0
// of partial[pos[o][r]][c .. c + 7], 0 outside valid: four threads a row,
// eight columns each (c = 32 blockIdx.y + 8 (tid % 4)), so a quad reads a
// pair's 32 products as one 128-byte line; the offsets' loads eight at a
// time.  A chunk of the offsets (nbr and pos at its first) starts from
// carry_in where given, and ends in carry_out where given, else in out.
// carry_in and carry_out may be one buffer: a thread reads its eight
// entries before it writes them.  The carry starts zero (the wrapper
// clears it), so a chunk before the last leaves alone a row without a
// pair in it (at one offset a chunk, two thirds of a k3 level's rows): its
// carry already holds its sum so far.
template <typename T>
__global__ void __launch_bounds__(128)
conv_pair_sum_kernel(const int32_t* __restrict__ nbr, const int32_t* __restrict__ pos,
                     const float* __restrict__ partial, int ld,
                     const uint8_t* __restrict__ valid, const float* carry_in,
                     float* carry_out, T* __restrict__ out, int v, int cout, int n_off) {
  const int64_t r = (int64_t)blockIdx.x * 32 + threadIdx.x / 4;
  const int c = 32 * blockIdx.y + (threadIdx.x % 4) * 8;
  if (r >= v) return;
  if (carry_out != nullptr) {
    bool any = false;
    if (valid[r])
      for (int o = 0; o < n_off && !any; ++o) any = nbr[(int64_t)o * v + r] >= 0;
    if (!any) return;
  }
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  if (valid[r]) {
    if (carry_in != nullptr) {
      const float4* src = reinterpret_cast<const float4*>(carry_in + r * ld + c);
      const float4 a = src[0], b = src[1];
      acc[0] = a.x;
      acc[1] = a.y;
      acc[2] = a.z;
      acc[3] = a.w;
      acc[4] = b.x;
      acc[5] = b.y;
      acc[6] = b.z;
      acc[7] = b.w;
    }
    for (int o0 = 0; o0 < n_off; o0 += 8) {
      int p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = o0 + i < n_off && nbr[(int64_t)(o0 + i) * v + r] >= 0
            ? pos[(int64_t)(o0 + i) * v + r] : -1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (p[i] < 0) continue;
        const float4* src = reinterpret_cast<const float4*>(partial + (int64_t)p[i] * ld + c);
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
  }
  if (carry_out != nullptr) {
    float4* dst = reinterpret_cast<float4*>(carry_out + r * ld + c);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    return;
  }
  T* const row = out + r * cout;
  if (c < cout) gtt::store4(row, c, cout, make_float4(acc[0], acc[1], acc[2], acc[3]));
  if (c + 4 < cout) gtt::store4(row, c + 4, cout, make_float4(acc[4], acc[5], acc[6], acc[7]));
}

// The pointers of one chunk [o_begin, o_end) of the offsets: the table's
// and the weight's rows, the pair list's and its counts from o_begin; the
// carry in and out as the contract says.
struct Chunk {
  int64_t o0;
  int n;
  const float* carry_in;
  float* carry_out;
  Chunk(int o_begin, int o_end, int n_off, float* carry)
      : o0(o_begin), n(o_end - o_begin), carry_in(o_begin > 0 ? carry : nullptr),
        carry_out(o_end < n_off ? carry : nullptr) {}
};

template <typename T, int BN>
cudaError_t launch(const T* x, const int32_t* nbr, const T* w, const uint8_t* valid,
                   int32_t* pairs, int32_t* pos, float* partial, const Chunk& ch, T* out,
                   int v, int cin, int cout, int n_off, cudaStream_t s) {
  auto kernel = conv_products_kernel<T, BN>;
  const size_t smem = pmc::smem_bytes<T, BN>(ch.n);
  // the items of a chunk whose every pair is live; the count is on the card
  const int n_col = (cout + BN - 1) / BN;
  const int64_t max_items = (int64_t)((v + BM - 1) / BM) * ch.n * n_col;
  int grid = 0;
  cudaError_t err = ntt::grid_of(kernel, kThreads, smem, max_items, &grid);
  if (err != cudaSuccess) return err;
  const int64_t n_list = (int64_t)n_off * v, first = ch.o0 * v;
  kernel<<<grid, kThreads, smem, s>>>(x, nbr + first, w + ch.o0 * cin * cout, pairs + first,
                                      pairs + n_list + ch.o0, pairs + n_list + n_off, pos,
                                      partial, v, cin, cout, ch.n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_pair_sum_kernel<T><<<dim3((v + 31) / 32, (cout + 31) / 32), 128, 0, s>>>(
      nbr + first, pos, partial, n_col * BN, valid, ch.carry_in, ch.carry_out, out, v, cout,
      ch.n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bn(const void* x, const void* nbr, const void* w, const void* valid,
                      void* pairs, void* pos, void* partial, const Chunk& ch, void* out, int v,
                      int cin, int cout, int n_off, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  const int32_t* nb = static_cast<const int32_t*>(nbr);
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  int32_t* pl = static_cast<int32_t*>(pairs);
  int32_t* ps = static_cast<int32_t*>(pos);
  float* pt = static_cast<float*>(partial);
  switch (pair_bn(cout)) {
    case 32:
      return launch<T, 32>(xt, nb, wt, va, pl, ps, pt, ch, ot, v, cin, cout, n_off, s);
    case 96:
      return launch<T, 96>(xt, nb, wt, va, pl, ps, pt, ch, ot, v, cin, cout, n_off, s);
    default:
      return launch<T, 64>(xt, nb, wt, va, pl, ps, pt, ch, ot, v, cin, cout, n_off, s);
  }
}

// ---------------------------------------------------------------------------
// the bf16 wide stems: warpgroup tiles (wgmma_tile.cuh)
// ---------------------------------------------------------------------------

using wgc::bf16;

// Pair-major form: an item is 64 live pairs of one offset and one column
// tile, as conv_products_kernel's, its Cin in 64-channel stages through
// the warpgroup core; the products go to the pair-major buffer and
// conv_pair_sum_kernel adds them.
template <int BN>
__global__ void __launch_bounds__(wgc::kThreads)
conv_products_wg_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ nbr,
                        const bf16* __restrict__ w, const int32_t* __restrict__ list,
                        const int32_t* __restrict__ counts, int32_t* __restrict__ ticket,
                        int32_t* __restrict__ pos, float* __restrict__ partial, int v, int cin,
                        int cout, int n_off, int vec_a, int vec_b) {
  pmc::products_wg<BN>(x, w, counts, ticket, partial, cin, cout, n_off, vec_a != 0, vec_b != 0,
                       TableSource{list, nbr, pos, v});
}

template <int BN>
cudaError_t launch_wg(const bf16* x, const int32_t* nbr, const bf16* w, const uint8_t* valid,
                      int32_t* pairs, int32_t* pos, float* partial, const Chunk& ch, bf16* out,
                      int v, int cin, int cout, int n_off, cudaStream_t s) {
  const bf16* wc = w + ch.o0 * cin * cout;
  const int vec_a = cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int vec_b = cout % 8 == 0 && (reinterpret_cast<uintptr_t>(wc) & 15) == 0;
  const int n_col = (cout + BN - 1) / BN;
  int grid = 0;
  auto kernel = conv_products_wg_kernel<BN>;
  const size_t smem = pmc::smem_bytes_wg<BN>(ch.n);
  cudaError_t err = ntt::grid_of(kernel, wgc::kThreads, smem,
                                 (int64_t)((v + BM - 1) / BM) * ch.n * n_col, &grid);
  if (err != cudaSuccess) return err;
  const int64_t n_list = (int64_t)n_off * v, first = ch.o0 * v;
  kernel<<<grid, wgc::kThreads, smem, s>>>(x, nbr + first, wc, pairs + first,
                                           pairs + n_list + ch.o0, pairs + n_list + n_off, pos,
                                           partial, v, cin, cout, ch.n, vec_a, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_pair_sum_kernel<bf16><<<dim3((v + 31) / 32, (cout + 31) / 32), 128, 0, s>>>(
      nbr + first, pos, partial, n_col * BN, valid, ch.carry_in, ch.carry_out, out, v, cout,
      ch.n);
  return cudaGetLastError();
}

// the narrow path: out[r] = sum_o x[nbr[o][r]] @ w[o] on valid rows
template <typename T>
__global__ void __launch_bounds__(ntt::kThreads)
gather_conv_narrow_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                          const T* __restrict__ w, const uint8_t* __restrict__ valid,
                          T* __restrict__ out, int v, int cin, int cout, int n_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ntt::Layout l = ntt::layout(n_off, cin, cout, sizeof(T) == 2);
  const ntt::Smem<T> s(smem, l);
  const ntt::TableSrc src{nbr, v};
  const int tid = threadIdx.x, n_tiles = (v + ntt::BM - 1) / ntt::BM;
  ntt::stage_weights<T>(s, l, w, n_off, cin, cout);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    __syncthreads();  // the last tile's stores are done with s.row
    if (tid < ntt::BM) {
      const int r = t * ntt::BM + tid;
      s.row[tid] = r < v ? r : -1;
      s.key[tid] = r < v && valid[r] ? r : -1;
    }
    __syncthreads();
    ntt::tile<T>(s, l, x, src, out, n_off, cin, cout);
  }
}

template <typename T>
cudaError_t launch_narrow(const void* x, const void* nbr, const void* w, const void* valid,
                          void* out, int v, int cin, int cout, int n_off, cudaStream_t s) {
  auto kernel = gather_conv_narrow_kernel<T>;
  const size_t smem = ntt::smem_bytes(n_off, cin, cout, sizeof(T) == 2);
  int grid = 0;
  cudaError_t err =
      ntt::grid_of(kernel, ntt::kThreads, smem, (v + ntt::BM - 1) / ntt::BM, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ntt::kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(nbr), static_cast<const T*>(w),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), v, cin, cout, n_off);
  return cudaGetLastError();
}

// the row-group form (live_rows.cuh) over every row of the table
template <typename T, int BN>
__global__ void __launch_bounds__(lrc::kThreads)
conv_rows_kernel(const T* __restrict__ x, const T* __restrict__ w, lrc::TableRows rows,
                 lrc::Words pw, lrc::TableSrc src, int32_t* __restrict__ ticket,
                 T* __restrict__ out, int cin, int cout, int n_off) {
  lrc::conv<T, BN>(x, w, rows, pw, src, ticket, out, cin, cout, n_off);
}

// The word tables of gather_pairs' workspace (gather_wgrad.cu): after the
// rows, the counts, the ticket and the per-block counts
struct PairWs {
  int32_t* ticket;
  lrc::Words words;
  PairWs(int32_t* ws, int v, int n_off) {
    const int blocks = v > 0 ? (v + 4095) / 4096 : 1;
    const int64_t n_words = (int64_t)blocks * 128;
    int32_t* const counts = ws + (int64_t)n_off * v;
    ticket = counts + n_off;
    const int32_t* const block_counts = ticket + 1;
    const int32_t* const bits = block_counts + (int64_t)n_off * blocks;
    words = lrc::Words{reinterpret_cast<const uint32_t*>(bits), bits + n_off * n_words, n_words,
                       v};
  }
};

template <typename T, int BN>
cudaError_t launch_rows(const void* x, const void* nbr, const void* w, const void* valid,
                        const PairWs& ws, void* out, int v, int cin, int cout, int n_off,
                        cudaStream_t s) {
  auto kernel = conv_rows_kernel<T, BN>;
  constexpr int R = lrc::Group<T>::R;
  const size_t smem = lrc::smem_bytes<T, BN>(n_off);
  const int64_t items = (int64_t)(v + R - 1) / R * ((cout + BN - 1) / BN);
  int grid = 0;
  cudaError_t err = ntt::grid_of(kernel, lrc::kThreads, smem, items, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, lrc::kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      lrc::TableRows{static_cast<const uint8_t*>(valid), v}, ws.words,
      lrc::TableSrc{static_cast<const int32_t*>(nbr), v}, ws.ticket, static_cast<T*>(out), cin,
      cout, n_off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rows_bn(const void* x, const void* nbr, const void* w, const void* valid,
                    const PairWs& ws, void* out, int v, int cin, int cout, int n_off,
                    cudaStream_t s) {
  switch (pair_bn(cout)) {
    case 32: return launch_rows<T, 32>(x, nbr, w, valid, ws, out, v, cin, cout, n_off, s);
    case 96: return launch_rows<T, 96>(x, nbr, w, valid, ws, out, v, cin, cout, n_off, s);
    default: return launch_rows<T, 64>(x, nbr, w, valid, ws, out, v, cin, cout, n_off, s);
  }
}

}  // namespace

// The narrow path's dynamic shared memory a block (ops/narrow.py:smem_bytes
// computes the same).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int narrow_conv_smem(int n_off, int cin, int cout, int dtype) {
  return static_cast<int>(ntt::smem_bytes(n_off, cin, cout, dtype == 1));
}

// K1's narrow path: the same contract without pairs, pos and partial, one
// launch.  Returns its cudaError_t.
extern "C" int gather_conv_narrow(const void* x, const void* nbr, const void* w,
                                  const void* valid, void* out, int v, int cin, int cout,
                                  int n_off, int dtype, void* stream) {
  if (v == 0 || cout == 0) return 0;
  if (cin < 1 || cin > ntt::kMaxCin) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch_narrow<__nv_bfloat16>(x, nbr, w, valid, out, v, cin, cout, n_off, s)
      : launch_narrow<float>(x, nbr, w, valid, out, v, cin, cout, n_off, s);
  return static_cast<int>(err);
}

// The row width of the partial buffer for Cout.
extern "C" int gather_conv_pair_stride(int cout) { return pair_stride(cout); }

// One chunk [o_begin, o_end) of the offsets (the contract above); the
// wrapper calls it for each chunk in ascending order.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the launches' cudaError_t.
extern "C" int gather_gemm_conv(const void* x, const void* nbr, const void* w,
                                const void* valid, void* pairs, void* pos, void* partial,
                                void* carry, void* out, int v, int cin, int cout, int n_off,
                                int o_begin, int o_end, int dtype, void* stream) {
  if (v == 0 || cout == 0) return 0;
  if (o_begin < 0 || o_end <= o_begin || o_end > n_off ||
      (carry == nullptr && (o_begin > 0 || o_end < n_off)))
    return cudaErrorInvalidValue;
  const Chunk ch(o_begin, o_end, n_off, static_cast<float*>(carry));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch_bn<__nv_bfloat16>(x, nbr, w, valid, pairs, pos, partial, ch, out, v, cin, cout,
                                 n_off, s)
      : launch_bn<float>(x, nbr, w, valid, pairs, pos, partial, ch, out, v, cin, cout, n_off,
                         s);
  return static_cast<int>(err);
}

// K1's bf16 wide stems (ops/narrow.py:wide_stem): the contract of
// gather_gemm_conv in bf16 on the warpgroup core, one chunk of the offsets
// a call.  Returns the launches' cudaError_t.
extern "C" int gather_conv_wg(const void* x, const void* nbr, const void* w, const void* valid,
                              void* pairs, void* pos, void* partial, void* carry, void* out,
                              int v, int cin, int cout, int n_off, int o_begin, int o_end,
                              void* stream) {
  if (v == 0 || cout == 0) return 0;
  const int bn = wgc::pick_bn(cout);
  if (pair_stride(cout) != (cout + bn - 1) / bn * bn) return cudaErrorInvalidValue;
  if (o_begin < 0 || o_end <= o_begin || o_end > n_off ||
      (carry == nullptr && (o_begin > 0 || o_end < n_off)))
    return cudaErrorInvalidValue;
  const Chunk ch(o_begin, o_end, n_off, static_cast<float*>(carry));
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* nb = static_cast<const int32_t*>(nbr);
  const auto* va = static_cast<const uint8_t*>(valid);
  auto* pl = static_cast<int32_t*>(pairs);
  auto* ps = static_cast<int32_t*>(pos);
  auto* pt = static_cast<float*>(partial);
  auto* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bn) {
    case 32:
      err = launch_wg<32>(xb, nb, wb, va, pl, ps, pt, ch, ob, v, cin, cout, n_off, s);
      break;
    case 64:
      err = launch_wg<64>(xb, nb, wb, va, pl, ps, pt, ch, ob, v, cin, cout, n_off, s);
      break;
    case 96:
      err = launch_wg<96>(xb, nb, wb, va, pl, ps, pt, ch, ob, v, cin, cout, n_off, s);
      break;
    default:
      err = launch_wg<128>(xb, nb, wb, va, pl, ps, pt, ch, ob, v, cin, cout, n_off, s);
  }
  return static_cast<int>(err);
}

// K1's row-group form: out[r] = sum over the offsets o ascending with
// nbr[o][r] >= 0 of x[nbr[o][r]] @ w[o], 0 outside valid, in one launch
// over groups of consecutive rows (lrc::Group: fp32 64, bf16 128).  pairs:
// gather_pairs' workspace of nbr (its ticket 0, as every call leaves it).
// dtype: 0 = float32, 1 = bfloat16.  Only out is written.  Returns the
// launch's cudaError_t.
extern "C" int gather_conv_rows(const void* x, const void* nbr, const void* w,
                                const void* valid, void* pairs, void* out, int v, int cin,
                                int cout, int n_off, int dtype, void* stream) {
  if (v == 0 || cout == 0) return 0;
  if (cin < 1) return cudaErrorInvalidValue;
  const PairWs ws(static_cast<int32_t*>(pairs), v, n_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? rows_bn<__nv_bfloat16>(x, nbr, w, valid, ws, out, v, cin, cout, n_off, s)
                 : rows_bn<float>(x, nbr, w, valid, ws, out, v, cin, cout, n_off, s));
}

// A block's dynamic shared memory in the row-group form
// (ops/narrow.py:rows_smem_bytes computes the same).  dtype: 0 = float32,
// 1 = bfloat16.
extern "C" int gather_conv_rows_smem(int n_off, int cout, int dtype) {
  const int bn = pair_bn(cout);
  if (dtype == 1)
    return static_cast<int>(bn == 32   ? lrc::smem_bytes<__nv_bfloat16, 32>(n_off)
                            : bn == 96 ? lrc::smem_bytes<__nv_bfloat16, 96>(n_off)
                                       : lrc::smem_bytes<__nv_bfloat16, 64>(n_off));
  return static_cast<int>(bn == 32   ? lrc::smem_bytes<float, 32>(n_off)
                          : bn == 96 ? lrc::smem_bytes<float, 96>(n_off)
                                     : lrc::smem_bytes<float, 64>(n_off));
}
