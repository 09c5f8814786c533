// The weight-gradient tile core shared by K4 (gather_wgrad.cu) and K11
// (block_wgrad.cu).
//
// Both kernels compute, for every offset o, dW[o] = sum over a list of
// (a-row, b-row) pairs of A[a-row]^T @ B[b-row]: a GEMM of M = Cin by N =
// Cout whose reduction axis is the pairs.  They differ only in where the
// pairs come from (a `Pairs` policy: K4 a compacted per-offset list of live
// rows of an index table, K11 the level's occupied-row list shifted through
// the block halo).
//
// What bounds it: operations, 2 * pairs * Cin * Cout fp32 FMAs over inputs
// of tens of MB.  The k5 stems (Cout 32) reach about a third of it: each
// staged element of their 259-wide rows feeds only 32 FMAs.  The design:
//   * work items are (split, offset, M tile, N tile).  Persistent thread
//     blocks, as many as fit on the SMs, take items by an atomic ticket;
//     the grid and the item count follow the list's capacity, so no pair
//     count leaves the card.  The block that takes the last ticket resets
//     it for the next call (the list pass zeroes it first);
//   * an offset's pairs are cut into splits by pair index alone: split_of
//     derives the splits in use and the pairs per split from the offset's
//     count and the scratch's split capacity, on the card, the same way in
//     the tile kernel and in the split sum.  Each split writes its partial
//     dW (splits x n_off x Cin x Cout fp32 scratch); sum_splits adds the
//     splits of each offset in ascending order.  No float atomics, and a
//     split's sum runs over its pairs in ascending order, so two calls give
//     bit-equal dW;
//   * a split's pairs run in chunks of BK = 32 through a two-buffer
//     cp.async pipeline: one barrier per chunk, chunk c + 1's copies in
//     flight during chunk c's products.  A chunk stages its BK gathered A
//     rows (BM channels) and B rows (BN channels) into padded shared rows,
//     16-byte copies where the row width allows, else 4-byte copies in
//     fp32 (Cin 259) and plain loads in bf16 (odd widths); rows past the
//     list and channels past Cin / Cout are zero-filled.  A producer warp
//     beside the compute warps resolves each chunk's rows two chunks ahead
//     into three index sets, keeping only pairs whose two rows exist;
//   * fp32 multiplies on FMAs, 8 x 4 sums per thread; bf16 on
//     mma.sync.m16n8k16 tensor-core tiles (ldmatrix.trans of the k-major
//     rows), fp32 sums, each warp a 32 x 32 sub-tile.  Tiles: 288 x 32 (the
//     k5 stem, Cin 259 in one M tile), 64 x 32, 64 x 64, 96 x 96, 128 x 96
//     and 128 x 128, picked by Cin and Cout; blocks of at most 320 threads
//     are held to two an SM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgt {

constexpr int BK = 32;            // pairs per chunk
constexpr int kMinPairs = 1024;   // pairs per split, at least (but the last)

struct Split {
  int used;  // splits holding pairs
  int per;   // pairs per split, a multiple of BK
};

// The splits of `count` pairs when the scratch holds `cap` splits.  Both
// the tile kernel and sum_splits call it.
__host__ __device__ __forceinline__ Split split_of(int count, int cap) {
  if (count <= 0) return {0, BK};
  int used = (count + kMinPairs - 1) / kMinPairs;
  used = used < cap ? used : cap;
  const int per = ((count + used - 1) / used + BK - 1) / BK * BK;
  return {(count + per - 1) / per, per};
}

template <typename T> struct Elt;
template <> struct Elt<float> { static constexpr int kVec = 4, kPad = 4; };
template <> struct Elt<__nv_bfloat16> { static constexpr int kVec = 8, kPad = 8; };

template <typename T, int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int TM = 8, TN = 4;                  // fp32 sums per thread
  static constexpr int kThreads = (BM / TM) * (BN / TN);  // = 32 warps of 32 x 32
  static constexpr int AST = BM + Elt<T>::kPad;         // A row stride (elements)
  static constexpr int BST = BN + Elt<T>::kPad;         // B row stride
  static constexpr int kStage = BK * (AST + BST);       // elements
  static constexpr size_t kSmem = sizeof(T) * 2 * (size_t)kStage;
  static_assert(BM % 32 == 0 && BN % 32 == 0, "32 x 32 warp tiles");
  static_assert(kThreads == BM * BN / 32, "one warp per 32 x 32");
  static constexpr int kBlock = kThreads + 32;          // + the producer warp
  // two resident blocks where 320 threads or fewer: the 288 x 32 stem tile
  // held 139-157 registers and so one block an SM, and took 1.3-1.5x the
  // time of the same tile held to 96 registers (wgrad_bench.py)
  static constexpr int kMinBlocks = kBlock <= 320 ? 2 : 1;
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

// one element where the row breaks 16-byte alignment: a 4-byte async copy
// in fp32, a plain load in bf16 (no async copy is narrower than 4 bytes)
__device__ __forceinline__ void copy_one(float* dst, const float* src, bool ok,
                                         const float* any) {
  cp_async4(dst, ok ? src : any, ok ? 4 : 0);
}
__device__ __forceinline__ void copy_one(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                         bool ok, const __nv_bfloat16*) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

// dst[k][c] = src[rows[k]][c0 + c] for k < BK, c < W (stride ST), zero
// where rows[k] < 0 or c0 + c >= width.  Each thread keeps one column
// piece and walks the rows, so a copy costs a shared read of its row and
// one address.
template <typename T, int W, int ST, int kThreads>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, const T* __restrict__ src,
                                           const int* __restrict__ rows, int c0,
                                           int width, bool vec) {
  constexpr int V = Elt<T>::kVec;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int P = W / V;            // 16-byte pieces per row
    constexpr int R = kThreads / P;     // rows per pass
    static_assert(R >= 1, "a pass covers a row");
    const int c = (tid % P) * V;
    if (tid >= R * P) return;
    const bool in = c0 + c < width;
    for (int k = tid / P; k < BK; k += R) {
      const int s = rows[k];
      const bool ok = s >= 0 && in;
      cp_async16(dst + k * ST + c, ok ? src + (int64_t)s * width + c0 + c : src,
                 ok ? 16 : 0);
    }
  } else {
    constexpr int R = kThreads / W;
    static_assert(R >= 1, "a pass covers a row");
    const int c = tid % W;
    if (tid >= R * W) return;
    const bool in = c0 + c < width;
    for (int k = tid / W; k < BK; k += R) {
      const int s = rows[k];
      copy_one(dst + k * ST + c, src + (int64_t)s * width + c0 + c, s >= 0 && in, src);
    }
  }
}

// fp32: thread (tx, ty) owns rows ty * 8 .. + 7 and columns tx * 4 .. + 3
template <int BM, int BN>
struct FmaAcc {
  float v[8][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
  }
  __device__ __forceinline__ void compute(const float* __restrict__ As,
                                          const float* __restrict__ Bs) {
    using S = Tile<float, BM, BN>;
    const int tx = threadIdx.x % (BN / 4), ty = threadIdx.x / (BN / 4);
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * S::AST + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * S::AST + ty * 8 + 4);
      const float4 b4 = *reinterpret_cast<const float4*>(Bs + k * S::BST + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = fmaf(a[i], b[j], v[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ dst, int m0, int n0, int cin,
                                        int cout) const {
    const int tx = threadIdx.x % (BN / 4), ty = threadIdx.x / (BN / 4);
    const int n = n0 + tx * 4;
    const bool vec = cout % 4 == 0 && n + 3 < cout;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty * 8 + i;
      if (m >= cin) continue;
      float* __restrict__ row = dst + (int64_t)m * cout;
      if (vec) {
        *reinterpret_cast<float4*>(row + n) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < cout) row[n + j] = v[i][j];
      }
    }
  }
};

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

// bf16: warp w owns rows 32 (w % (BM / 32)) .. + 31 and columns
// 32 (w / (BM / 32)) .. + 31: 2 m16 x 4 n8 tiles.  Both operands are
// stored k-major (As[k][m], Bs[k][n]), so A's row-major fragments and B's
// column-major ones both come from ldmatrix.trans.
template <int BM, int BN>
struct MmaAcc {
  float v[2][4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[i][j][q] = 0.f;
  }
  __device__ __forceinline__ void compute(const __nv_bfloat16* __restrict__ As,
                                          const __nv_bfloat16* __restrict__ Bs) {
    using S = Tile<__nv_bfloat16, BM, BN>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp % (BM / 32)) * 32, wn = (warp / (BM / 32)) * 32;
    // A: matrix q = lane / 8 holds m + 8 (q & 1), k + 8 (q >> 1)
    const int ak = (lane & 7) + ((lane >> 4) << 3), am = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(a[mi], As + (kk + ak) * S::AST + wm + mi * 16 + am);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Bs + (kk + (lane & 15)) * S::BST + wn + np * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(v[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(v[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  // v[mi][ni][2 h + e]: row wm + 16 mi + lane / 4 + 8 h, column
  // wn + 8 ni + 2 (lane % 4) + e
  __device__ __forceinline__ void store(float* __restrict__ dst, int m0, int n0, int cin,
                                        int cout) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = m0 + (warp % (BM / 32)) * 32, wn = n0 + (warp / (BM / 32)) * 32;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + 16 * mi + lane / 4 + 8 * h;
        if (m >= cin) continue;
        float* __restrict__ row = dst + (int64_t)m * cout;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = wn + 8 * ni + 2 * (lane % 4);
          if (n < cout) row[n] = v[mi][ni][2 * h];
          if (n + 1 < cout) row[n + 1] = v[mi][ni][2 * h + 1];
        }
      }
  }
};

template <typename T, int BM, int BN> struct AccOf;
template <int BM, int BN> struct AccOf<float, BM, BN> { using type = FmaAcc<BM, BN>; };
template <int BM, int BN> struct AccOf<__nv_bfloat16, BM, BN> {
  using type = MmaAcc<BM, BN>;
};

// The persistent tile loop.  `Pairs` gives count(o), the pairs of offset o
// (the same on every thread), and a pair's A and B rows in three steps:
// key(o, p), the list entry of pair p < count(o); fetch(o, key), the loads
// that depend on it (an int2); finish(o, key, fetched, ra, rb), the rows,
// -1 where there is none.  Partial slot (s, slot(o)) of `partial` receives
// split s's sum; slot(o) = n_off - 1 - o with `mirror`.  Items are
// split-major, so the splits that hold pairs come first in ticket order.
//
// The block's last warp is the producer: it walks its split's pairs and
// fills each chunk's index set (three sets, chunk c in set c % 3) with the
// next BK pairs whose two rows exist, two chunks ahead of the products, its
// own loads pipelined over rounds of 32 pairs, so that they never hold the
// compute warps; a pair with a missing row adds a zero row and is dropped.  Chunks so hold pairs in
// ascending order whatever their row count, and a chunk of no pair ends
// the split.
template <typename T, int BM, int BN, class Pairs>
__device__ __forceinline__ void run_tiles(const T* __restrict__ a, const T* __restrict__ b,
                                          const Pairs& pairs, int32_t* __restrict__ ticket,
                                          float* __restrict__ partial, int cin, int cout,
                                          int n_off, int splits, int mirror) {
  using S = Tile<T, BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem);
  __shared__ int s_ra[3][BK], s_rb[3][BK], s_n[3];
  __shared__ int s_item[2];

  const int tid = threadIdx.x, lane = tid & 31;
  const bool producer = tid >= S::kThreads;
  const int n_mt = (cin + BM - 1) / BM, n_nt = (cout + BN - 1) / BN;
  const int per_split = n_off * n_mt * n_nt;
  const int n_items = per_split * splits;
  const bool vec_a = cin % Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool vec_b = cout % Elt<T>::kVec == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;

  for (int iter = 0;; ++iter) {
    // two item slots: a slot is rewritten two iterations later, after a
    // barrier every thread passed once it had read it
    if (tid == 0) s_item[iter & 1] = atomicAdd(ticket, 1);
    __syncthreads();  // also: the last item's reads of shared memory are done
    const int item = s_item[iter & 1];
    if (item >= n_items) {
      // the last ticket taken: every block is done with the counter
      if (tid == 0 && item == n_items + (int)gridDim.x - 1) *ticket = 0;
      break;
    }
    const int s = item / per_split, rem = item % per_split;
    const int o = rem / (n_mt * n_nt);
    const int m0 = (rem / n_nt) % n_mt * BM, n0 = rem % n_nt * BN;
    const int count = pairs.count(o);
    const Split sp = split_of(count, splits);
    if (s >= (sp.used > 0 ? sp.used : 1)) continue;  // split 0 always writes
    const int p_begin = s * sp.per;
    const int p_end = min(count, p_begin + sp.per);
    const int n_rounds = (p_end - p_begin + 31) / 32;

    // The producer walks its split's pairs in rounds of 32 candidates, one
    // a lane, software-pipelined: round r + 1's dependent loads and round
    // r + 2's list loads are in flight while round r is handed out, and a
    // round may feed two chunks.
    int round = -1;                        // the round being handed out
    unsigned left = 0;                     // its live pairs not handed out
    int ra0 = -1, rb0 = -1;                // this lane's pair of that round
    int key1 = -1, key2 = -1;              // the next two rounds' entries
    int2 f1 = make_int2(-1, -1);           // the next round's loads
    auto key_at = [&](int r) {
      const int p = p_begin + 32 * r + lane;
      return r < n_rounds && p < p_end ? pairs.key(o, p) : -1;
    };
    auto fetch = [&](int key) { return key >= 0 ? pairs.fetch(o, key) : make_int2(-1, -1); };
    auto advance = [&]() {                 // round + 1 becomes the one handed out
      ra0 = rb0 = -1;
      if (key1 >= 0) pairs.finish(o, key1, f1, ra0, rb0);
      left = __ballot_sync(0xFFFFFFFFu, ra0 >= 0 && rb0 >= 0);
      ++round;
      key1 = key2;
      f1 = fetch(key1);
      key2 = key_at(round + 2);
    };
    if (producer) {
      key1 = key_at(0);
      key2 = key_at(1);
      f1 = fetch(key1);
    }
    // the producer: chunk c's index set, the next BK live pairs
    auto produce = [&](int c) {
      int* const ra_set = s_ra[c % 3];
      int* const rb_set = s_rb[c % 3];
      int n = 0;
      while (n < BK) {
        if (left == 0) {
          if (round + 1 >= n_rounds) break;
          advance();
          continue;
        }
        const int rank = n + __popc(left & ((1u << lane) - 1u));
        const bool take = ((left >> lane) & 1u) && rank < BK;
        if (take) {
          ra_set[rank] = ra0;
          rb_set[rank] = rb0;
        }
        const unsigned taken = __ballot_sync(0xFFFFFFFFu, take);
        n += __popc(taken);
        left &= ~taken;
      }
      for (int i = n + lane; i < BK; i += 32) ra_set[i] = rb_set[i] = -1;
      if (lane == 0) s_n[c % 3] = n;
    };
    auto load = [&](int c) {
      T* const As = stage + (c & 1) * S::kStage;
      T* const Bs = As + BK * S::AST;
      stage_rows<T, BM, S::AST, S::kThreads>(As, a, s_ra[c % 3], m0, cin, vec_a);
      stage_rows<T, BN, S::BST, S::kThreads>(Bs, b, s_rb[c % 3], n0, cout, vec_b);
      cp_async_commit();
    };

    typename AccOf<T, BM, BN>::type acc;
    acc.zero();
    if (producer) {
      produce(0);
      produce(1);
    }
    __syncthreads();
    if (s_n[0] > 0) load(0);
    for (int c = 0;; ++c) {
      cp_async_wait_all();
      // chunk c's rows are in; buffer (c + 1) & 1 and index set
      // (c + 2) % 3 are free; index set (c + 1) % 3 is visible
      __syncthreads();
      if (s_n[c % 3] == 0) break;
      if (s_n[(c + 1) % 3] > 0) load(c + 1);
      if (producer) {
        produce(c + 2);
      } else {
        const T* const As = stage + (c & 1) * S::kStage;
        acc.compute(As, As + BK * S::AST);
      }
    }
    if (!producer) {
      const int slot = mirror ? n_off - 1 - o : o;
      acc.store(partial + ((int64_t)s * n_off + slot) * (int64_t)cin * cout, m0, n0, cin,
                cout);
    }
  }
}

// out[slot][m][n] = sum over the splits in use of offset o (slot(o)), in
// ascending order, of partial[s][slot][m][n]
template <class Pairs>
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  Pairs pairs, int n_off, int cin, int cout, int splits, int mirror) {
  const int64_t per = (int64_t)cin * cout, n = per * n_off;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int slot = (int)(e / per);
  const int used = split_of(pairs.count(mirror ? n_off - 1 - slot : slot), splits).used;
  float acc = partial[e];
  for (int s = 1; s < used; ++s) acc += partial[(int64_t)s * n + e];
  out[e] = acc;
}

// Launches the tile kernel on as many resident blocks as the items need,
// then (splits > 1) the split sum.  `Kernel` is the caller's __global__
// wrapper of run_tiles.
template <typename T, int BM, int BN, class Pairs, class Kernel, class... Args>
cudaError_t launch_tiles(Kernel kernel, const Pairs& pairs, float* partial, float* out,
                         int cin, int cout, int n_off, int splits, int mirror,
                         cudaStream_t stream, Args... args) {
  using S = Tile<T, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  static int fit = 0;  // resident blocks per SM, one per instantiation
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, S::kBlock,
                                                        S::kSmem);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  const int64_t items =
      (int64_t)n_off * ((cin + BM - 1) / BM) * ((cout + BN - 1) / BN) * splits;
  const int grid = items < (int64_t)sms * fit ? (int)items : sms * fit;
  kernel<<<grid, S::kBlock, S::kSmem, stream>>>(args...);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const int64_t n = (int64_t)n_off * cin * cout;
  sum_splits_kernel<Pairs><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, out, pairs, n_off, cin, cout, splits, mirror);
  return cudaGetLastError();
}

}  // namespace wgt
