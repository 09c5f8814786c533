// The tile core of K1 (gather_gemm_conv.cu) and K2 (up_conv.cu): the
// products of one work item, up to BM = 64 live pairs (row r, offset o) of
// one offset, each x[src] @ W[o][:, n0 .. n0 + BN), summed over Cin, held
// in registers until the caller stores them (K1 into its pair-major
// buffer, K2 straight into the output rows).
//
// Work items: an offset's pairs (K4's per-offset list, gather_wgrad.cu)
// in groups of 64, times the column tiles; persistent blocks take them by
// an atomic ticket that the block taking the last ticket resets.
//
// An item's Cin runs in 32-channel slices through a two-buffer cp.async
// pipeline: a stage copies its source rows (padded to a multiple of 16
// with zero rows) and the offset's 32 x BN weight slice into padded shared
// rows (16-byte copies; 4-byte ones for fp32 rows that break the
// alignment, Cin 259; plain loads for such bf16 rows), one barrier a
// stage, the next slice's copies in flight during this one's products.
// fp32 multiplies on FMAs (each thread up to 4 x BN/8 sums, only the
// 16-row groups that hold rows), bf16 on mma.sync.m16n8k16 (one 16-row
// group a warp), both with fp32 sums.  The order of each product's sum is
// fixed: slices, then channels, ascending.
#pragma once

#include "wgrad_tile.cuh"  // Elt, cp.async, ldmatrix.trans and mma.sync

namespace gtt {

using wgt::Elt;

constexpr int kThreads = 128;
constexpr int BM = 64;       // entries (pairs) an item
constexpr int BK = 32;       // input channels a stage

// Shared rows.  fp32 pads the A rows only (4 distinct rows a quarter
// warp); bf16 pads both, for ldmatrix.
template <typename T, int BN>
struct Smem {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int AST = BK + Elt<T>::kPad;                  // A row stride
  static constexpr int BST = BN + (kBf16 ? Elt<T>::kPad : 0);    // B row stride
  static constexpr int kStage = BM * AST + BK * BST;             // elements
  static_assert(sizeof(T) * kStage % 16 == 0, "16-byte aligned stages");
};

// Column tiles: BN = Cout up to 96 (rounded up to 32, 64 or 96), else 64.
__host__ __device__ __forceinline__ int pair_bn(int cout) {
  return cout <= 32 ? 32 : cout <= 64 || cout > 96 ? 64 : 96;
}

// Pair j of offset o is pair first[o] + j of the table; its 64-pair
// groups start at group[o].  first[] and group[] (n_off + 1 each, shared
// memory) are exclusive prefixes of the counts.
__device__ __forceinline__ void pair_prefixes(const int32_t* __restrict__ counts, int n_off,
                                              int* __restrict__ first, int* __restrict__ group) {
  if (threadIdx.x == 0) {
    int p = 0, g = 0;
    for (int o = 0; o < n_off; ++o) {
      first[o] = p;
      group[o] = g;
      const int c = counts[o];
      p += c;
      g += (c + BM - 1) / BM;
    }
    first[n_off] = p;
    group[n_off] = g;
  }
  __syncthreads();
}

// One work item: pairs j0 .. j0 + live - 1 of offset o, column tile ct.
struct Item {
  int o, j0, live, ct;
};

// Item `item` = (64-pair group, column tile); the group's offset o has
// group[o] <= grp < group[o + 1].  (The ticket loop stays in each kernel:
// taking items through a helper that held the shared slot by pointer
// cost K1 12% at level 0, and with __restrict__ on it nvcc moved the
// slot's read above the barrier.)
__device__ __forceinline__ Item decode_item(int item, const int* first, const int* group,
                                            int n_off, int n_col) {
  const int grp = item / n_col;
  int lo = 0, hi = n_off;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (group[mid] <= grp) lo = mid; else hi = mid;
  }
  Item it;
  it.o = lo;
  it.ct = item % n_col;
  it.j0 = (grp - group[lo]) * BM;
  it.live = min(BM, first[lo + 1] - first[lo] - it.j0);
  return it;
}

// out[c .. c + 3] of one row = q, columns past Cout dropped
__device__ __forceinline__ void store4(float* __restrict__ o, int c, int cout, const float4& q) {
  if (cout % 4 == 0 && c + 3 < cout) {
    *reinterpret_cast<float4*>(o + c) = q;
    return;
  }
  const float e[4] = {q.x, q.y, q.z, q.w};
  for (int j = 0; j < 4 && c + j < cout; ++j) o[c + j] = e[j];
}
__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ o, int c, int cout,
                                       const float4& q) {
  if (cout % 4 == 0 && c + 3 < cout) {
    *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(q.x, q.y);
    *reinterpret_cast<__nv_bfloat162*>(o + c + 2) = __floats2bfloat162_rn(q.z, q.w);
    return;
  }
  const float e[4] = {q.x, q.y, q.z, q.w};
  for (int j = 0; j < 4 && c + j < cout; ++j) o[c + j] = __float2bfloat16(e[j]);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Stage: A[r][kk] = x[src[r]][k0 + kk] for the n_rows (a multiple of 16)
// first rows (zero past `live`, or past Cin);
// B[kk][n] = w[o][k0 + kk][n0 + n] (zero past Cin or Cout)
template <typename T, int BN>
__device__ __forceinline__ void load_stage(T* __restrict__ As, T* __restrict__ Bs,
                                           const T* __restrict__ x, const T* __restrict__ wo,
                                           const int* __restrict__ src, int live, int n_rows,
                                           int k0, int n0, int cin, int cout, bool vec_a,
                                           bool vec_b) {
  using S = Smem<T, BN>;
  constexpr int V = Elt<T>::kVec;
  const int tid = threadIdx.x;
  if (vec_a) {
    constexpr int P = BK / V;
    for (int e = tid; e < n_rows * P; e += kThreads) {
      const int r = e / P, c = (e % P) * V;
      const int s = r < live ? src[r] : -1;
      const bool ok = s >= 0 && k0 + c < cin;
      wgt::cp_async16(As + r * S::AST + c, ok ? x + (int64_t)s * cin + k0 + c : x,
                      ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < n_rows * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int s = r < live ? src[r] : -1;
      wgt::copy_one(As + r * S::AST + c, x + (int64_t)s * cin + k0 + c,
                    s >= 0 && k0 + c < cin, x);
    }
  }
  if (vec_b) {
    constexpr int P = BN / V;
    static_assert(BK * P % kThreads == 0, "whole copies per thread");
#pragma unroll
    for (int i = 0; i < BK * P / kThreads; ++i) {
      const int e = tid + i * kThreads, kk = e / P, n = (e % P) * V;
      const bool ok = k0 + kk < cin && n0 + n < cout;
      wgt::cp_async16(Bs + kk * S::BST + n,
                      ok ? wo + (int64_t)(k0 + kk) * cout + n0 + n : wo, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, n = e % BN;
      wgt::copy_one(Bs + kk * S::BST + n, wo + (int64_t)(k0 + kk) * cout + n0 + n,
                    k0 + kk < cin && n0 + n < cout, wo);
    }
  }
}

// fp32 partial sums: thread (tx, ty) = (tid % 8, tid / 8) owns entries ty +
// 16 i (i < 4) and columns (j / 4) * 32 + tx * 4 + j % 4 (j < BN / 8), so a
// quarter warp's 16-byte reads of a B row are contiguous
template <typename T, int BN> struct Part;
template <int BN> struct Part<float, BN> {
  static constexpr int TN = BN / 8;
  float v[4][TN];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) v[i][j] = 0.f;
  }
  // the groups i < n_i, channels kk < k_end (a multiple of 4)
  __device__ __forceinline__ void compute(const float* __restrict__ As,
                                          const float* __restrict__ Bs, int n_i, int k_end) {
    using S = Smem<float, BN>;
    const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      if (kk >= k_end) break;
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < n_i) a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * S::AST + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[TN];
#pragma unroll
        for (int j4 = 0; j4 < TN / 4; ++j4) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(Bs + (kk + q) * S::BST + j4 * 32 + tx * 4);
          b[4 * j4] = w4.x;
          b[4 * j4 + 1] = w4.y;
          b[4 * j4 + 2] = w4.z;
          b[4 * j4 + 3] = w4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < n_i) {
            const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int j = 0; j < TN; ++j) v[i][j] = fmaf(av, b[j], v[i][j]);
          }
        }
      }
    }
  }
  // dst[e * ld + col] = v for the entries e below `live`
  __device__ __forceinline__ void store(float* __restrict__ dst, int ld, int live) const {
    const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = ty + 16 * i;
      if (e >= live) continue;
#pragma unroll
      for (int j4 = 0; j4 < TN / 4; ++j4)
        *reinterpret_cast<float4*>(dst + (int64_t)e * ld + j4 * 32 + tx * 4) =
            make_float4(v[i][4 * j4], v[i][4 * j4 + 1], v[i][4 * j4 + 2], v[i][4 * j4 + 3]);
    }
  }
  // out[row[e]][n0 + col] = v for the entries e below `live` whose row is
  // >= 0 (out is (rows, Cout); columns past Cout dropped)
  __device__ __forceinline__ void store_rows(float* __restrict__ out, const int* __restrict__ row,
                                             int live, int n0, int cout) const {
    const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = ty + 16 * i;
      const int r = e < live ? row[e] : -1;
      if (r < 0) continue;
      float* const o = out + (int64_t)r * cout + n0;
#pragma unroll
      for (int j4 = 0; j4 < TN / 4; ++j4) {
        const int c = j4 * 32 + tx * 4;
        if (n0 + c < cout)
          store4(o, c, cout - n0,
                 make_float4(v[i][4 * j4], v[i][4 * j4 + 1], v[i][4 * j4 + 2], v[i][4 * j4 + 3]));
      }
    }
  }
};

// bf16 partial sums: warp w owns entries 16 w .. 16 w + 15 and every
// column, BN / 8 n8 tiles; v[t][2 h + e] is entry 16 w + lane / 4 + 8 h,
// column t * 8 + 2 (lane % 4) + e
template <int BN> struct Part<__nv_bfloat16, BN> {
  float v[BN / 8][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[t][q] = 0.f;
  }
  // the warps w < n_i, channels kk < k_end (a multiple of 16)
  __device__ __forceinline__ void compute(const __nv_bfloat16* __restrict__ As,
                                          const __nv_bfloat16* __restrict__ Bs, int n_i,
                                          int k_end) {
    using S = Smem<__nv_bfloat16, BN>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp >= n_i) return;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      if (kk >= k_end) break;
      uint32_t a[4];
      ldmatrix_x4(a, As + (16 * warp + (lane & 15)) * S::AST + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < BN / 8; nt += 2) {
        uint32_t b[4];
        wgt::ldmatrix_x4_trans(b, Bs + (kk + (lane & 15)) * S::BST + nt * 8 + (lane >> 4) * 8);
        wgt::mma_bf16(v[nt], a, b[0], b[1]);
        wgt::mma_bf16(v[nt + 1], a, b[2], b[3]);
      }
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ dst, int ld, int live) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int e = 16 * warp + lane / 4 + 8 * hh;
      if (e >= live) continue;
#pragma unroll
      for (int t = 0; t < BN / 8; ++t)
        *reinterpret_cast<float2*>(dst + (int64_t)e * ld + t * 8 + 2 * (lane % 4)) =
            make_float2(v[t][2 * hh], v[t][2 * hh + 1]);
    }
  }
  // out[row[e]][n0 + col] = v rounded to bf16, as the fp32 store_rows
  __device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                             const int* __restrict__ row, int live, int n0,
                                             int cout) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int e = 16 * warp + lane / 4 + 8 * hh;
      const int r = e < live ? row[e] : -1;
      if (r < 0) continue;
      __nv_bfloat16* const o = out + (int64_t)r * cout;
#pragma unroll
      for (int t = 0; t < BN / 8; ++t) {
        const int c = n0 + t * 8 + 2 * (lane % 4);
        if (cout % 2 == 0 && c + 1 < cout) {
          *reinterpret_cast<__nv_bfloat162*>(o + c) =
              __floats2bfloat162_rn(v[t][2 * hh], v[t][2 * hh + 1]);
        } else {
          if (c < cout) o[c] = __float2bfloat16(v[t][2 * hh]);
          if (c + 1 < cout) o[c + 1] = __float2bfloat16(v[t][2 * hh + 1]);
        }
      }
    }
  }
};

// The products x[src[e]] @ w[o][:, n0 .. n0 + BN) of the rows e < live
// (live <= BM) into `part`: Cin in ascending slices through the two
// stages of `stage`.  Every thread of the block calls it; src is visible
// to all of them.
template <typename T, int BN>
__device__ __forceinline__ void products(Part<T, BN>& part, T* __restrict__ stage,
                                         const T* __restrict__ x, const T* __restrict__ w,
                                         const int* __restrict__ src, int live, int o, int n0,
                                         int cin, int cout, bool vec_a, bool vec_b) {
  using S = Smem<T, BN>;
  constexpr int KQ = sizeof(T) == 2 ? 16 : 4;  // the products' channel step
  const int n_kc = (cin + BK - 1) / BK, n_rows = (live + 15) / 16 * 16;
  const T* __restrict__ wo = w + (int64_t)o * cin * cout;
  auto copy_slice = [&](int kc) {
    T* const As = stage + (kc & 1) * S::kStage;
    load_stage<T, BN>(As, As + BM * S::AST, x, wo, src, live, n_rows, kc * BK, n0, cin, cout,
                      vec_a, vec_b);
    wgt::cp_async_commit();
  };
  part.zero();
  copy_slice(0);
  for (int kc = 0; kc < n_kc; ++kc) {
    wgt::cp_async_wait_all();
    __syncthreads();  // slice kc is visible; slice kc - 1's buffer is free
    if (kc + 1 < n_kc) copy_slice(kc + 1);
    const int k_end = min(BK, cin - kc * BK);
    const T* const As = stage + (kc & 1) * S::kStage;
    part.compute(As, As + BM * S::AST, n_rows / 16, (k_end + KQ - 1) / KQ * KQ);
  }
}

}  // namespace gtt
