// The narrow-input tile core of K1 (gather_gemm_conv.cu) and K10
// (block_conv.cu): out[r] = sum_o x[src(r, o)] @ W[o] for a tile of output
// rows when Cin is a few channels (the Baseline's k5 stem, rgb 3 -> 32).
//
// Both kernels' wide paths run one pipeline stage per (offset, 32-channel
// slice) behind a barrier.  At Cin 3 that is 125 barriers a tile, stages of
// which 29 of 32 lanes are zero, and (K1) a pair-major buffer ten times as
// wide as its input.  This core is the JAX package's im2col form instead
// (segdino3d_tpu/ops/sparse_conv.py:238, 276-290: one GEMM of K = n_off *
// Cin), tiled for Hopper.  What bounds it: in fp32 the FMAs, 2 * rows *
// n_off * Cin * Cout (every offset of a tile's rows is multiplied, a fifth
// of them live at the stem); in bf16 the gathers, a (row, offset) source
// and its Cin values each; both well under a millisecond.  The design:
//   * a persistent thread block stages the whole weight, (n_off * Cin) x
//     Cout, in shared memory once with 16-byte async copies (48 KB fp32 /
//     30 KB bf16 at k5 3 -> 32), then takes tiles of BM = 128 output rows;
//   * a tile runs its offsets in chunks of G <= 16 offsets (G * Cin at most
//     48 packed channels in fp32, 64 in bf16: 8 chunks at Cin 3).  A chunk
//     gathers each row's G sources into an im2col tile in shared memory,
//     (rows) x (offset, channel), with scalar loads: 12- or 6-byte rows
//     take no 16-byte copies, and the input (a few MB) stays in L2.  Each
//     thread holds kPairs = 16 (row, offset) pairs of a chunk.  K1 resolves
//     the next chunk's sources (its neighbour table, streamed from device
//     memory) before it multiplies this one, so their loads are in flight
//     during the products; K10 resolves a chunk's sources through the halo
//     eight at a time (16 at once spilled registers and ran slower).  A
//     thread loads its pairs' rows together, then stores them, the channel
//     loops unrolled for each Cin (a branch on Cin, the same for every
//     thread).  An absent source (-1) is zeros.  Two barriers a chunk; a
//     chunk in which no row has a source is not multiplied;
//   * fp32 on FMAs: thread (tx, ty) = (tid % 4, tid / 4) holds rows ty + 32
//     i (i < 4) and columns tx * 4 + {0..3, 16..19} of a 32-column tile, 6
//     shared loads to 32 FMAs (the tile's odd row stride puts a warp's rows
//     in distinct banks).  Per offset, its Cin products go into a partial
//     (channels ascending, from 0), and the partials are added to the sum
//     in ascending offset order: the plain versions' order and, bit for
//     bit, both kernels' wide paths'.  A small training step amplifies
//     rounding (PERF.md section 6), so the order is kept;
//   * bf16 on mma.sync.m16n8k16 over the packed channels (each chunk's G *
//     Cin zero-padded to a multiple of 16), fp32 sums; warp w holds rows
//     32 w .. 32 w + 31.  The sum follows the MMA over 16-channel steps,
//     not the offsets: bf16 results agree with the plain version to 1e-2,
//     not bit for bit.
// No atomics touch the output, so two calls are bit-equal.  The caller
// fills, per tile, s.row (each slot's output row, -1 for none: nothing is
// stored) and s.key (the row whose sources the slot gathers, -1 for none:
// its output is 0) and passes a source functor src(key, o) with a
// constexpr bool kAhead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntt {

constexpr int kThreads = 128;
constexpr int BM = 128;     // output rows a tile
constexpr int BN = 32;      // output columns a column tile
constexpr int kMaxCin = 8;  // input channels, at most (a source row in registers)
constexpr int kPairs = 16;  // (row, offset) pairs of a chunk a thread holds
constexpr int kMaxG = kPairs * kThreads / BM;   // offsets a chunk, at most

// The shared-memory layout of a shape.  Chunk c holds offsets c * g ..
// c * g + g - 1; its weight rows start at c * kc, row (o - c * g) * Cin +
// channel.  ops/narrow.py:layout mirrors it.
struct Layout {
  int g;       // offsets a chunk
  int kc;      // a chunk's packed channels (bf16: padded to 16)
  int ast;     // the im2col tile's row stride, elements
  int chunks;
  int kp;      // weight rows
  int wst;     // weight row stride, elements
};

__host__ __device__ __forceinline__ Layout layout(int n_off, int cin, int cout, bool bf16) {
  Layout l;
  int per = (bf16 ? 64 : 48) / cin;
  per = per < kMaxG ? per : kMaxG;
  l.g = per < 1 ? 1 : (per < n_off ? per : n_off);
  l.chunks = (n_off + l.g - 1) / l.g;
  const int cols = (cout + BN - 1) / BN * BN;
  if (bf16) {
    l.kc = (l.g * cin + 15) / 16 * 16;
    l.ast = l.kc + 8;   // 16-byte rows for ldmatrix, shifted 4 banks a row
    l.kp = l.chunks * l.kc;
    l.wst = cols + 8;
  } else {
    l.kc = l.g * cin;
    l.ast = l.kc | 1;   // odd: 32 consecutive rows in 32 banks
    l.kp = n_off * cin;
    l.wst = cols;
  }
  return l;
}

// Dynamic shared memory of a block: the weights, the im2col tile, s.row
// and s.key.
__host__ __device__ __forceinline__ size_t smem_bytes(int n_off, int cin, int cout,
                                                      bool bf16) {
  const Layout l = layout(n_off, cin, cout, bf16);
  return (bf16 ? 2 : 4) * ((size_t)l.kp * l.wst + (size_t)BM * l.ast) +
         2 * BM * sizeof(int);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T>
struct Smem {
  T* w;      // [kp][wst]
  T* a;      // [BM][ast]
  int* row;  // [BM]
  int* key;  // [BM]
  __device__ __forceinline__ Smem(unsigned char* base, const Layout& l) {
    w = reinterpret_cast<T*>(base);
    a = w + (size_t)l.kp * l.wst;
    row = reinterpret_cast<int*>(a + BM * l.ast);
    key = row + BM;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The whole weight (n_off, Cin, Cout) into s.w, zero in the padding.  A
// chunk's weight rows are consecutive rows of w (row o * Cin + channel), so
// a 16-byte piece of a row goes in one async copy where Cout allows it;
// the padding is written with plain stores meanwhile.  Visible after the
// caller's next barrier.
template <typename T>
__device__ __forceinline__ void stage_weights(const Smem<T>& s, const Layout& l,
                                              const T* __restrict__ w, int n_off, int cin,
                                              int cout) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, rows_c = l.g * cin, live = n_off * cin;
  const bool vec = cout % V == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int per = vec ? cout / V : cout;   // pieces (elements) a row
  for (int e = tid; e < live * per; e += kThreads) {
    const int r = e / per, p = e % per;
    T* const dst = s.w + (size_t)((r / rows_c) * l.kc + r % rows_c) * l.wst;
    if (vec)
      cp_async16(dst + p * V, w + (size_t)r * cout + p * V);
    else
      dst[p] = w[(size_t)r * cout + p];
  }
  const int pad = l.wst - cout;   // columns past Cout
  for (int e = tid; e < l.kp * pad; e += kThreads)
    s.w[(e / pad) * l.wst + cout + e % pad] = zero<T>();
  for (int kr = tid; kr < l.kp; kr += kThreads) {   // bf16: a chunk's rows past its live ones
    const int c = kr / l.kc, k = kr % l.kc;
    if (k >= min(l.g, n_off - c * l.g) * cin)
      for (int n = 0; n < cout; ++n) s.w[kr * l.wst + n] = zero<T>();
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The sources of pairs u0 .. u0 + P - 1 of this thread (pair u: e = tid +
// 128 u, row e % BM, offset o0 + e / BM) in chunk (o0, g), -1 where absent
// or past the chunk.
template <int P, class Src>
__device__ __forceinline__ void resolve(int (&sr)[P], const int* __restrict__ key,
                                        const Src& src, int o0, int g, int u0) {
#pragma unroll
  for (int u = 0; u < P; ++u) {   // a warp: one offset, 32 rows
    const int e = threadIdx.x + (u0 + u) * kThreads;
    const int k = e < BM * g ? key[e % BM] : -1;
    sr[u] = k >= 0 ? src(k, o0 + e / BM) : -1;
  }
}

// Those pairs' rows into the im2col tile, A[i][j * CIN + ch] = x[sr][ch]
// (zeros for an absent source), loaded H pairs at a time.  Returns whether
// one of the pairs has a source.
template <typename T, int CIN, int P>
__device__ __forceinline__ int place(const Smem<T>& s, const Layout& l,
                                     const T* __restrict__ x, const int (&sr)[P], int g,
                                     int u0) {
  constexpr int H = P < (CIN <= 4 ? 16 : 8) ? P : (CIN <= 4 ? 16 : 8);
  int any = 0;
#pragma unroll
  for (int h0 = 0; h0 < P; h0 += H) {
    T v[H][CIN];
#pragma unroll
    for (int u = 0; u < H; ++u)
#pragma unroll
      for (int ch = 0; ch < CIN; ++ch)
        v[u][ch] = sr[h0 + u] >= 0 ? x[(int64_t)sr[h0 + u] * CIN + ch] : zero<T>();
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const int e = threadIdx.x + (u0 + h0 + u) * kThreads;
      if (e >= BM * g) continue;
      T* const a = s.a + (e % BM) * l.ast + (e / BM) * CIN;
#pragma unroll
      for (int ch = 0; ch < CIN; ++ch) a[ch] = v[u][ch];
      any |= sr[h0 + u] >= 0;
    }
  }
  return any;
}

// This thread's kPairs pairs of chunk (o0, g) into the im2col tile: from
// `sr` resolved ahead (Src::kAhead), or resolved here, eight at a time,
// each eight's rows loaded before the next eight resolve (a source whose
// resolution takes many registers, K10's halo).
template <typename T, int CIN, class Src>
__device__ __forceinline__ int gather(const Smem<T>& s, const Layout& l,
                                      const T* __restrict__ x, const Src& src,
                                      const int (&sr)[kPairs], int o0, int g) {
  if constexpr (Src::kAhead) {
    return place<T, CIN, kPairs>(s, l, x, sr, g, 0);
  } else {
    int any = 0;
#pragma unroll 1   // unrolled, the two eights held more registers and ran slower
    for (int u0 = 0; u0 < kPairs; u0 += 8) {
      int part[8];
      resolve<8>(part, s.key, src, o0, g, u0);
      any |= place<T, CIN, 8>(s, l, x, part, g, u0);
    }
    return any;
  }
}

// The chunk's im2col tile and (bf16) its zero padding.  Returns, to every
// thread, whether some row has a source.
template <typename T, class Src>
__device__ __forceinline__ int fill(const Smem<T>& s, const Layout& l,
                                    const T* __restrict__ x, const Src& src,
                                    const int (&sr)[kPairs], int o0, int g, int cin) {
  int any = 0;
  switch (cin) {
    case 1: any = gather<T, 1>(s, l, x, src, sr, o0, g); break;
    case 2: any = gather<T, 2>(s, l, x, src, sr, o0, g); break;
    case 3: any = gather<T, 3>(s, l, x, src, sr, o0, g); break;
    case 4: any = gather<T, 4>(s, l, x, src, sr, o0, g); break;
    case 5: any = gather<T, 5>(s, l, x, src, sr, o0, g); break;
    case 6: any = gather<T, 6>(s, l, x, src, sr, o0, g); break;
    case 7: any = gather<T, 7>(s, l, x, src, sr, o0, g); break;
    default: any = gather<T, 8>(s, l, x, src, sr, o0, g); break;
  }
  const int used = g * cin, pad = l.kc - used;
  if (pad > 0)
    for (int e = threadIdx.x; e < BM * pad; e += kThreads)
      s.a[(e / pad) * l.ast + used + e % pad] = zero<T>();
  return __syncthreads_or(any);
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
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> struct Acc;

// fp32: v[i][q] is row ty + 32 i, column tx * 4 + q (q < 4) or 16 + tx * 4
// + q - 4 (q >= 4)
template <> struct Acc<float> {
  float v[4][8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) v[i][q] = 0.f;
  }
  // the chunk's g offsets, ascending; wc = the chunk's first weight row at
  // the column tile
  __device__ __forceinline__ void chunk(const float* __restrict__ a,
                                        const float* __restrict__ wc, const Layout& l, int g,
                                        int cin) {
    const int tx = threadIdx.x % 4, ty = threadIdx.x / 4;
    for (int j = 0; j < g; ++j) {
      float p[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) p[i][q] = 0.f;
#pragma unroll 4
      for (int ch = 0; ch < cin; ++ch) {
        const int k = j * cin + ch;
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a[(ty + 32 * i) * l.ast + k];
        const float* const wk = wc + k * l.wst + tx * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(wk);
        const float4 b1 = *reinterpret_cast<const float4*>(wk + 16);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) p[i][q] = fmaf(av[i], b[q], p[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) v[i][q] += p[i][q];
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ out, const int* __restrict__ rows,
                                        int n0, int cout) const {
    const int tx = threadIdx.x % 4, ty = threadIdx.x / 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rows[ty + 32 * i];
      if (r < 0) continue;
      float* __restrict__ o = out + (int64_t)r * cout;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + 16 * h + tx * 4;
        const float* const q = v[i] + 4 * h;
        if (cout % 4 == 0 && c + 3 < cout) {
          *reinterpret_cast<float4*>(o + c) = make_float4(q[0], q[1], q[2], q[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < cout) o[c + e] = q[e];
        }
      }
    }
  }
};

// bf16: mma accumulators, v[m][t][2 h + e] is row 32 w + 16 m + lane / 4 +
// 8 h, column t * 8 + 2 (lane % 4) + e
template <> struct Acc<__nv_bfloat16> {
  float v[2][4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[m][t][q] = 0.f;
  }
  __device__ __forceinline__ void chunk(const __nv_bfloat16* __restrict__ a,
                                        const __nv_bfloat16* __restrict__ wc, const Layout& l,
                                        int g, int cin) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int k_end = (g * cin + 15) / 16 * 16;
    for (int kk = 0; kk < k_end; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldmatrix_x4(af[m], a + (32 * warp + 16 * m + (lane & 15)) * l.ast + kk +
                               (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 4; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wc + (kk + (lane & 15)) * l.wst + nt * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(v[m][nt], af[m], b[0], b[1]);
          mma_bf16(v[m][nt + 1], af[m], b[2], b[3]);
        }
      }
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ out,
                                        const int* __restrict__ rows, int n0, int cout) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rows[32 * warp + 16 * m + lane / 4 + 8 * hh];
        if (r < 0) continue;
        __nv_bfloat16* __restrict__ o = out + (int64_t)r * cout;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = n0 + t * 8 + 2 * (lane % 4);
          const float e0 = v[m][t][2 * hh], e1 = v[m][t][2 * hh + 1];
          if (cout % 2 == 0 && c + 1 < cout) {
            *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(e0, e1);
          } else {
            if (c < cout) o[c] = __float2bfloat16(e0);
            if (c + 1 < cout) o[c + 1] = __float2bfloat16(e1);
          }
        }
      }
  }
};

// One tile whose s.row and s.key are set (and visible: the caller's
// barrier): every column tile, each over the chunks in order.  Ends with a
// barrier after the last chunk's products; the stores follow it, so the
// caller must pass a barrier before it writes s.row again.
template <typename T, class Src>
__device__ __forceinline__ void tile(const Smem<T>& s, const Layout& l, const T* __restrict__ x,
                                     const Src& src, T* __restrict__ out, int n_off, int cin,
                                     int cout) {
  for (int n0 = 0; n0 < cout; n0 += BN) {
    Acc<T> acc;
    acc.zero();
    int sr[kPairs];
    if constexpr (Src::kAhead) resolve<kPairs>(sr, s.key, src, 0, min(l.g, n_off), 0);
    for (int c = 0; c < l.chunks; ++c) {
      const int o0 = c * l.g, g = min(l.g, n_off - o0);
      const int any = fill<T>(s, l, x, src, sr, o0, g, cin);
      if constexpr (Src::kAhead)   // in flight during this chunk's products
        if (c + 1 < l.chunks)
          resolve<kPairs>(sr, s.key, src, o0 + l.g, min(l.g, n_off - o0 - l.g), 0);
      if (any) acc.chunk(s.a, s.w + (size_t)c * l.kc * l.wst + n0, l, g, cin);
      __syncthreads();  // the chunk's products are done with s.a
    }
    acc.store(out, s.row, n0, cout);
  }
}

// A source through an (n_off, v) index table: row r's source at offset o
// is nbr[o][r] (K1's narrow path, K4's narrow weight gradient).  A warp's
// 32 consecutive rows of one offset read one 128-byte line.
struct TableSrc {
  static constexpr bool kAhead = true;   // one load a source
  const int32_t* __restrict__ nbr;
  int v;
  __device__ __forceinline__ int operator()(int r, int o) const {
    return nbr[(int64_t)o * v + r];
  }
};

// The launch grid of a persistent kernel (both paths of K1 and K10): as
// many blocks of `threads` as are resident on the card at `smem` bytes of
// dynamic shared memory, at most `items` (at least 1); sets the kernel's
// shared-memory limit.  The residency is cached per (kernel, smem).
template <class K>
cudaError_t grid_of(K kernel, int threads, size_t smem, int64_t items, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  static const void* known_fn[16] = {};
  static size_t known_smem[16] = {};
  static int known_fit[16] = {};
  const void* fn = reinterpret_cast<const void*>(kernel);
  int fit = 0, slot = 0;
  for (; slot < 16 && known_fn[slot] != nullptr; ++slot)
    if (known_fn[slot] == fn && known_smem[slot] == smem) fit = known_fit[slot];
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    if (slot < 16) {
      known_fn[slot] = fn;
      known_smem[slot] = smem;
      known_fit[slot] = fit;
    }
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int64_t most = (int64_t)sms * fit;
  *grid = (int)(items < most ? (items > 0 ? items : 1) : most);
  return cudaSuccess;
}

}  // namespace ntt
