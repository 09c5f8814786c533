// The bf16 warpgroup tile core of K10 (block_conv.cu) and of K1's wide
// stems (gather_gemm_conv.cu): one 64-row tile's products with Hopper's
// wgmma, held in fp32 registers until the caller stores them.
//
// A tile is 64 output rows (or, in K1's pair-major form, 64 pairs of one
// offset) times a BN-column tile (32, 64, 96 or 128).  Its reduction runs in
// stages of BK = 64 input channels of one offset: the caller names each
// stage's source rows (64 ints in shared memory, -1 for none), its offset
// and its first channel.  A stage copies the 64 source rows' 64-channel
// slice (A, 64 x 128 bytes) and the offset's 64 x BN weight slice (B) into a
// ring of four stage buffers with 16-byte cp.async copies (zero-filled past
// the rows, Cin and Cout); two stages' copies are in flight while the
// tensor cores work on a third and the fourth drains.  TMA cannot gather
// arbitrary rows on Hopper, so the copies stay cp.async.  Rows or weights
// whose width breaks 16-byte alignment are copied element by element
// (`vec_a`, `vec_b` false): the wrappers count such calls, and the main
// path pads the stems' rows to an aligned pitch so that none takes it.
//
// Layouts (the operand forms wgmma reads from shared memory):
//   A, K-major, 128-byte swizzle: row r's 16-byte chunk j (channels 8j ..
//     8j + 7) at r * 128 + ((j ^ (r % 8)) * 16), 1024-byte aligned; the
//     k16 steps advance the descriptor by 32 bytes within the rows;
//   B, N-major (wgmma's transposed B), 64-byte swizzle: panels of 32
//     columns, panel p at p * 4096; row kk's chunk q (columns 32 p + 8 q ..)
//     at kk * 64 + ((q ^ (kk / 2 % 4)) * 16); the k16 steps advance by 16
//     rows (1024 bytes), the panels follow at the leading-byte offset.
// Per stage: one cp.async wait (all but the newest stage's group landed), a
// proxy fence and one barrier; then the next-but-one stage's copies, the
// stage's four wgmma.m64nBNk16 (fewer where Cin ends inside the stage),
// and a wgmma wait that leaves this stage's products in flight.  So one
// barrier per 64 channels, against the mma.sync core's one per 32 with
// nothing in flight during its products.
//
// The sums are fp32; each output's order is fixed by the stage order (the
// caller's), so two calls are bit-equal.  The accumulator is wgmma's: acc[4 t
// + 2 h + e] is row 16 w + lane / 4 + 8 h (w the warp), column 8 t + 2 (lane
// % 4) + e.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // one warpgroup
constexpr int BM = 64;          // rows of a tile
constexpr int BK = 64;          // input channels of a stage
constexpr int kStages = 4;      // the ring
constexpr int kAhead = 2;       // stages whose copies run ahead of the products
constexpr int kABytes = BM * BK * 2;
constexpr int kPanel = BK * 64;  // one 32-column B panel

template <int BN>
struct Ring {
  static_assert(BN % 32 == 0 && BN >= 32 && BN <= 128, "column tile");
  static constexpr int kStage = kABytes + BN / 32 * kPanel;  // a multiple of 1024
  static constexpr int kBytes = kStages * kStage + 1024;      // + the alignment slack
};

// The column tile for Cout: Cout rounded up to 32, at most 128.
__host__ __device__ __forceinline__ int pick_bn(int cout) {
  return cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 96 ? 96 : 128;
}

__device__ __forceinline__ int a_off(int r, int j) { return r * 128 + ((j ^ (r & 7)) << 4); }
__device__ __forceinline__ int b_off(int kk, int n) {
  return (n >> 5) * kPanel + kk * 64 + ((((n >> 3) & 3) ^ ((kk >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of the generic proxy visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a shared-memory matrix descriptor: address, leading and stride byte
// offsets, swizzle mode (1: 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// d += A (64 x 16, K-major) @ B (16 x N, N-major), fp32 sums
template <int N> struct Mma;
template <> struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Mma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The ring's first byte, aligned to 1024 in the shared window (the swizzle
// patterns follow address bits).
__device__ __forceinline__ unsigned char* ring_base(unsigned char* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return smem + ((1024u - (s & 1023u)) & 1023u);
}

// Stage copies: A[r][c] = x[src[r]][k0 + c], B[kk][n] = wo[k0 + kk][n0 + n],
// zero past the rows (src < 0), Cin and Cout
template <int BN>
__device__ __forceinline__ void load_stage(unsigned char* __restrict__ st,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ wo,
                                           const int* __restrict__ src, int k0, int n0,
                                           int cin, int cout, bool vec_a, bool vec_b) {
  const int tid = threadIdx.x;
  unsigned char* const As = st;
  unsigned char* const Bs = st + kABytes;
  if (vec_a) {
#pragma unroll
    for (int i = 0; i < BM * 8 / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e >> 3, j = e & 7;
      const int s = src[r], c = k0 + j * 8;
      const bool ok = s >= 0 && c < cin;
      cp_async16(As + a_off(r, j), ok ? x + (int64_t)s * cin + c : x, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK, s = src[r];
      *reinterpret_cast<bf16*>(As + a_off(r, c >> 3) + (c & 7) * 2) =
          s >= 0 && k0 + c < cin ? x[(int64_t)s * cin + k0 + c] : __float2bfloat16(0.f);
    }
  }
  if (vec_b) {
    constexpr int P = BN / 8;
#pragma unroll
    for (int i = 0; i < BK * P / kThreads; ++i) {
      const int e = tid + i * kThreads, kk = e / P, n = (e % P) * 8;
      const bool ok = k0 + kk < cin && n0 + n < cout;
      cp_async16(Bs + b_off(kk, n), ok ? wo + (int64_t)(k0 + kk) * cout + n0 + n : wo,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, n = e % BN;
      *reinterpret_cast<bf16*>(Bs + b_off(kk, n) + (n & 7) * 2) =
          k0 + kk < cin && n0 + n < cout ? wo[(int64_t)(k0 + kk) * cout + n0 + n]
                                         : __float2bfloat16(0.f);
    }
  }
}

// A stage's source rows, offset and first channel: the caller's schedule.
struct Stage {
  const int* src;  // 64 rows in shared memory
  int o;           // the weight's offset
  int k0;          // the first input channel
};

// acc = sum over stages st < n_stages of A(st) @ B(st).  `stage(st)` gives
// a stage's rows, offset and channels; every thread of the block calls
// this with the same arguments, and the caller's shared data (the source
// rows) stays unchanged until it returns.  w is (n_off, Cin, Cout).
template <int BN, class StageOf>
__device__ __forceinline__ void mainloop(float (&acc)[BN / 2], unsigned char* __restrict__ ring,
                                         const bf16* __restrict__ x,
                                         const bf16* __restrict__ w, int n_stages,
                                         const StageOf& stage, int n0, int cin, int cout,
                                         bool vec_a, bool vec_b) {
  using R = Ring<BN>;
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  auto copy = [&](int st) {
    const Stage s = stage(st);
    load_stage<BN>(ring + (st % kStages) * R::kStage, x, w + (int64_t)s.o * cin * cout,
                   s.src, s.k0, n0, cin, cout, vec_a, vec_b);
  };
#pragma unroll
  for (int st = 0; st < kAhead; ++st) {
    if (st < n_stages) copy(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of stage st landed
    fence_proxy_async();
    // every thread's copies of stage st are visible, and every warp has
    // retired stage st - 2's products, whose buffer the next copies reuse
    __syncthreads();
    if (st + kAhead < n_stages) copy(st + kAhead);
    cp_async_commit();
    const uint32_t a = ring_s + (st % kStages) * R::kStage;
    const uint32_t b = a + kABytes;
    const int k_left = cin - stage(st).k0;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (ks * 16 < k_left)
        Mma<BN>::run(acc, desc(a + ks * 32, 16, 1024, 1), desc(b + ks * 1024, kPanel, 512, 2));
    }
    wg_commit();
    fence_acc(acc);
    wg_wait<1>();  // stage st - 1's products retired
    fence_acc(acc);
  }
  wg_wait<0>();
  fence_acc(acc);
}

// out[rows[i]][n0 + c] = acc rounded to bf16, for rows[i] >= 0 (rows in
// shared memory; columns past Cout dropped)
template <int BN>
__device__ __forceinline__ void store_rows(const float (&acc)[BN / 2], bf16* __restrict__ out,
                                           const int* __restrict__ rows, int n0, int cout) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool pair = cout % 2 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rows[16 * warp + lane / 4 + 8 * hh];
    if (row < 0) continue;
    bf16* __restrict__ o = out + (int64_t)row * cout;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      const int c = n0 + t * 8 + 2 * (lane % 4);
      const float v0 = acc[4 * t + 2 * hh], v1 = acc[4 * t + 2 * hh + 1];
      if (pair && c + 1 < cout) {
        *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < cout) o[c] = __float2bfloat16(v0);
        if (c + 1 < cout) o[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// dst[i * ld + c] = acc for the tile's rows i < live and its BN columns
// (ld even)
template <int BN>
__device__ __forceinline__ void store_f32(const float (&acc)[BN / 2], float* __restrict__ dst,
                                          int64_t ld, int live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = 16 * warp + lane / 4 + 8 * hh;
    if (i >= live) continue;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
      *reinterpret_cast<float2*>(dst + i * ld + t * 8 + 2 * (lane % 4)) =
          make_float2(acc[4 * t + 2 * hh], acc[4 * t + 2 * hh + 1]);
  }
}

// The active offsets of a tile's source table src[o][i] (n_off x BM, shared
// memory), ascending, into act[]; returns their count.  Every thread calls
// it; it ends with a barrier.  hit[] (n_off ints of shared memory) is
// scratch.
__device__ __forceinline__ int active_offsets(const int* __restrict__ src, int n_off,
                                              int* __restrict__ hit, int* __restrict__ act,
                                              int* __restrict__ n_act) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int o = warp; o < n_off; o += kThreads / 32) {
    const bool any = __any_sync(0xFFFFFFFFu, src[o * BM + lane] >= 0 ||
                                                 src[o * BM + 32 + lane] >= 0);
    if (lane == 0) hit[o] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int o0 = 0; o0 < n_off; o0 += 32) {
      const bool h = o0 + lane < n_off && hit[o0 + lane];
      const unsigned bal = __ballot_sync(0xFFFFFFFFu, h);
      if (h) act[n + __popc(bal & ((1u << lane) - 1u))] = o0 + lane;
      n += __popc(bal);
    }
    if (lane == 0) *n_act = n;
  }
  __syncthreads();
  return *n_act;
}

}  // namespace wgc
