// K10: halo-padded block convolution, out[c] = sum_o halo[c + o] @ W[o].
//
// Replaces segdino3d_tpu/ops/block_dense.py:halo_pad (:152-232) with
// _conv_valid and dense_subm_conv (:243-308), and the chunked conv's
// forward (_chunked_conv_cd, :358-387).  Features live as flat dense rows
// (n_blocks * edge^3, Cin) (block_tile.cuh); each block is padded with the
// cells of its 26 shell neighbours to (edge + 2h)^3, h = (k - 1) / 2, and a
// VALID k^3 cross-correlation over the padded block gives its edge^3
// outputs, zeroed at unoccupied cells when the occupancy mask is given.  On
// the main path it runs the 46 k3 convs of the BasicBlocks (block-dense
// levels), the training plan's dense k5 stem (259 -> 32), and, with
// offset-flipped, channel-transposed weights and no mask, every block conv's
// input gradient (the mirror identity of _chunked_conv_bwd, :396-412).
//
// What bounds it: operations.  It computes every cell of a block, occupied
// or not (a fifth of them are, on the headline scene): 2 * n_blocks * edge^3
// * k^3 * Cin * Cout flops over inputs of tens of MB.  This first version
// multiplies with fp32 FMAs (67 TFLOP/s), not tensor cores.  The design
// never writes the halo-padded tensor to device memory: one thread block
// owns one 64-cell tile of a block (a whole edge-4 block, one x plane of an
// edge-8 block) and a tile of BN output channels, stages the padded block
// for a 16-channel slice of Cin in shared memory as fp32, straight from the
// block's and its neighbours' cores, then walks the k^3 offsets: each
// offset's window is an address shift inside the staged tile, and the
// offset's 16 x BN weight slice is staged beside it.  Each thread keeps 8
// cells x TN channels of fp32 sums in registers.  Under the mask a tile
// with no occupied cell is written as zeros without any product.  The order
// of the sums is fixed (Cin slices, then offsets, then channels), so a run
// is deterministic.  Computing occupied cells only, and tensor-core tiles,
// are later work.
//
// Contract: x (n_blocks * edge^3, Cin), w (k^3, Cin, Cout) and out
// (n_blocks * edge^3, Cout) share one dtype (fp32 or bf16), rows contiguous;
// block_nbr (26, n_blocks) int32; occ (n_blocks * edge^3,) bytes or null;
// edge in {4, 8}, k in {3, 5}.
#include "block_tile.cuh"

namespace {

using bdt::from_f;
using bdt::to_f;

constexpr int TM = 8;                 // cells per thread
constexpr int kRowGroups = 64 / TM;   // a tile is 64 cells
constexpr int CK = 16;                // input channels per shared-memory slice

template <int EDGE, int K>
struct Tile {
  static constexpr int H = (K - 1) / 2;
  static constexpr int P = EDGE + 2 * H;  // padded block edge
  static constexpr int PP = P * P;
  static constexpr int P3 = P * P * P;
  static constexpr int kCells = EDGE * EDGE * EDGE;
};

template <int EDGE, int K, int BN>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)CK * (Tile<EDGE, K>::P3 + BN) +
         sizeof(int) * (size_t)Tile<EDGE, K>::P3;
}

template <typename T, int EDGE, int K, int BN, int TN>
__global__ void __launch_bounds__(kRowGroups * (BN / TN))
block_conv_kernel(const T* __restrict__ x, const int32_t* __restrict__ block_nbr,
                  const T* __restrict__ w, const uint8_t* __restrict__ occ,
                  T* __restrict__ out, int n_blocks, int cin, int cout) {
  using S = Tile<EDGE, K>;
  constexpr int kColGroups = BN / TN;
  constexpr int kThreads = kRowGroups * kColGroups;
  constexpr int kTiles = S::kCells / 64;
  extern __shared__ __align__(16) float smem[];
  float* halo = smem;                                    // [CK][P3]
  float* ws = halo + CK * S::P3;                         // [CK][BN]
  int* src = reinterpret_cast<int*>(ws + CK * BN);       // [P3] source rows

  const int b = blockIdx.x / kTiles;
  const int cell0 = (blockIdx.x % kTiles) * 64;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;
  const int ty = tid / kColGroups;
  const int64_t row0 = (int64_t)b * S::kCells + cell0;

  if (occ) {
    int any = 0;
    for (int r = tid; r < 64; r += kThreads) any |= occ[row0 + r];
    if (!__syncthreads_or(any)) {
      for (int e = tid; e < 64 * BN; e += kThreads) {
        const int n = n0 + e % BN;
        if (n < cout) out[(row0 + e / BN) * cout + n] = from_f<T>(0.f);
      }
      return;
    }
  }
  for (int p = tid; p < S::P3; p += kThreads) {
    const int px = p / S::PP, py = (p / S::P) % S::P, pz = p % S::P;
    src[p] = bdt::halo_row(block_nbr, n_blocks, b, EDGE, px - S::H, py - S::H,
                           pz - S::H);
  }
  // this thread's cells cell0 + ty + kRowGroups * i: their windows' origin in
  // the padded block
  int base[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = cell0 + ty + kRowGroups * i;
    base[i] = (c / (EDGE * EDGE)) * S::PP + ((c / EDGE) % EDGE) * S::P + c % EDGE;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  __syncthreads();  // src is complete

  for (int k0 = 0; k0 < cin; k0 += CK) {
    // the padded block's Cin slice [k0, k0 + CK), channel-major; the last
    // offset's trailing barrier freed the previous slice
    for (int e = tid; e < S::P3 * CK; e += kThreads) {
      const int p = e / CK, kk = e % CK;
      const int s = src[p];
      halo[kk * S::P3 + p] =
          (s >= 0 && k0 + kk < cin) ? to_f(x[(int64_t)s * cin + k0 + kk]) : 0.f;
    }
    for (int o = 0; o < K * K * K; ++o) {
      const T* __restrict__ wo = w + ((int64_t)o * cin + k0) * cout + n0;
      for (int e = tid; e < CK * BN; e += kThreads) {
        const int kk = e / BN, n = e % BN;
        ws[e] = (k0 + kk < cin && n0 + n < cout) ? to_f(wo[(int64_t)kk * cout + n]) : 0.f;
      }
      __syncthreads();  // ws (and on the first offset the halo) visible
      const float* hp =
          halo + (o / (K * K)) * S::PP + ((o / K) % K) * S::P + o % K;
#pragma unroll
      for (int kk = 0; kk < CK; ++kk) {
        float a[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = hp[kk * S::P3 + base[i]];
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&ws[kk * BN + tx * TN + j]);
          bv[j] = v.x;
          bv[j + 1] = v.y;
          bv[j + 2] = v.z;
          bv[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();  // before ws (or the halo) is overwritten
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = row0 + ty + kRowGroups * i;
    const bool keep = !occ || occ[row] != 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < cout) out[row * cout + n] = from_f<T>(keep ? acc[i][j] : 0.f);
    }
  }
}

template <typename T, int EDGE, int K, int BN>
cudaError_t launch_shape(const void* x, const void* nbr, const void* w, const void* occ,
                         void* out, int n_blocks, int cin, int cout, cudaStream_t stream) {
  constexpr int TN = BN == 32 ? 4 : 8;
  constexpr size_t smem = smem_bytes<EDGE, K, BN>();
  auto kernel = block_conv_kernel<T, EDGE, K, BN, TN>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_blocks * (Tile<EDGE, K>::kCells / 64), (cout + BN - 1) / BN);
  kernel<<<grid, kRowGroups * (BN / TN), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(nbr),
      static_cast<const T*>(w), static_cast<const uint8_t*>(occ), static_cast<T*>(out),
      n_blocks, cin, cout);
  return cudaGetLastError();
}

// BN: the widest of 128, 96, 64 that divides Cout, else 32 (edges masked)
template <typename T, int EDGE, int K>
cudaError_t launch_bn(const void* x, const void* nbr, const void* w, const void* occ,
                      void* out, int n_blocks, int cin, int cout, cudaStream_t s) {
  if (cout % 128 == 0)
    return launch_shape<T, EDGE, K, 128>(x, nbr, w, occ, out, n_blocks, cin, cout, s);
  if (cout % 96 == 0)
    return launch_shape<T, EDGE, K, 96>(x, nbr, w, occ, out, n_blocks, cin, cout, s);
  if (cout % 64 == 0)
    return launch_shape<T, EDGE, K, 64>(x, nbr, w, occ, out, n_blocks, cin, cout, s);
  return launch_shape<T, EDGE, K, 32>(x, nbr, w, occ, out, n_blocks, cin, cout, s);
}

template <typename T>
cudaError_t launch(const void* x, const void* nbr, const void* w, const void* occ,
                   void* out, int n_blocks, int edge, int k, int cin, int cout,
                   cudaStream_t s) {
  if (edge == 4 && k == 3)
    return launch_bn<T, 4, 3>(x, nbr, w, occ, out, n_blocks, cin, cout, s);
  if (edge == 4 && k == 5)
    return launch_bn<T, 4, 5>(x, nbr, w, occ, out, n_blocks, cin, cout, s);
  if (edge == 8 && k == 3)
    return launch_bn<T, 8, 3>(x, nbr, w, occ, out, n_blocks, cin, cout, s);
  if (edge == 8 && k == 5)
    return launch_bn<T, 8, 5>(x, nbr, w, occ, out, n_blocks, cin, cout, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; occ may be null (no output mask).
// Returns the launch's cudaError_t.
extern "C" int block_conv(const void* x, const void* block_nbr, const void* w,
                          const void* occ, void* out, int n_blocks, int edge, int k,
                          int cin, int cout, int dtype, void* stream) {
  if (n_blocks == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(x, block_nbr, w, occ, out, n_blocks, edge, k, cin, cout, s)
      : launch<float>(x, block_nbr, w, occ, out, n_blocks, edge, k, cin, cout, s);
  return static_cast<int>(err);
}
