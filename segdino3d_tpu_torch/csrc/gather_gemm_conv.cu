// K1: gather-GEMM sparse convolution, out[i] = sum_o x[nbr[o, i]] @ W[o].
//
// Replaces segdino3d_tpu/ops/sparse_conv.py:_subm_conv_impl (both its
// im2col branch and its matmul-first branch) and, through the plan's
// (8, V_coarse) child table, sparse_conv.py:down_conv.  On the main path it
// runs the k5 stem (125 offsets, 259 -> 32), the 46 k3 convs of the
// BasicBlocks and the 4 stride-2 down convs.
//
// What bounds it: the 46 k3 convs and the stem do 2 * V * n_off * Cin * Cout
// flops over neighbour rows that are mostly present (k3) or mostly absent
// (the k5 stem, about a fifth of its 125 offsets hit), on inputs of a few
// MB that stay in the 50 MB L2; so operations, not bytes, bound it.  This
// first version multiplies with fp32 FMAs (67 TFLOP/s peak), not tensor
// cores.  The design skips an offset for a whole tile when none of the
// tile's rows has that neighbour (on the main path about a quarter of the
// stem's (tile, offset) pairs), and never writes an im2col buffer: gathered
// rows go straight to shared memory.  Tensor-core (wgmma) tiles are later
// work.
//
// Contract: x (V_in, Cin), w (n_off, Cin, Cout) and out (V, Cout) share one
// dtype (fp32 or bf16), rows contiguous; nbr (n_off, V) int32 with -1 for
// an absent neighbour; valid (V,) bytes; invalid rows are written as 0.
#include "conv_tile.cuh"

namespace {

struct NbrSource {
  const int32_t* __restrict__ nbr;
  int v;
  int row0;
  __device__ int operator()(int o, int r) const {
    const int i = row0 + r;
    return i < v ? nbr[(int64_t)o * v + i] : -1;
  }
};

struct LinearRows {
  int v;
  int row0;
  __device__ int operator()(int r) const {
    const int i = row0 + r;
    return i < v ? i : -1;
  }
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(sdt::kThreads)
gather_gemm_conv_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                        const T* __restrict__ w, const uint8_t* __restrict__ valid,
                        T* __restrict__ out, int v, int cin, int cout, int n_off) {
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float acc[sdt::TM][sdt::TN];
#pragma unroll
  for (int i = 0; i < sdt::TM; ++i)
#pragma unroll
    for (int j = 0; j < sdt::TN; ++j) acc[i][j] = 0.f;
  const NbrSource src{nbr, v, row0};
  sdt::gather_gemm_tile<T, BM, BN>(x, w, cin, cout, n_off, col0, src, acc);
  sdt::store_tile<T, BM, BN>(out, valid, cout, col0, LinearRows{v, row0}, acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* nbr, const void* w, const void* valid,
                   void* out, int v, int cin, int cout, int n_off, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  const int32_t* nb = static_cast<const int32_t*>(nbr);
  const uint8_t* va = static_cast<const uint8_t*>(valid);
  if (cout <= 32) {
    constexpr int BM = 128, BN = 32;
    dim3 grid((v + BM - 1) / BM, (cout + BN - 1) / BN);
    gather_gemm_conv_kernel<T, BM, BN><<<grid, sdt::kThreads, 0, stream>>>(
        xt, nb, wt, va, ot, v, cin, cout, n_off);
  } else {
    constexpr int BM = 64, BN = 64;
    dim3 grid((v + BM - 1) / BM, (cout + BN - 1) / BN);
    gather_gemm_conv_kernel<T, BM, BN><<<grid, sdt::kThreads, 0, stream>>>(
        xt, nb, wt, va, ot, v, cin, cout, n_off);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int gather_gemm_conv(const void* x, const void* nbr, const void* w,
                                const void* valid, void* out, int v, int cin,
                                int cout, int n_off, int dtype, void* stream) {
  if (v == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(x, nbr, w, valid, out, v, cin, cout, n_off, s)
      : launch<float>(x, nbr, w, valid, out, v, cin, cout, n_off, s);
  return static_cast<int>(err);
}
