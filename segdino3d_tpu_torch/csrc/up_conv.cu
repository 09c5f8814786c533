// K2: transposed stride-2 convolution, fine[i] = x[parent[i]] @ W[kpos[i]].
//
// Replaces segdino3d_tpu/ops/sparse_conv.py:up_conv (the 4 up convs of the
// Res16UNet34C decoder: 256->256, 256->128, 128->96, 96->96).
//
// What bounds it: 2 * V_fine * Cin * Cout flops with each fine row read
// once through its parent; fp32 FMAs bound it like K1.  The TPU version ran
// all 8 kernel slots over every row and masked; here the host plan hands
// over the fine rows grouped by kernel slot (`order`, a stable sort by kpos),
// so a tile of BM consecutive entries of `order` sees one or two slots and
// the shared tile loop (conv_tile.cuh) skips the other slots for the tile.
// Output rows are written at order[r], so each row is written exactly once.
//
// Contract: x (V_coarse, Cin), w (8, Cin, Cout), out (V_fine, Cout) share one
// dtype; parent, kpos, order (V_fine,) int32, order a permutation of
// [0, V_fine); valid (V_fine,) bytes; invalid rows are written as 0.
#include "conv_tile.cuh"

namespace {

struct SlotSource {
  const int* srow;
  const int* skpos;
  const int* sparent;
  __device__ int operator()(int o, int r) const {
    return (srow[r] >= 0 && skpos[r] == o) ? sparent[r] : -1;
  }
};

struct OrderedRows {
  const int* srow;
  __device__ int operator()(int r) const { return srow[r]; }
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(sdt::kThreads)
up_conv_kernel(const T* __restrict__ x, const int32_t* __restrict__ parent,
               const int32_t* __restrict__ kpos, const int32_t* __restrict__ order,
               const T* __restrict__ w, const uint8_t* __restrict__ valid,
               T* __restrict__ out, int v, int cin, int cout) {
  __shared__ int srow[BM], skpos[BM], sparent[BM];
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    const int p = row0 + r;
    const int i = p < v ? order[p] : -1;
    srow[r] = i;
    // an invalid or unlinked row takes no slot: it gathers nothing
    const bool live = i >= 0 && valid[i] && parent[i] >= 0;
    skpos[r] = live ? kpos[i] : -1;
    sparent[r] = live ? parent[i] : -1;
  }
  __syncthreads();
  float acc[sdt::TM][sdt::TN];
#pragma unroll
  for (int i = 0; i < sdt::TM; ++i)
#pragma unroll
    for (int j = 0; j < sdt::TN; ++j) acc[i][j] = 0.f;
  const SlotSource src{srow, skpos, sparent};
  sdt::gather_gemm_tile<T, BM, BN>(x, w, cin, cout, 8, col0, src, acc);
  sdt::store_tile<T, BM, BN>(out, valid, cout, col0, OrderedRows{srow}, acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* parent, const void* kpos,
                   const void* order, const void* w, const void* valid, void* out,
                   int v, int cin, int cout, cudaStream_t stream) {
  constexpr int BM = 64, BN = 64;
  dim3 grid((v + BM - 1) / BM, (cout + BN - 1) / BN);
  up_conv_kernel<T, BM, BN><<<grid, sdt::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(parent),
      static_cast<const int32_t*>(kpos), static_cast<const int32_t*>(order),
      static_cast<const T*>(w), static_cast<const uint8_t*>(valid),
      static_cast<T*>(out), v, cin, cout);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int up_conv(const void* x, const void* parent, const void* kpos,
                       const void* order, const void* w, const void* valid,
                       void* out, int v, int cin, int cout, int dtype,
                       void* stream) {
  if (v == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(x, parent, kpos, order, w, valid, out, v, cin, cout, s)
      : launch<float>(x, parent, kpos, order, w, valid, out, v, cin, cout, s);
  return static_cast<int>(err);
}
