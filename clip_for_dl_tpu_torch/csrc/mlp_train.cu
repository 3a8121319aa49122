// Fused Dense -> GELU -> Dense forward (kernel B4).
//
// Replaces the TPU kernel clip_for_dl_tpu/ops/mlp_train.py _fwd_kernel (:99),
// reached through _pallas_fwd's pallas_call (:154). Its backward is kernel B8
// (mlp_train_bwd.cu).
//
//   y = gelu(x W1^T + b1) W2^T + b2      (weights in nn.Linear layout)
//
// x, W1, W2 and the biases are bf16; both products accumulate in fp32; GELU
// is exact erf in fp32 and its output is rounded to bf16 before the second
// product, as the TPU kernel does (:106). The [rows, F] intermediate never
// reaches device memory.
//
// What bounds it on the card: tensor-core math. At the prompt-bank shape
// (R = 12,800 rows, H = 768, F = 3072) it is 121 GFLOP over 40 MB of
// activations and 9.4 MB of weights. The TPU kernel held a [256, 768] fp32
// accumulator and both weight matrices in VMEM; a Hopper block has at most
// 227 KB of shared memory. Design: a block owns kT = 32 rows, stages their x
// tile in shared memory (48 KB) and keeps the fp32 [32, H] output accumulator
// in the registers of its 8 warps as WMMA fragments (12 16x16 tiles each at
// H = 768). It walks F in chunks of kFC = 64: the first product for the
// chunk (8 tiles, one per warp) goes to a small fp32 buffer, bias + GELU turn
// it into a bf16 [32, 64] tile in shared memory, and the second product adds
// that tile times the chunk's W2 columns into the accumulators. Weight tiles
// are read straight from global memory (both matrices stay in the 50 MB L2).
// WMMA lowers to mma.sync, not wgmma, and there is no TMA pipeline yet: this
// is the simple, correct first kernel.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kT = 32;      // rows per block
constexpr int kFC = 64;     // intermediate columns per chunk
constexpr int kWarps = 8;

template <int H>
constexpr size_t smem_bytes() {
  return (size_t)kT * (H + 8) * sizeof(bf16)    // x tile, padded rows
         + (size_t)kT * kFC * sizeof(float)     // first-product chunk / epilogue staging
         + (size_t)kT * (kFC + 8) * sizeof(bf16);  // GELU output, padded rows
}

template <int H>
__global__ void __launch_bounds__(kWarps * 32, 1)
mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ b2, bf16* __restrict__ y, int R, int F) {
  constexpr int XS = H + 8;          // x row stride (elements)
  constexpr int GS = kFC + 8;        // GELU tile row stride
  constexpr int NPW = H / 16 / kWarps;  // output column tiles per warp
  static_assert(H % (16 * kWarps) == 0, "H must be a multiple of 128");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  float* hs = reinterpret_cast<float*>(xs + kT * XS);
  bf16* gs = reinterpret_cast<bf16*>(hs + kT * kFC);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kT;

  constexpr int VPR = H / 8;  // 16-byte vectors per x row
  for (int i = tid; i < kT * VPR; i += blockDim.x) {
    const int r = i / VPR, v = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < R) val = reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * H)[v];
    *reinterpret_cast<uint4*>(xs + r * XS + v * 8) = val;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NPW];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NPW; ++j) wmma::fill_fragment(acc[m][j], 0.f);
  __syncthreads();

  const int hm = warp / 4, hn = warp % 4;  // this warp's tile of the [32, 64] chunk
  for (int f0 = 0; f0 < F; f0 += kFC) {
    // first product: h[32, 64] = x_tile . W1[f0 : f0 + 64, :]^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
    wmma::fill_fragment(hacc, 0.f);
    const bf16* w1_tile = w1 + (size_t)(f0 + hn * 16) * H;
#pragma unroll 4
    for (int k = 0; k < H; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a, xs + hm * 16 * XS + k, XS);
      wmma::load_matrix_sync(bw, w1_tile + k, H);
      wmma::mma_sync(hacc, a, bw, hacc);
    }
    wmma::store_matrix_sync(hs + hm * 16 * kFC + hn * 16, hacc, kFC, wmma::mem_row_major);
    __syncthreads();

    // bias + exact GELU in fp32, rounded to bf16 for the second product
    for (int i = tid; i < kT * kFC; i += blockDim.x) {
      const int r = i / kFC, c = i % kFC;
      const float hv = hs[i] + __bfloat162float(b1[f0 + c]);
      gs[r * GS + c] = __float2bfloat16(0.5f * hv * (1.f + erff(hv * 0.70710678118654752f)));
    }
    __syncthreads();

    // second product: acc[32, H] += g[32, 64] . W2[:, f0 : f0 + 64]^T
#pragma unroll
    for (int kk = 0; kk < kFC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, gs + kk, GS);
      wmma::load_matrix_sync(a1, gs + 16 * GS + kk, GS);
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int n = warp + j * kWarps;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, w2 + (size_t)(n * 16) * F + f0 + kk, F);
        wmma::mma_sync(acc[0][j], a0, bw, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, bw, acc[1][j]);
      }
    }
  }
  __syncthreads();  // hs is reused below as per-warp staging

  float* stage = hs + warp * 256;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const int n = warp + j * kWarps;
      wmma::store_matrix_sync(stage, acc[m][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = r0 + m * 16 + e / 16, col = n * 16 + e % 16;
        if (row < R) y[(size_t)row * H + col] = __float2bfloat16(stage[e] + __bfloat162float(b2[col]));
      }
      __syncwarp();
    }
  }
}

template <int H>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* y, int R, int F, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<H>();
  cudaError_t err = cxr::allow_smem(mlp_fwd_kernel<H>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kT - 1) / kT;
  mlp_fwd_kernel<H><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(y), R, F);
  return cudaGetLastError();
}

}  // namespace

// x [R, H], w1 [F, H], b1 [F], w2 [H, F], b2 [H], y [R, H], all bf16; x
// 16-byte and the weights 32-byte aligned (WMMA loads them from global
// memory); H a multiple of 128 up to 1024, F a positive multiple of 64.
CXR_API int cxr_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* y, int R, int H, int F, void* stream) {
  if (R < 1 || F < kFC || F % kFC != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (H) {
#define CXR_CASE(h) \
  case h: return launch<h>(x, w1, b1, w2, b2, y, R, F, s);
    CXR_MLP_WIDTHS(CXR_CASE)
#undef CXR_CASE
    default: return cudaErrorInvalidValue;
  }
}
