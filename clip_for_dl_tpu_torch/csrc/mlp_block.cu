// Fused pre-LN MLP block forward (kernel B9).
//
// Replaces the TPU kernel clip_for_dl_tpu/ops/mlp_block.py _mlp_block_kernel
// (:78), reached through _pallas_mlp_2d's pallas_call (:162): the MLP half of
// every ViT encoder layer at inference. Per row of x [R, H]:
//
//   y   = bf16(LayerNorm(x) * scale + bias)   fp32; mean, then the mean of
//                                             squared deviations; eps
//   h   = y W1^T + b1                         fp32 accumulation
//   g   = bf16(gelu(h))                       fp32; exact erf, or tanh
//   o   = bf16(g W2^T + b2)                   fp32 accumulation
//   out = bf16(x + o)                         the residual, two bf16 values
//
// with W1 [F, H] and W2 [H, F] in nn.Linear layout and bf16, and the
// LayerNorm scale and bias and both biases in fp32, as fused_mlp_block hands
// them to the TPU kernel (it casts only the weights to the compute dtype).
// GELU uses exact erff where the TPU kernel carried an A&S erf (error
// <= 5.3e-7, below bf16 resolution).
//
// What bounds it on the card: tensor-core math. At the ViT-B/16 serving shape
// (R = 256 * 197 = 50,432 rows, H = 768, F = 3072) it is 2 * 2 R H F =
// 476 GFLOP against 77 MB of x read, 77 MB of out written and 9.4 MB of
// weights. The TPU kernel kept 128-row tiles and both weight matrices in
// VMEM; a Hopper block has at most 227 KB of shared memory. Design, from
// kernel B4 (mlp_train.cu): a block owns kT = 32 rows and stages their x tile
// in shared memory, where it stays for the residual; a LayerNorm prologue
// (one warp per row, two passes over the staged row, shuffles for the sums)
// writes the normalized bf16 tile beside it (2 x 32 x (H + 8) bf16, 99 KB at
// H = 768). The fp32 [32, H] accumulator of the second product lives in the
// registers of the block's 8 warps as WMMA fragments, and F is walked in
// chunks of kFC = 64: the chunk's first product goes to a small fp32 buffer,
// bias + GELU turn it into a bf16 [32, 64] tile, and the second product adds
// that tile times the chunk's W2 columns into the fragments. Weight tiles are
// read straight from global memory (both matrices stay in the 50 MB L2). So
// x is read once and out written once; the normalized rows and the [R, F]
// intermediate never reach device memory. WMMA lowers to mma.sync, not
// wgmma, and there is no TMA pipeline: the simple, correct first kernel.
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
  return (size_t)2 * kT * (H + 8) * sizeof(bf16)   // x and LayerNorm(x) tiles, padded rows
         + (size_t)kT * kFC * sizeof(float)        // first-product chunk / epilogue staging
         + (size_t)kT * (kFC + 8) * sizeof(bf16);  // GELU output, padded rows
}

// jax.nn.gelu: exact erf, or the tanh form when approximate
__device__ __forceinline__ float gelu(float h, bool approximate) {
  if (approximate)
    return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

template <int H>
__global__ void __launch_bounds__(kWarps * 32, 1)
mlp_block_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                 const float* __restrict__ ln_bias, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out, int R, int F, float eps,
                 bool approximate) {
  constexpr int XS = H + 8;             // x / y row stride (elements)
  constexpr int GS = kFC + 8;           // GELU tile row stride
  constexpr int NPW = H / 16 / kWarps;  // output column tiles per warp
  static_assert(H % (16 * kWarps) == 0, "H must be a multiple of 128");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ys = xs + kT * XS;
  float* hs = reinterpret_cast<float*>(ys + kT * XS);
  bf16* gs = reinterpret_cast<bf16*>(hs + kT * kFC);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kT;

  constexpr int VPR = H / 8;  // 16-byte vectors per x row
  for (int i = tid; i < kT * VPR; i += blockDim.x) {
    const int r = i / VPR, v = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);  // rows past R: zeros, never written out
    if (r0 + r < R) val = reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * H)[v];
    *reinterpret_cast<uint4*>(xs + r * XS + v * 8) = val;
  }
  __syncthreads();

  // LayerNorm prologue, one warp per row: mean, variance as the mean of
  // squared deviations, then scale and bias in fp32, rounded to bf16
  for (int r = warp; r < kT; r += kWarps) {
    const bf16* xr = xs + r * XS;
    float sum = 0.f;
    for (int c = lane; c < H; c += 32) sum += __bfloat162float(xr[c]);
    const float mean = cxr::warp_sum(sum) / H;
    float sq = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float d = __bfloat162float(xr[c]) - mean;
      sq = fmaf(d, d, sq);
    }
    const float rstd = rsqrtf(cxr::warp_sum(sq) / H + eps);
    bf16* yr = ys + r * XS;
    for (int c = lane; c < H; c += 32)
      yr[c] = __float2bfloat16((__bfloat162float(xr[c]) - mean) * rstd * ln_scale[c] + ln_bias[c]);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NPW];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NPW; ++j) wmma::fill_fragment(acc[m][j], 0.f);
  __syncthreads();

  const int hm = warp / 4, hn = warp % 4;  // this warp's tile of the [32, 64] chunk
  for (int f0 = 0; f0 < F; f0 += kFC) {
    // first product: h[32, 64] = y_tile . W1[f0 : f0 + 64, :]^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
    wmma::fill_fragment(hacc, 0.f);
    const bf16* w1_tile = w1 + (size_t)(f0 + hn * 16) * H;
#pragma unroll 4
    for (int k = 0; k < H; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a, ys + hm * 16 * XS + k, XS);
      wmma::load_matrix_sync(bw, w1_tile + k, H);
      wmma::mma_sync(hacc, a, bw, hacc);
    }
    wmma::store_matrix_sync(hs + hm * 16 * kFC + hn * 16, hacc, kFC, wmma::mem_row_major);
    __syncthreads();

    // bias + GELU in fp32, rounded to bf16 for the second product
    for (int i = tid; i < kT * kFC; i += blockDim.x) {
      const int r = i / kFC, c = i % kFC;
      gs[r * GS + c] = __float2bfloat16(gelu(hs[i] + b1[f0 + c], approximate));
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

  // epilogue: o = bf16(acc + b2), out = bf16(x + o) with x from the staged tile
  float* stage = hs + warp * 256;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const int n = warp + j * kWarps;
      wmma::store_matrix_sync(stage, acc[m][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = m * 16 + e / 16, col = n * 16 + e % 16;
        if (r0 + r < R) {
          const float o = cxr::round_bf16(stage[e] + b2[col]);
          const float xv = __bfloat162float(xs[r * XS + col]);
          out[(size_t)(r0 + r) * H + col] = __float2bfloat16(xv + o);
        }
      }
      __syncwarp();
    }
  }
}

template <int H>
cudaError_t launch(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* out, int R, int F,
                   float eps, bool approximate, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<H>();
  cudaError_t err = cxr::allow_smem(mlp_block_kernel<H>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kT - 1) / kT;
  mlp_block_kernel<H><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<bf16*>(out), R, F, eps, approximate);
  return cudaGetLastError();
}

}  // namespace

// x, out [R, H] bf16; ln_scale, ln_bias, b2 [H] fp32; w1 [F, H] bf16; b1 [F]
// fp32; w2 [H, F] bf16. x 16-byte and the weights 32-byte aligned (WMMA loads
// them from global memory); H a multiple of 128 up to 1024, F a positive
// multiple of 64; approximate != 0 selects the tanh GELU.
CXR_API int cxr_mlp_block(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          void* out, int R, int H, int F, float eps, int approximate,
                          void* stream) {
  if (R < 1 || F < kFC || F % kFC != 0 || !(eps > 0.f)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bool approx = approximate != 0;
  switch (H) {
#define CXR_CASE(h) \
  case h: return launch<h>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, R, F, eps, approx, s);
    CXR_MLP_WIDTHS(CXR_CASE)
#undef CXR_CASE
    default: return cudaErrorInvalidValue;
  }
}
