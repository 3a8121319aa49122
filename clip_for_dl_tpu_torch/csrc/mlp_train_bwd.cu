// Fused Dense -> GELU -> Dense backward (kernel B8).
//
// Replaces the TPU kernel clip_for_dl_tpu/ops/mlp_train.py _bwd_kernel (:112),
// reached through _pallas_bwd's pallas_call (:190). For x [R, H], dy [R, H]
// and the weights in nn.Linear layout (W1 [F, H], W2 [H, F]):
//
//   h  = x W1^T + b1                      fp32 (recomputed: the forward saved x)
//   g  = bf16(gelu(h))                    written out
//   dh = bf16((dy W2) * gelu'(h))         written out; gelu' = Phi(h) + h phi(h)
//   dx = bf16(dh W1)                      fp32 accumulation
//
// exactly the TPU kernel's roundings (exact erff where the TPU used an A&S
// erf, as the forward does). The weight gradients dW1 = dh^T x and
// dW2 = dy^T g are plain GEMMs outside the kernel, as in the TPU's _mlp_bwd.
//
// What bounds it on the card: tensor-core math. At the train shape
// (R = 25,600 rows, H = 768, F = 3072) it is 3 products of 2 R H F = 363 GFLOP
// and writes the two bf16 [R, F] tiles (315 MB). Design, from the forward
// kernel (mlp_train.cu): a block owns kT = 32 rows and stages their x and dy
// tiles in shared memory (2 x 48 KB at H = 768); the fp32 [32, H] dx
// accumulator lives in the registers of its 8 warps as WMMA fragments. It
// walks F in chunks of kFC = 64: per chunk each warp makes one 16x16 tile of
// h (x W1^T) and then of dg (dy W2) into fp32 shared buffers, the block turns
// them into g and dh (stored to device memory and, for dh, to a bf16 shared
// tile), and the warps add dh W1[chunk, :] into the dx fragments. Weight
// tiles are read straight from global memory (both matrices stay in the
// 50 MB L2). WMMA lowers to mma.sync; no TMA pipeline yet.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kT = 32;   // rows per block
constexpr int kFC = 64;  // intermediate columns per chunk
constexpr int kWarps = 8;

template <int H>
constexpr size_t smem_bytes() {
  return (size_t)2 * kT * (H + 8) * sizeof(bf16)   // x and dy tiles, padded rows
         + (size_t)2 * kT * kFC * sizeof(float)    // h and dg chunks / epilogue staging
         + (size_t)kT * (kFC + 8) * sizeof(bf16);  // dh chunk, padded rows
}

template <int H>
__global__ void __launch_bounds__(kWarps * 32, 1)
mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const bf16* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ dy, bf16* __restrict__ dx, bf16* __restrict__ g,
               bf16* __restrict__ dh, int R, int F) {
  constexpr int XS = H + 8;             // x / dy row stride (elements)
  constexpr int GS = kFC + 8;           // dh tile row stride
  constexpr int NPW = H / 16 / kWarps;  // dx column tiles per warp
  static_assert(H % (16 * kWarps) == 0, "H must be a multiple of 128");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ys = xs + kT * XS;
  float* hs = reinterpret_cast<float*>(ys + kT * XS);
  float* dgs = hs + kT * kFC;
  bf16* dhs = reinterpret_cast<bf16*>(dgs + kT * kFC);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kT;

  constexpr int VPR = H / 8;  // 16-byte vectors per row
  for (int i = tid; i < kT * VPR; i += blockDim.x) {
    const int r = i / VPR, v = i % VPR;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u), yv = xv;
    if (r0 + r < R) {
      xv = reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * H)[v];
      yv = reinterpret_cast<const uint4*>(dy + (size_t)(r0 + r) * H)[v];
    }
    *reinterpret_cast<uint4*>(xs + r * XS + v * 8) = xv;
    *reinterpret_cast<uint4*>(ys + r * XS + v * 8) = yv;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NPW];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NPW; ++j) wmma::fill_fragment(acc[m][j], 0.f);
  __syncthreads();

  const int hm = warp / 4, hn = warp % 4;  // this warp's tile of the [32, 64] chunk
  for (int f0 = 0; f0 < F; f0 += kFC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> t;
    // h[32, 64] = x_tile . W1[f0 : f0 + 64, :]^T
    wmma::fill_fragment(t, 0.f);
    const bf16* w1_tile = w1 + (size_t)(f0 + hn * 16) * H;
#pragma unroll 4
    for (int k = 0; k < H; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a, xs + hm * 16 * XS + k, XS);
      wmma::load_matrix_sync(bw, w1_tile + k, H);
      wmma::mma_sync(t, a, bw, t);
    }
    wmma::store_matrix_sync(hs + hm * 16 * kFC + hn * 16, t, kFC, wmma::mem_row_major);
    // dg[32, 64] = dy_tile . W2[:, f0 : f0 + 64]
    wmma::fill_fragment(t, 0.f);
#pragma unroll 4
    for (int k = 0; k < H; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(a, ys + hm * 16 * XS + k, XS);
      wmma::load_matrix_sync(bw, w2 + (size_t)k * F + f0 + hn * 16, F);
      wmma::mma_sync(t, a, bw, t);
    }
    wmma::store_matrix_sync(dgs + hm * 16 * kFC + hn * 16, t, kFC, wmma::mem_row_major);
    __syncthreads();

    // bias, GELU and its derivative in fp32; g and dh rounded to bf16
    for (int i = tid; i < kT * kFC; i += blockDim.x) {
      const int r = i / kFC, c = i % kFC;
      const float hv = hs[i] + __bfloat162float(b1[f0 + c]);
      const float e = erff(hv * 0.70710678118654752f);
      const float gv = 0.5f * hv * (1.f + e);  // the forward kernel's expression
      const float dgelu = 0.5f * (1.f + e) + hv * expf(-0.5f * hv * hv) * 0.39894228040143268f;
      const bf16 dhv = __float2bfloat16(dgs[i] * dgelu);
      dhs[r * GS + c] = dhv;
      if (r0 + r < R) {
        const size_t o = (size_t)(r0 + r) * F + f0 + c;
        g[o] = __float2bfloat16(gv);
        dh[o] = dhv;
      }
    }
    __syncthreads();

    // dx[32, H] += dh[32, 64] . W1[f0 : f0 + 64, :]
#pragma unroll
    for (int kk = 0; kk < kFC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, dhs + kk, GS);
      wmma::load_matrix_sync(a1, dhs + 16 * GS + kk, GS);
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int n = warp + j * kWarps;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, w1 + (size_t)(f0 + kk) * H + n * 16, H);
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
        if (row < R) dx[(size_t)row * H + col] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
  }
}

template <int H>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* dy, void* dx, void* g, void* dh, int R, int F,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<H>();
  cudaError_t err = cxr::allow_smem(mlp_bwd_kernel<H>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kT - 1) / kT;
  mlp_bwd_kernel<H><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<bf16*>(g), static_cast<bf16*>(dh), R, F);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx [R, H], w1 [F, H], b1 [F], w2 [H, F], g, dh [R, F], all bf16; x and
// dy 16-byte and the weights 32-byte aligned (WMMA loads them from global
// memory); H a multiple of 128 up to 1024, F a positive multiple of 64.
CXR_API int cxr_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* dy, void* dx, void* g, void* dh, int R, int H, int F,
                        void* stream) {
  if (R < 1 || F < kFC || F % kFC != 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (H) {
#define CXR_CASE(h) \
  case h: return launch<h>(x, w1, b1, w2, dy, dx, g, dh, R, F, s);
    CXR_MLP_WIDTHS(CXR_CASE)
#undef CXR_CASE
    default: return cudaErrorInvalidValue;
  }
}
