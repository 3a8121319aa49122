// Fused pre-LN MLP block forward (kernel B9): a LayerNorm row pass, then
// two wgmma kernels fed by TMA (mlp_fwd.cuh).
//
// Replaces the TPU kernel clip_for_dl_tpu/ops/mlp_block.py _mlp_block_kernel
// (:78), reached through _pallas_mlp_2d's pallas_call (:162): the MLP half of
// every ViT encoder layer at inference. Per row of x [R, H]:
//
//   y   = bf16(LayerNorm(x) * scale + bias)   mlp_block_ln_kernel; fp32 mean,
//                                             then the mean of squared
//                                             deviations, rsqrt(var + eps)
//   h   = y W1^T + b1                         GEMM-1, fp32 accumulation
//   g   = bf16(gelu(h))                       fp32; exact erf, or tanh
//   o   = bf16(g W2^T + b2)                   GEMM-2, fp32 accumulation
//   out = bf16(x + o)                         the residual, two bf16 values
//
// with W1 [F, H] and W2 [H, F] in nn.Linear layout and bf16, and the
// LayerNorm scale and bias and both biases in fp32, as fused_mlp_block hands
// them to the TPU kernel (it casts only the weights to the compute dtype).
// Every rounding is the TPU kernel's (:88, :91, :94). GELU uses exact erff
// where the TPU kernel carried an A&S erf (error <= 5.3e-7, below bf16
// resolution).
//
// What bounds it on the card: tensor-core math. At the ViT-B/16 serving shape
// (R = 256 * 197 = 50,432 rows, H = 768, F = 3072) it is 2 * 2 R H F =
// 476 GFLOP, 0.481 ms at 989 TFLOP/s, against 77 MB of x read, 77 MB of out
// written and 9.4 MB of weights. The TPU kernel kept 128-row tiles, both
// weight matrices and the intermediate in VMEM; on the card the fp32 [rows,
// H] accumulator does not fit a block's registers (mlp_fwd.cuh), so y
// (77 MB) and g (310 MB) pass through device memory: y is written by the
// LayerNorm pass (one warp a row, memory-bound, ~0.05 ms) and read by
// GEMM-1, g written by GEMM-1 and read by GEMM-2, which reads x again in
// its epilogue for the residual. That traffic (~0.16 ms at 3.35 TB/s) runs
// under products bound by operations.
#include "mlp_fwd.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLnRows = 8;  // rows of a LayerNorm block: one warp a row

// jax.nn.gelu: exact erf, or the tanh form when approximate
__device__ __forceinline__ float gelu(float h, bool approximate) {
  if (approximate)
    return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// y = bf16(LayerNorm(x) * scale + bias), one warp a row: the mean, then the
// mean of squared deviations, each a lane's strided sum and a shuffle tree
__global__ void __launch_bounds__(kLnRows * 32)
mlp_block_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                    const float* __restrict__ ln_bias, bf16* __restrict__ y, int R, int H,
                    float eps) {
  const int lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * kLnRows + threadIdx.x / 32;
  if (r >= R) return;
  const bf16* xr = x + r * H;
  float sum = 0.f;
  for (int c = lane; c < H; c += 32) sum += __bfloat162float(xr[c]);
  const float mean = cxr::warp_sum(sum) / H;
  float sq = 0.f;
  for (int c = lane; c < H; c += 32) {
    const float d = __bfloat162float(xr[c]) - mean;
    sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(cxr::warp_sum(sq) / H + eps);
  bf16* yr = y + r * H;
  for (int c = lane; c < H; c += 32)
    yr[c] = __float2bfloat16((__bfloat162float(xr[c]) - mean) * rstd * ln_scale[c] + ln_bias[c]);
}

// GEMM-1's epilogue: h + b1 (fp32), GELU in fp32
struct MlpBlockGelu {
  const float* b1;
  bool approximate;
  __device__ float operator()(float h, int col) const { return gelu(h + b1[col], approximate); }
};

// GEMM-2's epilogue: o = bf16(o + b2), out = bf16(x + o)
struct MlpBlockOut {
  const float* b2;
  const bf16* x;
  bf16* out;
  int H;
  __device__ void operator()(int r, int col, float o0, float o1) const {
    const size_t i = (size_t)r * H + col;
    const float2 xv = cxr::bf2_to_f2(*reinterpret_cast<const uint32_t*>(x + i));
    *reinterpret_cast<uint32_t*>(out + i) = cxr::f2_to_bf2(
        xv.x + cxr::round_bf16(o0 + b2[col]), xv.y + cxr::round_bf16(o1 + b2[col + 1]));
  }
};

}  // namespace

// x, out [R, H] bf16; ln_scale, ln_bias, b2 [H] fp32; w1 [F, H] bf16; b1 [F]
// fp32; w2 [H, F] bf16; the scratch y [R, H] and g [R, F] bf16. x, w1, w2, y
// and g 16-byte aligned (TMA), out 4-byte; R >= 1, H and F positive
// multiples of 64; approximate != 0 selects the tanh GELU. Launches the
// LayerNorm pass, GEMM-1 and GEMM-2 on ``stream``.
CXR_API int cxr_mlp_block(const void* x, const void* ln_scale, const void* ln_bias,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          void* out, void* y, void* g, int R, int H, int F, float eps,
                          int approximate, void* stream) {
  if (!mlp_fwd_takes(R, H, F) || !(eps > 0.f)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned ln_blocks = (R + (long long)kLnRows - 1) / kLnRows;
  mlp_block_ln_kernel<<<ln_blocks, kLnRows * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<bf16*>(y), R, H, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_mlp_fwd(
      y, w1, w2, g, MlpBlockGelu{static_cast<const float*>(b1), approximate != 0},
      MlpBlockOut{static_cast<const float*>(b2), static_cast<const bf16*>(x),
                  static_cast<bf16*>(out), H},
      R, H, F, s);
}
