// Fused Dense -> GELU -> Dense forward (kernel B4), as two wgmma kernels fed
// by TMA (mlp_fwd.cuh).
//
// Replaces the TPU kernel clip_for_dl_tpu/ops/mlp_train.py _fwd_kernel (:99),
// reached through _pallas_fwd's pallas_call (:154). Its backward is kernel B8
// (mlp_train_bwd.cu).
//
//   g = bf16(gelu(x W1^T + b1))          GEMM-1, into a scratch [R, F]
//   y = bf16(g W2^T + b2)                GEMM-2
//
// with the weights in nn.Linear layout (W1 [F, H], W2 [H, F]). x, W1, W2 and
// the biases are bf16; both products accumulate in fp32; GELU is exact erff
// in fp32 (the TPU kernel's A&S erf is within 5.3e-7 of it), or with
// ``approximate`` the tanh form of jax.nn.gelu(approximate=True) (the ViT's
// --fast-gelu), and its output is rounded to bf16 before the second
// product, as the TPU kernel does (:106). B8 recomputes g with the same
// expressions (cxr::gelu_erf, cxr::gelu_tanh), so the two round it alike.
//
// What bounds it on the card: tensor-core math. At the prompt-bank shape
// (R = 12,800 rows, H = 768, F = 3072) it is 2 products of 2 R H F = 121
// GFLOP, 0.122 ms at 989 TFLOP/s, over 40 MB of activations and 9.4 MB of
// weights; g's round trip through device memory adds 157 MB (0.047 ms at
// 3.35 TB/s), which the products' time covers. The TPU kernel held a
// [256, 768] fp32 accumulator in VMEM; on the card that accumulator does not
// fit a block's registers (mlp_fwd.cuh), so g passes through device memory
// and each product is a GEMM-shaped kernel on 128 x 128 tiles.
#include "mlp_fwd.cuh"

namespace {

using bf16 = __nv_bfloat16;

// GEMM-1's epilogue: h + b1 (bf16), GELU in fp32: exact erf, or tanh
struct DenseGelu {
  const bf16* b1;
  bool approximate;
  __device__ float operator()(float h, int col) const {
    const float v = h + __bfloat162float(b1[col]);
    return approximate ? cxr::gelu_tanh(v, cxr::gelu_tanh_t(v)) : cxr::gelu_erf(v);
  }
};

// GEMM-2's epilogue: y = bf16(o + b2)
struct DenseOut {
  const bf16* b2;
  bf16* y;
  int H;
  __device__ void operator()(int r, int col, float o0, float o1) const {
    *reinterpret_cast<uint32_t*>(y + (size_t)r * H + col) = cxr::f2_to_bf2(
        o0 + __bfloat162float(b2[col]), o1 + __bfloat162float(b2[col + 1]));
  }
};

}  // namespace

// x, y [R, H], w1 [F, H], b1 [F], w2 [H, F], b2 [H] and the scratch g
// [R, F], all bf16; x, w1, w2 and g 16-byte aligned (TMA), y 4-byte; R >= 1,
// H and F positive multiples of 64; approximate != 0 selects the tanh GELU.
// Launches GEMM-1, then GEMM-2, on ``stream``.
CXR_API int cxr_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* y, void* g, int R, int H, int F, int approximate,
                        void* stream) {
  return launch_mlp_fwd(x, w1, w2, g,
                        DenseGelu{static_cast<const bf16*>(b1), approximate != 0},
                        DenseOut{static_cast<const bf16*>(b2), static_cast<bf16*>(y), H}, R, H,
                        F, static_cast<cudaStream_t>(stream));
}
