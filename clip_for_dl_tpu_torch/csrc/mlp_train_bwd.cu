// Fused Dense -> GELU -> Dense backward (kernel B8), on wgmma with TMA-fed
// tiles.
//
// Replaces the TPU kernel clip_for_dl_tpu/ops/mlp_train.py _bwd_kernel (:112),
// reached through _pallas_bwd's pallas_call (:190). For x [R, H], dy [R, H]
// and the weights in nn.Linear layout (W1 [F, H], W2 [H, F]):
//
//   h  = x W1^T + b1                      fp32 (recomputed: the forward saved x)
//   g  = bf16(gelu(h))                    written out
//   dh = bf16((dy W2) * gelu'(h))         written out; gelu' = Phi(h) + h phi(h)
//   dx = bf16(dh W1)                      from the bf16 dh, fp32 accumulation
//
// exactly the TPU kernel's roundings (exact erff where the TPU used an A&S
// erf, as the forward does). The weight gradients dW1 = dh^T x and
// dW2 = dy^T g are plain GEMMs outside the kernel, as in the TPU's _mlp_bwd.
//
// What bounds it on the card: tensor-core math. At the train shape
// (R = 25,600 rows, H = 768, F = 3072) it is 3 products of 2 R H F = 362
// GFLOP, 0.366 ms at 989 TFLOP/s, and it writes the two bf16 [R, F]
// intermediates (315 MB, 0.094 ms at 3.35 TB/s). g and dh are outputs (the
// weight gradients read them), so they reach device memory anyway, and the
// function splits into two GEMM-shaped kernels at the cost of reading dh
// back once (157 MB):
//
//   B8a (mlp_bwd_gelu_kernel): a 128-row x 128-column tile of [R, F] forms
//       h and dg = dy W2 in two fp32 accumulators, over k-steps of 64 of H,
//       and its epilogue, in registers, adds b1, takes GELU and GELU' in fp32
//       and stores g and dh as bf16;
//   B8b (mlp_bwd_dx_kernel): a 128 x 128 tile of dx = dh W1, over k-steps of
//       64 of F. No split of K and no atomics: two calls give the same bits.
//
// Both are one producer warp that keeps TMA loads of whole tiles in flight
// through a ring of stages (a full and an empty mbarrier each) and two
// consumer warpgroups of 64 rows that run wgmma.mma_async m64n128k16 (bf16 in,
// fp32 out) on the stages that have landed, releasing each stage once the
// products that read it are done (wgmma_tiles.cuh). x, dy, dh and, for h, W1
// are K-major as they lie; W2 (for dg) and W1 (for dx) are N-major and read
// with wgmma's transpose bit, so no transposed weight copy is made. Ragged
// row, H and F edges are zero-filled by the TMA load and clipped at the store.
// No [rows, H] accumulator lives in registers, so every H and F that is a
// multiple of 64 (the TMA box and the k-step) is taken, and any R >= 1.
// Output tiles are numbered with the F (or H) tile fastest, so that the
// blocks in flight share their x, dy or dh rows in L2.
#include "wgmma_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

using cxr::kBox;
using cxr::kCols;
using cxr::kK;
using cxr::kRows;
using cxr::kWarpgroupRows;
constexpr int kConsumers = cxr::kConsumerThreads;
constexpr int kThreads = cxr::kRingThreads;
constexpr uint32_t kHalf = kK * 64 * 2;  // an N-major box, 64 k-rows x 64 columns: 8 KB

// B8a: x, dy, W1 (K-major) and W2 (two N-major halves) a stage
constexpr int kStagesGelu = 3;
constexpr uint32_t kStageGelu = 4 * kBox;
// B8b: dh (K-major) and W1 (two N-major halves) a stage
constexpr int kStagesDx = 4;
constexpr uint32_t kStageDx = 2 * kBox;

// B8a: g and dh of one 128 x 128 tile of [R, F]
__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_gelu_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap dy_map,
                    const __grid_constant__ CUtensorMap w1_map,
                    const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ b1,
                    bf16* __restrict__ g, bf16* __restrict__ dh, int R, int H, int F) {
  extern __shared__ unsigned char smem[];
  const auto ring = cxr::make_ring<kStagesGelu, kStageGelu>(smem);
  ring.init();
  const int nf = (F + kCols - 1) / kCols;
  const int f0 = (blockIdx.x % nf) * kCols, r0 = (blockIdx.x / nf) * kRows;
  const int nk = H / kK;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers)
      cxr::produce(ring, nk, [&](uint32_t st, uint32_t full, int k) {
        cxr::tma_load(st, &x_map, full, k * kK, r0);
        cxr::tma_load(st + kBox, &dy_map, full, k * kK, r0);
        cxr::tma_load(st + 2 * kBox, &w1_map, full, k * kK, f0);
        cxr::tma_load(st + 3 * kBox, &w2_map, full, f0, k * kK);
        cxr::tma_load(st + 3 * kBox + kHalf, &w2_map, full, f0 + 64, k * kK);
      });
    return;
  }

  const int wg = threadIdx.x / 128;
  float h[64], dg[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) h[i] = dg[i] = 0.f;
  cxr::fence_accumulators(h);
  cxr::fence_accumulators(dg);
  cxr::consume(ring, nk, [&](uint32_t st) {
    const uint32_t xa = st + wg * kWarpgroupRows, dya = xa + kBox;
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      cxr::wgmma_128<0>(h, cxr::desc_k_major(xa + 32 * kk),
                        cxr::desc_k_major(st + 2 * kBox + 32 * kk));
      cxr::wgmma_128<1>(dg, cxr::desc_k_major(dya + 32 * kk),
                        cxr::desc_n_major(st + 3 * kBox + 2048 * kk, kHalf));
    }
  });
  cxr::fence_accumulators(h);
  cxr::fence_accumulators(dg);

  // epilogue: bias, GELU and its derivative in fp32; g and dh rounded to bf16
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row = r0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = f0 + 8 * j + 2 * (lane % 4);
    if (col < F) {  // F is a multiple of 64: col and col + 1 lie on one side
      const float bias[2] = {__bfloat162float(b1[col]), __bfloat162float(b1[col + 1])};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half;
        if (r < R) {
          float gv[2], dhv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * half + e;
            const float hv = h[i] + bias[e];
            const float erfv = erff(hv * 0.70710678118654752f);
            gv[e] = 0.5f * hv * (1.f + erfv);  // the forward kernel's expression
            const float dgelu =
                0.5f * (1.f + erfv) + hv * expf(-0.5f * hv * hv) * 0.39894228040143268f;
            dhv[e] = dg[i] * dgelu;
          }
          const size_t o = (size_t)r * F + col;
          *reinterpret_cast<uint32_t*>(g + o) = cxr::f2_to_bf2(gv[0], gv[1]);
          *reinterpret_cast<uint32_t*>(dh + o) = cxr::f2_to_bf2(dhv[0], dhv[1]);
        }
      }
    }
  }
}

// B8b: one 128 x 128 tile of dx = dh W1
__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_dx_kernel(const __grid_constant__ CUtensorMap dh_map,
                  const __grid_constant__ CUtensorMap w1_map, bf16* __restrict__ dx, int R,
                  int H, int F) {
  extern __shared__ unsigned char smem[];
  const auto ring = cxr::make_ring<kStagesDx, kStageDx>(smem);
  ring.init();
  const int nh = (H + kCols - 1) / kCols;
  const int n0 = (blockIdx.x % nh) * kCols, r0 = (blockIdx.x / nh) * kRows;
  const int nk = F / kK;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      cxr::produce(ring, nk, [&](uint32_t st, uint32_t full, int k) {
        cxr::tma_load(st, &dh_map, full, k * kK, r0);
        cxr::tma_load(st + kBox, &w1_map, full, n0, k * kK);
        cxr::tma_load(st + kBox + kHalf, &w1_map, full, n0 + 64, k * kK);
      });
    return;
  }

  const int wg = threadIdx.x / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  cxr::fence_accumulators(acc);
  cxr::consume(ring, nk, [&](uint32_t st) {
    const uint32_t a = st + wg * kWarpgroupRows;
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk)
      cxr::wgmma_128<1>(acc, cxr::desc_k_major(a + 32 * kk),
                        cxr::desc_n_major(st + kBox + 2048 * kk, kHalf));
  });
  cxr::fence_accumulators(acc);

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row = r0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (col < H && r < R)
        *reinterpret_cast<uint32_t*>(dx + (size_t)r * H + col) =
            cxr::f2_to_bf2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

}  // namespace

// x, dy, dx [R, H], w1 [F, H], b1 [F], w2 [H, F], g, dh [R, F], all bf16 and
// every pointer 16-byte aligned (TMA); R >= 1, H and F positive multiples
// of 64. Launches B8a, then B8b, on ``stream``.
CXR_API int cxr_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* dy, void* dx, void* g, void* dh, int R, int H, int F,
                        void* stream) {
  if (R < 1 || H < kK || H % kK != 0 || F < kK || F % kK != 0) return cudaErrorInvalidValue;
  const long long row_tiles = (R + kRows - 1) / kRows;
  const long long gelu_tiles = row_tiles * ((F + kCols - 1) / kCols);
  const long long dx_tiles = row_tiles * ((H + kCols - 1) / kCols);
  if (gelu_tiles > 0x7fffffffLL || dx_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap x_map, dy_map, w1_k, w2_n, dh_map, w1_n;
  cudaError_t err;
  if ((err = cxr::bf16_tensor_map(&x_map, x, H, R, kRows)) != cudaSuccess ||
      (err = cxr::bf16_tensor_map(&dy_map, dy, H, R, kRows)) != cudaSuccess ||
      (err = cxr::bf16_tensor_map(&w1_k, w1, H, F, kCols)) != cudaSuccess ||
      (err = cxr::bf16_tensor_map(&w2_n, w2, F, H, kK)) != cudaSuccess ||
      (err = cxr::bf16_tensor_map(&dh_map, dh, F, R, kRows)) != cudaSuccess ||
      (err = cxr::bf16_tensor_map(&w1_n, w1, H, F, kK)) != cudaSuccess)
    return err;
  constexpr size_t gelu_smem = cxr::ring_smem_bytes<kStagesGelu, kStageGelu>();
  constexpr size_t dx_smem = cxr::ring_smem_bytes<kStagesDx, kStageDx>();
  if ((err = cxr::allow_smem(mlp_bwd_gelu_kernel, gelu_smem)) != cudaSuccess ||
      (err = cxr::allow_smem(mlp_bwd_dx_kernel, dx_smem)) != cudaSuccess)
    return err;
  auto s = static_cast<cudaStream_t>(stream);
  mlp_bwd_gelu_kernel<<<(unsigned)gelu_tiles, kThreads, gelu_smem, s>>>(
      x_map, dy_map, w1_k, w2_n, static_cast<const bf16*>(b1), static_cast<bf16*>(g),
      static_cast<bf16*>(dh), R, H, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlp_bwd_dx_kernel<<<(unsigned)dx_tiles, kThreads, dx_smem, s>>>(dh_map, w1_n,
                                                                    static_cast<bf16*>(dx), R, H, F);
  return cudaGetLastError();
}
