// The MLP forwards B4 (mlp_train.cu) and B9 (mlp_block.cu) as two
// GEMM-shaped kernels on the ring of wgmma_tiles.cuh, templated on their
// epilogues:
//
//   GEMM-1 (mlp_fwd_gelu_kernel): a 128 x 128 tile of h = A W1^T over
//       [R, F], K = H; its epilogue adds b1 and takes GELU in fp32 and
//       stores g = bf16(gelu(h)) into a scratch [R, F];
//   GEMM-2 (mlp_fwd_out_kernel): a 128 x 128 tile of o = g W2^T over
//       [R, H], K = F; its epilogue adds b2 (and, for B9, the residual) and
//       stores the output.
//
// A, W1 [F, H], g and W2 [H, F] are all K-major as they lie, so both
// products read their operands with desc_k_major and no transposed weight
// copy is made. A block is one producer warp that keeps TMA loads of an A
// box and a weight box (128 rows x 64 k each) in flight through the ring,
// and two consumer warpgroups of 64 rows that run wgmma m64n128k16 (bf16 in,
// fp32 out) on them. Ragged row, H and F edges are zero-filled by the TMA
// load and clipped at the store; output tiles are numbered with the column
// tile fastest, so that the blocks in flight share their A rows in L2.
//
// Why g passes through device memory: a fused kernel would hold the fp32
// [64, H] output accumulator of a warpgroup across all of F, 49,152
// registers at H = 768 and all 65,536 of an SM at H = 1024, before the h
// tile, addresses or the producer. Two kernels hold only a 64 x 128 tile a
// warpgroup (64 registers a thread), so every H and F that is a multiple of
// 64 runs and two blocks fit on an SM, where one's epilogue can overlap the
// other's products. g costs 2 R F 2 bytes of traffic (0.62 GB, ~0.19 ms at
// 3.35 TB/s, at the ViT batch), against products bound by operations that
// leave device memory mostly idle. g is rounded to bf16 where the TPU
// kernels round it (clip_for_dl_tpu/ops/mlp_train.py:106, mlp_block.py:91),
// so writing it out computes the same function.
#pragma once

#include "wgmma_tiles.cuh"

namespace {

using cxr::kBox;
using cxr::kCols;
using cxr::kK;
using cxr::kRows;
using cxr::kWarpgroupRows;

// A stage is one A box and one weight box; two blocks of three stages each
// share an SM (96 KB of ring and at most 112 registers a thread apiece).
constexpr int kFwdBlocksPerSM = 2;
constexpr int kFwdStages = 3;
constexpr uint32_t kFwdStage = 2 * kBox;
constexpr size_t kFwdSmem = cxr::ring_smem_bytes<kFwdStages, kFwdStage>();

// One 128 x 128 tile of A[r0 :, :] B[c0 :, :]^T over nk k-steps, both
// operands K-major. The consumers return true with their warpgroup's
// 64 x 128 fp32 sums in acc; the producer warp returns false.
__device__ __forceinline__ bool gemm_tile(const CUtensorMap* a_map, const CUtensorMap* b_map,
                                          int r0, int c0, int nk, float (&acc)[64]) {
  extern __shared__ unsigned char smem[];
  const auto ring = cxr::make_ring<kFwdStages, kFwdStage>(smem);
  ring.init();
  if (threadIdx.x >= cxr::kConsumerThreads) {
    if (threadIdx.x == cxr::kConsumerThreads)
      cxr::produce(ring, nk, [&](uint32_t st, uint32_t full, int k) {
        cxr::tma_load(st, a_map, full, k * kK, r0);
        cxr::tma_load(st + kBox, b_map, full, k * kK, c0);
      });
    return false;
  }
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  cxr::fence_accumulators(acc);
  cxr::consume(ring, nk, [&](uint32_t st) {
    const uint32_t a = st + wg * kWarpgroupRows;
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk)
      cxr::wgmma_128<0>(acc, cxr::desc_k_major(a + 32 * kk),
                        cxr::desc_k_major(st + kBox + 32 * kk));
  });
  cxr::fence_accumulators(acc);
  return true;
}

// store(row, col, v0, v1) for each pair of a consumer's sums (columns col
// and col + 1) inside [R, N]; N is a multiple of 64, so a pair never
// straddles the edge
template <typename Store>
__device__ __forceinline__ void store_pairs(const float (&acc)[64], int r0, int c0, int R, int N,
                                            Store store) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row = r0 + (threadIdx.x / 128) * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (col < N && r < R) store(r, col, acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// GEMM-1: g = bf16(gelu(h)) with gelu(h, col) the epilogue's bias + GELU
template <typename Gelu>
__global__ void __launch_bounds__(cxr::kRingThreads, kFwdBlocksPerSM)
mlp_fwd_gelu_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap w1_map, const Gelu gelu,
                    __nv_bfloat16* __restrict__ g, int R, int H, int F) {
  const int nf = (F + kCols - 1) / kCols;
  const int c0 = (blockIdx.x % nf) * kCols, r0 = (blockIdx.x / nf) * kRows;
  float acc[64];
  if (!gemm_tile(&a_map, &w1_map, r0, c0, H / kK, acc)) return;
  store_pairs(acc, r0, c0, R, F, [&](int r, int col, float h0, float h1) {
    *reinterpret_cast<uint32_t*>(g + (size_t)r * F + col) =
        cxr::f2_to_bf2(gelu(h0, col), gelu(h1, col + 1));
  });
}

// GEMM-2: out(row, col, o0, o1) stores the epilogue's output of a pair
template <typename Out>
__global__ void __launch_bounds__(cxr::kRingThreads, kFwdBlocksPerSM)
mlp_fwd_out_kernel(const __grid_constant__ CUtensorMap g_map,
                   const __grid_constant__ CUtensorMap w2_map, const Out out, int R, int H,
                   int F) {
  const int nh = (H + kCols - 1) / kCols;
  const int c0 = (blockIdx.x % nh) * kCols, r0 = (blockIdx.x / nh) * kRows;
  float acc[64];
  if (!gemm_tile(&g_map, &w2_map, r0, c0, F / kK, acc)) return;
  store_pairs(acc, r0, c0, R, H, out);
}

// The widths both kernels take: R >= 1, H and F positive multiples of 64
// (the TMA box and the k-step), and tile counts that fit gridDim.x.
inline bool mlp_fwd_takes(int R, int H, int F) {
  if (R < 1 || H < kK || H % kK != 0 || F < kK || F % kK != 0) return false;
  const long long row_tiles = (R + kRows - 1) / kRows;
  return row_tiles * ((F + kCols - 1) / kCols) <= 0x7fffffffLL &&
         row_tiles * ((H + kCols - 1) / kCols) <= 0x7fffffffLL;
}

// GEMM-1 then GEMM-2 on ``stream``: a [R, H] (x, or B9's LayerNorm output),
// w1 [F, H], w2 [H, F] and the scratch g [R, F], all bf16 and 16-byte
// aligned; widths as mlp_fwd_takes.
template <typename Gelu, typename Out>
cudaError_t launch_mlp_fwd(const void* a, const void* w1, const void* w2, void* g, Gelu gelu,
                           Out out, int R, int H, int F, cudaStream_t stream) {
  if (!mlp_fwd_takes(R, H, F)) return cudaErrorInvalidValue;
  const unsigned row_tiles = (R + kRows - 1) / kRows;
  const unsigned gelu_tiles = row_tiles * ((F + kCols - 1) / kCols);
  const unsigned out_tiles = row_tiles * ((H + kCols - 1) / kCols);
  CUtensorMap a_map, w1_map, g_map, w2_map;
  cudaError_t err;
  if ((err = cxr::bf16_tensor_map(&a_map, a, H, R, kRows)) != cudaSuccess ||
      (err = cxr::bf16_tensor_map(&w1_map, w1, H, F, kCols)) != cudaSuccess ||
      (err = cxr::bf16_tensor_map(&g_map, g, F, R, kRows)) != cudaSuccess ||
      (err = cxr::bf16_tensor_map(&w2_map, w2, F, H, kCols)) != cudaSuccess)
    return err;
  if ((err = cxr::allow_smem(mlp_fwd_gelu_kernel<Gelu>, kFwdSmem)) != cudaSuccess ||
      (err = cxr::allow_smem(mlp_fwd_out_kernel<Out>, kFwdSmem)) != cudaSuccess)
    return err;
  mlp_fwd_gelu_kernel<Gelu><<<gelu_tiles, cxr::kRingThreads, kFwdSmem, stream>>>(
      a_map, w1_map, gelu, static_cast<__nv_bfloat16*>(g), R, H, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlp_fwd_out_kernel<Out><<<out_tiles, cxr::kRingThreads, kFwdSmem, stream>>>(
      g_map, w2_map, out, R, H, F);
  return cudaGetLastError();
}

}  // namespace
