// The CUDA-core pieces shared by the fp32 attention bodies (B3/B5 in
// flash_attention.cu, B6/B7 in flash_attention_bwd.cu): fp32 q/k/v, the
// parity mode, in fp32 FMAs. A block has kF32Warps warps and takes kF32Rows
// tokens of a (head, batch row), kF32RowsPerWarp a warp; every operand passes
// through shared memory in chunks of kF32Tokens tokens by kF32Cols columns of
// the head dim, so any D and N <= 512 fit (a head's fp32 K and V at N = 512,
// D = 64 already take 256 KB, past a block's 227 KB). Operands are read
// through HeadStrides (common.cuh), whose 32-bit words are single fp32 values;
// the grid and its limits are mma_tiles.cuh's.
#pragma once

#include "mma_tiles.cuh"

namespace cxr {

constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kF32Rows = 32;                  // the block's own tokens
constexpr int kF32RowsPerWarp = kF32Rows / kF32Warps;
constexpr int kF32Tokens = 64;                // tokens of a streamed chunk: two a lane
constexpr int kF32Cols = 64;                  // head-dim columns of a chunk: two a lane
constexpr int kF32Pad = kF32Cols + 1;         // a padded streamed row, in words

// rows [t0, t0 + R) x columns [c0, c0 + kF32Cols) of one head's fp32 operand
// (token t at base + t * stride) into dst, row r at r * pitch; past N or D
// zero. A streamed chunk's rows are padded to kF32Pad words, so that the
// lanes' 32 tokens fall in distinct banks.
template <int R>
__device__ __forceinline__ void stage_f32(float* dst, int pitch, const float* base,
                                          long long stride, int t0, int N, int c0, int D) {
  for (int i = threadIdx.x; i < R * kF32Cols; i += kF32Threads) {
    const int r = i / kF32Cols, c = i % kF32Cols, t = t0 + r;
    dst[r * pitch + c] = (t < N && c0 + c < D) ? base[t * stride + c0 + c] : 0.f;
  }
}

// acc[i][e] += sum over the chunk's columns of a[r0 + i][c] * b[lane + 32 e][c]
// (a the block's chunk, b a streamed one), in ascending column order: the
// rows and columns passes of the backward form s = q k^T (and s^T) with the
// same FMAs, so with the same bits
__device__ __forceinline__ void f32_chunk_dots(float (&acc)[kF32RowsPerWarp][2], const float* a,
                                               const float* b, int r0, int lane) {
#pragma unroll 8
  for (int c = 0; c < kF32Cols; ++c) {
    const float b0 = b[lane * kF32Pad + c], b1 = b[(lane + 32) * kF32Pad + c];
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i) {
      const float x = a[(r0 + i) * kF32Cols + c];
      acc[i][0] = fmaf(x, b0, acc[i][0]);
      acc[i][1] = fmaf(x, b1, acc[i][1]);
    }
  }
}

// out[t0 + r0 + i][c0 + lane + 32 e] (< N, < D) = mul * sum over the tokens
// j of w[r0 + i][j] * m[j][c], m's chunks streamed from ``mb`` through
// s_chunk, one column chunk of the output at a time
__device__ __forceinline__ void f32_weighted_rows(const float* w, int N, const float* mb,
                                                  long long m_stride, float* s_chunk, float* ob,
                                                  long long o_stride, int t0, int r0, int lane,
                                                  int D, float mul) {
  for (int c0 = 0; c0 < D; c0 += kF32Cols) {
    float acc[kF32RowsPerWarp][2] = {};
    for (int j0 = 0; j0 < N; j0 += kF32Tokens) {
      __syncthreads();  // w is whole; the previous chunk is read
      stage_f32<kF32Tokens>(s_chunk, kF32Pad, mb, m_stride, j0, N, c0, D);
      __syncthreads();
      const int n = min(kF32Tokens, N - j0);
      for (int j = 0; j < n; ++j) {
        const float m0 = s_chunk[j * kF32Pad + lane], m1 = s_chunk[j * kF32Pad + lane + 32];
#pragma unroll
        for (int i = 0; i < kF32RowsPerWarp; ++i) {
          const float x = w[(r0 + i) * N + j0 + j];
          acc[i][0] = fmaf(x, m0, acc[i][0]);
          acc[i][1] = fmaf(x, m1, acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i) {
      const int t = t0 + r0 + i;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + lane + 32 * e;
        if (t < N && c < D) ob[t * o_stride + c] = acc[i][e] * mul;
      }
    }
  }
}

// What the fp32 entry points refuse (their bodies take any D): N outside
// [1, 512], no batch row, heads outside [1, 65535], D < 1, a rate outside
// [0, 1).
inline bool bad_f32_attention_args(int B, int N, int H, int D, float rate) {
  return N < 1 || N > kMaxSeq || B < 1 || H < 1 || H > kMaxGridZ || D < 1 || !(rate >= 0.f) ||
         !(rate < 1.f);
}

}  // namespace cxr
