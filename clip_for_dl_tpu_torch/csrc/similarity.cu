// Fused L2-normalize + cosine similarity (kernel B1).
//
// Replaces the TPU kernel clip_for_dl_tpu/ops/similarity.py _fused_kernel
// (:45), reached through _fused_similarity_impl's pallas_call (:152).
//
//   out[b, c] = <img[b] * rsqrt(max(|img[b]|^2, eps^2)),
//                txt[c] * rsqrt(max(|txt[c]|^2, eps^2))> * inv_temp
//
// all in fp32, with the clamp on the squared norm as the TPU kernel has it
// (zero rows, such as the padded rows of a service bucket, give 0, not NaN).
// The kernel takes the dot product of the raw rows and both squared norms in
// one pass, then scales the dot by the two rsqrt factors: one fp32 rounding
// from scaling the rows first, as the plain version does.
//
// What bounds it on the card: bytes and launch latency. At the main-path
// shape (B image rows of D = 512 fp32 against C = 16 prompt features) each
// image row is 2 KB read for 2*C*D = 16 K flops, far below the ridge point,
// and the [B, D] x [D, 16] product is too small for tensor-core tiles to
// matter. Design: one warp per image row, eight a block; the text block goes
// through shared memory in tiles of kRows rows x kCols features, so any D and
// any C fit (the TPU kernel pads D to 128 and C to 8 instead). For each
// group of kRows text rows the block walks D in kCols steps: it stages the
// tile, and each lane accumulates its strided share of the kRows dot
// products and of its image row's squared norm in registers; lanes past D,
// and rows past C, hold zeros. The text rows' squared norms are taken once
// a block, not once a warp: warp w sums rows 2w and 2w + 1 of the tile (in
// the same lane order as the dot products) and leaves their rsqrt factors in
// shared memory for the other warps. Shuffle reductions give the sums. The
// image row is read once for each group of kRows text rows, from L1 or L2
// after the first.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;   // text rows of a tile
constexpr int kCols = 256;  // features of a tile: kCols / 32 a lane
constexpr int kNormRows = kRows / kWarps;  // text rows whose norm each warp takes
static_assert(kCols % kThreads == 0, "every thread stages the same share of each tile row");
static_assert(kNormRows * kWarps == kRows, "the warps share the tile's norms evenly");

__global__ void __launch_bounds__(kThreads)
similarity_kernel(const float* __restrict__ img, const float* __restrict__ txt,
                  float* __restrict__ out, int B, int C, int D, float inv_temp, float eps2) {
  __shared__ float tile[kRows][kCols];
  __shared__ float text_scale[kRows];  // rsqrt(max(|txt[c0 + r]|^2, eps^2))
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  const float* row = img + (size_t)(b < B ? b : 0) * D;

  for (int c0 = 0; c0 < C; c0 += kRows) {
    float dot[kRows], tss[kNormRows], iss = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kNormRows; ++j) tss[j] = 0.f;
    // the previous group's last tile and text_scale are read (one barrier a
    // group past the first; within a group, one before each tile past the
    // first)
    if (c0 > 0) __syncthreads();
    for (int d0 = 0; d0 < D; d0 += kCols) {
      // the image row's share of the tile and this thread's share of the
      // text tile are loaded into registers together, before the barrier,
      // so that both wait out one memory latency
      float x[kCols / 32], staged[kRows][kCols / kThreads];
#pragma unroll
      for (int u = 0; u < kCols / 32; ++u) {
        const int d = d0 + u * 32 + lane;
        x[u] = d < D ? row[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int s = 0; s < kCols / kThreads; ++s) {
          const int d = d0 + s * kThreads + threadIdx.x;
          staged[r][s] = (c0 + r < C && d < D) ? txt[(size_t)(c0 + r) * D + d] : 0.f;
        }
      if (d0 > 0) __syncthreads();  // the previous tile is read
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int s = 0; s < kCols / kThreads; ++s)
          tile[r][s * kThreads + threadIdx.x] = staged[r][s];
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kCols / 32; ++u) {
        const int d = u * 32 + lane;
        iss = fmaf(x[u], x[u], iss);
#pragma unroll
        for (int r = 0; r < kRows; ++r) dot[r] = fmaf(x[u], tile[r][d], dot[r]);
#pragma unroll
        for (int j = 0; j < kNormRows; ++j) {
          const float t = tile[warp * kNormRows + j][d];
          tss[j] = fmaf(t, t, tss[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNormRows; ++j) {
      const float s = rsqrtf(fmaxf(cxr::warp_sum(tss[j]), eps2));
      if (lane == 0) text_scale[warp * kNormRows + j] = s;
    }
    const float ri = rsqrtf(fmaxf(cxr::warp_sum(iss), eps2)) * inv_temp;
    __syncthreads();  // text_scale is written
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dr = cxr::warp_sum(dot[r]);
      if (lane == 0 && b < B && c0 + r < C)
        out[(size_t)b * C + c0 + r] = dr * ri * text_scale[r];
    }
  }
}

}  // namespace

// img [B, D] fp32, txt [C, D] fp32, out [B, C] fp32; B, C >= 1, D >= 0.
CXR_API int cxr_similarity(const void* img, const void* txt, void* out, int B, int C,
                           int D, float inv_temp, float eps, void* stream) {
  if (B < 1 || C < 1 || D < 0) return cudaErrorInvalidValue;
  const int blocks = (int)(((long long)B + kWarps - 1) / kWarps);
  similarity_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(txt), static_cast<float*>(out),
      B, C, D, inv_temp, eps * eps);
  return cudaGetLastError();
}

CXR_API const char* cxr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
