// Fused bilinear resize + channel normalize + cast (kernel B2).
//
// Replaces the TPU kernel clip_for_dl_tpu/ops/image_prep.py _fused_prep_kernel
// (:185), reached through _pallas_prep's pallas_call (:219). The TPU kernel
// ran the resize as two dense matmuls (H weights, then a W x C Kronecker
// matrix) because the MXU is its fast unit. Here every output pixel reads its
// 2x2 source neighbourhood directly: the taps and fractions come from the
// same float64 host computation as _resize_weights (cast to fp32), applied in
// the matrix form's order (H pass at the two source columns, then W pass), so
// the result matches the matrix form to fp32 rounding. Edge-clamped rows and
// columns carry both weights on one tap, as np.add.at builds them.
//
//   out[b, y, x, c] = cast(resize(u8 -> f32)[b, y, x, c_in] * scale[c] + bias[c])
//
// Grey input (C_in = 1) is read once and written to all C_out channels: the
// resize of identical channels is identical, so this equals resizing the
// triplicated RGB batch. The output is NHWC, which is the channels_last
// memory of the NCHW tensor the ResNet's convolutions take.
//
// What bounds it on the card: bytes. A 512x512 grey image is 256 KB in and
// 224*224*3*2 = 294 KB out for ~10 flops per output value. Design: one block
// per (image, output row), all in gridDim.x so that the batch is not bounded
// by gridDim.y's 65535, one thread per output column; the two source rows it
// reads stay in L1/L2, and the stores of a row are contiguous.
#include "common.cuh"

namespace {

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Taps {
  const int* lo;
  const int* hi;
  const float* w0;
  const float* w1;
};

template <typename OutT>
__global__ void __launch_bounds__(256)
image_prep_kernel(const uint8_t* __restrict__ img, Taps ty, Taps tx,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  OutT* __restrict__ out, int H_in, int W_in, int C_in, int H_out,
                  int W_out, int C_out) {
  const int b = blockIdx.x / H_out;
  const int y = blockIdx.x - b * H_out;
  const int r0 = ty.lo[y], r1 = ty.hi[y];
  const float wy0 = ty.w0[y], wy1 = ty.w1[y];
  const size_t row_elems = (size_t)W_in * C_in;
  const uint8_t* row0 = img + ((size_t)b * H_in + r0) * row_elems;
  const uint8_t* row1 = img + ((size_t)b * H_in + r1) * row_elems;
  OutT* orow = out + ((size_t)b * H_out + y) * W_out * C_out;
  for (int x = threadIdx.x; x < W_out; x += blockDim.x) {
    const int c0 = tx.lo[x], c1 = tx.hi[x];
    const float wx0 = tx.w0[x], wx1 = tx.w1[x];
    if (C_in == 1) {
      const float t0 = wy0 * (float)row0[c0] + wy1 * (float)row1[c0];
      const float t1 = wy0 * (float)row0[c1] + wy1 * (float)row1[c1];
      const float v = wx0 * t0 + wx1 * t1;
      for (int c = 0; c < C_out; ++c) orow[x * C_out + c] = to_out<OutT>(v * scale[c] + bias[c]);
    } else {
      for (int c = 0; c < C_in; ++c) {
        const float t0 = wy0 * (float)row0[c0 * C_in + c] + wy1 * (float)row1[c0 * C_in + c];
        const float t1 = wy0 * (float)row0[c1 * C_in + c] + wy1 * (float)row1[c1 * C_in + c];
        const float v = wx0 * t0 + wx1 * t1;
        orow[x * C_out + c] = to_out<OutT>(v * scale[c] + bias[c]);
      }
    }
  }
}

}  // namespace

// img [B, H_in, W_in, C_in] uint8; taps [H_out] / [W_out]; scale, bias [C_out] fp32;
// out [B, H_out, W_out, C_out], bf16 (out_bf16 = 1) or fp32 (out_bf16 = 0).
// C_out equals C_in, or C_in = 1 broadcast to C_out; B * H_out < 2^31.
CXR_API int cxr_image_prep(const void* img, const void* y_lo, const void* y_hi,
                           const void* y_w0, const void* y_w1, const void* x_lo,
                           const void* x_hi, const void* x_w0, const void* x_w1,
                           const void* scale, const void* bias, void* out, int B, int H_in,
                           int W_in, int C_in, int H_out, int W_out, int C_out, int out_bf16,
                           void* stream) {
  if (B <= 0 || H_out <= 0 || (long long)B * H_out > 2147483647LL ||
      (C_in != C_out && C_in != 1))
    return cudaErrorInvalidValue;
  Taps ty{static_cast<const int*>(y_lo), static_cast<const int*>(y_hi),
          static_cast<const float*>(y_w0), static_cast<const float*>(y_w1)};
  Taps tx{static_cast<const int*>(x_lo), static_cast<const int*>(x_hi),
          static_cast<const float*>(x_w0), static_cast<const float*>(x_w1)};
  const dim3 grid(static_cast<unsigned>(B * H_out));
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint8_t*>(img);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  if (out_bf16) {
    image_prep_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        in, ty, tx, sc, bi, static_cast<__nv_bfloat16*>(out), H_in, W_in, C_in, H_out, W_out,
        C_out);
  } else {
    image_prep_kernel<float><<<grid, 256, 0, s>>>(in, ty, tx, sc, bi, static_cast<float*>(out),
                                                 H_in, W_in, C_in, H_out, W_out, C_out);
  }
  return cudaGetLastError();
}
