// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exports plain C functions (no PyTorch headers, so nvcc
// builds the library in seconds). Each takes raw device pointers and the
// CUDA stream as void*, launches on that stream without synchronising, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CXR_API extern "C" __attribute__((visibility("default")))

namespace cxr {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// two bf16 packed in one 32-bit word (low half first) <-> two floats
__device__ __forceinline__ float2 bf2_to_f2(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t f2_to_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The same for either 16-bit type of the attention kernels' template
// parameter T (__nv_bfloat16 or __half): two floats rounded to T and packed
// in one word, low half first; and two T of a word back to floats
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  return f2_to_bf2(a, b);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t w) {
  return bf2_to_f2(w);
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t w) {
  __half2 h = *reinterpret_cast<__half2*>(&w);
  return __half22float2(h);
}

// Attention-probability dropout bits: the JAX package's counter hash
// (_uniform01, clip_for_dl_tpu/ops/flash_attention.py:132), a murmur3 fmix32
// over the absolute (query row, key column) grid, salted per batch row and
// head. uint32 arithmetic wraps as the JAX int32 ops do, so the bits are
// equal; the top 24 bits give a uniform [0, 1) that fp32 holds exactly.
__device__ __forceinline__ uint32_t dropout_salt(int seed, int head) {
  return static_cast<uint32_t>(seed) + static_cast<uint32_t>(head) * 0xC2B2AE3Du;
}

__device__ __forceinline__ float uniform01(uint32_t salt, uint32_t row, uint32_t col) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^ salt;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

// Where one attention operand's head rows lie (kernels B3, B5, B6, B7): the
// strides, in 32-bit words (16-bit pairs, or single fp32 values), of its
// batch, token and head dims;
// the head's D values are contiguous. Packed qkv [B, N, 3*H*D] is three views
// of one buffer with token stride 3*H*D/2; split [B, N, H, D] ("bnhd") and
// [B, H, N, D] ("bhnd") are two other stride sets over the same kernel body.
struct HeadStrides {
  long long b, n, h;
};

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace cxr
