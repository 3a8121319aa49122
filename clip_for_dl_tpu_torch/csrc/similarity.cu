// Fused L2-normalize + cosine similarity (kernel B1).
//
// Replaces the TPU kernel clip_for_dl_tpu/ops/similarity.py _fused_kernel
// (:45), reached through _fused_similarity_impl's pallas_call (:152).
//
//   out[b, c] = <img[b], txt[c]> * rsqrt(max(|img[b]|^2, eps^2)) * inv_temp
//                                * rsqrt(max(|txt[c]|^2, eps^2))
//
// in fp32, with the clamp on the squared norm as the TPU kernel has it (zero
// rows, such as the padded rows of a service bucket, give 0, not NaN). The
// kernel takes the dot product of the raw rows and both squared norms in one
// pass, then scales the dot by the two rsqrt factors: one fp32 rounding from
// scaling the rows first, as the plain version does. Each side is read in
// its own type (fp32, bf16 or fp16, a template parameter each) and widened to
// fp32 in registers, as the TPU kernel casts inside itself.
//
// What bounds it on the card: bytes and latency. At the serving shape
// (B = 256 image rows of D = 512 fp32 against C = 16 prompt features) the
// call moves 0.56 MB for 4.5 M flops, far below the ridge point, and the
// [B, D] x [D, 16] product is too small for tensor-core tiles to matter; its
// bound is 0.00017 ms, so the time is the latency of one wave.
//
// What held the first design back (0.0041 ms on the card at that shape, on an
// NVIDIA H100 80GB HBM3 at 700 W): 32 blocks of 8 warps, one warp an image
// row, on 132 SMs; scalar loads; the text tile through shared memory behind
// a barrier, its norms taken by every block; and 16 + 2 warp reductions of
// five dependent shuffles each at the end of every group of 16 prompts.
//
// This design: one block of kThreads threads an image row (256 blocks at the
// serving batch, about two an SM). A thread owns E consecutive features of a
// row (E = 4 in fp32, 8 where a side is 16-bit) at every kThreads * E step
// of D. For each group of kGroup text rows it issues the 16-byte loads of
// its image piece and of its piece of every text row of the group, in each
// input's own type, before using any, so all of them wait out one memory
// latency; the text block is read from L2 by every block, which costs less
// than staging it in shared memory behind a barrier. It accumulates the
// kGroup dot products, the kGroup text squared norms and the image squared
// norm in registers. The block then reduces those 2 kGroup + 1 partial sums:
// within a warp by a reduce-scatter (five rounds of 16, 8, 4, 2 and 1
// shuffles, after which lane l holds the warp's sum of value l: 31 shuffles
// five deep, where 32 separate warp sums would take 160), then across the
// kWarps warps through shared memory, and warp 0 writes the group's kGroup
// logits. Rows whose width or address does not allow whole 16-byte pieces
// are read element by element, in the same order.
//
// Timed in turns on the card against the alternatives (PERF.md, section 6),
// this design was the fastest at the serving shape: blocks of 4 or 2 warps,
// each warp an image row, with the text block staged in shared memory once
// per block by double-buffered cp.async, were slower, and two image rows a
// warp slower still.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 16;  // text rows of a group: 2 kGroup partial sums, one a lane
static_assert(2 * kGroup == 32, "the reduce-scatter gives each lane one of 32 sums");

// features a thread takes at a time: one 16-byte piece of the wider side's
// type
template <typename TI, typename TT>
__host__ __device__ constexpr int unit() {
  return sizeof(TI) == 4 && sizeof(TT) == 4 ? 4 : 8;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// fp32 values of E consecutive elements of a row starting at element d
// (d + E <= the row's width, the row on the 16-byte grid), read as whole
// 16-byte pieces
template <typename T, int E>
__device__ __forceinline__ void load_piece(const T* row, int d, float (&x)[E]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(row + d + i));
      x[i] = f.x;
      x[i + 1] = f.y;
      x[i + 2] = f.z;
      x[i + 3] = f.w;
    }
  } else {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + d));
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = cxr::unpack2<T>(ws[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// the same elements one by one, any of them at or past D zero (the rows
// that are not whole 16-byte pieces)
template <typename T, int E>
__device__ __forceinline__ void load_tail(const T* row, int d, int D, float (&x)[E]) {
#pragma unroll
  for (int i = 0; i < E; ++i) x[i] = d + i < D ? to_float(row[d + i]) : 0.f;
}

// One round of the reduce-scatter: lanes with bit OFF set keep v[OFF..2 OFF)
// and send v[0..OFF), the others the reverse, each adding what its partner
// sends. OFF is a template constant so that every index is one, and v stays
// in registers (a loop over OFF put v on the stack).
template <int OFF>
__device__ __forceinline__ void reduce_round(float (&v)[32], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// v[0] of lane l <- the warp's sum of v[l] (v's other entries are spent)
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  reduce_round<16>(v, lane);
  reduce_round<8>(v, lane);
  reduce_round<4>(v, lane);
  reduce_round<2>(v, lane);
  reduce_round<1>(v, lane);
  return v[0];
}

template <typename TI, typename TT>
__global__ void __launch_bounds__(kThreads)
similarity_kernel(const TI* __restrict__ img, const TT* __restrict__ txt, float* __restrict__ out,
                  int C, int D, float inv_temp, float eps2, bool vec) {
  constexpr int E = unit<TI, TT>();
  __shared__ float part[kWarps][33];  // per warp: the 32 reduced sums, then |img|^2
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const TI* row = img + (size_t)b * D;
  for (int c0 = 0; c0 < C; c0 += kGroup) {
    float v[32], iss = 0.f;  // dots at 0..kGroup-1, text |.|^2 at kGroup..
#pragma unroll
    for (int r = 0; r < 32; ++r) v[r] = 0.f;
    for (int d = threadIdx.x * E; d < D; d += kThreads * E) {
      float x[E], t[kGroup][E];
      if (vec) {
        load_piece<TI, E>(row, d, x);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          if (c0 + r < C) {
            load_piece<TT, E>(txt + (size_t)(c0 + r) * D, d, t[r]);
          } else {
#pragma unroll
            for (int i = 0; i < E; ++i) t[r][i] = 0.f;
          }
        }
      } else {
        load_tail<TI, E>(row, d, D, x);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          if (c0 + r < C) {
            load_tail<TT, E>(txt + (size_t)(c0 + r) * D, d, D, t[r]);
          } else {
#pragma unroll
            for (int i = 0; i < E; ++i) t[r][i] = 0.f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < E; ++i) {
        iss = fmaf(x[i], x[i], iss);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          v[r] = fmaf(x[i], t[r][i], v[r]);
          v[kGroup + r] = fmaf(t[r][i], t[r][i], v[kGroup + r]);
        }
      }
    }
    const float mine = reduce_scatter(v, lane);
    iss = cxr::warp_sum(iss);
    if (c0 > 0) __syncthreads();  // warp 0 has read the previous group's sums
    part[warp][lane] = mine;
    if (lane == 0) part[warp][32] = iss;
    __syncthreads();
    if (warp == 0) {
      float sum = 0.f, is = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sum += part[w][lane];
        is += part[w][32];
      }
      // lane r < kGroup holds dot r; lane kGroup + r the text row's |.|^2
      const float tss = __shfl_down_sync(0xffffffffu, sum, kGroup);
      const float ri = rsqrtf(fmaxf(is, eps2)) * inv_temp;
      if (lane < kGroup && c0 + lane < C)
        out[(size_t)b * C + c0 + lane] = sum * ri * rsqrtf(fmaxf(tss, eps2));
    }
  }
}

template <typename TI, typename TT>
cudaError_t launch(const void* img, const void* txt, void* out, int B, int C, int D,
                   float inv_temp, float eps, cudaStream_t stream) {
  constexpr int E = unit<TI, TT>();
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // every row starts on the 16-byte grid, and E elements are whole 16-byte
  // pieces on both sides
  const bool vec = aligned(img) && aligned(txt) && D % E == 0;
  similarity_kernel<TI, TT><<<B, kThreads, 0, stream>>>(
      static_cast<const TI*>(img), static_cast<const TT*>(txt), static_cast<float*>(out), C, D,
      inv_temp, eps * eps, vec);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_txt(int txt_type, const void* img, const void* txt, void* out, int B, int C,
                       int D, float inv_temp, float eps, cudaStream_t s) {
  switch (txt_type) {
    case 0: return launch<TI, float>(img, txt, out, B, C, D, inv_temp, eps, s);
    case 1: return launch<TI, __nv_bfloat16>(img, txt, out, B, C, D, inv_temp, eps, s);
    case 2: return launch<TI, __half>(img, txt, out, B, C, D, inv_temp, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// img [B, D], txt [C, D], each fp32 (type 0), bf16 (1) or fp16 (2); out
// [B, C] fp32; B, C >= 1, D >= 0.
CXR_API int cxr_similarity(const void* img, const void* txt, void* out, int B, int C, int D,
                           float inv_temp, float eps, int img_type, int txt_type,
                           void* stream) {
  if (B < 1 || C < 1 || D < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (img_type) {
    case 0: return launch_txt<float>(txt_type, img, txt, out, B, C, D, inv_temp, eps, s);
    case 1: return launch_txt<__nv_bfloat16>(txt_type, img, txt, out, B, C, D, inv_temp, eps, s);
    case 2: return launch_txt<__half>(txt_type, img, txt, out, B, C, D, inv_temp, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

CXR_API const char* cxr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
