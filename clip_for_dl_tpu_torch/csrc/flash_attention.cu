// Attention forward: packed qkv (kernel B3) and split q/k/v (kernel B5), one
// kernel body.
//
// Replaces the TPU kernels clip_for_dl_tpu/ops/flash_attention.py
// _fwd_kernel_packed (:309), reached through _pallas_fwd_packed's
// pallas_call (:623), and _fwd_kernel (:278), reached through _pallas_fwd's
// pallas_call (:443); both compute _head_fwd (:168) per head.
//
// For each batch row b and head h, with q, k, v the head's [N, D] rows, key
// bias [B, N] (0 for real tokens, -1e10 for padding) and dropout seeds [B]
// (int32):
//
//   s = q k^T * scale + bias          fp32
//   p = softmax(s)                    fp32, normalized
//   p = u >= rate ? p / (1 - rate) : 0    only when rate > 0
//   o = bf16(p) v                     fp32 accumulation, stored bf16
//
// The probabilities are normalized in fp32, dropped out and rounded to bf16
// before PV, exactly as the TPU kernel does, so the kernel and the plain
// version differ only by summation order; no online-softmax rescaling is
// involved. The dropout draw u is the JAX counter hash (common.cuh
// uniform01) over the absolute (query row, key column) pair with the salt
// seed[b] + h * 0xC2B2AE3D: the TPU kernel pads N to a multiple of 8, but
// its grid indices are absolute, so the bits at real positions are the same
// and the backward kernel (flash_attention_bwd.cu) regenerates the mask.
//
// Layouts: the body reads q, k, v and writes o through a base pointer and
// HeadStrides (batch, token, head strides in words) per operand. Packed qkv
// [B, N, 3*H*D] (columns q-heads | k-heads | v-heads) is three views of one
// buffer; split [B, N, H, D] and [B, H, N, D] are two other stride sets, so
// no layout needs a transpose copy, and every layout runs the same fmaf
// sequence: the split form of a packed qkv's slices gives the packed form's
// bits.
//
// Sequence edge: there is no padding to a multiple of 8 (the TPU's sublane
// tile); key columns j >= N are skipped in the kernel. The running maximum
// starts from -FLT_MAX, a finite value, and padded keys carry a finite
// -1e10, so a query row whose keys are all padding still gives finite output.
// The TPU's pair packing (_pair_fwd) is MXU layout work and has no
// counterpart here.
//
// What bounds it on the card: at the prompt-bank shape (B=64, N=200, H=12,
// D=64) it is ~7.9 GFLOP over 79 MB in and out, bound by the bytes on paper
// (0.024 ms at 3.35 TB/s). This first kernel runs on the CUDA cores, not the
// tensor cores: one block per (64 query rows, head, batch row) stages that
// head's K and V in shared memory (K rows padded by one word so that lanes
// reading different keys hit different banks); each warp takes one query row
// at a time, keeps q in registers, scores its keys lane-strided (up to
// kMaxN / 32 per lane), reduces max and sum with shuffles, and accumulates PV
// with each lane owning D / 32 output dims. The N <= 512 bound (MAX_SEQ_LEN
// in the TPU file) is kept. At D = 64 a block needs N * 296 bytes of shared
// memory (150 KB at N = 512, within Hopper's 227 KB). At D = 128, K and V
// together would need N * 552 bytes (282,624 at N = 512, over the limit), so
// only K, which the score loop reads across lanes, is staged; the PV loop
// reads V row by row, one coalesced 256-byte row per step, from global
// memory, where one head's V (128 KB at N = 512) stays in L2. That is N * 296
// bytes again.
#include <float.h>

#include "common.cuh"

namespace {

using cxr::HeadStrides;

constexpr int kWarps = 8;
constexpr int kRows = 64;   // query rows per block
constexpr int kMaxN = 512;  // keys per row: kMaxN / 32 score registers per lane

// V is staged in shared memory only at D = 64 (see the note above)
template <int D>
__host__ __device__ constexpr bool stage_v() { return D <= 64; }

template <int D>
__host__ __device__ constexpr size_t smem_bytes(int N) {
  return (size_t)N * (D / 2 + 1) * 4                    // K, padded rows of bf16 pairs
         + (stage_v<D>() ? (size_t)N * (D / 2) * 4 : 0)   // V
         + (size_t)N * 4                                // key bias
         + (size_t)kWarps * N * 4;                      // per-warp probabilities
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const uint32_t* __restrict__ q, HeadStrides sq, const uint32_t* __restrict__ k,
                 HeadStrides sk, const uint32_t* __restrict__ v, HeadStrides sv,
                 const float* __restrict__ bias, const int* __restrict__ seeds,
                 uint32_t* __restrict__ out, HeadStrides so, int N, float scale, float rate,
                 float inv_keep) {
  constexpr int W = D / 2;       // bf16 pairs per head row
  constexpr int KS = W + 1;      // padded K row stride in words
  constexpr int NT = kMaxN / 32;
  constexpr int WPL = W / 32;    // output pairs per lane
  static_assert(W % 32 == 0, "D must be a multiple of 64");

  extern __shared__ uint32_t smem[];
  uint32_t* ks = smem;                              // [N][KS]
  uint32_t* vs = ks + (size_t)N * KS;               // [N][W] when staged
  float* bs = reinterpret_cast<float*>(vs + (stage_v<D>() ? (size_t)N * W : 0));  // [N]
  float* ps = bs + N;                               // [kWarps][N]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this (batch row, head)'s rows: token i at i * s.n words
  const uint32_t* qb = q + b * sq.b + h * sq.h;
  const uint32_t* kb = k + b * sk.b + h * sk.h;
  const uint32_t* vb = v + b * sv.b + h * sv.h;
  uint32_t* ob = out + b * so.b + h * so.h;

  for (int i = threadIdx.x; i < N * W; i += blockDim.x) {
    const int j = i / W, w = i % W;
    ks[j * KS + w] = kb[j * sk.n + w];
    if constexpr (stage_v<D>()) vs[j * W + w] = vb[j * sv.n + w];
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) bs[j] = bias[(size_t)b * N + j];
  __syncthreads();

  float* p = ps + warp * N;
  const int row_end = min(row0 + kRows, N);
  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  for (int i = row0 + warp; i < row_end; i += kWarps) {
    const uint32_t* qrow = qb + i * sq.n;
    float qf[D];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float2 f = cxr::bf2_to_f2(qrow[w]);
      qf[2 * w] = f.x;
      qf[2 * w + 1] = f.y;
    }

    float s[NT];
    float m = -FLT_MAX;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = lane + 32 * t;
      s[t] = -FLT_MAX;
      if (j < N) {
        const uint32_t* kr = ks + j * KS;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float2 kf = cxr::bf2_to_f2(kr[w]);
          acc = fmaf(qf[2 * w], kf.x, acc);
          acc = fmaf(qf[2 * w + 1], kf.y, acc);
        }
        s[t] = acc * scale + bs[j];
        m = fmaxf(m, s[t]);
      }
    }
    m = cxr::warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = lane + 32 * t;
      s[t] = (j < N) ? expf(s[t] - m) : 0.f;
      l += s[t];
    }
    l = cxr::warp_sum(l);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        float pj = s[t] / l;
        if (drop) pj = cxr::uniform01(salt, i, j) >= rate ? pj * inv_keep : 0.f;
        p[j] = cxr::round_bf16(pj);
      }
    }
    __syncwarp();

    float o[2 * WPL];
#pragma unroll
    for (int u = 0; u < 2 * WPL; ++u) o[u] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float pj = p[j];
      const uint32_t* vrow;
      if constexpr (stage_v<D>()) vrow = vs + j * W;
      else vrow = vb + j * sv.n;
#pragma unroll
      for (int u = 0; u < WPL; ++u) {
        const float2 vf = cxr::bf2_to_f2(vrow[u * 32 + lane]);
        o[2 * u] = fmaf(pj, vf.x, o[2 * u]);
        o[2 * u + 1] = fmaf(pj, vf.y, o[2 * u + 1]);
      }
    }
    uint32_t* orow = ob + i * so.n;
#pragma unroll
    for (int u = 0; u < WPL; ++u) orow[u * 32 + lane] = cxr::f2_to_bf2(o[2 * u], o[2 * u + 1]);
    __syncwarp();  // p is rewritten by this warp's next row
  }
}

template <int D>
cudaError_t launch(const uint32_t* q, HeadStrides sq, const uint32_t* k, HeadStrides sk,
                   const uint32_t* v, HeadStrides sv, const void* bias, const void* seeds,
                   uint32_t* out, HeadStrides so, int B, int N, int H, float scale, float rate,
                   float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(N);
  cudaError_t err = cxr::allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      q, sq, k, sk, v, sv, static_cast<const float*>(bias), static_cast<const int*>(seeds), out,
      so, N, scale, rate, inv_keep);
  return cudaGetLastError();
}

bool bad_args(int B, int N, int H, float rate) {
  return N < 1 || N > kMaxN || B < 1 || B > 65535 || H < 1 || H > 65535 || !(rate >= 0.f) ||
         !(rate < 1.f);
}

cudaError_t dispatch(int D, const uint32_t* q, HeadStrides sq, const uint32_t* k, HeadStrides sk,
                     const uint32_t* v, HeadStrides sv, const void* bias, const void* seeds,
                     uint32_t* out, HeadStrides so, int B, int N, int H, float scale, float rate,
                     float inv_keep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, scale, rate,
                        inv_keep, s);
    case 128:
      return launch<128>(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, scale, rate,
                         inv_keep, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B3: qkv [B, N, 3*H*D] bf16, bias [B, N] fp32, seeds [B] int32, out
// [B, N, H*D] bf16; D in {64, 128}, 1 <= N <= 512, B <= 65535; 0 <= rate < 1
// and inv_keep = 1 / (1 - rate) (rate 0 turns dropout off).
CXR_API int cxr_flash_fwd_packed(const void* qkv, const void* bias, const void* seeds,
                                 void* out, int B, int N, int H, int D, float scale,
                                 float rate, float inv_keep, void* stream) {
  if (bad_args(B, N, H, rate)) return cudaErrorInvalidValue;
  const long long W = D / 2, row = 3 * H * W;
  const cxr::HeadStrides sqkv{N * row, row, W}, so{N * H * W, H * W, W};
  const auto* base = static_cast<const uint32_t*>(qkv);
  return dispatch(D, base, sqkv, base + H * W, sqkv, base + 2 * H * W, sqkv, bias, seeds,
                  static_cast<uint32_t*>(out), so, B, N, H, scale, rate, inv_keep, stream);
}

// B5: q, k, v and out bf16 with the head dim contiguous, each addressed by
// three strides in 32-bit words in ``strides`` (host memory, 12 values: q,
// k, v, out, each as batch, token, head); at D = 128 every stride a multiple
// of 4 words and every pointer 16-byte aligned. Other arguments as B3's.
CXR_API int cxr_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                          const void* seeds, void* out, const long long* strides, int B, int N,
                          int H, int D, float scale, float rate, float inv_keep, void* stream) {
  if (bad_args(B, N, H, rate)) return cudaErrorInvalidValue;
  const cxr::HeadStrides sq{strides[0], strides[1], strides[2]};
  const cxr::HeadStrides sk{strides[3], strides[4], strides[5]};
  const cxr::HeadStrides sv{strides[6], strides[7], strides[8]};
  const cxr::HeadStrides so{strides[9], strides[10], strides[11]};
  return dispatch(D, static_cast<const uint32_t*>(q), sq, static_cast<const uint32_t*>(k), sk,
                  static_cast<const uint32_t*>(v), sv, bias, seeds, static_cast<uint32_t*>(out),
                  so, B, N, H, scale, rate, inv_keep, stream);
}
