// Attention backward: packed qkv (kernel B6) and split q/k/v (kernel B7), one
// kernel body.
//
// Replaces the TPU kernels clip_for_dl_tpu/ops/flash_attention.py
// _bwd_kernel_packed (:375), reached through _pallas_bwd_packed's
// pallas_call (:654), and _bwd_kernel (:343), reached through _pallas_bwd's
// pallas_call (:478); both compute _head_bwd (:185) per head:
//
//   s  = q k^T * scale + bias,  p = softmax(s)             fp32, recomputed
//   keep = u >= rate (u: the forward's counter hash, regenerated)
//   pd = keep ? p / (1 - rate) : 0;  dv = bf16(pd)^T do     fp32 accumulation
//   dp = keep ? (do v^T) / (1 - rate) : 0
//   delta = rowsum(p * dp)                                  fp32 p and dp
//   ds = bf16(p * (dp - delta))
//   dq = ds k * scale,  dk = ds^T q * scale
//
// each head's dq, dk and dv rounded to bf16 and written through a base
// pointer and HeadStrides (common.cuh) per operand, as the forward reads q, k
// and v: into the packed dqkv [B, N, 3*H*D] (q | k | v heads) for B6, into
// three tensors in the inputs' layout ([B, N, H, D] or [B, H, N, D]) for B7,
// with the same fmaf sequence in every layout. delta is taken from the fp32 p and dp
// as the TPU kernel does, not FlashAttention-2's rowsum(dO * O), which
// differs from it by O's and pd's bf16 rounding.
//
// What bounds it on the card: at the train shape (B = 128, N = 200, H = 12,
// D = 64) it is ~39 GFLOP (five products of 2 N^2 D per head) over 275 MB in
// and out, bound by the bytes on paper (0.082 ms at 3.35 TB/s). One head's
// Q, K, V and dO are 4 x 25.6 KB of bf16, but at the
// checked bound N = 512 they are 4 x 64 KB, more than the 227 KB a Hopper
// block can hold, so no block owns a whole head. The kernel is two passes
// (FlashAttention-2's split), each of which holds two of the four matrices:
//
//   1. rows: one block per (64 query rows, head, batch row) stages the head's
//      K and V; each warp takes one query row at a time and computes its
//      scores and dp with the keys lane-strided (kMaxN / 32 registers each),
//      the row max, sum and delta with shuffles, then ds, and dq = ds k with
//      each lane owning D / 32 output dims. It writes dq and the row's (max,
//      sum, delta) to a [3, B, H, N] fp32 scratch.
//   2. columns: one block per (64 key columns, head, batch row) stages the
//      head's Q and dO and the row statistics; each warp takes one key at a
//      time, recomputes the column of p and dp with the query rows
//      lane-strided, stages bf16 pd and ds in shared memory and reduces
//      dv = pd^T do and dk = ds^T q with each lane owning D / 32 dims.
//
// The row statistics are recomputed here, not saved by the forward: delta
// needs a full pass over each row's scores and dp anyway, and that pass
// yields the max and sum for free, so the forward writes nothing extra and
// the autograd function saves only its inputs, as the TPU's custom VJP does.
// Every sum over rows or columns is a loop inside one warp: the reduction is
// deterministic, with no atomics. Both passes form each score and each dp
// with the same fmaf sequence, so p and dp agree bit for bit between them.
// Matrices in shared memory are stored as rows of bf16 pairs padded by one
// word, so that lanes reading different rows hit different banks. This first
// kernel runs on the CUDA cores, as the forward does.
//
// Head dim 128: staging both matrices would need N * 556 bytes (rows) and
// N * 596 bytes (columns), over the limit for N > 418 and N > 390. So at
// D = 128 each pass stages only the matrix its score loop reads both across
// lanes and row by row (K in the rows pass, Q in the columns pass) and reads
// the other (V, or dO) from global memory: across lanes as 16-byte vectors,
// row by row as coalesced 256-byte rows; one head's V or dO (128 KB at
// N = 512) stays in L2. Shared memory is then N * 296 and N * 336 bytes
// (151,552 and 172,032 at N = 512). D = 64 keeps both matrices staged.
#include <float.h>

#include "common.cuh"

namespace {

using cxr::HeadStrides;

constexpr int kWarps = 8;
constexpr int kRows = 64;   // query rows (pass 1) or key columns (pass 2) per block
constexpr int kMaxN = 512;  // sequence bound (MAX_SEQ_LEN)

// the second matrix of each pass (V, dO) is staged only at D = 64
template <int D>
__host__ __device__ constexpr bool stage_second() { return D <= 64; }

template <int D>
__host__ __device__ constexpr size_t rows_smem_bytes(int N) {
  return (size_t)(stage_second<D>() ? 2 : 1) * N * (D / 2 + 1) * 4  // K (and V), padded rows
         + (size_t)N * 4                                           // key bias
         + (size_t)kWarps * N * 4;                                 // per-warp ds row
}

template <int D>
__host__ __device__ constexpr size_t cols_smem_bytes(int N) {
  return (size_t)(stage_second<D>() ? 2 : 1) * N * (D / 2 + 1) * 4  // Q (and dO), padded rows
         + (size_t)3 * N * 4                                       // row max, sum, delta
         + (size_t)2 * kWarps * N * 4;                             // per-warp pd and ds columns
}

// a.b over W bf16 pairs, in the one order both passes use (unrolled, so a
// register array argument stays in registers)
template <int W>
__device__ __forceinline__ float dot_pairs(const uint32_t* a, const uint32_t* b) {
  float acc = 0.f;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const float2 x = cxr::bf2_to_f2(a[w]);
    const float2 y = cxr::bf2_to_f2(b[w]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// dot_pairs with b read from global memory as 16-byte vectors (b 16-byte
// aligned); the same fmaf sequence, so the same result
template <int W>
__device__ __forceinline__ float dot_pairs_global(const uint32_t* a, const uint32_t* b) {
  float acc = 0.f;
#pragma unroll
  for (int w = 0; w < W; w += 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(b + w));
    const uint32_t bw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = cxr::bf2_to_f2(a[w + e]);
      const float2 y = cxr::bf2_to_f2(bw[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_rows_kernel(const uint32_t* __restrict__ q, HeadStrides sq,
                      const uint32_t* __restrict__ k, HeadStrides sk,
                      const uint32_t* __restrict__ v, HeadStrides sv,
                      const uint32_t* __restrict__ dout, HeadStrides sdo,
                      const float* __restrict__ bias, const int* __restrict__ seeds,
                      uint32_t* __restrict__ dq, HeadStrides sdq, float* __restrict__ stats,
                      int N, int H, float scale, float rate, float inv_keep) {
  constexpr int W = D / 2;
  constexpr int KS = W + 1;
  constexpr int NT = kMaxN / 32;
  constexpr int WPL = W / 32;
  static_assert(W % 32 == 0, "D must be a multiple of 64");

  extern __shared__ uint32_t smem[];
  constexpr bool kStage = stage_second<D>();
  uint32_t* ks = smem;                                      // [N][KS]
  uint32_t* vs = ks + (size_t)N * KS;                       // [N][KS] when staged
  float* bs = reinterpret_cast<float*>(vs + (kStage ? (size_t)N * KS : 0));  // [N]
  float* dsw = bs + N;                                      // [kWarps][N]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this (batch row, head)'s rows: token i at i * s.n words
  const uint32_t* qb = q + b * sq.b + h * sq.h;
  const uint32_t* kb = k + b * sk.b + h * sk.h;
  const uint32_t* vb = v + b * sv.b + h * sv.h;
  const uint32_t* ob = dout + b * sdo.b + h * sdo.h;
  uint32_t* gb = dq + b * sdq.b + h * sdq.h;
  const size_t plane = (size_t)gridDim.z * H * N;
  float* st = stats + ((size_t)b * H + h) * N;  // max at st, sum at +plane, delta at +2*plane

  for (int i = threadIdx.x; i < N * W; i += blockDim.x) {
    const int j = i / W, w = i % W;
    ks[j * KS + w] = kb[j * sk.n + w];
    if constexpr (kStage) vs[j * KS + w] = vb[j * sv.n + w];
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) bs[j] = bias[(size_t)b * N + j];
  __syncthreads();

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  float* ds_row = dsw + warp * N;
  const int row_end = min(row0 + kRows, N);
  for (int i = row0 + warp; i < row_end; i += kWarps) {
    uint32_t q2[W], o2[W];
    const uint32_t* qrow = qb + i * sq.n;
    const uint32_t* orow = ob + i * sdo.n;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      q2[w] = qrow[w];
      o2[w] = orow[w];
    }

    float s[NT], dp[NT];
    float m = -FLT_MAX;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = lane + 32 * t;
      s[t] = -FLT_MAX;
      dp[t] = 0.f;
      if (j < N) {
        s[t] = fmaf(dot_pairs<W>(q2, ks + j * KS), scale, bs[j]);
        if constexpr (kStage) dp[t] = dot_pairs<W>(o2, vs + j * KS);
        else dp[t] = dot_pairs_global<W>(o2, vb + j * sv.n);
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
    float pdp = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        s[t] = s[t] / l;  // p
        if (drop) dp[t] = cxr::uniform01(salt, i, j) >= rate ? dp[t] * inv_keep : 0.f;
        pdp += s[t] * dp[t];
      }
    }
    const float delta = cxr::warp_sum(pdp);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = lane + 32 * t;
      if (j < N) ds_row[j] = cxr::round_bf16(s[t] * (dp[t] - delta));
    }
    __syncwarp();

    float a[2 * WPL];
#pragma unroll
    for (int u = 0; u < 2 * WPL; ++u) a[u] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float dj = ds_row[j];
#pragma unroll
      for (int u = 0; u < WPL; ++u) {
        const float2 kf = cxr::bf2_to_f2(ks[j * KS + u * 32 + lane]);
        a[2 * u] = fmaf(dj, kf.x, a[2 * u]);
        a[2 * u + 1] = fmaf(dj, kf.y, a[2 * u + 1]);
      }
    }
    uint32_t* gq = gb + i * sdq.n;
#pragma unroll
    for (int u = 0; u < WPL; ++u) gq[u * 32 + lane] = cxr::f2_to_bf2(a[2 * u] * scale, a[2 * u + 1] * scale);
    if (lane == 0) {
      st[i] = m;
      st[plane + i] = l;
      st[2 * plane + i] = delta;
    }
    __syncwarp();  // ds_row is rewritten by this warp's next row
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_cols_kernel(const uint32_t* __restrict__ q, HeadStrides sq,
                      const uint32_t* __restrict__ k, HeadStrides sk,
                      const uint32_t* __restrict__ v, HeadStrides sv,
                      const uint32_t* __restrict__ dout, HeadStrides sdo,
                      const float* __restrict__ bias, const int* __restrict__ seeds,
                      uint32_t* __restrict__ dk, HeadStrides sdk, uint32_t* __restrict__ dv,
                      HeadStrides sdv, const float* __restrict__ stats, int N, int H,
                      float scale, float rate, float inv_keep) {
  constexpr int W = D / 2;
  constexpr int KS = W + 1;
  constexpr int WPL = W / 32;

  extern __shared__ uint32_t smem[];
  constexpr bool kStage = stage_second<D>();
  uint32_t* qs = smem;                                       // [N][KS]
  uint32_t* os = qs + (size_t)N * KS;                        // [N][KS] when staged
  float* sm = reinterpret_cast<float*>(os + (kStage ? (size_t)N * KS : 0));  // [N] row max
  float* sl = sm + N;                                        // [N] row sum
  float* sd = sl + N;                                        // [N] row delta
  float* pw = sd + N;                                        // [kWarps][N] bf16(pd)
  float* dw = pw + kWarps * N;                               // [kWarps][N] bf16(ds)

  const int b = blockIdx.z, h = blockIdx.y, col0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this (batch row, head)'s rows: token i at i * s.n words
  const uint32_t* qb = q + b * sq.b + h * sq.h;
  const uint32_t* kb = k + b * sk.b + h * sk.h;
  const uint32_t* vb = v + b * sv.b + h * sv.h;
  const uint32_t* ob = dout + b * sdo.b + h * sdo.h;
  uint32_t* gkb = dk + b * sdk.b + h * sdk.h;
  uint32_t* gvb = dv + b * sdv.b + h * sdv.h;
  const size_t plane = (size_t)gridDim.z * H * N;
  const float* st = stats + ((size_t)b * H + h) * N;

  for (int i = threadIdx.x; i < N * W; i += blockDim.x) {
    const int r = i / W, w = i % W;
    qs[r * KS + w] = qb[r * sq.n + w];
    if constexpr (kStage) os[r * KS + w] = ob[r * sdo.n + w];
  }
  for (int r = threadIdx.x; r < N; r += blockDim.x) {
    sm[r] = st[r];
    sl[r] = st[plane + r];
    sd[r] = st[2 * plane + r];
  }
  __syncthreads();

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  float* pcol = pw + warp * N;
  float* dcol = dw + warp * N;
  const int col_end = min(col0 + kRows, N);
  for (int j = col0 + warp; j < col_end; j += kWarps) {
    uint32_t k2[W], v2[W];
    const uint32_t* krow = kb + j * sk.n;
    const uint32_t* vrow = vb + j * sv.n;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      k2[w] = krow[w];
      v2[w] = vrow[w];
    }
    const float bj = bias[(size_t)b * N + j];
    for (int i = lane; i < N; i += 32) {
      const float s = fmaf(dot_pairs<W>(qs + i * KS, k2), scale, bj);
      const float p = expf(s - sm[i]) / sl[i];
      float d;
      if constexpr (kStage) d = dot_pairs<W>(os + i * KS, v2);
      else d = dot_pairs_global<W>(v2, ob + i * sdo.n);
      float pd = p;
      if (drop) {
        const bool keep = cxr::uniform01(salt, i, j) >= rate;
        pd = keep ? p * inv_keep : 0.f;
        d = keep ? d * inv_keep : 0.f;
      }
      pcol[i] = cxr::round_bf16(pd);
      dcol[i] = cxr::round_bf16(p * (d - sd[i]));
    }
    __syncwarp();

    float av[2 * WPL], ak[2 * WPL];
#pragma unroll
    for (int u = 0; u < 2 * WPL; ++u) av[u] = ak[u] = 0.f;
    for (int i = 0; i < N; ++i) {
      const float pi = pcol[i], di = dcol[i];
      const uint32_t* orow;
      if constexpr (kStage) orow = os + i * KS;
      else orow = ob + i * sdo.n;
#pragma unroll
      for (int u = 0; u < WPL; ++u) {
        const float2 of = cxr::bf2_to_f2(orow[u * 32 + lane]);
        const float2 qf = cxr::bf2_to_f2(qs[i * KS + u * 32 + lane]);
        av[2 * u] = fmaf(pi, of.x, av[2 * u]);
        av[2 * u + 1] = fmaf(pi, of.y, av[2 * u + 1]);
        ak[2 * u] = fmaf(di, qf.x, ak[2 * u]);
        ak[2 * u + 1] = fmaf(di, qf.y, ak[2 * u + 1]);
      }
    }
    uint32_t* gk = gkb + j * sdk.n;
    uint32_t* gv = gvb + j * sdv.n;
#pragma unroll
    for (int u = 0; u < WPL; ++u) {
      gk[u * 32 + lane] = cxr::f2_to_bf2(ak[2 * u] * scale, ak[2 * u + 1] * scale);
      gv[u * 32 + lane] = cxr::f2_to_bf2(av[2 * u], av[2 * u + 1]);
    }
    __syncwarp();  // pcol and dcol are rewritten by this warp's next key
  }
}

// one operand of the backward: base pointer and strides
struct Operand {
  const uint32_t* p;
  HeadStrides s;
};

struct Gradient {
  uint32_t* p;
  HeadStrides s;
};

template <int D>
cudaError_t launch(Operand q, Operand k, Operand v, Operand dout, const void* bias,
                   const void* seeds, Gradient dq, Gradient dk, Gradient dv, void* stats, int B,
                   int N, int H, float scale, float rate, float inv_keep, cudaStream_t stream) {
  const size_t rows_smem = rows_smem_bytes<D>(N), cols_smem = cols_smem_bytes<D>(N);
  cudaError_t err = cxr::allow_smem(flash_bwd_rows_kernel<D>, rows_smem);
  if (err != cudaSuccess) return err;
  err = cxr::allow_smem(flash_bwd_cols_kernel<D>, cols_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  const auto* bi = static_cast<const float*>(bias);
  const auto* sd = static_cast<const int*>(seeds);
  auto* st = static_cast<float*>(stats);
  flash_bwd_rows_kernel<D><<<grid, kWarps * 32, rows_smem, stream>>>(
      q.p, q.s, k.p, k.s, v.p, v.s, dout.p, dout.s, bi, sd, dq.p, dq.s, st, N, H, scale, rate,
      inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_cols_kernel<D><<<grid, kWarps * 32, cols_smem, stream>>>(
      q.p, q.s, k.p, k.s, v.p, v.s, dout.p, dout.s, bi, sd, dk.p, dk.s, dv.p, dv.s, st, N, H,
      scale, rate, inv_keep);
  return cudaGetLastError();
}

bool bad_args(int B, int N, int H, float rate) {
  return N < 1 || N > kMaxN || B < 1 || B > 65535 || H < 1 || H > 65535 || !(rate >= 0.f) ||
         !(rate < 1.f);
}

cudaError_t dispatch(int D, Operand q, Operand k, Operand v, Operand dout, const void* bias,
                     const void* seeds, Gradient dq, Gradient dk, Gradient dv, void* stats,
                     int B, int N, int H, float scale, float rate, float inv_keep,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, B, N, H, scale, rate,
                        inv_keep, s);
    case 128:
      return launch<128>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, B, N, H, scale, rate,
                         inv_keep, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B6: qkv [B, N, 3*H*D] bf16, dout [B, N, H*D] bf16, bias [B, N] fp32, seeds
// [B] int32, dqkv [B, N, 3*H*D] bf16 (every element written), stats
// [3, B, H, N] fp32 scratch; D in {64, 128}, 1 <= N <= 512, B <= 65535;
// 0 <= rate < 1 and inv_keep = 1 / (1 - rate), as in the forward that made
// dout's output.
CXR_API int cxr_flash_bwd_packed(const void* qkv, const void* dout, const void* bias,
                                 const void* seeds, void* dqkv, void* stats, int B, int N,
                                 int H, int D, float scale, float rate, float inv_keep,
                                 void* stream) {
  if (bad_args(B, N, H, rate)) return cudaErrorInvalidValue;
  const long long W = D / 2, row = 3 * H * W;
  const cxr::HeadStrides sqkv{N * row, row, W}, sdo{N * H * W, H * W, W};
  const auto* in = static_cast<const uint32_t*>(qkv);
  auto* g = static_cast<uint32_t*>(dqkv);
  return dispatch(D, {in, sqkv}, {in + H * W, sqkv}, {in + 2 * H * W, sqkv},
                  {static_cast<const uint32_t*>(dout), sdo}, bias, seeds, {g, sqkv},
                  {g + H * W, sqkv}, {g + 2 * H * W, sqkv}, stats, B, N, H, scale, rate,
                  inv_keep, stream);
}

// B7: q, k, v, dout, dq, dk and dv bf16 with the head dim contiguous, each
// addressed by three strides in 32-bit words in ``strides`` (host memory, 21
// values: q, k, v, dout, dq, dk, dv, each as batch, token, head); at D = 128
// every stride a multiple of 4 words and every pointer 16-byte aligned. Other
// arguments as B6's.
CXR_API int cxr_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                          const void* bias, const void* seeds, void* dq, void* dk, void* dv,
                          void* stats, const long long* strides, int B, int N, int H, int D,
                          float scale, float rate, float inv_keep, void* stream) {
  if (bad_args(B, N, H, rate)) return cudaErrorInvalidValue;
  cxr::HeadStrides s[7];
  for (int t = 0; t < 7; ++t) s[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
  auto out = [](void* p) { return static_cast<uint32_t*>(p); };
  return dispatch(D, {in(q), s[0]}, {in(k), s[1]}, {in(v), s[2]}, {in(dout), s[3]}, bias,
                  seeds, {out(dq), s[4]}, {out(dk), s[5]}, {out(dv), s[6]}, stats, B, N, H,
                  scale, rate, inv_keep, stream);
}
