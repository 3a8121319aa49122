// Attention forward: packed qkv (kernel B3) and split q/k/v (kernel B5), one
// kernel body on Hopper's tensor cores for bf16 and fp16 operands (the
// 16-bit type T a template parameter), and one on the CUDA cores for fp32
// (at the end of this file).
//
// Replaces the TPU kernels clip_for_dl_tpu/ops/flash_attention.py
// _fwd_kernel_packed (:309), reached through _pallas_fwd_packed's
// pallas_call (:623), and _fwd_kernel (:278), reached through _pallas_fwd's
// pallas_call (:443); both compute _head_fwd (:168) per head.
//
// For each batch row b and head h, with q, k, v the head's [N, D] rows in
// type T, key bias [B, N] (0 for real tokens, -1e10 for padding) and dropout
// seeds [B] (int32):
//
//   s = q k^T * scale + bias          fp32
//   p = softmax(s)                    fp32, normalized
//   p = u >= rate ? p / (1 - rate) : 0    only when rate > 0
//   o = T(p) v                        fp32 accumulation, stored in T
//
// The probabilities are normalized in fp32, dropped out and rounded to T
// before PV, exactly as the TPU kernel does with q's dtype (bf16 below; fp16
// takes mma.sync's .f16 form and fp16 roundings), so the kernel and the plain
// version differ only by summation order and by the normalization, which
// multiplies by 1 / l (as the backward does) where the plain version divides
// by l: one fp32 rounding apart, far inside one bf16 step. The dropout draw u
// is the JAX counter hash (common.cuh uniform01) over the absolute (query
// row, key column) pair with the salt seed[b] + h * 0xC2B2AE3D: the TPU
// kernel pads N to a multiple of 8, but its grid indices are absolute, so the
// bits at real positions are the same and the backward kernel
// (flash_attention_bwd.cu) regenerates the mask.
//
// Layouts: the body reads q, k, v and writes o through a base pointer and
// HeadStrides (batch, token, head strides in words) per operand. Packed qkv
// [B, N, 3*H*D] (columns q-heads | k-heads | v-heads) is three views of one
// buffer; split [B, N, H, D] and [B, H, N, D] are two other stride sets, so
// no layout needs a transpose copy, and every layout runs the same
// instructions: the split form of a packed qkv's slices gives the packed
// form's bits.
//
// What bounds it on the card: at the prompt-bank shape (B = 64, N = 200,
// H = 12, D = 64) it is ~7.9 GFLOP over 79 MB in and out, bound by the bytes
// (0.024 ms at 3.35 TB/s; 0.008 ms by the operations at 989 TFLOP/s). With
// the row statistics taken in a first sweep it does three products, not two,
// and the dropout hash costs ~20 integer operations an element. So every
// product runs on the tensor cores and no [N, N] intermediate leaves the
// registers.
//
// Tiling (the backward's rows pass with fewer products): one block per
// (64 query rows, head, batch row), 4 warps of 16 rows; a batch over 65535
// rows (gridDim.z's bound) is launched in chunks. Q is loaded once; K streams
// in 64-key tiles through a 2-stage ring of 16-byte cp.async copies, twice,
// and V beside it in the second sweep only. Sweep 1
// forms S = Q K^T with mma.sync m16n8k16 (bf16 in, fp32 accumulators), masks
// keys >= N to -inf and keeps the online row max m and sum l, rescaled
// whenever m moves. Sweep 2 forms S again (the same instructions, so the
// same bits), p = exp(s - m) * (1 / l), applies the keep mask and
// 1 / (1 - rate) (the hash runs once an element, here), and the accumulators,
// rounded to bf16 as the A operand, feed o += p V in registers. A one-sweep
// online softmax would round the unnormalized exp(s - m) to bf16 before the
// division, which is another function. o is written through the warp's own
// rows of the Q tile as 16-byte stores. A row with no finite score takes
// m = 0 (exp(s - m) = 0, not NaN); a row whose keys all carry -1e10 gets the
// plain version's uniform p. Tokens >= N of a tile are zero-filled by the
// copy (source size 0) and never read: in a "bnhd" view they belong to the
// next batch row, past the last one to no allocation, and 0 * NaN would be
// NaN in PV.
//
// Head dims 32, 64 and 128 are built (the wrapper zero-pads other widths
// up to 128). Shared memory is independent of N: Q and two stages of K and V,
// 20, 40 and 80 KB at D = 32, 64 and 128, plus the key bias (2 KB). The N <=
// 512 bound (MAX_SEQ_LEN in the TPU file) is kept.
//
// Head dims over 128 (any multiple of 64; the wrapper zero-pads others) run
// flash_fwd_sliced_kernel, the same two sweeps in slices: o at D = 256 would
// be 128 fp32 registers a thread on top of the 254 that D = 128 takes, so
// each block writes one 64-column slice of o (the slice index folded into
// gridDim.y beside the head) and QK^T is summed over 64-column chunks of the
// head dim, each chunk of Q and K streamed through the ring (V's slice only
// rides with the last chunk of a sweep-2 tile). Shared memory (50 KB) and
// registers are the same at every such D. Every slice recomputes s and p,
// which costs D / 64 times the QK^T work; no preset reaches D > 128. The
// slices of a head run the same instructions on the same data, so their
// m, l and dropout masks agree bit for bit.
#include <math_constants.h>

#include "attention_f32.cuh"

namespace {

using cxr::HeadStrides;
using cxr::cp_async_commit;
using cxr::cp_async_wait_one;
using cxr::load_tile;
using cxr::product_ab;
using cxr::product_abt;
using cxr::quad_max;
using cxr::quad_sum;
using cxr::store_rows;
using cxr::tile_bytes;
using cxr::to_a;

constexpr int kThreads = cxr::kMmaThreads;
constexpr int kBlock = cxr::kHeadBlock;  // query rows of a block, 16 a warp
constexpr int kKeyTile = 64;             // keys of a tile
constexpr int kMaxN = cxr::kMaxSeq;

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)5 * tile_bytes<D>(kBlock) + kMaxN * 4;  // Q, 2 x (K, V); key bias
}

constexpr int NT = kKeyTile / 8;  // n8 tiles of a key tile

// sweep 1's row statistics, at the start of sweep 2: l becomes 1 / l
__device__ __forceinline__ void finish_sweep1(float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = 1.f / quad_sum(l[r]);
    if (m[r] == -CUDART_INF_F) m[r] = 0.f;  // no finite score: exp(s - m) is 0, not NaN
  }
}

// A key tile's work once its scores are whole: s (the warp's 16 x 64 of
// Q K^T over keys j0..) scaled, biased and masked past N; then sweep 1
// moves the online m and l, and sweep 2 forms p = exp(s - m) (1 / l),
// drops it out and adds T(p) V into o, V the tile at vt.
template <typename T, int D>
__device__ __forceinline__ void key_tile(float (&s)[NT][4], bool sweep2, int j0, int N,
                                         float scale, const float* s_bias, float (&m)[2],
                                         float (&l)[2], bool drop, uint32_t salt,
                                         const int (&rows)[2], float rate, float inv_keep,
                                         float (&oa)[D / 8][4], uint32_t vt) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 8 * n + 2 * qd + (e & 1);
      s[n][e] = j < N ? fmaf(s[n][e], scale, s_bias[j]) : -CUDART_INF_F;
    }
  }
  if (!sweep2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = m[r];
#pragma unroll
      for (int n = 0; n < NT; ++n) mt = fmaxf(mt, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mt = quad_max(mt);
      const float mu = mt == -CUDART_INF_F ? 0.f : mt;
      l[r] *= expf(m[r] - mu);
#pragma unroll
      for (int n = 0; n < NT; ++n) l[r] += expf(s[n][2 * r] - mu) + expf(s[n][2 * r + 1] - mu);
      m[r] = mt;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = j0 + 8 * n + 2 * qd + (e & 1);
        float p = expf(s[n][e] - m[r]) * l[r];
        if (drop) p = cxr::uniform01(salt, rows[r], j) >= rate ? p * inv_keep : 0.f;
        s[n][e] = p;  // rounded to T by to_a
      }
    }
    uint32_t pa[NT / 2][4];
    to_a<T, NT / 2>(s, pa);
    product_ab<T, D, NT / 2>(oa, pa, vt);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint32_t* __restrict__ q, HeadStrides sq, const uint32_t* __restrict__ k,
                 HeadStrides sk, const uint32_t* __restrict__ v, HeadStrides sv,
                 const float* __restrict__ bias, const int* __restrict__ seeds,
                 uint32_t* __restrict__ out, HeadStrides so, int N, float scale, float rate,
                 float inv_keep) {
  constexpr int TILE = tile_bytes<D>(kBlock);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // Q, then stage st's K and V at s_kv + 2 st TILE
  const uint32_t s_q = sbase, s_kv = s_q + TILE;
  float* s_bias = reinterpret_cast<float*>(smem + 5 * TILE);

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  const int r0 = 16 * warp;
  const uint32_t* qb = q + b * sq.b + h * sq.h;
  const uint32_t* kb = k + b * sk.b + h * sk.h;
  const uint32_t* vb = v + b * sv.b + h * sv.h;

  const int nkt = (N + kKeyTile - 1) / kKeyTile;
  load_tile<D, kBlock>(s_q, qb, sq.n, row0, N);
  load_tile<D, kKeyTile>(s_kv, kb, sk.n, 0, N);  // tile 0 of sweep 1: no V
  cp_async_commit();
  for (int j = threadIdx.x; j < N; j += kThreads) s_bias[j] = bias[(size_t)b * N + j];

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  const bool active = row0 + r0 < N;  // the warp has a query row below N
  const int rows[2] = {row0 + r0 + g, row0 + r0 + g + 8};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float oa[D / 8][4];
  cxr::zero(oa);

  for (int t = 0; t < 2 * nkt; ++t) {  // sweep 1 over the key tiles, then sweep 2
    if (t + 1 < 2 * nkt) {
      const uint32_t next = s_kv + ((t + 1) & 1) * 2 * TILE;
      const int j0 = ((t + 1) % nkt) * kKeyTile;
      load_tile<D, kKeyTile>(next, kb, sk.n, j0, N);
      if (t + 1 >= nkt) load_tile<D, kKeyTile>(next + TILE, vb, sv.n, j0, N);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t kt = s_kv + (t & 1) * 2 * TILE, vt = kt + TILE;
    if (t == nkt) finish_sweep1(m, l);
    if (active) {
      float s[NT][4];
      product_abt<T, D, NT>(s, s_q, r0, kt);
      key_tile<T, D>(s, t >= nkt, (t % nkt) * kKeyTile, N, scale, s_bias, m, l, drop, salt, rows,
                  rate, inv_keep, oa, vt);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  if (active)
    store_rows<T, D>(oa, 1.f, smem, s_q - sbase, r0, out + b * so.b + h * so.h, so.n, row0 + r0,
                     N);
}

// ---- head dims over 128 ------------------------------------------------------

constexpr int kC = cxr::kSlice;  // columns of a chunk of the head dim, and of a slice of o

__host__ __device__ constexpr size_t sliced_smem_bytes() {
  return (size_t)6 * tile_bytes<kC>(kBlock) + kMaxN * 4;  // 2 x (Q, K chunks; V slice); bias
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_sliced_kernel(const uint32_t* __restrict__ q, HeadStrides sq,
                        const uint32_t* __restrict__ k, HeadStrides sk,
                        const uint32_t* __restrict__ v, HeadStrides sv,
                        const float* __restrict__ bias, const int* __restrict__ seeds,
                        uint32_t* __restrict__ out, HeadStrides so, int N, int nc, float scale,
                        float rate, float inv_keep) {
  constexpr int TILE = tile_bytes<kC>(kBlock);
  static_assert(kKeyTile == kBlock, "Q, K and V chunks are tiles of one size");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // stage st: Q chunk at sbase + 3 st TILE, the K chunk after it, then V's slice
  float* s_bias = reinterpret_cast<float*>(smem + 6 * TILE);

  const int b = blockIdx.z, h = blockIdx.y / nc, sl = blockIdx.y % nc;
  const int row0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  const int r0 = 16 * warp;
  const uint32_t* qb = q + b * sq.b + h * sq.h;
  const uint32_t* kb = k + b * sk.b + h * sk.h;
  const uint32_t* vb = v + b * sv.b + h * sv.h + sl * kC / 2;

  // step i: chunk i % nc of key tile (i / nc) % nkt, in sweep 1 (i / nc < nkt) or 2
  const int nkt = (N + kKeyTile - 1) / kKeyTile, steps = 2 * nkt * nc;
  auto load_step = [&](int i) {
    const uint32_t at = sbase + (i & 1) * 3 * TILE;
    const int t = i / nc, c = i % nc, j0 = (t % nkt) * kKeyTile;
    load_tile<kC, kBlock>(at, qb + c * kC / 2, sq.n, row0, N);
    load_tile<kC, kKeyTile>(at + TILE, kb + c * kC / 2, sk.n, j0, N);
    if (t >= nkt && c == nc - 1) load_tile<kC, kKeyTile>(at + 2 * TILE, vb, sv.n, j0, N);
  };
  load_step(0);
  cp_async_commit();
  for (int j = threadIdx.x; j < N; j += kThreads) s_bias[j] = bias[(size_t)b * N + j];

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  const bool active = row0 + r0 < N;
  const int rows[2] = {row0 + r0 + g, row0 + r0 + g + 8};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float oa[kC / 8][4], s[NT][4];
  cxr::zero(oa);

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t at = sbase + (i & 1) * 3 * TILE;
    const int t = i / nc, c = i % nc, j0 = (t % nkt) * kKeyTile;
    if (t == nkt && c == 0) finish_sweep1(m, l);
    if (active) {
      if (c == 0) cxr::zero(s);
      cxr::add_abt<T, kC>(s, at, r0, at + TILE);
      if (c == nc - 1)  // s of the tile is whole
        key_tile<T, kC>(s, t >= nkt, j0, N, scale, s_bias, m, l, drop, salt, rows, rate, inv_keep,
                     oa, at + 2 * TILE);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  // stage 0's Q chunk is free: the warps stage their rows of o there
  if (active)
    store_rows<T, kC>(oa, 1.f, smem, 0, r0, out + b * so.b + h * so.h + sl * kC / 2, so.n,
                   row0 + r0, N);
}

template <typename T>
cudaError_t launch_sliced(const uint32_t* q, HeadStrides sq, const uint32_t* k, HeadStrides sk,
                          const uint32_t* v, HeadStrides sv, const void* bias, const void* seeds,
                          uint32_t* out, HeadStrides so, int B, int N, int H, int D, float scale,
                          float rate, float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = sliced_smem_bytes();
  cudaError_t err = cxr::allow_smem(flash_fwd_sliced_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int nc = D / kC;
  const auto* bi = static_cast<const float*>(bias);
  const auto* sd = static_cast<const int*>(seeds);
  return cxr::for_batch_chunks(B, [&](int b0, int rows) {
    flash_fwd_sliced_kernel<T><<<cxr::head_grid(rows, N, H * nc), kThreads, smem, stream>>>(
        q + b0 * sq.b, sq, k + b0 * sk.b, sk, v + b0 * sv.b, sv, bi + (size_t)b0 * N, sd + b0,
        out + b0 * so.b, so, N, nc, scale, rate, inv_keep);
    return cudaGetLastError();
  });
}

template <typename T, int D>
cudaError_t launch(const uint32_t* q, HeadStrides sq, const uint32_t* k, HeadStrides sk,
                   const uint32_t* v, HeadStrides sv, const void* bias, const void* seeds,
                   uint32_t* out, HeadStrides so, int B, int N, int H, float scale, float rate,
                   float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cxr::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const auto* bi = static_cast<const float*>(bias);
  const auto* sd = static_cast<const int*>(seeds);
  return cxr::for_batch_chunks(B, [&](int b0, int rows) {
    flash_fwd_kernel<T, D><<<cxr::head_grid(rows, N, H), kThreads, smem, stream>>>(
        q + b0 * sq.b, sq, k + b0 * sk.b, sk, v + b0 * sv.b, sv, bi + (size_t)b0 * N, sd + b0,
        out + b0 * so.b, so, N, scale, rate, inv_keep);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t dispatch(int D, const uint32_t* q, HeadStrides sq, const uint32_t* k, HeadStrides sk,
                     const uint32_t* v, HeadStrides sv, const void* bias, const void* seeds,
                     uint32_t* out, HeadStrides so, int B, int N, int H, float scale, float rate,
                     float inv_keep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<T, 32>(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, scale, rate,
                        inv_keep, s);
    case 64:
      return launch<T, 64>(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, scale, rate,
                        inv_keep, s);
    case 128:
      return launch<T, 128>(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, scale, rate,
                         inv_keep, s);
    default:
      return launch_sliced<T>(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, D, scale, rate,
                           inv_keep, s);
  }
}

// ---- fp32: the CUDA-core body --------------------------------------------
//
// fp32 q, k and v (the parity mode, ``--fp32``) run on the CUDA cores in
// fp32 FMAs, as the plain version does: right, not fast (attention_f32.cuh).
// A block takes kF32Rows query rows of a (head, batch row):
//
//  1. scores: for each key chunk, the Q and K chunks of each column chunk are
//     staged in turn; each lane sums its two keys of the chunk for its warp's
//     rows over the head dim, in ascending column order, and writes
//     s = sum * scale + bias into the block's [rows, N] fp32 scores;
//  2. softmax: each warp turns its rows of scores into p = exp(s - m) / l
//     and drops them out (the counter hash at (query row, key), as the
//     tensor-core bodies do); no rounding, fp32 is the output type;
//  3. PV: for each column chunk of the output, V's chunks over the keys are
//     staged in turn and each lane sums p v for its two columns of its
//     warp's rows, then stores them.
//
// Shared memory: the Q chunk, one K or V chunk, the scores (kF32Rows * N fp32,
// 64 KB at N = 512) and the key bias: 91 KB at N = 512, any D. Every D is
// taken as it is (no padding), with no 16-byte alignment asked of the
// operands.

using cxr::kF32Cols;
using cxr::kF32Pad;
using cxr::kF32Rows;
using cxr::kF32RowsPerWarp;
using cxr::kF32Threads;
using cxr::kF32Tokens;

__host__ __device__ constexpr size_t fp32_smem_bytes(int N) {
  return ((size_t)kF32Rows * kF32Cols + (size_t)kF32Tokens * kF32Pad + (size_t)kF32Rows * N +
          N) * 4;
}

__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, HeadStrides sq, const float* __restrict__ k,
                     HeadStrides sk, const float* __restrict__ v, HeadStrides sv,
                     const float* __restrict__ bias, const int* __restrict__ seeds,
                     float* __restrict__ out, HeadStrides so, int N, int D, float scale,
                     float rate, float inv_keep) {
  extern __shared__ float fsm[];
  float* s_q = fsm;                                // [kF32Rows][kF32Cols]
  float* s_kv = s_q + kF32Rows * kF32Cols;         // [kF32Tokens][kF32Pad]
  float* s_p = s_kv + kF32Tokens * kF32Pad;        // [kF32Rows][N]
  float* s_bias = s_p + (size_t)kF32Rows * N;      // [N]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kF32Rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * kF32RowsPerWarp;  // the warp's first row of the block
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  for (int j = threadIdx.x; j < N; j += kF32Threads) s_bias[j] = bias[(size_t)b * N + j];

  // 1. scores
  for (int j0 = 0; j0 < N; j0 += kF32Tokens) {
    float acc[kF32RowsPerWarp][2] = {};
    for (int c0 = 0; c0 < D; c0 += kF32Cols) {
      __syncthreads();  // the previous chunks are read
      cxr::stage_f32<kF32Rows>(s_q, kF32Cols, qb, sq.n, row0, N, c0, D);
      cxr::stage_f32<kF32Tokens>(s_kv, kF32Pad, kb, sk.n, j0, N, c0, D);
      __syncthreads();
      cxr::f32_chunk_dots(acc, s_q, s_kv, r0, lane);
    }
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + lane + 32 * e;
        if (j < N) s_p[(r0 + i) * N + j] = fmaf(acc[i][e], scale, s_bias[j]);
      }
  }

  // 2. softmax and dropout, each warp over its own rows
  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  for (int i = 0; i < kF32RowsPerWarp; ++i) {
    const int t = row0 + r0 + i;
    if (t >= N) break;
    float* row = s_p + (r0 + i) * N;
    float m = -CUDART_INF_F;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    m = cxr::warp_max(m);
    if (m == -CUDART_INF_F) m = 0.f;  // no finite score: exp(s - m) is 0, not NaN
    float l = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
    l = cxr::warp_sum(l);
    for (int j = lane; j < N; j += 32) {
      float p = row[j] / l;
      if (drop) p = cxr::uniform01(salt, t, j) >= rate ? p * inv_keep : 0.f;
      row[j] = p;
    }
  }

  // 3. o = p V
  cxr::f32_weighted_rows(s_p, N, vb, sv.n, s_kv, out + b * so.b + h * so.h, so.n, row0, r0,
                         lane, D, 1.f);
}

cudaError_t launch_f32(const float* q, HeadStrides sq, const float* k, HeadStrides sk,
                       const float* v, HeadStrides sv, const void* bias, const void* seeds,
                       float* out, HeadStrides so, int B, int N, int H, int D, float scale,
                       float rate, float inv_keep, void* stream) {
  const size_t smem = fp32_smem_bytes(N);
  cudaError_t err = cxr::allow_smem(flash_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const auto* bi = static_cast<const float*>(bias);
  const auto* sd = static_cast<const int*>(seeds);
  return cxr::for_batch_chunks(B, [&](int b0, int rows) {
    const dim3 grid((N + kF32Rows - 1) / kF32Rows, H, rows);
    flash_fwd_f32_kernel<<<grid, kF32Threads, smem, static_cast<cudaStream_t>(stream)>>>(
        q + b0 * sq.b, sq, k + b0 * sk.b, sk, v + b0 * sv.b, sv, bi + (size_t)b0 * N, sd + b0,
        out + b0 * so.b, so, N, D, scale, rate, inv_keep);
    return cudaGetLastError();
  });
}

// B3 in one type: qkv [B, N, 3*H*D], out [B, N, H*D]; strides in 32-bit
// words, W of them a head (D / 2 in a 16-bit type, D in fp32)
template <typename T>
int fwd_packed(const void* qkv, const void* bias, const void* seeds, void* out, int B, int N,
               int H, int D, float scale, float rate, float inv_keep, void* stream) {
  const long long W = sizeof(T) == 4 ? D : D / 2, row = 3 * H * W;
  const cxr::HeadStrides sqkv{N * row, row, W}, so{N * H * W, H * W, W};
  if constexpr (sizeof(T) == 4) {
    if (cxr::bad_f32_attention_args(B, N, H, D, rate)) return cudaErrorInvalidValue;
    const auto* base = static_cast<const float*>(qkv);
    return launch_f32(base, sqkv, base + H * W, sqkv, base + 2 * H * W, sqkv, bias, seeds,
                      static_cast<float*>(out), so, B, N, H, D, scale, rate, inv_keep, stream);
  } else {
    if (cxr::bad_attention_args(B, N, H, D, rate)) return cudaErrorInvalidValue;
    const auto* base = static_cast<const uint32_t*>(qkv);
    return dispatch<T>(D, base, sqkv, base + H * W, sqkv, base + 2 * H * W, sqkv, bias, seeds,
                       static_cast<uint32_t*>(out), so, B, N, H, scale, rate, inv_keep, stream);
  }
}

// B5 in one type: ``strides`` in 32-bit words (q, k, v, out, each as batch,
// token, head)
template <typename T>
int fwd_split(const void* q, const void* k, const void* v, const void* bias, const void* seeds,
              void* out, const long long* strides, int B, int N, int H, int D, float scale,
              float rate, float inv_keep, void* stream) {
  const cxr::HeadStrides sq{strides[0], strides[1], strides[2]};
  const cxr::HeadStrides sk{strides[3], strides[4], strides[5]};
  const cxr::HeadStrides sv{strides[6], strides[7], strides[8]};
  const cxr::HeadStrides so{strides[9], strides[10], strides[11]};
  if constexpr (sizeof(T) == 4) {
    if (cxr::bad_f32_attention_args(B, N, H, D, rate)) return cudaErrorInvalidValue;
    return launch_f32(static_cast<const float*>(q), sq, static_cast<const float*>(k), sk,
                      static_cast<const float*>(v), sv, bias, seeds, static_cast<float*>(out),
                      so, B, N, H, D, scale, rate, inv_keep, stream);
  } else {
    if (cxr::bad_attention_args(B, N, H, D, rate)) return cudaErrorInvalidValue;
    return dispatch<T>(D, static_cast<const uint32_t*>(q), sq, static_cast<const uint32_t*>(k),
                       sk, static_cast<const uint32_t*>(v), sv, bias, seeds,
                       static_cast<uint32_t*>(out), so, B, N, H, scale, rate, inv_keep, stream);
  }
}

}  // namespace

// B3: qkv [B, N, 3*H*D], bias [B, N] fp32, seeds [B] int32, out [B, N, H*D]
// in qkv's type: bf16 (cxr_flash_fwd_packed), fp16 (_f16) or fp32 (_f32).
// In bf16 and fp16 D is 32, 64, 128 or a multiple of 64 over 128, H (times
// D / 64 over 128) <= 65535, and qkv and out 16-byte aligned; in fp32 any
// D >= 1 and H <= 65535. 1 <= N <= 512, any B; 0 <= rate < 1 and inv_keep =
// 1 / (1 - rate) (rate 0 turns dropout off).
CXR_API int cxr_flash_fwd_packed(const void* qkv, const void* bias, const void* seeds,
                                 void* out, int B, int N, int H, int D, float scale,
                                 float rate, float inv_keep, void* stream) {
  return fwd_packed<__nv_bfloat16>(qkv, bias, seeds, out, B, N, H, D, scale, rate, inv_keep,
                                   stream);
}

CXR_API int cxr_flash_fwd_packed_f16(const void* qkv, const void* bias, const void* seeds,
                                     void* out, int B, int N, int H, int D, float scale,
                                     float rate, float inv_keep, void* stream) {
  return fwd_packed<__half>(qkv, bias, seeds, out, B, N, H, D, scale, rate, inv_keep, stream);
}

CXR_API int cxr_flash_fwd_packed_f32(const void* qkv, const void* bias, const void* seeds,
                                     void* out, int B, int N, int H, int D, float scale,
                                     float rate, float inv_keep, void* stream) {
  return fwd_packed<float>(qkv, bias, seeds, out, B, N, H, D, scale, rate, inv_keep, stream);
}

// B5: q, k, v and out of one type with the head dim contiguous, each
// addressed by three strides in 32-bit words in ``strides`` (host memory, 12
// values: q, k, v, out, each as batch, token, head). In bf16 (cxr_flash_fwd)
// and fp16 (_f16) every stride a multiple of 4 words and every pointer
// 16-byte aligned (the 16-byte copies and stores); in fp32 (_f32) any.
// Other arguments as B3's.
CXR_API int cxr_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                          const void* seeds, void* out, const long long* strides, int B, int N,
                          int H, int D, float scale, float rate, float inv_keep, void* stream) {
  return fwd_split<__nv_bfloat16>(q, k, v, bias, seeds, out, strides, B, N, H, D, scale, rate,
                                  inv_keep, stream);
}

CXR_API int cxr_flash_fwd_f16(const void* q, const void* k, const void* v, const void* bias,
                              const void* seeds, void* out, const long long* strides, int B,
                              int N, int H, int D, float scale, float rate, float inv_keep,
                              void* stream) {
  return fwd_split<__half>(q, k, v, bias, seeds, out, strides, B, N, H, D, scale, rate,
                           inv_keep, stream);
}

CXR_API int cxr_flash_fwd_f32(const void* q, const void* k, const void* v, const void* bias,
                              const void* seeds, void* out, const long long* strides, int B,
                              int N, int H, int D, float scale, float rate, float inv_keep,
                              void* stream) {
  return fwd_split<float>(q, k, v, bias, seeds, out, strides, B, N, H, D, scale, rate,
                          inv_keep, stream);
}
