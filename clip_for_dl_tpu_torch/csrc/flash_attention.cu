// Attention forward: packed qkv (kernel B3) and split q/k/v (kernel B5), one
// kernel body on Hopper's tensor cores.
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

#include "mma_tiles.cuh"

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
// drops it out and adds bf16(p) V into o, V the tile at vt.
template <int D>
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
        s[n][e] = p;  // rounded to bf16 by to_a
      }
    }
    uint32_t pa[NT / 2][4];
    to_a<NT / 2>(s, pa);
    product_ab<D, NT / 2>(oa, pa, vt);
  }
}

template <int D>
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
      product_abt<D, NT>(s, s_q, r0, kt);
      key_tile<D>(s, t >= nkt, (t % nkt) * kKeyTile, N, scale, s_bias, m, l, drop, salt, rows,
                  rate, inv_keep, oa, vt);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  if (active)
    store_rows<D>(oa, 1.f, smem, s_q - sbase, r0, out + b * so.b + h * so.h, so.n, row0 + r0, N);
}

// ---- head dims over 128 ------------------------------------------------------

constexpr int kC = cxr::kSlice;  // columns of a chunk of the head dim, and of a slice of o

__host__ __device__ constexpr size_t sliced_smem_bytes() {
  return (size_t)6 * tile_bytes<kC>(kBlock) + kMaxN * 4;  // 2 x (Q, K chunks; V slice); bias
}

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
      cxr::add_abt<kC>(s, at, r0, at + TILE);
      if (c == nc - 1)  // s of the tile is whole
        key_tile<kC>(s, t >= nkt, j0, N, scale, s_bias, m, l, drop, salt, rows, rate, inv_keep,
                     oa, at + 2 * TILE);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  // stage 0's Q chunk is free: the warps stage their rows of o there
  if (active)
    store_rows<kC>(oa, 1.f, smem, 0, r0, out + b * so.b + h * so.h + sl * kC / 2, so.n,
                   row0 + r0, N);
}

cudaError_t launch_sliced(const uint32_t* q, HeadStrides sq, const uint32_t* k, HeadStrides sk,
                          const uint32_t* v, HeadStrides sv, const void* bias, const void* seeds,
                          uint32_t* out, HeadStrides so, int B, int N, int H, int D, float scale,
                          float rate, float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = sliced_smem_bytes();
  cudaError_t err = cxr::allow_smem(flash_fwd_sliced_kernel, smem);
  if (err != cudaSuccess) return err;
  const int nc = D / kC;
  const auto* bi = static_cast<const float*>(bias);
  const auto* sd = static_cast<const int*>(seeds);
  return cxr::for_batch_chunks(B, [&](int b0, int rows) {
    flash_fwd_sliced_kernel<<<cxr::head_grid(rows, N, H * nc), kThreads, smem, stream>>>(
        q + b0 * sq.b, sq, k + b0 * sk.b, sk, v + b0 * sv.b, sv, bi + (size_t)b0 * N, sd + b0,
        out + b0 * so.b, so, N, nc, scale, rate, inv_keep);
    return cudaGetLastError();
  });
}

template <int D>
cudaError_t launch(const uint32_t* q, HeadStrides sq, const uint32_t* k, HeadStrides sk,
                   const uint32_t* v, HeadStrides sv, const void* bias, const void* seeds,
                   uint32_t* out, HeadStrides so, int B, int N, int H, float scale, float rate,
                   float inv_keep, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cxr::allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const auto* bi = static_cast<const float*>(bias);
  const auto* sd = static_cast<const int*>(seeds);
  return cxr::for_batch_chunks(B, [&](int b0, int rows) {
    flash_fwd_kernel<D><<<cxr::head_grid(rows, N, H), kThreads, smem, stream>>>(
        q + b0 * sq.b, sq, k + b0 * sk.b, sk, v + b0 * sv.b, sv, bi + (size_t)b0 * N, sd + b0,
        out + b0 * so.b, so, N, scale, rate, inv_keep);
    return cudaGetLastError();
  });
}

cudaError_t dispatch(int D, const uint32_t* q, HeadStrides sq, const uint32_t* k, HeadStrides sk,
                     const uint32_t* v, HeadStrides sv, const void* bias, const void* seeds,
                     uint32_t* out, HeadStrides so, int B, int N, int H, float scale, float rate,
                     float inv_keep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, scale, rate,
                        inv_keep, s);
    case 64:
      return launch<64>(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, scale, rate,
                        inv_keep, s);
    case 128:
      return launch<128>(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, scale, rate,
                         inv_keep, s);
    default:
      return launch_sliced(q, sq, k, sk, v, sv, bias, seeds, out, so, B, N, H, D, scale, rate,
                           inv_keep, s);
  }
}

}  // namespace

// B3: qkv [B, N, 3*H*D] bf16, bias [B, N] fp32, seeds [B] int32, out
// [B, N, H*D] bf16; D in {32, 64, 128} or a multiple of 64 over 128,
// 1 <= N <= 512, H (times D / 64 over 128) <= 65535, any B;
// 0 <= rate < 1 and
// inv_keep = 1 / (1 - rate) (rate 0 turns dropout off); qkv and out 16-byte
// aligned.
CXR_API int cxr_flash_fwd_packed(const void* qkv, const void* bias, const void* seeds,
                                 void* out, int B, int N, int H, int D, float scale,
                                 float rate, float inv_keep, void* stream) {
  if (cxr::bad_attention_args(B, N, H, D, rate)) return cudaErrorInvalidValue;
  const long long W = D / 2, row = 3 * H * W;
  const cxr::HeadStrides sqkv{N * row, row, W}, so{N * H * W, H * W, W};
  const auto* base = static_cast<const uint32_t*>(qkv);
  return dispatch(D, base, sqkv, base + H * W, sqkv, base + 2 * H * W, sqkv, bias, seeds,
                  static_cast<uint32_t*>(out), so, B, N, H, scale, rate, inv_keep, stream);
}

// B5: q, k, v and out bf16 with the head dim contiguous, each addressed by
// three strides in 32-bit words in ``strides`` (host memory, 12 values: q,
// k, v, out, each as batch, token, head); every stride a multiple of 4 words
// and every pointer 16-byte aligned (the 16-byte copies and stores). Other
// arguments as B3's.
CXR_API int cxr_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                          const void* seeds, void* out, const long long* strides, int B, int N,
                          int H, int D, float scale, float rate, float inv_keep, void* stream) {
  if (cxr::bad_attention_args(B, N, H, D, rate)) return cudaErrorInvalidValue;
  const cxr::HeadStrides sq{strides[0], strides[1], strides[2]};
  const cxr::HeadStrides sk{strides[3], strides[4], strides[5]};
  const cxr::HeadStrides sv{strides[6], strides[7], strides[8]};
  const cxr::HeadStrides so{strides[9], strides[10], strides[11]};
  return dispatch(D, static_cast<const uint32_t*>(q), sq, static_cast<const uint32_t*>(k), sk,
                  static_cast<const uint32_t*>(v), sv, bias, seeds, static_cast<uint32_t*>(out),
                  so, B, N, H, scale, rate, inv_keep, stream);
}
