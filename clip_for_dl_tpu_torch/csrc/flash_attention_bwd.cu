// Attention backward: packed qkv (kernel B6) and split q/k/v (kernel B7), one
// kernel body on Hopper's tensor cores for bf16 and fp16 operands (the
// 16-bit type T a template parameter: mma.sync's .bf16 or .f16 form and the
// roundings to T; bf16 below), and one on the CUDA cores for fp32 (at the
// end of this file).
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
// each head's dq, dk and dv rounded to bf16 once and written through a base
// pointer and HeadStrides (common.cuh) per operand, as the forward reads q, k
// and v: into the packed dqkv [B, N, 3*H*D] (q | k | v heads) for B6, into
// three tensors in the inputs' layout ([B, N, H, D] or [B, H, N, D]) for B7.
// Every layout runs the same instructions in the same order, so B7 on split
// views of a packed qkv gives B6's bits. delta is taken from the fp32 p and
// dp as the TPU kernel does, not FlashAttention-2's rowsum(dO * O), which
// differs from it by O's and pd's bf16 rounding.
//
// What bounds it on the card: at the train shape (B = 128, N = 200, H = 12,
// D = 64) the five products are ~39 GFLOP over 275 MB in and out: 0.082 ms
// by the bytes at 3.35 TB/s, 0.040 ms by the operations at 989 TFLOP/s. With
// the row statistics recomputed (sweep 1 below) the kernel does seven
// products, and the dropout hash costs ~20 integer operations an element,
// twice (once a pass). So it has to run every product on the tensor cores and
// keep every [N, N] intermediate in registers.
//
// Tiling (FlashAttention-2's split into two kernels, no atomics):
//
//   1. rows: one block per (64 query rows, head, batch row), 4 warps of 16
//      rows. Q and dO are loaded once; K and V stream in 64-key tiles through
//      a 2-stage ring of 16-byte cp.async copies, twice. Sweep 1 forms
//      S = Q K^T and dP = dO V^T with mma.sync m16n8k16 (bf16 in, fp32
//      accumulators), masks keys >= N, applies the dropout mask to dP (and
//      leaves each thread's 32 keep bits of the tile in a word of shared
//      memory for sweep 2) and keeps the online row max m, sum l and
//      sum exp(s - m) * dp, rescaled whenever m moves; then
//      delta = that / l. Sweep 2 forms S and dP again
//      (the same instructions, so the same bits), p = exp(s - m) / l and
//      ds = bf16(p (dp - delta)); the ds accumulators, packed to bf16, are
//      the A operand of dq += ds K in registers. It writes bf16(dq * scale)
//      and (m, 1 / l, delta) to the [3, B, H, N] fp32 scratch.
//   2. columns: one block per (64 keys, head, batch row), 4 warps of 16 keys.
//      K and V are loaded once; Q, dO and the row statistics stream in tiles
//      of QT query rows (64 at D = 32 and 64, 32 at D = 128) through the same
//      ring.
//      It forms S^T = K Q^T and dP^T = V dO^T, so that the accumulators sit
//      in the A-operand layout of dv += bf16(pd^T) dO and dk += bf16(ds^T) Q.
//      It writes bf16(dk * scale) and bf16(dv).
//
// The two passes sum s and dp in another order (S vs S^T), so their p and dp
// may differ in the last bits; each gradient comes from one pass, and the
// difference is far inside the two-bf16-step tolerance of the checks. Every
// sum over keys or query rows is a loop inside one block: two calls on the
// same inputs give the same bits.
//
// Head dims 32, 64 and 128 are built (other widths are zero-padded by the
// wrapper). Shared memory is independent of N: rows 24, 48 and 96 KB of
// tiles at D = 32, 64 and 128, plus the key bias (2 KB) and keep bits
// (4 KB); columns 24.8, 49.5 and 64.8 KB. The tiles, the PTX and the
// products are mma_tiles.cuh's, shared with the forward (B3/B5). A batch
// over 65535 rows (gridDim.z's bound) is launched in chunks; the stats
// planes are placed by the whole batch B. Tokens >= N of a tile are
// zero-filled by the copy
// itself (source size 0), never read: in a "bnhd" view they belong to the
// next batch row, and after the last one they lie past the allocation; a
// stale row would give 0 * NaN = NaN in the products. The registers of a
// thread stay within 255 at D = 128 because the columns pass takes 32 query
// rows a tile there (dk and dv are 128 fp32 accumulators a thread).
//
// Head dims over 128 (any multiple of 64; the wrapper zero-pads others) run
// the same two passes in slices (flash_bwd_rows_sliced_kernel,
// flash_bwd_cols_sliced_kernel), as the forward does: each block writes one
// 64-column slice of its gradients (dq; dk and dv), the slice index folded
// into gridDim.y beside the head, and S and dP are summed over 64-column
// chunks of the head dim streamed through the ring, the slice's K (rows
// pass) or Q and dO (columns pass) riding with a tile's last chunk. Shared
// memory (86 and 98 KB) and registers are the same at every such D. Every
// slice recomputes s, p and dp (D / 64 times the work of those products;
// no preset reaches D > 128). The slices of a head run the same
// instructions on the same data, so their statistics agree bit for bit;
// slice 0 alone writes them, and the columns pass reads a buffer with one
// writer.
#include <math_constants.h>

#include "attention_f32.cuh"

namespace {

using cxr::HeadStrides;
using cxr::cp_async4;
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
// query rows (rows pass) or keys (columns pass) of a block, 16 a warp
constexpr int kBlock = cxr::kHeadBlock;
constexpr int kKeyTile = 64;  // keys of a rows-pass tile
constexpr int kMaxN = cxr::kMaxSeq;

// query rows of a columns-pass tile
template <int D>
__host__ __device__ constexpr int query_tile() { return D == 128 ? 32 : 64; }

// a rows-pass thread's keep bits of one key tile: its 32 scores, one word
constexpr int kKeepBytes = kMaxN / kKeyTile * kThreads * 4;

template <int D>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  // Q, dO, 2 x (K, V); key bias; keep bits
  return (size_t)6 * tile_bytes<D>(kBlock) + kMaxN * 4 + kKeepBytes;
}

template <int D>
__host__ __device__ constexpr int cols_stage_bytes() {
  return 2 * tile_bytes<D>(query_tile<D>()) + 3 * query_tile<D>() * 4;  // Q, dO; m, 1/l, delta
}

template <int D>
__host__ __device__ constexpr size_t cols_smem_bytes() {
  return (size_t)2 * tile_bytes<D>(kBlock) + 2 * cols_stage_bytes<D>();  // K, V; 2 stages
}

// ---- the tile bodies, shared by the kernels of every head dim -------------

constexpr int NT = kKeyTile / 8;  // n8 tiles of a rows-pass key tile

// sweep 1's row statistics, at the start of sweep 2: delta = sum / l, then
// l becomes 1 / l
__device__ __forceinline__ void finish_sweep1(float (&m)[2], float (&l)[2], const float (&pdp)[2],
                                              float (&delta)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    delta[r] = quad_sum(pdp[r]) / lr;
    l[r] = 1.f / lr;
    if (m[r] == -CUDART_INF_F) m[r] = 0.f;  // no finite score: exp(s - m) is 0, not NaN
  }
}

// A rows-pass key tile's work once s and dp (the warp's 16 x 64 of Q K^T
// and dO V^T over keys j0..) are whole: the dropout mask of the thread's 32
// scores (hashed in sweep 1 and kept in ``keep_word`` for sweep 2) applied
// to dp, s scaled, biased and masked past N; then sweep 1 moves the online
// m, l and sum exp(s - m) dp, and sweep 2 forms ds = p (dp - delta) and adds
// T(ds) K into dq, K the tile at kt.
template <typename T, int D>
__device__ __forceinline__ void rows_key_tile(float (&s)[NT][4], float (&dp)[NT][4], bool sweep2,
                                              int j0, int N, float scale, const float* s_bias,
                                              uint32_t* keep_word, float (&m)[2], float (&l)[2],
                                              float (&pdp)[2], const float (&delta)[2],
                                              bool drop, uint32_t salt, const int (&rows)[2],
                                              float rate, float inv_keep,
                                              float (&dqa)[D / 8][4], uint32_t kt) {
  static_assert(NT * 4 == 32, "a thread's scores of a key tile fill one word of keep bits");
  const int qd = threadIdx.x & 3;
  uint32_t keep = 0;
  if (drop) {
    if (!sweep2) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 8 * n + 2 * qd + (e & 1);
          keep |= uint32_t(cxr::uniform01(salt, rows[e >> 1], j) >= rate) << (4 * n + e);
        }
      *keep_word = keep;
    } else {
      keep = *keep_word;
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 8 * n + 2 * qd + (e & 1);
      s[n][e] = j < N ? fmaf(s[n][e], scale, s_bias[j]) : -CUDART_INF_F;
      if (drop) dp[n][e] = (keep >> (4 * n + e)) & 1u ? dp[n][e] * inv_keep : 0.f;
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
      const float corr = expf(m[r] - mu);
      l[r] *= corr;
      pdp[r] *= corr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float x = expf(s[n][e] - mu);
          l[r] += x;
          pdp[r] = fmaf(x, dp[n][e], pdp[r]);
        }
      }
      m[r] = mt;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(s[n][e] - m[r]) * l[r];
        s[n][e] = p * (dp[n][e] - delta[r]);  // ds, rounded to T by to_a
      }
    }
    uint32_t ds[NT / 2][4];
    to_a<T, NT / 2>(s, ds);
    product_ab<T, D, NT / 2>(dqa, ds, kt);
  }
}

// A columns-pass query tile's work once s and dp (the warp's 16 x 8 QN of
// K Q^T and V dO^T over query rows i0..) are whole: p from the rows pass's
// m, 1/l and delta of those rows (sm, sl, sd), zero on rows past N, the
// dropout mask hashed at (row, key); then dv += T(pd)^T dO and
// dk += T(ds)^T Q, Q and dO the tiles at qt and ot.
template <typename T, int D, int QN>
__device__ __forceinline__ void cols_query_tile(float (&s)[QN][4], float (&dp)[QN][4], int i0,
                                                int N, float scale, const float (&kbias)[2],
                                                const float* sm, const float* sl,
                                                const float* sd, bool drop, uint32_t salt,
                                                const int (&keys)[2], float rate,
                                                float inv_keep, float (&dka)[D / 8][4],
                                                float (&dva)[D / 8][4], uint32_t qt,
                                                uint32_t ot) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < QN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + 2 * qd + (e & 1), i = i0 + c;
      const float x = expf(fmaf(s[n][e], scale, kbias[e >> 1]) - sm[c]) * sl[c];
      const float p = i < N ? x : 0.f;
      float d = dp[n][e], pd = p;
      if (drop) {
        const bool keep = cxr::uniform01(salt, i, keys[e >> 1]) >= rate;
        pd = keep ? p * inv_keep : 0.f;
        d = keep ? d * inv_keep : 0.f;
      }
      s[n][e] = pd;
      dp[n][e] = p * (d - sd[c]);  // ds
    }
  }
  uint32_t a[QN / 2][4];
  to_a<T, QN / 2>(s, a);
  product_ab<T, D, QN / 2>(dva, a, ot);
  to_a<T, QN / 2>(dp, a);
  product_ab<T, D, QN / 2>(dka, a, qt);
}

// ---- pass 1: dq and the row statistics ------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_kernel(const uint32_t* __restrict__ q, HeadStrides sq,
                      const uint32_t* __restrict__ k, HeadStrides sk,
                      const uint32_t* __restrict__ v, HeadStrides sv,
                      const uint32_t* __restrict__ dout, HeadStrides sdo,
                      const float* __restrict__ bias, const int* __restrict__ seeds,
                      uint32_t* __restrict__ dq, HeadStrides sdq, float* __restrict__ stats,
                      int B, int N, int H, float scale, float rate, float inv_keep) {
  constexpr int TILE = tile_bytes<D>(kBlock);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // Q, dO, then stage st's K and V at s_kv + 2 st TILE
  const uint32_t s_q = sbase, s_do = s_q + TILE, s_kv = s_do + TILE;
  float* s_bias = reinterpret_cast<float*>(smem + 6 * TILE);
  uint32_t* s_keep = reinterpret_cast<uint32_t*>(s_bias + kMaxN);  // [key tile][thread]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int r0 = 16 * warp;
  const uint32_t* qb = q + b * sq.b + h * sq.h;
  const uint32_t* kb = k + b * sk.b + h * sk.h;
  const uint32_t* vb = v + b * sv.b + h * sv.h;
  const uint32_t* ob = dout + b * sdo.b + h * sdo.h;
  const size_t plane = (size_t)B * H * N;
  float* st = stats + ((size_t)b * H + h) * N;  // max at st, 1/sum at +plane, delta at +2 plane

  load_tile<D, kBlock>(s_q, qb, sq.n, row0, N);
  load_tile<D, kBlock>(s_do, ob, sdo.n, row0, N);
  load_tile<D, kKeyTile>(s_kv, kb, sk.n, 0, N);
  load_tile<D, kKeyTile>(s_kv + TILE, vb, sv.n, 0, N);
  cp_async_commit();
  for (int j = threadIdx.x; j < N; j += kThreads) s_bias[j] = bias[(size_t)b * N + j];

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  const bool active = row0 + r0 < N;  // the warp has a query row below N
  const int rows[2] = {row0 + r0 + g, row0 + r0 + g + 8};
  const int nkt = (N + kKeyTile - 1) / kKeyTile;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
  float delta[2] = {0.f, 0.f};
  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int t = 0; t < 2 * nkt; ++t) {  // sweep 1 over the key tiles, then sweep 2
    if (t + 1 < 2 * nkt) {
      const uint32_t next = s_kv + ((t + 1) & 1) * 2 * TILE;
      const int j0 = ((t + 1) % nkt) * kKeyTile;
      load_tile<D, kKeyTile>(next, kb, sk.n, j0, N);
      load_tile<D, kKeyTile>(next + TILE, vb, sv.n, j0, N);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t kt = s_kv + (t & 1) * 2 * TILE, vt = kt + TILE;
    const int j0 = (t % nkt) * kKeyTile;
    if (t == nkt) finish_sweep1(m, l, pdp, delta);
    if (active) {
      float s[NT][4], dp[NT][4];
      product_abt<T, D, NT>(s, s_q, r0, kt);
      product_abt<T, D, NT>(dp, s_do, r0, vt);
      rows_key_tile<T, D>(s, dp, t >= nkt, j0, N, scale, s_bias,
                       s_keep + (t % nkt) * kThreads + threadIdx.x, m, l, pdp, delta, drop, salt,
                       rows, rate, inv_keep, dqa, kt);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  if (active) {
    uint32_t* gq = dq + b * sdq.b + h * sdq.h;
    store_rows<T, D>(dqa, scale, smem, s_q - sbase, r0, gq, sdq.n, row0 + r0, N);
    if (qd == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < N) {
          st[rows[r]] = m[r];
          st[plane + rows[r]] = l[r];
          st[2 * plane + rows[r]] = delta[r];
        }
      }
    }
  }
}

// ---- pass 2: dk and dv ----------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_cols_kernel(const uint32_t* __restrict__ q, HeadStrides sq,
                      const uint32_t* __restrict__ k, HeadStrides sk,
                      const uint32_t* __restrict__ v, HeadStrides sv,
                      const uint32_t* __restrict__ dout, HeadStrides sdo,
                      const float* __restrict__ bias, const int* __restrict__ seeds,
                      uint32_t* __restrict__ dk, HeadStrides sdk, uint32_t* __restrict__ dv,
                      HeadStrides sdv, const float* __restrict__ stats, int B, int N, int H,
                      float scale, float rate, float inv_keep) {
  constexpr int QT = query_tile<D>();
  constexpr int NT = QT / 8;  // n8 tiles of a query tile
  constexpr int KV = tile_bytes<D>(kBlock), QTILE = tile_bytes<D>(QT);
  constexpr int STAGE = cols_stage_bytes<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_k = sbase, s_v = s_k + KV, s_stage = s_v + KV;
  // stage st: Q at s_stage + st STAGE, dO after it, then m, 1/l and delta of QT rows

  const int b = blockIdx.z, h = blockIdx.y, col0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  const int r0 = 16 * warp;
  const uint32_t* qb = q + b * sq.b + h * sq.h;
  const uint32_t* kb = k + b * sk.b + h * sk.h;
  const uint32_t* vb = v + b * sv.b + h * sv.h;
  const uint32_t* ob = dout + b * sdo.b + h * sdo.h;
  const size_t plane = (size_t)B * H * N;
  const float* st = stats + ((size_t)b * H + h) * N;

  auto load_stage = [&](int stage, int i0) {
    const uint32_t at = s_stage + stage * STAGE;
    load_tile<D, QT>(at, qb, sq.n, i0, N);
    load_tile<D, QT>(at + QTILE, ob, sdo.n, i0, N);
    for (int x = threadIdx.x; x < 3 * QT; x += kThreads) {
      const int c = x / QT, i = i0 + x % QT;
      cp_async4(at + 2 * QTILE + 4 * x, i < N ? st + c * plane + i : st, i < N);
    }
  };
  load_tile<D, kBlock>(s_k, kb, sk.n, col0, N);
  load_tile<D, kBlock>(s_v, vb, sv.n, col0, N);
  load_stage(0, 0);
  cp_async_commit();

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  const bool active = col0 + r0 < N;  // the warp has a key below N
  const int keys[2] = {col0 + r0 + g, col0 + r0 + g + 8};
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kbias[r] = keys[r] < N ? bias[(size_t)b * N + keys[r]] : -CUDART_INF_F;
  const int nqt = (N + QT - 1) / QT;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int t = 0; t < nqt; ++t) {
    if (t + 1 < nqt) load_stage((t + 1) & 1, (t + 1) * QT);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t qt = s_stage + (t & 1) * STAGE, ot = qt + QTILE;
    const float* sm = reinterpret_cast<const float*>(smem + (qt - sbase) + 2 * QTILE);
    const float* sl = sm + QT;
    const float* sd = sl + QT;
    const int i0 = t * QT;
    if (active) {
      float s[NT][4], dp[NT][4];
      product_abt<T, D, NT>(s, s_k, r0, qt);   // S^T: rows the warp's keys, columns query rows
      product_abt<T, D, NT>(dp, s_v, r0, ot);  // dP^T
      cols_query_tile<T, D>(s, dp, i0, N, scale, kbias, sm, sl, sd, drop, salt, keys, rate,
                         inv_keep, dka, dva, qt, ot);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  if (active) {
    store_rows<T, D>(dka, scale, smem, s_k - sbase, r0, dk + b * sdk.b + h * sdk.h, sdk.n,
                     col0 + r0, N);
    store_rows<T, D>(dva, 1.f, smem, s_v - sbase, r0, dv + b * sdv.b + h * sdv.h, sdv.n,
                     col0 + r0, N);
  }
}

// ---- head dims over 128 ------------------------------------------------------

constexpr int kC = cxr::kSlice;  // columns of a chunk of the head dim, and of a slice
constexpr int kSlicedQT = 64;   // query rows of a sliced columns-pass tile
constexpr int kTile = tile_bytes<kC>(kBlock);
static_assert(kKeyTile == kBlock && kSlicedQT == kBlock, "every chunk is a tile of one size");

// 2 stages x (Q, dO, K, V chunks; K's slice); key bias; keep bits
constexpr size_t kRowsSlicedSmem = (size_t)10 * kTile + kMaxN * 4 + kKeepBytes;
// a stage: K, V, Q, dO chunks; Q's and dO's slices; m, 1/l, delta
constexpr int kColsSlicedStage = 6 * kTile + 3 * kSlicedQT * 4;
constexpr size_t kColsSlicedSmem = (size_t)2 * kColsSlicedStage;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_sliced_kernel(const uint32_t* __restrict__ q, HeadStrides sq,
                             const uint32_t* __restrict__ k, HeadStrides sk,
                             const uint32_t* __restrict__ v, HeadStrides sv,
                             const uint32_t* __restrict__ dout, HeadStrides sdo,
                             const float* __restrict__ bias, const int* __restrict__ seeds,
                             uint32_t* __restrict__ dq, HeadStrides sdq,
                             float* __restrict__ stats, int B, int N, int H, int nc, float scale,
                             float rate, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // stage st at sbase + 5 st kTile: Q, dO, K and V chunks, then K's slice
  float* s_bias = reinterpret_cast<float*>(smem + 10 * kTile);
  uint32_t* s_keep = reinterpret_cast<uint32_t*>(s_bias + kMaxN);

  const int b = blockIdx.z, h = blockIdx.y / nc, sl = blockIdx.y % nc;
  const int row0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, qd = lane & 3;
  const int r0 = 16 * warp;
  const uint32_t* qb = q + b * sq.b + h * sq.h;
  const uint32_t* kb = k + b * sk.b + h * sk.h;
  const uint32_t* vb = v + b * sv.b + h * sv.h;
  const uint32_t* ob = dout + b * sdo.b + h * sdo.h;
  const size_t plane = (size_t)B * H * N;
  float* st = stats + ((size_t)b * H + h) * N;

  // step i: chunk i % nc of key tile (i / nc) % nkt, in sweep 1 (i / nc < nkt) or 2
  const int nkt = (N + kKeyTile - 1) / kKeyTile, steps = 2 * nkt * nc;
  auto load_step = [&](int i) {
    const uint32_t at = sbase + (i & 1) * 5 * kTile;
    const int t = i / nc, c = i % nc, j0 = (t % nkt) * kKeyTile;
    load_tile<kC, kBlock>(at, qb + c * kC / 2, sq.n, row0, N);
    load_tile<kC, kBlock>(at + kTile, ob + c * kC / 2, sdo.n, row0, N);
    load_tile<kC, kKeyTile>(at + 2 * kTile, kb + c * kC / 2, sk.n, j0, N);
    load_tile<kC, kKeyTile>(at + 3 * kTile, vb + c * kC / 2, sv.n, j0, N);
    if (t >= nkt && c == nc - 1)
      load_tile<kC, kKeyTile>(at + 4 * kTile, kb + sl * kC / 2, sk.n, j0, N);
  };
  load_step(0);
  cp_async_commit();
  for (int j = threadIdx.x; j < N; j += kThreads) s_bias[j] = bias[(size_t)b * N + j];

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  const bool active = row0 + r0 < N;
  const int rows[2] = {row0 + r0 + g, row0 + r0 + g + 8};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
  float delta[2] = {0.f, 0.f};
  float dqa[kC / 8][4], s[NT][4], dp[NT][4];
  cxr::zero(dqa);

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t at = sbase + (i & 1) * 5 * kTile;
    const int t = i / nc, c = i % nc, j0 = (t % nkt) * kKeyTile;
    if (t == nkt && c == 0) finish_sweep1(m, l, pdp, delta);
    if (active) {
      if (c == 0) {
        cxr::zero(s);
        cxr::zero(dp);
      }
      cxr::add_abt<T, kC>(s, at, r0, at + 2 * kTile);
      cxr::add_abt<T, kC>(dp, at + kTile, r0, at + 3 * kTile);
      if (c == nc - 1)  // s and dp of the tile are whole
        rows_key_tile<T, kC>(s, dp, t >= nkt, j0, N, scale, s_bias,
                          s_keep + (t % nkt) * kThreads + threadIdx.x, m, l, pdp, delta, drop,
                          salt, rows, rate, inv_keep, dqa, at + 4 * kTile);
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  if (active) {  // stage 0's Q chunk is free: the warps stage their rows of dq there
    store_rows<T, kC>(dqa, scale, smem, 0, r0, dq + b * sdq.b + h * sdq.h + sl * kC / 2, sdq.n,
                   row0 + r0, N);
    if (sl == 0 && qd == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < N) {
          st[rows[r]] = m[r];
          st[plane + rows[r]] = l[r];
          st[2 * plane + rows[r]] = delta[r];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_cols_sliced_kernel(const uint32_t* __restrict__ q, HeadStrides sq,
                             const uint32_t* __restrict__ k, HeadStrides sk,
                             const uint32_t* __restrict__ v, HeadStrides sv,
                             const uint32_t* __restrict__ dout, HeadStrides sdo,
                             const float* __restrict__ bias, const int* __restrict__ seeds,
                             uint32_t* __restrict__ dk, HeadStrides sdk,
                             uint32_t* __restrict__ dv, HeadStrides sdv,
                             const float* __restrict__ stats, int B, int N, int H, int nc,
                             float scale, float rate, float inv_keep) {
  constexpr int QT = kSlicedQT;
  constexpr int NT = QT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // stage st at sbase + st kColsSlicedStage: K, V, Q and dO chunks, Q's and
  // dO's slices, then m, 1/l and delta of the QT query rows

  const int b = blockIdx.z, h = blockIdx.y / nc, sl = blockIdx.y % nc;
  const int col0 = blockIdx.x * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  const int r0 = 16 * warp;
  const uint32_t* qb = q + b * sq.b + h * sq.h;
  const uint32_t* kb = k + b * sk.b + h * sk.h;
  const uint32_t* vb = v + b * sv.b + h * sv.h;
  const uint32_t* ob = dout + b * sdo.b + h * sdo.h;
  const size_t plane = (size_t)B * H * N;
  const float* st = stats + ((size_t)b * H + h) * N;

  // step i: chunk i % nc of query tile i / nc
  const int nqt = (N + QT - 1) / QT, steps = nqt * nc;
  auto load_step = [&](int i) {
    const uint32_t at = sbase + (i & 1) * kColsSlicedStage;
    const int c = i % nc, i0 = (i / nc) * QT;
    load_tile<kC, kBlock>(at, kb + c * kC / 2, sk.n, col0, N);
    load_tile<kC, kBlock>(at + kTile, vb + c * kC / 2, sv.n, col0, N);
    load_tile<kC, QT>(at + 2 * kTile, qb + c * kC / 2, sq.n, i0, N);
    load_tile<kC, QT>(at + 3 * kTile, ob + c * kC / 2, sdo.n, i0, N);
    if (c == nc - 1) {
      load_tile<kC, QT>(at + 4 * kTile, qb + sl * kC / 2, sq.n, i0, N);
      load_tile<kC, QT>(at + 5 * kTile, ob + sl * kC / 2, sdo.n, i0, N);
      for (int x = threadIdx.x; x < 3 * QT; x += kThreads) {
        const int which = x / QT, r = i0 + x % QT;
        cp_async4(at + 6 * kTile + 4 * x, r < N ? st + which * plane + r : st, r < N);
      }
    }
  };
  load_step(0);
  cp_async_commit();

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  const bool active = col0 + r0 < N;
  const int keys[2] = {col0 + r0 + g, col0 + r0 + g + 8};
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kbias[r] = keys[r] < N ? bias[(size_t)b * N + keys[r]] : -CUDART_INF_F;
  float dka[kC / 8][4], dva[kC / 8][4], s[NT][4], dp[NT][4];
  cxr::zero(dka);
  cxr::zero(dva);

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t at = sbase + (i & 1) * kColsSlicedStage;
    const int c = i % nc, i0 = (i / nc) * QT;
    if (active) {
      if (c == 0) {
        cxr::zero(s);
        cxr::zero(dp);
      }
      cxr::add_abt<T, kC>(s, at, r0, at + 2 * kTile);           // S^T
      cxr::add_abt<T, kC>(dp, at + kTile, r0, at + 3 * kTile);  // dP^T
      if (c == nc - 1) {  // s and dp of the tile are whole
        const float* sm = reinterpret_cast<const float*>(smem + (at - sbase) + 6 * kTile);
        cols_query_tile<T, kC>(s, dp, i0, N, scale, kbias, sm, sm + QT, sm + 2 * QT, drop, salt,
                            keys, rate, inv_keep, dka, dva, at + 4 * kTile, at + 5 * kTile);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  if (active) {  // stage 0's K and V chunks are free: the warps stage their rows there
    store_rows<T, kC>(dka, scale, smem, 0, r0, dk + b * sdk.b + h * sdk.h + sl * kC / 2, sdk.n,
                   col0 + r0, N);
    store_rows<T, kC>(dva, 1.f, smem, kTile, r0, dv + b * sdv.b + h * sdv.h + sl * kC / 2, sdv.n,
                   col0 + r0, N);
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

template <typename T, int D>
cudaError_t launch(Operand q, Operand k, Operand v, Operand dout, const void* bias,
                   const void* seeds, Gradient dq, Gradient dk, Gradient dv, void* stats, int B,
                   int N, int H, float scale, float rate, float inv_keep, cudaStream_t stream) {
  constexpr size_t rows_smem = rows_smem_bytes<D>(), cols_smem = cols_smem_bytes<D>();
  cudaError_t err = cxr::allow_smem(flash_bwd_rows_kernel<T, D>, rows_smem);
  if (err != cudaSuccess) return err;
  err = cxr::allow_smem(flash_bwd_cols_kernel<T, D>, cols_smem);
  if (err != cudaSuccess) return err;
  return cxr::for_batch_chunks(B, [&](int b0, int rows) {
    // the chunk's operands start at its first batch row
    auto in = [b0](Operand o) { return o.p + b0 * o.s.b; };
    auto out = [b0](Gradient g) { return g.p + b0 * g.s.b; };
    const auto* bi = static_cast<const float*>(bias) + (size_t)b0 * N;
    const auto* sd = static_cast<const int*>(seeds) + b0;
    auto* st = static_cast<float*>(stats) + (size_t)b0 * H * N;
    const dim3 grid = cxr::head_grid(rows, N, H);
    flash_bwd_rows_kernel<T, D><<<grid, kThreads, rows_smem, stream>>>(
        in(q), q.s, in(k), k.s, in(v), v.s, in(dout), dout.s, bi, sd, out(dq), dq.s, st, B, N,
        H, scale, rate, inv_keep);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_bwd_cols_kernel<T, D><<<grid, kThreads, cols_smem, stream>>>(
        in(q), q.s, in(k), k.s, in(v), v.s, in(dout), dout.s, bi, sd, out(dk), dk.s, out(dv),
        dv.s, st, B, N, H, scale, rate, inv_keep);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_sliced(Operand q, Operand k, Operand v, Operand dout, const void* bias,
                          const void* seeds, Gradient dq, Gradient dk, Gradient dv, void* stats,
                          int B, int N, int H, int D, float scale, float rate, float inv_keep,
                          cudaStream_t stream) {
  cudaError_t err = cxr::allow_smem(flash_bwd_rows_sliced_kernel<T>, kRowsSlicedSmem);
  if (err != cudaSuccess) return err;
  err = cxr::allow_smem(flash_bwd_cols_sliced_kernel<T>, kColsSlicedSmem);
  if (err != cudaSuccess) return err;
  const int nc = D / kC;
  return cxr::for_batch_chunks(B, [&](int b0, int rows) {
    auto in = [b0](Operand o) { return o.p + b0 * o.s.b; };
    auto out = [b0](Gradient g) { return g.p + b0 * g.s.b; };
    const auto* bi = static_cast<const float*>(bias) + (size_t)b0 * N;
    const auto* sd = static_cast<const int*>(seeds) + b0;
    auto* st = static_cast<float*>(stats) + (size_t)b0 * H * N;
    const dim3 grid = cxr::head_grid(rows, N, H * nc);
    flash_bwd_rows_sliced_kernel<T><<<grid, kThreads, kRowsSlicedSmem, stream>>>(
        in(q), q.s, in(k), k.s, in(v), v.s, in(dout), dout.s, bi, sd, out(dq), dq.s, st, B, N,
        H, nc, scale, rate, inv_keep);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_bwd_cols_sliced_kernel<T><<<grid, kThreads, kColsSlicedSmem, stream>>>(
        in(q), q.s, in(k), k.s, in(v), v.s, in(dout), dout.s, bi, sd, out(dk), dk.s, out(dv),
        dv.s, st, B, N, H, nc, scale, rate, inv_keep);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t dispatch(int D, Operand q, Operand k, Operand v, Operand dout, const void* bias,
                     const void* seeds, Gradient dq, Gradient dk, Gradient dv, void* stats,
                     int B, int N, int H, float scale, float rate, float inv_keep,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, B, N, H, scale, rate,
                        inv_keep, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, B, N, H, scale, rate,
                        inv_keep, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, B, N, H, scale, rate,
                         inv_keep, s);
    default:
      return launch_sliced<T>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, B, N, H, D, scale,
                           rate, inv_keep, s);
  }
}

// ---- fp32: the CUDA-core bodies -------------------------------------------
//
// fp32 operands (the parity mode) run FlashAttention-2's same two passes on
// the CUDA cores in fp32 FMAs, with no atomics: right, not fast. Every
// operand passes through shared memory in chunks of kF32Tokens tokens by
// kF32Cols columns of the head dim, so any D and N <= 512 fit (staged bytes
// double against bf16: a head's Q, K, V and dO at N = 512, D = 64 are 512 KB).
//
//  1. rows: a block takes kF32Rows query rows of a (head, batch row), 8 warps
//     of kF32Rows / 8. For each key chunk it sums s = q k^T and dp = do v^T
//     over the head dim (Q, dO, K and V chunks staged in turn; K and V rows
//     padded by one word so that the lanes' keys fall in distinct banks),
//     each lane two keys of its warp's rows, into the block's [rows, N]
//     scores and dp. Each warp then takes its rows: m, l, p = exp(s - m) / l,
//     dp masked and scaled by the regenerated dropout mask, delta =
//     sum p dp, ds = p (dp - delta) in place of s; (m, l, delta) go to the
//     stats scratch. dq = ds K * scale, one column chunk at a time, K's
//     chunks staged over the keys.
//  2. columns: a block takes kF32Rows keys; for each query chunk it sums
//     s^T = k q^T and dp^T = v do^T the same way, in the same column order
//     (so s, hence p, has the rows pass's bits), forms p from the rows
//     pass's m and l, pd and ds with the mask hashed at (query row, key), and
//     keeps them in [keys, N] buffers; then dv = pd^T dO and dk = ds^T Q *
//     scale, one column chunk at a time.
//
// Shared memory is 4 chunks plus two [kF32Rows, N] fp32 buffers: 180 KB at
// N = 512 (one block an SM), any D.

using cxr::kF32Cols;
using cxr::kF32Pad;
using cxr::kF32Rows;
using cxr::kF32RowsPerWarp;
using cxr::kF32Threads;
using cxr::kF32Tokens;

// the block's own [kF32Rows, kF32Cols] chunks (2), the streamed padded
// chunks (2), two [kF32Rows, N] buffers, and N floats (the key bias) or 3 N
// (the row statistics)
__host__ __device__ constexpr size_t f32_smem_bytes(int N, int per_token) {
  return ((size_t)2 * kF32Rows * kF32Cols + (size_t)2 * kF32Tokens * kF32Pad +
          (size_t)2 * kF32Rows * N + (size_t)per_token * N) *
         4;
}

__global__ void __launch_bounds__(kF32Threads)
flash_bwd_rows_f32_kernel(const float* __restrict__ q, HeadStrides sq,
                          const float* __restrict__ k, HeadStrides sk,
                          const float* __restrict__ v, HeadStrides sv,
                          const float* __restrict__ dout, HeadStrides sdo,
                          const float* __restrict__ bias, const int* __restrict__ seeds,
                          float* __restrict__ dq, HeadStrides sdq, float* __restrict__ stats,
                          int B, int N, int H, int D, float scale, float rate, float inv_keep) {
  extern __shared__ float fsm[];
  float* s_q = fsm;                                   // [kF32Rows][kF32Cols]
  float* s_do = s_q + kF32Rows * kF32Cols;            // [kF32Rows][kF32Cols]
  float* s_k = s_do + kF32Rows * kF32Cols;            // [kF32Tokens][kF32Pad]
  float* s_v = s_k + kF32Tokens * kF32Pad;            // [kF32Tokens][kF32Pad]
  float* s_s = s_v + kF32Tokens * kF32Pad;            // [kF32Rows][N]: s, then ds
  float* s_dp = s_s + (size_t)kF32Rows * N;           // [kF32Rows][N]
  float* s_bias = s_dp + (size_t)kF32Rows * N;        // [N]

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kF32Rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * kF32RowsPerWarp;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* ob = dout + b * sdo.b + h * sdo.h;
  const size_t plane = (size_t)B * H * N;
  float* st = stats + ((size_t)b * H + h) * N;  // max at st, sum at +plane, delta at +2 plane
  for (int j = threadIdx.x; j < N; j += kF32Threads) s_bias[j] = bias[(size_t)b * N + j];

  for (int j0 = 0; j0 < N; j0 += kF32Tokens) {
    float as[kF32RowsPerWarp][2] = {}, adp[kF32RowsPerWarp][2] = {};
    for (int c0 = 0; c0 < D; c0 += kF32Cols) {
      __syncthreads();  // the previous chunks are read
      cxr::stage_f32<kF32Rows>(s_q, kF32Cols, qb, sq.n, row0, N, c0, D);
      cxr::stage_f32<kF32Rows>(s_do, kF32Cols, ob, sdo.n, row0, N, c0, D);
      cxr::stage_f32<kF32Tokens>(s_k, kF32Pad, kb, sk.n, j0, N, c0, D);
      cxr::stage_f32<kF32Tokens>(s_v, kF32Pad, vb, sv.n, j0, N, c0, D);
      __syncthreads();
      cxr::f32_chunk_dots(as, s_q, s_k, r0, lane);
      cxr::f32_chunk_dots(adp, s_do, s_v, r0, lane);
    }
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + lane + 32 * e;
        if (j < N) {
          s_s[(r0 + i) * N + j] = fmaf(as[i][e], scale, s_bias[j]);
          s_dp[(r0 + i) * N + j] = adp[i][e];
        }
      }
  }

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  for (int i = 0; i < kF32RowsPerWarp; ++i) {
    const int t = row0 + r0 + i;
    if (t >= N) break;
    float* srow = s_s + (r0 + i) * N;
    float* drow = s_dp + (r0 + i) * N;
    float m = -CUDART_INF_F;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, srow[j]);
    m = cxr::warp_max(m);
    if (m == -CUDART_INF_F) m = 0.f;  // no finite score: exp(s - m) is 0, not NaN
    float l = 0.f;
    for (int j = lane; j < N; j += 32) l += expf(srow[j] - m);
    l = cxr::warp_sum(l);
    float pdp = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = expf(srow[j] - m) / l;
      float d = drow[j];
      if (drop) d = cxr::uniform01(salt, t, j) >= rate ? d * inv_keep : 0.f;
      srow[j] = p;
      drow[j] = d;
      pdp = fmaf(p, d, pdp);
    }
    const float delta = cxr::warp_sum(pdp);
    for (int j = lane; j < N; j += 32) srow[j] = srow[j] * (drow[j] - delta);  // ds
    if (lane == 0) {
      st[t] = m;
      st[plane + t] = l;
      st[2 * plane + t] = delta;
    }
  }

  cxr::f32_weighted_rows(s_s, N, kb, sk.n, s_k, dq + b * sdq.b + h * sdq.h, sdq.n, row0, r0,
                         lane, D, scale);
}

__global__ void __launch_bounds__(kF32Threads)
flash_bwd_cols_f32_kernel(const float* __restrict__ q, HeadStrides sq,
                          const float* __restrict__ k, HeadStrides sk,
                          const float* __restrict__ v, HeadStrides sv,
                          const float* __restrict__ dout, HeadStrides sdo,
                          const float* __restrict__ bias, const int* __restrict__ seeds,
                          float* __restrict__ dk, HeadStrides sdk, float* __restrict__ dv,
                          HeadStrides sdv, const float* __restrict__ stats, int B, int N, int H,
                          int D, float scale, float rate, float inv_keep) {
  extern __shared__ float fsm[];
  float* s_k = fsm;                                   // [kF32Rows][kF32Cols]
  float* s_v = s_k + kF32Rows * kF32Cols;             // [kF32Rows][kF32Cols]
  float* s_q = s_v + kF32Rows * kF32Cols;             // [kF32Tokens][kF32Pad]
  float* s_o = s_q + kF32Tokens * kF32Pad;            // [kF32Tokens][kF32Pad]
  float* s_pd = s_o + kF32Tokens * kF32Pad;           // [kF32Rows][N]
  float* s_ds = s_pd + (size_t)kF32Rows * N;          // [kF32Rows][N]
  float* s_st = s_ds + (size_t)kF32Rows * N;          // [3][N]: m, l, delta

  const int b = blockIdx.z, h = blockIdx.y, col0 = blockIdx.x * kF32Rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * kF32RowsPerWarp;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* ob = dout + b * sdo.b + h * sdo.h;
  const size_t plane = (size_t)B * H * N;
  const float* st = stats + ((size_t)b * H + h) * N;
  for (int x = threadIdx.x; x < 3 * N; x += kF32Threads)
    s_st[x] = st[(x / N) * plane + x % N];

  const bool drop = rate > 0.f;
  const uint32_t salt = cxr::dropout_salt(seeds[b], h);
  float kbias[kF32RowsPerWarp];
#pragma unroll
  for (int i = 0; i < kF32RowsPerWarp; ++i) {
    const int j = col0 + r0 + i;
    kbias[i] = j < N ? bias[(size_t)b * N + j] : 0.f;
  }
  for (int i0 = 0; i0 < N; i0 += kF32Tokens) {
    float as[kF32RowsPerWarp][2] = {}, adp[kF32RowsPerWarp][2] = {};
    for (int c0 = 0; c0 < D; c0 += kF32Cols) {
      __syncthreads();  // the previous chunks are read
      cxr::stage_f32<kF32Rows>(s_k, kF32Cols, kb, sk.n, col0, N, c0, D);
      cxr::stage_f32<kF32Rows>(s_v, kF32Cols, vb, sv.n, col0, N, c0, D);
      cxr::stage_f32<kF32Tokens>(s_q, kF32Pad, qb, sq.n, i0, N, c0, D);
      cxr::stage_f32<kF32Tokens>(s_o, kF32Pad, ob, sdo.n, i0, N, c0, D);
      __syncthreads();
      cxr::f32_chunk_dots(as, s_k, s_q, r0, lane);
      cxr::f32_chunk_dots(adp, s_v, s_o, r0, lane);
    }
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i) {
      const int j = col0 + r0 + i;  // the key
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = i0 + lane + 32 * e;  // the query row
        if (t < N && j < N) {
          const float p = expf(fmaf(as[i][e], scale, kbias[i]) - s_st[t]) / s_st[N + t];
          float pd = p, d = adp[i][e];
          if (drop) {
            const bool keep = cxr::uniform01(salt, t, j) >= rate;
            pd = keep ? p * inv_keep : 0.f;
            d = keep ? d * inv_keep : 0.f;
          }
          s_pd[(r0 + i) * N + t] = pd;
          s_ds[(r0 + i) * N + t] = p * (d - s_st[2 * N + t]);
        }
      }
    }
  }

  cxr::f32_weighted_rows(s_pd, N, ob, sdo.n, s_o, dv + b * sdv.b + h * sdv.h, sdv.n, col0, r0,
                         lane, D, 1.f);
  cxr::f32_weighted_rows(s_ds, N, qb, sq.n, s_q, dk + b * sdk.b + h * sdk.h, sdk.n, col0, r0,
                         lane, D, scale);
}

struct F32Operand {
  const float* p;
  HeadStrides s;
};

struct F32Gradient {
  float* p;
  HeadStrides s;
};

cudaError_t launch_f32(F32Operand q, F32Operand k, F32Operand v, F32Operand dout,
                       const void* bias, const void* seeds, F32Gradient dq, F32Gradient dk,
                       F32Gradient dv, void* stats, int B, int N, int H, int D, float scale,
                       float rate, float inv_keep, cudaStream_t stream) {
  const size_t rows_smem = f32_smem_bytes(N, 1), cols_smem = f32_smem_bytes(N, 3);
  cudaError_t err = cxr::allow_smem(flash_bwd_rows_f32_kernel, rows_smem);
  if (err != cudaSuccess) return err;
  err = cxr::allow_smem(flash_bwd_cols_f32_kernel, cols_smem);
  if (err != cudaSuccess) return err;
  return cxr::for_batch_chunks(B, [&](int b0, int rows) {
    auto in = [b0](F32Operand o) { return o.p + b0 * o.s.b; };
    auto out = [b0](F32Gradient g) { return g.p + b0 * g.s.b; };
    const auto* bi = static_cast<const float*>(bias) + (size_t)b0 * N;
    const auto* sd = static_cast<const int*>(seeds) + b0;
    auto* st = static_cast<float*>(stats) + (size_t)b0 * H * N;
    const dim3 grid((N + kF32Rows - 1) / kF32Rows, H, rows);
    flash_bwd_rows_f32_kernel<<<grid, kF32Threads, rows_smem, stream>>>(
        in(q), q.s, in(k), k.s, in(v), v.s, in(dout), dout.s, bi, sd, out(dq), dq.s, st, B, N,
        H, D, scale, rate, inv_keep);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_bwd_cols_f32_kernel<<<grid, kF32Threads, cols_smem, stream>>>(
        in(q), q.s, in(k), k.s, in(v), v.s, in(dout), dout.s, bi, sd, out(dk), dk.s, out(dv),
        dv.s, st, B, N, H, D, scale, rate, inv_keep);
    return cudaGetLastError();
  });
}

// the seven operands' strides, in 32-bit words: q, k, v, dout, dq, dk, dv
template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* dout, const void* bias,
        const void* seeds, void* dq, void* dk, void* dv, void* stats, const HeadStrides (&s)[7],
        int B, int N, int H, int D, float scale, float rate, float inv_keep, void* stream) {
  if constexpr (sizeof(T) == 4) {
    if (cxr::bad_f32_attention_args(B, N, H, D, rate)) return cudaErrorInvalidValue;
    auto in = [](const void* p) { return static_cast<const float*>(p); };
    auto out = [](void* p) { return static_cast<float*>(p); };
    return launch_f32({in(q), s[0]}, {in(k), s[1]}, {in(v), s[2]}, {in(dout), s[3]}, bias,
                      seeds, {out(dq), s[4]}, {out(dk), s[5]}, {out(dv), s[6]}, stats, B, N, H,
                      D, scale, rate, inv_keep, static_cast<cudaStream_t>(stream));
  } else {
    if (cxr::bad_attention_args(B, N, H, D, rate)) return cudaErrorInvalidValue;
    auto in = [](const void* p) { return static_cast<const uint32_t*>(p); };
    auto out = [](void* p) { return static_cast<uint32_t*>(p); };
    return dispatch<T>(D, {in(q), s[0]}, {in(k), s[1]}, {in(v), s[2]}, {in(dout), s[3]}, bias,
                       seeds, {out(dq), s[4]}, {out(dk), s[5]}, {out(dv), s[6]}, stats, B, N,
                       H, scale, rate, inv_keep, stream);
  }
}

// B6 in one type: the packed operands' strides, W words a head (D / 2 in a
// 16-bit type, D in fp32)
template <typename T>
int bwd_packed(const void* qkv, const void* dout, const void* bias, const void* seeds,
               void* dqkv, void* stats, int B, int N, int H, int D, float scale, float rate,
               float inv_keep, void* stream) {
  const long long W = sizeof(T) == 4 ? D : D / 2, row = 3 * H * W;
  const HeadStrides sqkv{N * row, row, W}, sdo{N * H * W, H * W, W};
  const HeadStrides s[7] = {sqkv, sqkv, sqkv, sdo, sqkv, sqkv, sqkv};
  const auto* in = static_cast<const uint32_t*>(qkv);
  auto* g = static_cast<uint32_t*>(dqkv);
  return bwd<T>(in, in + H * W, in + 2 * H * W, dout, bias, seeds, g, g + H * W, g + 2 * H * W,
                stats, s, B, N, H, D, scale, rate, inv_keep, stream);
}

// B7 in one type: ``strides`` in 32-bit words (21 values)
template <typename T>
int bwd_split(const void* q, const void* k, const void* v, const void* dout, const void* bias,
              const void* seeds, void* dq, void* dk, void* dv, void* stats,
              const long long* strides, int B, int N, int H, int D, float scale, float rate,
              float inv_keep, void* stream) {
  HeadStrides s[7];
  for (int t = 0; t < 7; ++t) s[t] = {strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  return bwd<T>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, s, B, N, H, D, scale, rate,
                inv_keep, stream);
}

}  // namespace

// B6: qkv [B, N, 3*H*D], dout [B, N, H*D] and dqkv [B, N, 3*H*D] (every
// element written) in one type: bf16 (cxr_flash_bwd_packed), fp16 (_f16) or
// fp32 (_f32); bias [B, N] fp32, seeds [B] int32, stats [3, B, H, N] fp32
// scratch. In bf16 and fp16 D is 32, 64, 128 or a multiple of 64 over 128,
// H (times D / 64 over 128) <= 65535, and qkv, dout and dqkv 16-byte
// aligned; in fp32 any D >= 1 and H <= 65535. 1 <= N <= 512, any B;
// 0 <= rate < 1 and inv_keep = 1 / (1 - rate), as in the forward that made
// dout's output.
CXR_API int cxr_flash_bwd_packed(const void* qkv, const void* dout, const void* bias,
                                 const void* seeds, void* dqkv, void* stats, int B, int N,
                                 int H, int D, float scale, float rate, float inv_keep,
                                 void* stream) {
  return bwd_packed<__nv_bfloat16>(qkv, dout, bias, seeds, dqkv, stats, B, N, H, D, scale, rate,
                                   inv_keep, stream);
}

CXR_API int cxr_flash_bwd_packed_f16(const void* qkv, const void* dout, const void* bias,
                                     const void* seeds, void* dqkv, void* stats, int B, int N,
                                     int H, int D, float scale, float rate, float inv_keep,
                                     void* stream) {
  return bwd_packed<__half>(qkv, dout, bias, seeds, dqkv, stats, B, N, H, D, scale, rate,
                            inv_keep, stream);
}

CXR_API int cxr_flash_bwd_packed_f32(const void* qkv, const void* dout, const void* bias,
                                     const void* seeds, void* dqkv, void* stats, int B, int N,
                                     int H, int D, float scale, float rate, float inv_keep,
                                     void* stream) {
  return bwd_packed<float>(qkv, dout, bias, seeds, dqkv, stats, B, N, H, D, scale, rate,
                           inv_keep, stream);
}

// B7: q, k, v, dout, dq, dk and dv of one type with the head dim contiguous,
// each addressed by three strides in 32-bit words in ``strides`` (host
// memory, 21 values: q, k, v, dout, dq, dk, dv, each as batch, token, head).
// In bf16 (cxr_flash_bwd) and fp16 (_f16) every stride a multiple of 4 words
// and every pointer 16-byte aligned (the 16-byte copies and stores); in fp32
// (_f32) any. Other arguments as B6's.
CXR_API int cxr_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                          const void* bias, const void* seeds, void* dq, void* dk, void* dv,
                          void* stats, const long long* strides, int B, int N, int H, int D,
                          float scale, float rate, float inv_keep, void* stream) {
  return bwd_split<__nv_bfloat16>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, strides, B, N,
                                  H, D, scale, rate, inv_keep, stream);
}

CXR_API int cxr_flash_bwd_f16(const void* q, const void* k, const void* v, const void* dout,
                              const void* bias, const void* seeds, void* dq, void* dk, void* dv,
                              void* stats, const long long* strides, int B, int N, int H, int D,
                              float scale, float rate, float inv_keep, void* stream) {
  return bwd_split<__half>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, strides, B, N, H, D,
                           scale, rate, inv_keep, stream);
}

CXR_API int cxr_flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                              const void* bias, const void* seeds, void* dq, void* dk, void* dv,
                              void* stats, const long long* strides, int B, int N, int H, int D,
                              float scale, float rate, float inv_keep, void* stream) {
  return bwd_split<float>(q, k, v, dout, bias, seeds, dq, dk, dv, stats, strides, B, N, H, D,
                          scale, rate, inv_keep, stream);
}
