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
//   out[b, y, x, c] = cast(resize(src -> f32)[b, y, x, c_in] * scale[c] + bias[c])
//
// The source is uint8 (scale holds 1/255) or fp32 (scale 1, as the TPU
// kernel takes float images), a template parameter of each body; the output
// fp32, bf16 or fp16. Rows too wide to stage run the direct body at the end
// of this file.
//
// Grey input (C_in = 1) is read once and written to all C_out channels: the
// resize of identical channels is identical, so this equals resizing the
// triplicated RGB batch. The output is NHWC, which is the channels_last
// memory of the NCHW tensor the ResNet's convolutions take.
//
// What bounds it on the card: bytes. A 512x512 grey image is 256 KB in and
// 224*224*3*2 = 294 KB out for ~10 flops per output value.
//
// What held the first design back: one block of 256 threads per (image,
// output row), 57,344 blocks at B = 256, each writing 1,344 bytes and
// exiting, about 54 waves of 8 blocks an SM. Each thread loaded its column
// taps from device memory, then four bytes at addresses that depended on
// them, then stored three scalar bf16 at a 6-byte stride: two dependent
// round trips to device memory in every wave, so latency, not bytes, set its
// time (0.103-0.108 ms against a 0.043 ms bound).
//
// This design: kBlocksPerSm long-lived blocks an SM walk (image, band of R
// output rows, column chunk) items in a grid-stride loop. Three blocks of
// 256 threads an SM leave 80 registers a thread; at four (64) the pixel
// loop spilled.
//  - A thread owns kPix consecutive output pixels of the block's column
//    chunk; the chunk is fixed for a block (gridDim.x is a multiple of the
//    chunk count), so its column taps and, for C_out of 1 or 3, scale and
//    bias are loaded into registers once.
//  - Warp 0 plans each band: the at most 2R distinct source rows its row
//    taps name (a warp-wide dedup of lo and hi, so a row shared by two
//    output rows is staged once), their 16-byte-aligned window starts, and
//    each output row's two slots and weights, in shared memory. It plans the
//    band after next while the block computes (a ring of three plans, two
//    __syncthreads an item), from taps it loaded an item earlier, with
//    32-bit index arithmetic.
//  - The named rows' windows are staged into shared memory with 16-byte
//    cp.async, neighbouring threads on neighbouring addresses, in two
//    buffers: the next band's rows load while this band computes. A window
//    starts at the aligned address at or below its first byte and keeps the
//    offset; a 16-byte piece that would reach before the tensor or past its
//    end is copied byte by byte, so nothing outside the input is read.
//  - A source row too wide for the buffer is staged in column chunks: the
//    host narrows the chunk (then the band) until 2R rows of its window fit
//    kBufBytes. Only a row pair wider than that at one output column (C_in
//    in the thousands) gets a larger buffer, up to the card's shared memory.
//  - Stores are 16 bytes wide and coalesced. A thread's kPix pixels (48
//    bytes at C_out = 3 in bf16, three 16-byte pieces) go to its warp's
//    store region in shared memory when their first byte is 16-byte aligned
//    and all lie inside the chunk, else out as scalars; then lane l of the
//    warp stores the region's pieces l, l + 32, ..., so one instruction
//    writes up to 512 contiguous bytes. Each thread storing its own three
//    pieces, at a 48-byte stride across the warp, was the largest cost at
//    the serving batch (PERF.md §6): such a store instruction touches 12
//    lines of 128 bytes where a contiguous one touches 4.
// Each output keeps the first design's expressions in the same order
// (lerp2x2 and u * scale + bias), so nvcc forms the same multiply-adds.
//
// The host's rule for R, the chunk width, the row stride and the grid is
// mirrored by clip_for_dl_tpu_torch/ops/image_prep.py band_plan, which the
// CPU tests hold (tests/test_torch_image_prep_tiles.py); change both together.
#include <algorithm>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;
constexpr int kMaxBand = 16;            // R, output rows of a band
constexpr int kSlots = 32;              // a band's taps and staged rows: one a lane of warp 0
static_assert(2 * kMaxBand <= kSlots, "a band's 2R taps are planned by one warp");
constexpr int kPix = 8;                 // output pixels a thread owns in a row
constexpr int kMaxCols = kPix * kThreads;
constexpr int kBufBytes = 22528;        // one of the two staging buffers
constexpr int kMaxSmem = 232448 - 4096; // dynamic shared memory a block may opt into

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half to_out<__half>(float v) {
  return __float2half_rn(v);
}

struct Taps {
  const int* lo;
  const int* hi;
  const float* w0;
  const float* w1;
};

struct Geometry {
  const uint8_t* img;            // the input's first byte (uint8 or fp32 values)
  uintptr_t img_begin, img_end;  // the input's bytes, as addresses
  Taps ty, tx;
  const float* scale;
  const float* bias;
  int H_in, W_in, C_in, H_out, W_out, C_out;
  int R, Xc, stride, nbands, nchunks;  // the host's plan (band_plan); stride in bytes
  int items;                           // B * nbands * nchunks, below 2^30
};

// One band of one image, as warp 0 planned it.
struct Band {
  int b, y0, rows, n_slots;
  int slot_row[kSlots];    // source row staged in each slot, ascending
  int slot_shift[kSlots];  // bytes from the slot's aligned start to its window
  int tap_slot[kSlots];    // 2i: slot of lo[y0 + i]; 2i + 1: slot of hi[y0 + i]
  float wy[kSlots];        // 2i: w0[y0 + i]; 2i + 1: w1[y0 + i]
};

// the first byte of source row ``row`` of image b, and of the column c of it
template <typename SrcT>
__device__ __forceinline__ const uint8_t* row_start(const Geometry& g, int b, int row, int c) {
  return g.img + (((size_t)b * g.H_in + row) * g.W_in + c) * g.C_in * sizeof(SrcT);
}

// The row tap of warp 0's lane for ``item``: lanes 2i and 2i + 1 read lo and
// hi of the band's row i; lanes past the band repeat its last row.
__device__ __forceinline__ void load_taps(const Geometry& g, int item, int lane, int& row,
                                          float& w) {
  const int band = (item / g.nchunks) % g.nbands;
  const int y0 = band * g.R, rows = min(g.R, g.H_out - y0);
  const int y = y0 + min(lane >> 1, rows - 1);
  row = (lane & 1) ? g.ty.hi[y] : g.ty.lo[y];
  w = (lane & 1) ? g.ty.w1[y] : g.ty.w0[y];
}

// Warp 0: the band's distinct rows in ascending slots (a lane's rank among
// the first lanes holding each distinct row), their window offsets, and
// each tap's slot.
template <typename SrcT>
__device__ __forceinline__ void plan_band(const Geometry& g, Band& s, int item, int lane,
                                          int row, float w, int c_lo) {
  const unsigned same = __match_any_sync(0xffffffffu, row);
  const bool first = __ffs(same) - 1 == lane;
  const unsigned firsts = __ballot_sync(0xffffffffu, first);
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int rj = __shfl_sync(0xffffffffu, row, j);
    rank += ((firsts >> j) & 1u) && rj < row;
  }
  const int band_idx = item / g.nchunks;
  const int b = band_idx / g.nbands;
  if (first) {
    s.slot_row[rank] = row;
    s.slot_shift[rank] = (int)(reinterpret_cast<uintptr_t>(row_start<SrcT>(g, b, row, c_lo)) & 15);
  }
  s.tap_slot[lane] = rank;
  s.wy[lane] = w;
  if (lane == 0) {
    s.b = b;
    s.y0 = (band_idx - b * g.nbands) * g.R;
    s.rows = min(g.R, g.H_out - s.y0);
    s.n_slots = __popc(firsts);
  }
}

// All threads: copy each slot's window (win bytes), from its aligned start,
// as 16-byte pieces into buf (slot k at k * stride).
template <typename SrcT>
__device__ __forceinline__ void stage_rows(const Geometry& g, const Band& s, uint8_t* buf,
                                           int c_lo, int win) {
  const int per_row = g.stride / 16;
  const int n = s.n_slots * per_row;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int slot = i / per_row, j = i - slot * per_row;
    const int shift = s.slot_shift[slot];
    if (16 * j >= shift + win) continue;
    const uint8_t* src = row_start<SrcT>(g, s.b, s.slot_row[slot], c_lo) - shift + 16 * j;
    uint8_t* dst = buf + slot * g.stride + 16 * j;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    if (a >= g.img_begin && a + 16 <= g.img_end) {
      cxr::cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), src, true);
    } else {  // the tensor's first or last piece: only its own bytes
      for (int q = 0; q < 16; ++q)
        if (a + q >= g.img_begin && a + q < g.img_end) dst[q] = src[q];
    }
  }
}

template <typename SrcT>
__device__ __forceinline__ float lerp2x2(const SrcT* r0, const SrcT* r1, int o0, int o1,
                                         float wy0, float wy1, float wx0, float wx1) {
  const float t0 = wy0 * (float)r0[o0] + wy1 * (float)r1[o0];
  const float t1 = wy0 * (float)r0[o1] + wy1 * (float)r1[o1];
  return wx0 * t0 + wx1 * t1;
}

// Piece k of a thread's outputs (kPer values, 16 bytes): into the thread's
// pieces of its warp's store region, or as scalar stores of those of its
// first n outputs that it holds.
template <typename OutT, int kPer>
__device__ __forceinline__ void emit(OutT* dst, uint4* mine, int k, const float (&q)[kPer],
                                     bool vec, int n) {
  if (vec) {
    uint4 v;
    if constexpr (kPer == 8) {
      v = make_uint4(cxr::pack2<OutT>(q[0], q[1]), cxr::pack2<OutT>(q[2], q[3]),
                     cxr::pack2<OutT>(q[4], q[5]), cxr::pack2<OutT>(q[6], q[7]));
    } else {
      v = make_uint4(__float_as_uint(q[0]), __float_as_uint(q[1]), __float_as_uint(q[2]),
                     __float_as_uint(q[3]));
    }
    mine[k] = v;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (k * kPer + j < n) dst[k * kPer + j] = to_out<OutT>(q[j]);
  }
}

// SrcT: uint8_t or float source values. kC: C_out known at compile time (1
// or 3), or 0 for any C_out read at run time (scalar stores).
template <typename SrcT, typename OutT, int kC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
image_prep_kernel(Geometry g, OutT* __restrict__ out) {
  // two staging buffers of 2R slots, then (kC > 0) the warps' store regions
  extern __shared__ __align__(16) uint8_t stage[];
  __shared__ Band band[3];  // the band computed, the band staged, the band planned
  const int tid = threadIdx.x, lane = tid & 31;
  const bool planner = tid < 32;
  const int buf_bytes = 2 * g.R * g.stride;
  const int step = gridDim.x;
  uint4* store_region = reinterpret_cast<uint4*>(stage + 2 * buf_bytes);

  // the block's column chunk, and this thread's pixels in it
  const int chunk = blockIdx.x % g.nchunks;
  const int x_begin = chunk * g.Xc, x_end = min(x_begin + g.Xc, g.W_out);
  const int c_lo = g.tx.lo[x_begin];
  const int win = (g.tx.hi[x_end - 1] - c_lo + 1) * g.C_in * (int)sizeof(SrcT);
  const int groups = (g.Xc + kPix - 1) / kPix, lanes = kThreads / groups;
  const int row_lane = tid / groups;
  const int x0 = x_begin + (tid - row_lane * groups) * kPix;
  const int nvalid = min(kPix, x_end - x0);  // ≤ 0: no pixel of this thread
  // a pixel's lo column as an element offset into the window, times 2, plus
  // 1 where hi is the next column (hi = lo where the taps clamp)
  int tap[kPix];
  float wx0[kPix], wx1[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = min(x0 + p, x_end - 1);
    const int lo = g.tx.lo[x];
    tap[p] = (lo - c_lo) * g.C_in * 2 + (g.tx.hi[x] != lo);
    wx0[p] = g.tx.w0[x];
    wx1[p] = g.tx.w1[x];
  }
  float sc[kC > 0 ? kC : 1], bi[kC > 0 ? kC : 1];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    sc[c] = g.scale[c];
    bi[c] = g.bias[c];
  }
  const bool grey = g.C_in == 1;

  // Item k of this block is blockIdx.x + k * step, computed from band[k % 3]
  // and buffer k % 2; while it computes, item k + 1 loads and warp 0 plans
  // item k + 2 from the taps it loaded during item k - 1.
  int item = blockIdx.x;
  int tap_row = 0;
  float tap_w = 0.f;
  if (planner) {
    load_taps(g, item, lane, tap_row, tap_w);
    plan_band<SrcT>(g, band[0], item, lane, tap_row, tap_w, c_lo);
    if (item + step < g.items) load_taps(g, item + step, lane, tap_row, tap_w);
  }
  __syncthreads();
  stage_rows<SrcT>(g, band[0], stage, c_lo, win);
  cxr::cp_async_commit();
  if (planner && item + step < g.items) {
    plan_band<SrcT>(g, band[1], item + step, lane, tap_row, tap_w, c_lo);
    if (item + 2 * step < g.items) load_taps(g, item + 2 * step, lane, tap_row, tap_w);
  }

  for (int k = 0; item < g.items; item += step, ++k) {
    const int next = item + step;
    __syncthreads();  // band k + 1 planned; buffer (k + 1) % 2's last readers done
    if (next < g.items) {
      stage_rows<SrcT>(g, band[(k + 1) % 3], stage + ((k + 1) & 1) * buf_bytes, c_lo, win);
    }
    cxr::cp_async_commit();
    cxr::cp_async_wait_one();
    __syncthreads();  // item k's rows have landed, from every thread
    if (planner && next + step < g.items) {
      plan_band<SrcT>(g, band[(k + 2) % 3], next + step, lane, tap_row, tap_w, c_lo);
      if (next + 2 * step < g.items) load_taps(g, next + 2 * step, lane, tap_row, tap_w);
    }

    const Band& s = band[k % 3];
    const uint8_t* buf = stage + (k & 1) * buf_bytes;
    const int C = kC > 0 ? kC : g.C_out;
    // every thread of a warp runs the same rows' iterations, for __syncwarp
    for (int j = 0, iters = (s.rows + lanes - 1) / lanes; j < iters; ++j) {
      const int i = row_lane + j * lanes;
      const bool valid = nvalid > 0 && row_lane < lanes && i < s.rows;
      OutT* dst = nullptr;
      const SrcT *r0 = reinterpret_cast<const SrcT*>(buf), *r1 = r0;
      float wy0 = 0.f, wy1 = 0.f;
      if (valid) {
        const int k0 = s.tap_slot[2 * i], k1 = s.tap_slot[2 * i + 1];
        r0 = reinterpret_cast<const SrcT*>(buf + k0 * g.stride + s.slot_shift[k0]);
        r1 = reinterpret_cast<const SrcT*>(buf + k1 * g.stride + s.slot_shift[k1]);
        wy0 = s.wy[2 * i];
        wy1 = s.wy[2 * i + 1];
        dst = out + (((size_t)s.b * g.H_out + s.y0 + i) * g.W_out + x0) * C;
      }
      if constexpr (kC > 0) {
        // A thread's kPieces 16-byte pieces go to its warp's region when they
        // are whole and aligned; then the warp stores the region's pieces,
        // lane l the pieces l, l + 32, ..., so that one store instruction
        // covers up to 512 contiguous bytes.
        constexpr int kPer = 16 / sizeof(OutT), kPieces = kPix * kC / kPer;
        uint4* region = store_region + (tid >> 5) * 32 * kPieces;
        const bool vec =
            valid && nvalid == kPix && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
        if (valid) {
          float q[kPer];
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            const int o0 = tap[p] >> 1, o1 = o0 + (tap[p] & 1) * g.C_in;
            float u = 0.f;
            if (grey) u = lerp2x2(r0, r1, o0, o1, wy0, wy1, wx0[p], wx1[p]);
#pragma unroll
            for (int c = 0; c < kC; ++c) {
              if (!grey) u = lerp2x2(r0, r1, o0 + c, o1 + c, wy0, wy1, wx0[p], wx1[p]);
              const int e = p * kC + c;
              q[e % kPer] = u * sc[c] + bi[c];
              if (e % kPer == kPer - 1)
                emit<OutT, kPer>(dst, region + lane * kPieces, e / kPer, q, vec, nvalid * kC);
            }
          }
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < kPieces; ++r) {
          const int idx = lane + 32 * r, t = idx / kPieces;
          const auto d = __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(dst), t);
          if (__shfl_sync(0xffffffffu, (int)vec, t))
            reinterpret_cast<uint4*>(d)[idx - t * kPieces] = region[idx];
        }
        __syncwarp();  // the region is written again next row
      } else if (valid) {
        for (int p = 0; p < nvalid; ++p) {
          const int o0 = tap[p] >> 1, o1 = o0 + (tap[p] & 1) * g.C_in;
          if (grey) {
            const float u = lerp2x2(r0, r1, o0, o1, wy0, wy1, wx0[p], wx1[p]);
            for (int c = 0; c < C; ++c)
              dst[p * C + c] = to_out<OutT>(u * g.scale[c] + g.bias[c]);
          } else {
            for (int c = 0; c < C; ++c) {
              const float u = lerp2x2(r0, r1, o0 + c, o1 + c, wy0, wy1, wx0[p], wx1[p]);
              dst[p * C + c] = to_out<OutT>(u * g.scale[c] + g.bias[c]);
            }
          }
        }
      }
    }
  }
}

// ---- the direct body, for rows too wide to stage ---------------------------
//
// The first design's taps -> bytes -> stores body, with the 2x2 source values
// read straight from device memory, kept for a source row pair that no
// staging buffer holds: C_in * the element size past ~57 KB at one output
// column, where the host's plan (make_plan) gives up. Such rows have
// thousands of channels, so a block takes kThreads consecutive output
// values of one (image, output row), channels innermost (gridDim.y blocks
// along the row): the reads and stores of a warp are contiguous. Each output
// is lerp2x2 and u * scale + bias of the same operands in the same order as
// the staged body's, so the two give the same bits wherever both run.
template <typename SrcT, typename OutT>
__global__ void __launch_bounds__(kThreads)
image_prep_direct_kernel(Geometry g, OutT* __restrict__ out) {
  const int b = blockIdx.x / g.H_out;
  const int y = blockIdx.x - b * g.H_out;
  const auto* r0 = reinterpret_cast<const SrcT*>(row_start<SrcT>(g, b, g.ty.lo[y], 0));
  const auto* r1 = reinterpret_cast<const SrcT*>(row_start<SrcT>(g, b, g.ty.hi[y], 0));
  const float wy0 = g.ty.w0[y], wy1 = g.ty.w1[y];
  const long long n = (long long)g.W_out * g.C_out;  // output values of the row
  OutT* orow = out + ((size_t)b * g.H_out + y) * n;
  for (long long e = (long long)blockIdx.y * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.y * kThreads) {
    const int x = (int)(e / g.C_out), c = (int)(e - (long long)x * g.C_out);
    const int ci = g.C_in == 1 ? 0 : c;  // grey: every channel reads the one
    const float u = lerp2x2(r0, r1, g.tx.lo[x] * g.C_in + ci, g.tx.hi[x] * g.C_in + ci, wy0,
                            wy1, g.tx.w0[x], g.tx.w1[x]);
    orow[e] = to_out<OutT>(u * g.scale[c] + g.bias[c]);
  }
}

// ---- the host's plan (mirrored by ops/image_prep.py band_plan) ------------

// Bytes a staged source row needs for Xc output columns: the columns [lo,
// hi] they name span at most (Xc - 1) * W_in / W_out + 3 (+ 1 for the
// float64 taps' rounding; one column names at most 2), of C_in values of
// ``el`` bytes, and the window starts up to 15 bytes after its aligned
// start; rounded up to whole 16-byte pieces.
long long row_stride(long long Xc, int W_in, int W_out, int C_in, int el) {
  const long long cols =
      std::min<long long>(W_in, Xc == 1 ? 2 : (Xc - 1) * W_in / W_out + 4);
  return (15 + cols * C_in * el + 15) / 16 * 16;
}

struct Plan {
  int R, Xc, stride, nbands, nchunks, grid;
  long long items;
  size_t staging;  // bytes of the two staging buffers
};

// R: kMaxBand, halved while B bands of R rows would leave SMs without an
// item. The chunk: the whole row (at most kMaxCols columns), else the widest
// run of whole kPix-column groups, else of columns, whose 2R staged rows fit
// kBufBytes; if not even one column fits, R is halved; at R = 1 one column's
// row pair gets a buffer of its own size. Returns false past kMaxSmem (the
// direct body's case), or at 2^30 items.
bool make_plan(long long B, int W_in, int C_in, int el, int H_out, int W_out, int n_sms,
               Plan& p) {
  int R = kMaxBand;
  while (R > 1 && B * ((H_out + R - 1) / R) < n_sms) R /= 2;
  long long Xc = 0, stride = 0, buf = 0;
  for (;; R /= 2) {
    const long long cap = kBufBytes / (2 * R);
    Xc = std::min<long long>((W_out + kPix - 1) / kPix * kPix, kMaxCols);
    while (Xc > kPix && row_stride(Xc, W_in, W_out, C_in, el) > cap) Xc -= kPix;
    while (Xc > 0 && row_stride(Xc, W_in, W_out, C_in, el) > cap) --Xc;
    if (Xc > 0) {
      stride = row_stride(Xc, W_in, W_out, C_in, el);
      buf = 2LL * R * stride;
      break;
    }
    if (R == 1) {
      Xc = 1;
      stride = row_stride(1, W_in, W_out, C_in, el);
      buf = 2 * stride;
      break;
    }
  }
  if (2 * buf > kMaxSmem) return false;
  p.R = R;
  p.Xc = (int)Xc;
  p.stride = (int)stride;
  p.nbands = (H_out + R - 1) / R;
  p.nchunks = (int)((W_out + Xc - 1) / Xc);
  p.items = B * p.nbands * p.nchunks;
  if (p.items >= (1LL << 30)) return false;  // item + 2 * step stays an int
  const long long blocks = (long long)n_sms * kBlocksPerSm;
  p.grid = (int)(p.items <= blocks ? p.items
                                   : std::max<long long>(1, blocks / p.nchunks) * p.nchunks);
  p.staging = (size_t)(2 * buf);
  return true;
}

// Dynamic shared memory: the staging buffers, then for kC > 0 each warp's
// store region of its threads' outputs (24 KB in fp32 at C_out = 3).
template <typename SrcT, typename OutT, int kC>
cudaError_t launch(const Geometry& g, const Plan& p, void* out, cudaStream_t s) {
  auto kernel = image_prep_kernel<SrcT, OutT, kC>;
  const size_t smem = p.staging + (size_t)kThreads * kPix * kC * sizeof(OutT);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 40 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.grid, kThreads, smem, s>>>(g, static_cast<OutT*>(out));
  return cudaGetLastError();
}

template <typename SrcT, typename OutT>
cudaError_t launch_for(int C_out, const Geometry& g, const Plan& p, void* out, cudaStream_t s) {
  if (C_out == 3) return launch<SrcT, OutT, 3>(g, p, out, s);
  if (C_out == 1) return launch<SrcT, OutT, 1>(g, p, out, s);
  return launch<SrcT, OutT, 0>(g, p, out, s);
}

// The direct body: B * H_out (below 2^31) rows of blocks, each row's output
// values in up to 65535 blocks of kThreads.
template <typename SrcT, typename OutT>
cudaError_t launch_direct(const Geometry& g, long long B, void* out, cudaStream_t s) {
  if (B * g.H_out > 2147483647LL) return cudaErrorInvalidValue;
  const long long per_row = ((long long)g.W_out * g.C_out + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(B * g.H_out), (unsigned)std::min<long long>(per_row, 65535));
  image_prep_direct_kernel<SrcT, OutT><<<grid, kThreads, 0, s>>>(g, static_cast<OutT*>(out));
  return cudaGetLastError();
}

// out_type: 0 fp32, 1 bf16, 2 fp16
template <typename SrcT>
int prep(const void* img, const void* y_lo, const void* y_hi, const void* y_w0,
         const void* y_w1, const void* x_lo, const void* x_hi, const void* x_w0,
         const void* x_w1, const void* scale, const void* bias, void* out, int B, int H_in,
         int W_in, int C_in, int H_out, int W_out, int C_out, int out_type, bool direct,
         void* stream) {
  if (B <= 0 || H_in <= 0 || W_in <= 0 || C_in <= 0 || H_out <= 0 || W_out <= 0 ||
      (C_in != C_out && C_in != 1) || out_type < 0 || out_type > 2)
    return cudaErrorInvalidValue;
  Geometry g;
  g.img = static_cast<const uint8_t*>(img);
  g.img_begin = reinterpret_cast<uintptr_t>(img);
  g.img_end = g.img_begin + (size_t)B * H_in * W_in * C_in * sizeof(SrcT);
  g.ty = Taps{static_cast<const int*>(y_lo), static_cast<const int*>(y_hi),
              static_cast<const float*>(y_w0), static_cast<const float*>(y_w1)};
  g.tx = Taps{static_cast<const int*>(x_lo), static_cast<const int*>(x_hi),
              static_cast<const float*>(x_w0), static_cast<const float*>(x_w1)};
  g.scale = static_cast<const float*>(scale);
  g.bias = static_cast<const float*>(bias);
  g.H_in = H_in; g.W_in = W_in; g.C_in = C_in;
  g.H_out = H_out; g.W_out = W_out; g.C_out = C_out;
  auto s = static_cast<cudaStream_t>(stream);
  if (direct) {
    switch (out_type) {
      case 0: return launch_direct<SrcT, float>(g, B, out, s);
      case 1: return launch_direct<SrcT, __nv_bfloat16>(g, B, out, s);
      default: return launch_direct<SrcT, __half>(g, B, out, s);
    }
  }
  int dev = 0, n_sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan(B, W_in, C_in, (int)sizeof(SrcT), H_out, W_out, n_sms, p))
    return cudaErrorInvalidValue;
  g.R = p.R; g.Xc = p.Xc; g.stride = p.stride; g.nbands = p.nbands; g.nchunks = p.nchunks;
  g.items = (int)p.items;
  switch (out_type) {
    case 0: return launch_for<SrcT, float>(C_out, g, p, out, s);
    case 1: return launch_for<SrcT, __nv_bfloat16>(C_out, g, p, out, s);
    default: return launch_for<SrcT, __half>(C_out, g, p, out, s);
  }
}

}  // namespace

// img [B, H_in, W_in, C_in] uint8; taps [H_out] / [W_out]; scale, bias
// [C_out] fp32; out [B, H_out, W_out, C_out], fp32 (out_type 0), bf16 (1) or
// fp16 (2). C_out equals C_in, or C_in = 1 broadcast to C_out. The staged
// body; refuses a source row pair too wide for shared memory (make_plan).
CXR_API int cxr_image_prep(const void* img, const void* y_lo, const void* y_hi,
                           const void* y_w0, const void* y_w1, const void* x_lo,
                           const void* x_hi, const void* x_w0, const void* x_w1,
                           const void* scale, const void* bias, void* out, int B, int H_in,
                           int W_in, int C_in, int H_out, int W_out, int C_out, int out_type,
                           void* stream) {
  return prep<uint8_t>(img, y_lo, y_hi, y_w0, y_w1, x_lo, x_hi, x_w0, x_w1, scale, bias, out, B,
                       H_in, W_in, C_in, H_out, W_out, C_out, out_type, false, stream);
}

// cxr_image_prep over fp32 images (4-byte aligned).
CXR_API int cxr_image_prep_f32src(const void* img, const void* y_lo, const void* y_hi,
                                  const void* y_w0, const void* y_w1, const void* x_lo,
                                  const void* x_hi, const void* x_w0, const void* x_w1,
                                  const void* scale, const void* bias, void* out, int B,
                                  int H_in, int W_in, int C_in, int H_out, int W_out, int C_out,
                                  int out_type, void* stream) {
  return prep<float>(img, y_lo, y_hi, y_w0, y_w1, x_lo, x_hi, x_w0, x_w1, scale, bias, out, B,
                     H_in, W_in, C_in, H_out, W_out, C_out, out_type, false, stream);
}

// The direct body over uint8 (src_type 0) or fp32 (1) images, any row width;
// B * H_out < 2^31. Other arguments as cxr_image_prep's.
CXR_API int cxr_image_prep_direct(const void* img, const void* y_lo, const void* y_hi,
                                  const void* y_w0, const void* y_w1, const void* x_lo,
                                  const void* x_hi, const void* x_w0, const void* x_w1,
                                  const void* scale, const void* bias, void* out, int B,
                                  int H_in, int W_in, int C_in, int H_out, int W_out, int C_out,
                                  int out_type, int src_type, void* stream) {
  if (src_type == 0)
    return prep<uint8_t>(img, y_lo, y_hi, y_w0, y_w1, x_lo, x_hi, x_w0, x_w1, scale, bias, out,
                         B, H_in, W_in, C_in, H_out, W_out, C_out, out_type, true, stream);
  if (src_type == 1)
    return prep<float>(img, y_lo, y_hi, y_w0, y_w1, x_lo, x_hi, x_w0, x_w1, scale, bias, out, B,
                       H_in, W_in, C_in, H_out, W_out, C_out, out_type, true, stream);
  return cudaErrorInvalidValue;
}
