// Tensor-core tiles shared by the attention kernels B3/B5
// (flash_attention.cu) and B6/B7 (flash_attention_bwd.cu): the PTX they are
// built from (cp.async, ldmatrix, mma.sync m16n8k16 with 16-bit inputs and
// fp32 accumulators), the shared-memory tile layout and the products on it.
// The 16-bit type T (__nv_bfloat16 or __half) is a template parameter of the
// products and of the roundings to T; the tiles and ldmatrix are type-blind.
//
// A tile holds R token rows of one head's D 16-bit values as 16-byte chunks.
// Chunk c of row r is stored at c ^ swizzle(r), so that the eight row
// addresses of an ldmatrix, and a warp's cp.async writes, fall in distinct
// banks: swizzle(r) = r % 8 for rows of 8 or 16 chunks (D = 64, 128), and
// (r / 2) % 4 for rows of 4 chunks (D = 32), whose eight consecutive rows
// span two 128-byte lines. Every block has kThreads threads, 4 warps that
// own 16 rows of a 64-row tile each.
#pragma once

#include "common.cuh"

namespace cxr {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most one committed group (the tile in flight) is pending
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, T, row-major) b (16 x 8, T, col-major)
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// reductions over the four threads of a quad, which hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the grid -------------------------------------------------------------

// A block is (64-token block, head, batch row) = (blockIdx.x, .y, .z), read
// from the special registers wherever they are needed. gridDim.z takes at
// most 65535, so an entry point launches a batch in chunks of at most that
// many rows (for_batch_chunks), each with its operands offset to the
// chunk's first row.
constexpr int kHeadBlock = 64;   // tokens of a block
constexpr int kMaxSeq = 512;     // sequence bound (MAX_SEQ_LEN in ops/flash_attention.py)
constexpr int kMaxGridZ = 65535;

inline dim3 head_grid(int rows, int N, int H) {
  return dim3((N + kHeadBlock - 1) / kHeadBlock, H, rows);
}

// launch(b0, rows) for consecutive chunks [b0, b0 + rows) of B batch rows;
// stops at the first error
template <typename Launch>
inline cudaError_t for_batch_chunks(int B, Launch launch) {
  for (int b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const cudaError_t err = launch(b0, B - b0 < kMaxGridZ ? B - b0 : kMaxGridZ);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Head dims over 128 run in slices of kSlice columns (flash_attention.cu,
// flash_attention_bwd.cu): the contractions over D in chunks of kSlice
// columns, each block writing one kSlice-wide slice of its output.
constexpr int kSlice = 64;

// The blocks along gridDim.y of a head: one, or one per output slice.
inline int head_slices(int D) { return D > 128 ? D / kSlice : 1; }

// What every attention entry point refuses: N outside [1, 512], no batch
// row, heads (times slices) outside [1, 65535] (gridDim.y), a head dim that
// is neither 32, 64 nor 128 nor a multiple of kSlice over 128, a rate
// outside [0, 1).
inline bool bad_attention_args(int B, int N, int H, int D, float rate) {
  const bool built = D == 32 || D == 64 || D == 128 || (D > 128 && D % kSlice == 0);
  return N < 1 || N > kMaxSeq || B < 1 || H < 1 || !built ||
         (long long)H * head_slices(D) > kMaxGridZ || !(rate >= 0.f) || !(rate < 1.f);
}

// ---- tiles ------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * D * 2; }

template <int D>
__device__ __forceinline__ uint32_t chunk_at(int row, int chunk) {
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64 and 128");
  constexpr int C = D / 8;
  const int swizzle = C >= 8 ? (row & 7) : ((row >> 1) & 3);
  return (row * C + (chunk ^ swizzle)) * 16;
}

// tokens [t0, t0 + R) of one head's operand (token t at base + t * stride
// words) into a tile; tokens >= N are zero-filled and not read
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t tile, const uint32_t* base, long long stride,
                                          int t0, int N) {
  constexpr int C = D / 8;
  static_assert(R * C % kMmaThreads == 0, "a tile is whole 16-byte chunks for every thread");
#pragma unroll
  for (int it = 0; it < R * C / kMmaThreads; ++it) {
    const int idx = threadIdx.x + it * kMmaThreads;
    const int r = idx / C, c = idx % C, t = t0 + r;
    const bool ok = t < N;
    cp_async16(tile + chunk_at<D>(r, c), base + (ok ? t * stride : 0) + c * 4, ok);
  }
}

// A fragment of the 16 x 16 block at rows r0.., columns 16 ks.. of a tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t tile, int r0, int ks, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(tile + chunk_at<D>(r0 + (lane & 15), 2 * ks + (lane >> 4)), a);
}

// B fragments of two n8 tiles whose n index runs over the tile's rows
// n0..n0 + 15 and k over its columns 16 ks..: b[0], b[1] for rows n0..,
// b[2], b[3] for rows n0 + 8..
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t tile, int n0, int ks, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(tile + chunk_at<D>(n0 + ((lane >> 4) << 3) + (lane & 7), 2 * ks + ((lane >> 3) & 1)),
          b);
}

// B fragments of two n8 tiles whose k index runs over the tile's rows
// 16 kk..16 kk + 15 and n over its columns 16 p..: b[0], b[1] for columns
// 16 p.., b[2], b[3] for columns 16 p + 8..
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t tile, int kk, int p, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(tile + chunk_at<D>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                   2 * p + (lane >> 4)),
                b);
}

// acc (16 x 8 NT) += A[r0..r0 + 15, :] B^T, both tiles D wide; B's first
// 8 NT rows are the columns of acc
template <typename T, int D, int NT>
__device__ __forceinline__ void add_abt(float (&acc)[NT][4], uint32_t a_tile, int r0,
                                        uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    load_a<D>(a_tile, r0, ks, a);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t b[4];
      load_b_rows<D>(b_tile, 16 * p, ks, b);
      mma<T>(acc[2 * p], a, b[0], b[1]);
      mma<T>(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// acc (16 x 8 NT) = A[r0..r0 + 15, :] B^T
template <typename T, int D, int NT>
__device__ __forceinline__ void product_abt(float (&acc)[NT][4], uint32_t a_tile, int r0,
                                            uint32_t b_tile) {
  zero(acc);
  add_abt<T, D>(acc, a_tile, r0, b_tile);
}

// accumulators of a 16 x 16 KS product, rounded to T, as the A fragments of
// the next product (the C and A layouts of m16n8k16 line up)
template <typename T, int KS>
__device__ __forceinline__ void to_a(const float (&c)[2 * KS][4], uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    a[k][0] = pack2<T>(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack2<T>(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack2<T>(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack2<T>(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

// acc (16 x D) += A (16 x 16 KS, fragments) B, B the tile's first 16 KS rows
template <typename T, int D, int KS>
__device__ __forceinline__ void product_ab(float (&acc)[D / 8][4], const uint32_t (&a)[KS][4],
                                           uint32_t b_tile) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      uint32_t b[4];
      load_b_cols<D>(b_tile, k, p, b);
      mma<T>(acc[2 * p], a[k], b[0], b[1]);
      mma<T>(acc[2 * p + 1], a[k], b[2], b[3]);
    }
  }
}

// a warp's 16 x D accumulator, times mul and rounded to T, into its own 16
// rows of a tile, then from there to tokens t0.. (< N) of the output as
// 16-byte stores
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul,
                                           unsigned char* smem, uint32_t tile, int r0,
                                           uint32_t* out, long long stride, int t0, int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(smem + tile + chunk_at<D>(r0 + g, n) + 4 * qd) =
        pack2<T>(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(smem + tile + chunk_at<D>(r0 + g + 8, n) + 4 * qd) =
        pack2<T>(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int C = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * C / 32; ++it) {
    const int idx = lane + 32 * it;
    const int r = idx / C, c = idx % C, t = t0 + r;
    if (t < N)
      *reinterpret_cast<uint4*>(out + t * stride + c * 4) =
          *reinterpret_cast<const uint4*>(smem + tile + chunk_at<D>(r0 + r, c));
  }
}

}  // namespace cxr
