// Hopper's asynchronous tensor-core path, shared by the MLP kernels that run
// on it (B8: mlp_train_bwd.cu; B4 and B9 through mlp_fwd.cuh): TMA tensor
// maps and loads into shared memory, mbarriers that tell a consumer a stage
// has landed and a producer a stage is free again, wgmma.mma_async on
// operands read from shared memory through matrix descriptors, and the ring
// that ties them together: one producer warp keeps TMA loads of whole
// k-steps in flight through STAGES stages while two consumer warpgroups of
// 64 rows run wgmma on the stages that have landed. All of it is inline
// PTX, as mma_tiles.cuh is for mma.sync; every kernel that includes it is
// built for sm_90a (wgmma exists for that target only).
//
// Tiles. Every operand is bf16 and reaches shared memory as TMA boxes with
// the 128-byte swizzle: a box row is 64 values (128 bytes), and each group
// of 8 rows (1024 bytes) is one swizzle atom, so every box starts on a
// 1024-byte boundary.
//   - K-major (the contraction dim contiguous in device memory): a box of R
//     rows x 64 k. The descriptor's stride byte offset is one atom (1024 B);
//     a k16 step inside the 64-wide box moves the start address by 32 bytes.
//   - N-major (the output dim contiguous, as W2 is for dy W2 and W1 for
//     dh W1): boxes of 64 k-rows x 64 columns, one box per 64 columns, read
//     with wgmma's transpose bit. The stride byte offset (between groups of
//     8 k-rows) is one atom, the leading byte offset the distance between
//     the 64-column boxes; a k16 step moves the start address by 16 rows,
//     2048 bytes.
//
// The host encodes each tensor map with libcuda's cuTensorMapEncodeTiled,
// reached through the runtime's cudaGetDriverEntryPoint, so the library
// needs no link against libcuda; the map travels to the kernel by value as a
// __grid_constant__ parameter.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace cxr {

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled lookup_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiled>(fn)
             : nullptr;
}

// A row-major bf16 matrix [outer, inner] as boxes of box_outer rows x 64
// values with the 128-byte swizzle; boxes past the matrix's edges are
// zero-filled by the load. inner must be a multiple of 8 (16-byte rows) and
// the data 16-byte aligned.
inline cudaError_t bf16_tensor_map(CUtensorMap* map, const void* data, uint64_t inner,
                                   uint64_t outer, uint32_t box_outer) {
  static const EncodeTiled encode = lookup_encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {64, box_outer};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(data),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device: mbarriers and TMA ---------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// make the initialized barriers visible to the async proxy (TMA) before use
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// spin until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive, and expect ``bytes`` more from the copies that complete on ``bar``
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// the box of ``map`` at (inner coordinate c0, outer coordinate c1) into
// shared memory at ``dst``; its bytes complete on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- device: wgmma ------------------------------------------------------------

// matrix descriptors of a 128-byte-swizzled tile at shared address ``addr``
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return ((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_n_major(uint32_t addr, uint32_t box_bytes) {
  return ((addr & 0x3FFFFu) >> 4) | ((uint64_t)(box_bytes >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of the accumulators across
// this point (wgmma writes them asynchronously, behind its back)
__device__ __forceinline__ void fence_accumulators(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32, the warpgroup's registers) += A (64 x 16) B (16 x 128),
// bf16 from shared memory; TransB = 1 reads B N-major. Accumulator i of a
// thread (warp w, lane l) is row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2: mma.sync's C layout over 16 n8 tiles.
template <int TransB>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TransB));
}

// ---- device: the producer/consumer ring ---------------------------------------

// The block of every kernel on the ring: two consumer warpgroups, then one
// producer warp; its output tile is kRows x kCols, its k-steps kK wide.
constexpr int kConsumerThreads = 256;
constexpr int kRingThreads = kConsumerThreads + 32;
constexpr int kRows = 128;  // rows of a block tile: two consumer warpgroups of 64
constexpr int kCols = 128;  // output columns of a block tile
constexpr int kK = 64;      // k-step: one 128-byte swizzle row of bf16
constexpr uint32_t kBox = kRows * kK * 2;  // a K-major box, 128 rows x 64 k: 16 KB
constexpr uint32_t kWarpgroupRows = 64 * kK * 2;  // a consumer's 64 rows of a K-major box

// dynamic shared memory of a ring: stages, barriers, alignment
template <int STAGES, uint32_t STAGE>
constexpr size_t ring_smem_bytes() {
  return (size_t)STAGES * STAGE + 2 * STAGES * 8 + 1024;
}

// The ring of a block: the 1024-byte aligned base of its stages, and a full
// and an empty barrier a stage after them.
template <int STAGES, uint32_t STAGE>
struct Ring {
  uint32_t base;
  __device__ uint32_t stage(int s) const { return base + s * STAGE; }
  __device__ uint32_t full(int s) const { return base + STAGES * STAGE + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + STAGES * STAGE + 8 * (STAGES + s); }

  // thread 0 initializes the barriers: the producer's expect_tx completes a
  // full barrier, one arrival of each consumer warpgroup an empty one
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), kConsumerThreads / 128);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
};

template <int STAGES, uint32_t STAGE>
__device__ Ring<STAGES, STAGE> make_ring(unsigned char* smem) {
  return {(smem_addr(smem) + 1023u) & ~1023u};
}

// The producer warp's lane 0: for each of nk k-steps, wait for a free stage,
// then load(stage address, its full barrier, k) issues that step's TMA
// copies of STAGE bytes in all.
template <int STAGES, uint32_t STAGE, typename Load>
__device__ __forceinline__ void produce(const Ring<STAGES, STAGE>& ring, int nk, Load load) {
  for (int k = 0, s = 0, phase = 0; k < nk; ++k) {
    mbar_wait(ring.empty(s), phase ^ 1);
    mbar_expect_tx(ring.full(s), STAGE);
    load(ring.stage(s), ring.full(s), k);
    if (++s == STAGES) s = 0, phase ^= 1;
  }
}

// A consumer warpgroup: for each of nk k-steps, wait for the stage, issue
// mma(stage address) (the step's wgmma instructions), commit them, and
// release the previous step's stage once its products are done. Returns with
// every product complete.
template <int STAGES, uint32_t STAGE, typename Mma>
__device__ __forceinline__ void consume(const Ring<STAGES, STAGE>& ring, int nk, Mma mma) {
  const bool leader = threadIdx.x % 128 == 0;
  int prev = 0;
  for (int k = 0, s = 0, phase = 0; k < nk; ++k) {
    mbar_wait(ring.full(s), phase);
    wgmma_fence();
    mma(ring.stage(s));
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products have read their stage
    if (k > 0 && leader) mbar_arrive(ring.empty(prev));
    prev = s;
    if (++s == STAGES) s = 0, phase ^= 1;
  }
  wgmma_wait<0>();
}

}  // namespace cxr
