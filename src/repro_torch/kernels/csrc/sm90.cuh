// Hopper (sm_90a) building blocks written in PTX: mbarriers, TMA tile
// loads and wgmma, and the producer/consumer ring built from them that the
// bfloat16 paths of the grouped matmul (moe_gmm.cu, K4) and the
// block-sparse SpMM (bsr_spmm.cu, K3) share.
//
// Conventions:
// - Shared-memory addresses are 32-bit offsets in the shared window
//   (smem_u32).
// - Every operand tile is stored with the 128-byte swizzle: rows of 128
//   bytes (64 bf16 values), eight rows forming a 1024-byte atom in which
//   16-byte chunk c of row r sits at chunk c ^ (r % 8). TMA writes that
//   layout when its tensor map asks for CU_TENSOR_MAP_SWIZZLE_128B, and the
//   wgmma descriptors below read it (layout type 1). Atoms start on
//   1024-byte boundaries.
// - Wgmma<N>::mma adds A . B into a 64 x N float32 accumulator, with A
//   (64 x 16) MN-major (64 consecutive M values per 128-byte row, one row
//   per k) and B (16 x N) K-major (one 128-byte row of k values per n).
//
// The ring (ring_setup, ring_produce, ring_consume, store_transposed). A
// thread block of kRingThreads computes a transposed output tile
// out^T [128, BN] = A^T [128, K] . B^T [K, BN] as a sum over stages, each
// 64 deep along the summed axis. Two consumer warpgroups own 64 rows of
// out^T each (wgmma's M); one producer thread keeps a ring of kStages
// shared-memory stages full by TMA: per stage, one 64 x 64 box of A for
// each consumer warpgroup that has rows (A MN-major, 8 KB each) and one
// 64-deep box of B for BN columns (K-major, BN rows of 128 bytes). A full
// mbarrier per stage completes on the stage's TMA bytes; an empty one on
// the 256 consumer threads' arrivals. Consumers start a stage's four
// m64nBNk16 wgmmas, then wait until the previous stage's are done and free
// that one, so loads of up to kStages - 1 stages overlap the tensor cores.
// The ring holds about 96 KB, so two blocks share an SM (192 KB and one
// block for a 256-column tile). The epilogue
// writes the accumulator fragments straight to global memory, masked to
// the rows and columns in range; no block shares an output element with
// another, so there are no atomics and the result is deterministic.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives once and expects `bytes` more from the copies that complete on it.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0: waiting on parity 1 passes at once, on parity 0 blocks
// until the first phase completes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// -- TMA ---------------------------------------------------------------------

// One tile of a 2-D tensor map at (c0 innermost, c1) into shared memory at
// `dst`; completes `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// For a K-major operand the stride byte offset steps over eight rows (one
// atom) and the leading one is unused; for an MN-major operand of 64 MN
// values the stride byte offset steps over eight k rows and the leading one
// (the step between 64-wide MN blocks) is unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t desc = (uint64_t)((addr & 0x3FFFF) >> 4);
  desc |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  desc |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  desc |= (uint64_t)1 << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the point where it is called (the wgmma writes them asynchronously).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, float32, in registers) += A (64 x 16 bf16, MN-major, from
// descriptor a) . B (16 x N bf16, K-major, from descriptor b). The
// accumulator layout: thread t of the warpgroup holds, for each n-block j
// of 8, d[4j + 0..3] = D[r][c], D[r][c+1], D[r+8][c], D[r+8][c+1] with
// r = 16 * (t / 32) + (t % 32) / 4 and c = 8j + 2 * (t % 4).
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// -- tensor maps -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once at run time (the
// libraries are not linked against libcuda).
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first; byte strides of
// dimensions 1.. in `stride`), boxes of `box`, 128-byte swizzle, zero fill
// outside the tensor.
inline cudaError_t encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                                   const cuuint64_t* dim, const cuuint64_t* stride,
                                   const cuuint32_t* box) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base), dim,
          stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// -- the ring --------------------------------------------------------------

constexpr int kRingDepth = 64;                    // summed axis per stage: one 128-byte row
constexpr int kRingConsumers = 256;               // two warpgroups of 64 output rows each
constexpr int kRingThreads = kRingConsumers + 32; // and one producer warp
constexpr int kRingABytes = 64 * kRingDepth * 2;  // one 64 x 64 box of A

// BN up to 128 keeps the ring near 96 KB, so that two blocks share an SM;
// BN = 256 (128 accumulators per consumer thread) leaves registers for one
// block per SM, whose ring then takes four stages, 192 KB.
template <int BN>
struct Ring {
  static constexpr int kBBytes = BN * kRingDepth * 2;  // BN rows of 128 bytes
  static constexpr int kStageBytes = 2 * kRingABytes + kBBytes;
  static constexpr int kBlocksPerSm = BN > 128 ? 1 : 2;
  static constexpr int kFit = 196608 / kBlocksPerSm / kStageBytes;
  static constexpr int kStages = kFit < 3 ? 3 : (kFit > 5 ? 5 : kFit);
  // 1024 bytes of slack to align the ring to a swizzle atom, then the
  // ring, then a full and an empty mbarrier per stage.
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// Shared-memory addresses of a block's ring: stage s at ring + s *
// kStageBytes (A boxes first, then B), full[s] at full + 8 s, empty[s] at
// empty + 8 s.
struct RingAddr {
  uint32_t ring, full, empty;
};

// Aligns the ring in the block's dynamic shared memory and initialises its
// barriers; every thread of the block calls it (it ends with a barrier).
template <int BN>
__device__ __forceinline__ RingAddr ring_setup(const uint8_t* smem_raw) {
  using R = Ring<BN>;
  RingAddr r;
  r.ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  r.full = r.ring + R::kStages * R::kStageBytes;
  r.empty = r.full + 8 * R::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, kRingConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// The producer thread: fills stages 0 .. n-1 in turn, each once its slot
// is free, announcing `bytes` per stage; load(i, stage, full_bar) starts
// stage i's TMA copies (their bytes must add up to `bytes`, or the
// consumers wait forever).
template <int BN, typename Load>
__device__ __forceinline__ void ring_produce(const RingAddr& r, int n, uint32_t bytes,
                                             Load&& load) {
  using R = Ring<BN>;
  for (int i = 0; i < n; ++i) {
    const int s = i % R::kStages;
    mbar_wait(r.empty + 8 * s, ((i / R::kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(r.full + 8 * s, bytes);
    load(i, r.ring + s * R::kStageBytes, r.full + 8 * s);
  }
}

// The consumer warpgroups (threads 0 .. 255): acc += the stages' products
// for warpgroup wg's 64 rows, if `active` (a warpgroup whose rows lie
// outside the output takes part in the barriers only).
template <int BN>
__device__ __forceinline__ void ring_consume(const RingAddr& r, int n, bool active, int wg,
                                             float (&acc)[BN / 2]) {
  using R = Ring<BN>;
  for (int i = 0; i < n; ++i) {
    const int s = i % R::kStages;
    mbar_wait(r.full + 8 * s, (i / R::kStages) & 1);
    if (active) {
      const uint32_t a = r.ring + s * R::kStageBytes + wg * kRingABytes;
      const uint32_t b = r.ring + s * R::kStageBytes + 2 * kRingABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRingDepth / 16; ++kk) {
        // A: 16 rows of 128 bytes further; B: 16 values (32 bytes)
        // further along each row.
        Wgmma<BN>::mma(acc, sw128_desc(a + kk * 2048, 1024, 1024),
                       sw128_desc(b + kk * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas are done
    }
    if (i > 0) mbar_arrive(r.empty + 8 * ((i - 1) % R::kStages));
  }
  if (active) wgmma_wait<0>();
  fence_regs(acc);
}

// Writes one consumer warpgroup's accumulator fragments: element (i, c) of
// its transposed tile (i < 64 its row, c < BN its column) goes to
// out[c * ld + i], where c < rows and i < cols.
template <int BN>
__device__ __forceinline__ void store_transposed(float* __restrict__ out, int ld, int rows,
                                                 int cols, const float (&acc)[BN / 2]) {
  const int lane = threadIdx.x % 32;
  const int i = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    float* p = out + (size_t)c * ld;
    if (i < cols) {
      if (c < rows) p[i] = acc[4 * j];
      if (c + 1 < rows) p[ld + i] = acc[4 * j + 1];
    }
    if (i + 8 < cols) {
      if (c < rows) p[i + 8] = acc[4 * j + 2];
      if (c + 1 < rows) p[ld + i + 8] = acc[4 * j + 3];
    }
  }
}

}  // namespace sm90
