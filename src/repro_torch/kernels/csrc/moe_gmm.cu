// Grouped (expert) matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py::moe_gmm (_kernel).
// Plain version: repro_torch/kernels/ref.py::moe_gmm_ref.
//
// What it computes. Tokens sorted by expert, in tiles of tm rows that each
// belong to one expert:
//
//     out[i*tm : (i+1)*tm, :] = x[i*tm : (i+1)*tm, :] @ w[tile_expert[i]]
//
// for x [T, D] and w [E, D, F] (both float32 or both bfloat16), summed in
// float32 over the whole of D and written once as float32 [T, F]. A tile
// whose expert lies outside [0, E) is written as NaN, never read out of
// bounds (the wrapper checks a tile_expert it was handed from the host;
// the MoE layer builds it on the card from arange(E)).
//
// Two kernels, chosen by the type of the operands (a static rule, no
// fallback): float32 runs on float32 FMAs (tile_gemm.cuh), since float32
// parity at 1e-4 rules out TF32; bfloat16 runs on the tensor cores
// (wgmma), where bf16 x bf16 products are exact in float32 and only the
// order of the sums differs.
//
// What bounds it. At the MoE prefill's shape (T = 128 experts x 640 slots,
// D = 2048, F = 768) a launch is 257.7 GFLOP on 1 GB of operands: 0.26 ms
// of bf16 tensor-core work against 0.30 ms of bytes, so both limits are
// near. At decode (tm = 8, a few live rows per expert) every expert's whole
// weight (403 MB for gate/up) is read for 8 rows: the bytes of w bound it.
//
// Float32 (moe_gmm_kernel). One thread block owns one (BM-row tile,
// 128-column tile) of the output and loops over D itself (tile_gemm.cuh):
// float32 FMAs from shared memory, 8 x 8 outputs per thread. BM is the
// largest of 128, 64, 32, 16, 8 that divides tm, so a block never
// straddles two experts. blockIdx.x walks the row tiles.
//
// Bfloat16 (moe_gmm_wgmma_kernel). The product is computed transposed,
// out[tile]^T = w_e^T . x[tile]^T, so that wgmma's 64-row M runs over F and
// its N over the tile's tokens: N = BN, the largest of 128, 64, 32, 16, 8
// dividing tm, covers the prefill (tm 128) and decode (tm 8) alike. A
// block owns 128 columns of F (two consumer warpgroups of 64) by BN
// tokens and walks D in steps of 64 through a ring of shared-memory stages
// (3 to 5, about 96 KB): one producer thread fills each stage by TMA with
// 64 x 64 boxes of w (A, MN-major: w is F-contiguous) and a 64 x BN box of
// x (B, K-major), both 128-byte swizzled, and signals an mbarrier; the
// consumers run four m64nBNk16 wgmmas per stage and free a stage once the
// next stage's wgmmas are issued. TMA zero-fills the ragged edges of D and
// F; w is a 3-D tensor map [E, D, F], so a D edge never reads the next
// expert. TMA needs 16-byte strides, so w's rows are padded to a multiple
// of 8 values (the wrapper pads w when F % 8 != 0; no model shape does).
// The epilogue writes out[t, f] from the accumulator fragments: each store
// instruction fills four whole 32-byte sectors. Blocks share nothing and
// use no atomics, so the result is deterministic. blockIdx.x walks the F
// tiles first, then the token tiles: neighbouring blocks share a tile of x
// and an expert's weight, both met in L2. The tensor maps are encoded on
// the host at every launch (cuTensorMapEncodeTiled, through
// cudaGetDriverEntryPoint: the library is not linked against libcuda).
// Skipping empty capacity slots (the reference multiplies them) is later
// work.
#include <climits>

#include "sm90.cuh"
#include "tile_gemm.cuh"

namespace {

using tile_gemm::kBN;
using tile_gemm::Tile;

template <typename T, int BM>
__global__ void __launch_bounds__(Tile<BM>::kThreads)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ tile_expert, float* __restrict__ out,
               int t, int d, int f, int e, int tm) {
  __shared__ tile_gemm::Smem<BM> sm;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * kBN;
  const int ex = tile_expert[row0 / tm];
  float acc[Tile<BM>::kRM][8];
#pragma unroll
  for (int i = 0; i < Tile<BM>::kRM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  if (ex < 0 || ex >= e) {
#pragma unroll
    for (int i = 0; i < Tile<BM>::kRM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __int_as_float(0x7fc00000);
  } else {
    tile_gemm::Segment<T> s{x + (size_t)row0 * d, d, t - row0,
                            w + (size_t)ex * d * f + col0, f, f - col0, d};
    tile_gemm::accumulate<T, BM>(sm, s, acc);
  }
  tile_gemm::store<BM>(out + (size_t)row0 * f + col0, f, t - row0, f - col0, acc);
}

template <int BM>
cudaError_t launch_f32(const void* x, const void* w, const void* tile_expert, void* out,
                       int t, int d, int f, int e, int tm, cudaStream_t stream) {
  if ((f + kBN - 1) / kBN > 65535) return cudaErrorInvalidValue;
  const dim3 grid(t / BM, (f + kBN - 1) / kBN);
  moe_gmm_kernel<float, BM><<<grid, Tile<BM>::kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(tile_expert), static_cast<float*>(out), t, d, f, e, tm);
  return cudaGetLastError();
}

// -- bfloat16: wgmma fed by TMA ------------------------------------------------

constexpr int kBF = 128;                      // F columns per block
constexpr int kBD = 64;                       // D per stage: one 128-byte row
constexpr int kConsumers = 256;               // two warpgroups of 64 F rows each
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr int kWHalfBytes = 64 * kBD * 2;     // one 64 f x 64 d box of w

template <int BN>
struct Ring {
  static constexpr int kXBytes = BN * kBD * 2;  // BN rows of 128 bytes
  static constexpr int kStageBytes = 2 * kWHalfBytes + kXBytes;
  static constexpr int kFit = 98304 / kStageBytes;
  static constexpr int kStages = kFit < 3 ? 3 : (kFit > 5 ? 5 : kFit);
  // 1024 bytes of slack to align the ring to a swizzle atom, then the
  // ring, then a full and an empty mbarrier per stage.
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// The accumulator fragments of one consumer warpgroup (64 F rows from
// fbase, BN tokens from row0) into out [*, f]: element (r, c) of the
// transposed tile is out[row0 + c, fbase + r].
template <int BN>
__device__ __forceinline__ void store_transposed(float* __restrict__ out, const float (&acc)[BN / 2],
                                                 int row0, int fbase, int f) {
  const int lane = threadIdx.x % 32;
  const int fr = fbase + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float* p = out + (size_t)(row0 + 8 * j + 2 * (lane % 4)) * f;
    if (fr < f) {
      p[fr] = acc[4 * j];
      p[f + fr] = acc[4 * j + 1];
    }
    if (fr + 8 < f) {
      p[fr + 8] = acc[4 * j + 2];
      p[f + fr + 8] = acc[4 * j + 3];
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
moe_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const int* __restrict__ tile_expert, float* __restrict__ out,
                     int d, int f, int e, int tm, int n_ftiles) {
  using R = Ring<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + R::kStages * R::kStageBytes;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * R::kStages;               // empty[s] at empty + 8 s

  const int tid = threadIdx.x;
  const int f0 = (blockIdx.x % n_ftiles) * kBF;
  const int row0 = (blockIdx.x / n_ftiles) * BN;
  const int ex = tile_expert[row0 / tm];
  const int wg = tid / 128;

  if (ex < 0 || ex >= e) {
    if (tid < kConsumers) {
      float nans[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) nans[i] = __int_as_float(0x7fc00000);
      store_transposed<BN>(out, nans, row0, f0 + 64 * wg, f);
    }
    return;
  }

  const int nk = (d + kBD - 1) / kBD;
  const int halves = f - f0 > 64 ? 2 : 1;  // 64-row halves of the F tile inside F
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one thread keeps the ring full.
    if (tid == kConsumers) {
      sm90::tma_prefetch_map(&x_map);
      sm90::tma_prefetch_map(&w_map);
      const uint32_t bytes = halves * kWHalfBytes + R::kXBytes;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % R::kStages;
        const uint32_t stage = ring + s * R::kStageBytes;
        sm90::mbar_wait(empty + 8 * s, ((kt / R::kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full + 8 * s, bytes);
        sm90::tma_load_3d(stage, &w_map, full + 8 * s, f0, kt * kBD, ex);
        if (halves > 1)
          sm90::tma_load_3d(stage + kWHalfBytes, &w_map, full + 8 * s, f0 + 64, kt * kBD, ex);
        sm90::tma_load_2d(stage + 2 * kWHalfBytes, &x_map, full + 8 * s, kt * kBD, row0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns F rows f0 + 64 wg .. + 63 (none if past F).
  const bool active = wg < halves;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  sm90::fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % R::kStages;
    sm90::mbar_wait(full + 8 * s, (kt / R::kStages) & 1);
    if (active) {
      const uint32_t a = ring + s * R::kStageBytes + wg * kWHalfBytes;
      const uint32_t b = ring + s * R::kStageBytes + 2 * kWHalfBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBD / 16; ++kk) {
        // A: 16 d rows of 128 bytes further; B: 16 d values (32 bytes)
        // further along each token's row.
        sm90::Wgmma<BN>::mma(acc, sm90::sw128_desc(a + kk * 2048, 1024, 1024),
                             sm90::sw128_desc(b + kk * 32, 16, 1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous stage's wgmmas are done
    }
    if (kt > 0) sm90::mbar_arrive(empty + 8 * ((kt - 1) % R::kStages));
  }
  if (active) sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  store_transposed<BN>(out, acc, row0, f0 + 64 * wg, f);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once at run time.
EncodeTiledFn encode_tiled() {
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

// Tensor maps of x [t, d] (boxes of 64 d x bn tokens) and w [e, d, fw]
// (boxes of 64 f x 64 d x 1 expert), bf16, 128-byte swizzle, zero fill.
cudaError_t encode_maps(CUtensorMap* xm, CUtensorMap* wm, const void* x, const void* w, int t,
                        int d, int fw, int e, int bn) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t xdim[2] = {(cuuint64_t)d, (cuuint64_t)t};
  const cuuint64_t xstride[1] = {(cuuint64_t)d * 2};
  const cuuint32_t xbox[2] = {(cuuint32_t)kBD, (cuuint32_t)bn};
  if (enc(xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xdim, xstride, xbox,
          ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wdim[3] = {(cuuint64_t)fw, (cuuint64_t)d, (cuuint64_t)e};
  const cuuint64_t wstride[2] = {(cuuint64_t)fw * 2, (cuuint64_t)d * fw * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)kBD, 1};
  if (enc(wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), wdim, wstride, wbox,
          ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

int padded_f(int f) { return (f + 7) / 8 * 8; }

// The row tile: the largest of 128, 64, 32, 16, 8 that divides tm.
int row_tile(int tm) {
  int bn = 128;
  while (tm % bn) bn /= 2;
  return bn;
}

template <int BN>
cudaError_t launch_bf16(const void* x, const void* w, const void* tile_expert, void* out,
                        int t, int d, int f, int e, int tm, cudaStream_t stream) {
  using R = Ring<BN>;
  CUtensorMap xm, wm;
  cudaError_t err = encode_maps(&xm, &wm, x, w, t, d, padded_f(f), e, BN);
  if (err != cudaSuccess) return err;
  auto kernel = moe_gmm_wgmma_kernel<BN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_ftiles = (f + kBF - 1) / kBF;
  const long long blocks = (long long)n_ftiles * (t / BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, R::kSmemBytes, stream>>>(
      xm, wm, static_cast<const int*>(tile_expert), static_cast<float*>(out), d, f, e, tm,
      n_ftiles);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*, int, int, int, int,
                               int, cudaStream_t);

Launch pick(int dtype, int tm) {
  const bool f32 = dtype == 0;
  switch (row_tile(tm)) {
    case 128:
      if (f32) return launch_f32<128>;
      return launch_bf16<128>;
    case 64:
      if (f32) return launch_f32<64>;
      return launch_bf16<64>;
    case 32:
      if (f32) return launch_f32<32>;
      return launch_bf16<32>;
    case 16:
      if (f32) return launch_f32<16>;
      return launch_bf16<16>;
    default:
      if (f32) return launch_f32<8>;
      return launch_bf16<8>;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel); x [t, d],
// w [e, d, f] for float32 and [e, d, f rounded up to a multiple of 8] for
// bfloat16 (the columns past f are never written out), tile_expert int32
// [t / tm], out float32 [t, f], all contiguous and 16-byte aligned. Needs
// tm a multiple of 8 dividing t, d a multiple of 16 and f a multiple of 4.
extern "C" int moe_gmm_launch(const void* x, const void* w, const void* tile_expert,
                              void* out, int dtype, int t, int d, int f, int e, int tm,
                              void* stream) {
  if (tm < 8 || tm % 8 || t < tm || t % tm || d < 16 || d % 16 || f < 4 || f % 4 ||
      e < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)pick(dtype, tm)(x, w, tile_expert, out, t, d, f, e, tm,
                              static_cast<cudaStream_t>(stream));
}

// Encodes the bfloat16 kernel's two tensor maps `reps` times, as every
// launch does (for timing that host cost); returns a cudaError_t.
extern "C" int moe_gmm_encode_maps(const void* x, const void* w, int t, int d, int f, int e,
                                   int tm, int reps) {
  if (tm < 8 || tm % 8 || d % 16 || f % 4) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  for (int i = 0; i < reps; ++i) {
    const cudaError_t err = encode_maps(&xm, &wm, x, w, t, d, padded_f(f), e, row_tile(tm));
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Dynamic shared memory (bytes) a launch of the given type and tm asks for:
// the bfloat16 kernel's ring; the float32 kernel uses static memory only.
extern "C" int moe_gmm_smem_bytes(int dtype, int tm) {
  if (dtype != 1 || tm < 8 || tm % 8) return 0;
  switch (row_tile(tm)) {
    case 128: return Ring<128>::kSmemBytes;
    case 64: return Ring<64>::kSmemBytes;
    case 32: return Ring<32>::kSmemBytes;
    case 16: return Ring<16>::kSmemBytes;
    default: return Ring<8>::kSmemBytes;
  }
}
