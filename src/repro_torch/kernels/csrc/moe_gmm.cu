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
// D = 2048, F = 768) a launch is 257.7 GFLOP on 1 GB of operands: at an
// H100's peaks (989 TFLOP/s bf16, 3.35 TB/s) 0.26 ms of tensor-core work
// against 0.30 ms of bytes, so both limits are near. At decode (tm = 8, a few live rows per expert) every expert's whole
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
// tokens and walks D in steps of 64 through the ring of sm90.cuh (3 to 5
// shared-memory stages, about 96 KB), shared with the block-sparse SpMM:
// one producer thread fills each stage by TMA with 64 x 64 boxes of w (A,
// MN-major: w is F-contiguous) and a 64 x BN box of x (B, K-major), both
// 128-byte swizzled, and signals an mbarrier; the consumers run four
// m64nBNk16 wgmmas per stage and free a stage once the next stage's
// wgmmas have started. TMA zero-fills the ragged edges of D and F; w is a
// 3-D tensor map [E, D, F], so a D edge never reads the next expert. TMA needs 16-byte strides, so w's rows are padded to a multiple
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

// -- bfloat16: wgmma fed by TMA (the ring of sm90.cuh) -------------------------

constexpr int kBF = 128;  // F columns per block: two consumer warpgroups of 64

template <int BN>
__global__ void __launch_bounds__(sm90::kRingThreads, 2)
moe_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const int* __restrict__ tile_expert, float* __restrict__ out,
                     int d, int f, int e, int tm, int n_ftiles) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int f0 = (blockIdx.x % n_ftiles) * kBF;
  const int row0 = (blockIdx.x / n_ftiles) * BN;
  const int ex = tile_expert[row0 / tm];
  const int wg = tid / 128;
  // Warpgroup wg's output: F columns f0 + 64 wg .. + 63 of BN token rows.
  float* const o = out + (size_t)row0 * f + f0 + 64 * wg;

  if (ex < 0 || ex >= e) {
    if (tid < sm90::kRingConsumers) {
      float nans[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) nans[i] = __int_as_float(0x7fc00000);
      sm90::store_transposed<BN>(o, f, BN, f - f0 - 64 * wg, nans);
    }
    return;
  }

  const int nk = (d + sm90::kRingDepth - 1) / sm90::kRingDepth;
  const int halves = f - f0 > 64 ? 2 : 1;  // 64-row halves of the F tile inside F
  const sm90::RingAddr r = sm90::ring_setup<BN>(smem_raw);

  if (tid >= sm90::kRingConsumers) {
    if (tid == sm90::kRingConsumers) {
      sm90::tma_prefetch_map(&x_map);
      sm90::tma_prefetch_map(&w_map);
      const uint32_t bytes = halves * sm90::kRingABytes + sm90::Ring<BN>::kBBytes;
      sm90::ring_produce<BN>(r, nk, bytes, [&](int kt, uint32_t stage, uint32_t bar) {
        const int k0 = kt * sm90::kRingDepth;
        sm90::tma_load_3d(stage, &w_map, bar, f0, k0, ex);
        if (halves > 1) sm90::tma_load_3d(stage + sm90::kRingABytes, &w_map, bar, f0 + 64, k0, ex);
        sm90::tma_load_2d(stage + 2 * sm90::kRingABytes, &x_map, bar, k0, row0);
      });
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  sm90::fence_regs(acc);
  sm90::ring_consume<BN>(r, nk, wg < halves, wg, acc);
  sm90::store_transposed<BN>(o, f, BN, f - f0 - 64 * wg, acc);
}

// Tensor maps of x [t, d] (boxes of 64 d x bn tokens) and w [e, d, fw]
// (boxes of 64 f x 64 d x 1 expert).
cudaError_t encode_maps(CUtensorMap* xm, CUtensorMap* wm, const void* x, const void* w, int t,
                        int d, int fw, int e, int bn) {
  const cuuint64_t xdim[2] = {(cuuint64_t)d, (cuuint64_t)t};
  const cuuint64_t xstride[1] = {(cuuint64_t)d * 2};
  const cuuint32_t xbox[2] = {(cuuint32_t)sm90::kRingDepth, (cuuint32_t)bn};
  cudaError_t err = sm90::encode_bf16_map(xm, x, 2, xdim, xstride, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdim[3] = {(cuuint64_t)fw, (cuuint64_t)d, (cuuint64_t)e};
  const cuuint64_t wstride[2] = {(cuuint64_t)fw * 2, (cuuint64_t)d * fw * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)sm90::kRingDepth, 1};
  return sm90::encode_bf16_map(wm, w, 3, wdim, wstride, wbox);
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
  using R = sm90::Ring<BN>;
  CUtensorMap xm, wm;
  cudaError_t err = encode_maps(&xm, &wm, x, w, t, d, padded_f(f), e, BN);
  if (err != cudaSuccess) return err;
  auto kernel = moe_gmm_wgmma_kernel<BN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_ftiles = (f + kBF - 1) / kBF;
  const long long blocks = (long long)n_ftiles * (t / BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, sm90::kRingThreads, R::kSmemBytes, stream>>>(
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
    case 128: return sm90::Ring<128>::kSmemBytes;
    case 64: return sm90::Ring<64>::kSmemBytes;
    case 32: return sm90::Ring<32>::kSmemBytes;
    case 16: return sm90::Ring<16>::kSmemBytes;
    default: return sm90::Ring<8>::kSmemBytes;
  }
}
