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
// for x [T, D] and w [E, D, F] (both float32 or both bfloat16; bfloat16 is
// converted to float32 on load), accumulated in float32 over the whole of
// D and written once as float32 [T, F]. A tile whose expert lies outside
// [0, E) is written as NaN, never read out of bounds (the wrapper checks a
// tile_expert it was handed from the host; the MoE layer builds it on the
// card from arange(E)).
//
// Grid. The TPU kernel walks (token tile, F block, D block) in order and
// carries the sum over D blocks in VMEM scratch. Here one thread block owns
// one (BM-row tile, 128-column tile) of the output and loops over D itself
// (tile_gemm.cuh): blocks share nothing, use no atomics and write their
// tile once, so the result is deterministic. BM is the largest of 128, 64,
// 32, 16, 8 that divides tm, so a block never straddles two experts: the
// MoE prefill runs tm = BM = 128, decode tm = BM = 8. blockIdx.x walks the
// row tiles, so neighbouring blocks share an expert and meet its weight
// columns in L2.
//
// What bounds it. At the MoE prefill's shape (T = 128 experts x 640 slots,
// D = 2048, F = 768) a launch is 257.7 GFLOP on 1 GB of operands: far
// above the card's ridge point, so the bound is the arithmetic (0.26 ms at
// the bf16 tensor-core peak). This first kernel does it with float32 FMAs
// only (67 TFLOP/s peak outside the tensor cores) from shared memory, 8 x 8
// outputs per thread at BM = 128. At decode (tm = 8, a few live rows per
// expert) every expert's whole weight is read for 8 rows each, so there the
// bound is the bytes of w. mma.sync / wgmma on bf16, TMA loads and skipping
// empty capacity slots are later work.
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

template <typename T, int BM>
cudaError_t launch(const void* x, const void* w, const void* tile_expert, void* out,
                   int t, int d, int f, int e, int tm, cudaStream_t stream) {
  const dim3 grid(t / BM, (f + kBN - 1) / kBN);
  moe_gmm_kernel<T, BM><<<grid, Tile<BM>::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(tile_expert), static_cast<float*>(out), t, d, f, e, tm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* tile_expert, void* out,
                     int t, int d, int f, int e, int tm, cudaStream_t stream) {
  if (tm % 128 == 0) return launch<T, 128>(x, w, tile_expert, out, t, d, f, e, tm, stream);
  if (tm % 64 == 0) return launch<T, 64>(x, w, tile_expert, out, t, d, f, e, tm, stream);
  if (tm % 32 == 0) return launch<T, 32>(x, w, tile_expert, out, t, d, f, e, tm, stream);
  if (tm % 16 == 0) return launch<T, 16>(x, w, tile_expert, out, t, d, f, e, tm, stream);
  return launch<T, 8>(x, w, tile_expert, out, t, d, f, e, tm, stream);
}

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (x and w alike); x [t, d], w [e, d, f],
// tile_expert int32 [t / tm], out float32 [t, f], all contiguous and
// 16-byte aligned. Needs tm a multiple of 8 dividing t, d a multiple of 16
// and f a multiple of 4.
extern "C" int moe_gmm_launch(const void* x, const void* w, const void* tile_expert,
                              void* out, int dtype, int t, int d, int f, int e, int tm,
                              void* stream) {
  if (tm < 8 || tm % 8 || t < tm || t % tm || d < 16 || d % 16 || f < 4 || f % 4 ||
      e < 1 || (f + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(x, w, tile_expert, out, t, d, f, e, tm, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, w, tile_expert, out, t, d, f, e, tm, s);
  return (int)cudaErrorInvalidValue;
}
