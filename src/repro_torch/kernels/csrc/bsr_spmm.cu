// Block-sparse-weight matmul (SpMM) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bsr_spmm.py::bsr_spmm (_kernel).
// Plain version: repro_torch/kernels/ref.py::bsr_spmm_ref.
//
// What it computes. y [M, N] = x [M, K] @ W for a block-sparse W whose
// nonzero [bk, bn] blocks are stored column-panel-major (sorted by
// (bcol, brow), kernels/bsr_spmm.py::plan_bsr). Column panel p owns blocks
// panel_ptr[p] .. panel_ptr[p+1] - 1, and
//
//     y[:, p*bn : (p+1)*bn] = sum over those blocks t, in order, of
//                             x[:, brow[t]*bk : (brow[t]+1)*bk] @ blocks[t]
//
// accumulated in float32 and written once as float32. x and the blocks are
// both float32 or both bfloat16 (converted to float32 on load). A panel
// without blocks is written as zeros (the TPU kernel never visits it; the
// `ops` wrapper pads it with a zero block all the same, as the reference
// does).
//
// Grid. The TPU kernel walks (m tile, block) in order, resets its VMEM
// accumulator on a run's first block and writes it on the run's last (the
// first/last flags of plan_bsr). Here one thread block owns one (BM-row
// tile, column panel, 128-column slice of the panel) and walks the panel's
// run itself, from per-panel offsets the host derives from the sorted bcol
// (as core/schedule.py::panel_runs does for the Gustavson kernel): the
// accumulator stays in registers for the whole run, blocks share nothing,
// use no atomics and write their tile once, so the result is
// deterministic. Each block of the run is one segment of tile_gemm.cuh: x's
// [BM, bk] slab at column brow*bk against the [bk, 128] weight slab.
//
// What bounds it. At granite-3-2b's SparseLinear down projection (x 8192 x
// 8192 bf16, W 8192 x 2048 in 128 x 128 blocks at density 0.25, ~260
// blocks) a launch is ~70 GFLOP against ~210 MB: the bf16 tensor-core
// bound is ~70 us and the memory bound about the same. This first kernel
// uses float32 FMAs only (67 TFLOP/s peak), 8 x 8 outputs per thread at
// BM = 128; mma.sync / wgmma on bf16 and TMA loads are later work.
#include "tile_gemm.cuh"

namespace {

using tile_gemm::kBN;
using tile_gemm::Tile;

template <typename T, int BM>
__global__ void __launch_bounds__(Tile<BM>::kThreads)
bsr_spmm_kernel(const T* __restrict__ x, const T* __restrict__ blocks,
                const int* __restrict__ panel_ptr, const int* __restrict__ brow,
                float* __restrict__ out, int m, int k, int n, int bk, int bn) {
  __shared__ tile_gemm::Smem<BM> sm;
  const int row0 = blockIdx.x * BM;
  const int panel = blockIdx.y;
  const int c0 = blockIdx.z * kBN;
  float acc[Tile<BM>::kRM][8];
#pragma unroll
  for (int i = 0; i < Tile<BM>::kRM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int lo = panel_ptr[panel];
  const int hi = panel_ptr[panel + 1];
  const size_t block_size = (size_t)bk * bn;
  for (int t = lo; t < hi; ++t) {
    tile_gemm::Segment<T> s{x + (size_t)row0 * k + (size_t)brow[t] * bk, k, m - row0,
                            blocks + (size_t)t * block_size + c0, bn, bn - c0, bk};
    tile_gemm::accumulate<T, BM>(sm, s, acc);
  }
  tile_gemm::store<BM>(out + (size_t)row0 * n + (size_t)panel * bn + c0, n, m - row0,
                       bn - c0, acc);
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* blocks, const void* panel_ptr,
                   const void* brow, void* out, int m, int k, int n, int bk, int bn,
                   cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, n / bn, (bn + kBN - 1) / kBN);
  bsr_spmm_kernel<T, BM><<<grid, Tile<BM>::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(blocks),
      static_cast<const int*>(panel_ptr), static_cast<const int*>(brow),
      static_cast<float*>(out), m, k, n, bk, bn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* blocks, const void* panel_ptr,
                     const void* brow, void* out, int m, int k, int n, int bk, int bn,
                     cudaStream_t stream) {
  if (m > 64) return launch<T, 128>(x, blocks, panel_ptr, brow, out, m, k, n, bk, bn, stream);
  return launch<T, 64>(x, blocks, panel_ptr, brow, out, m, k, n, bk, bn, stream);
}

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (x and blocks alike); x [m, k], blocks
// [nnzb, bk, bn] column-panel-major, panel_ptr int32 [n / bn + 1], brow
// int32 [nnzb] (each below k / bk), out float32 [m, n], all contiguous and
// 16-byte aligned. Needs bk a multiple of 16 dividing k and bn a multiple
// of 4 dividing n.
extern "C" int bsr_spmm_launch(const void* x, const void* blocks, const void* panel_ptr,
                               const void* brow, void* out, int dtype, int m, int k,
                               int n, int bk, int bn, void* stream) {
  if (m < 1 || bk < 16 || bk % 16 || k < bk || k % bk || bn < 4 || bn % 4 || n < bn ||
      n % bn || n / bn > 65535 || (bn + kBN - 1) / kBN > 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(x, blocks, panel_ptr, brow, out, m, k, n, bk, bn, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, blocks, panel_ptr, brow, out, m, k, n, bk, bn, s);
  return (int)cudaErrorInvalidValue;
}
