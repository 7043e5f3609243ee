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
// both float32 or both bfloat16. A panel without blocks is written as
// zeros (the TPU kernel never visits it; the `ops` wrapper pads it with a
// zero block all the same, as the reference does).
//
// Grid. The TPU kernel walks (m tile, block) in order, resets its VMEM
// accumulator on a run's first block and writes it on the run's last (the
// first/last flags of plan_bsr). Here one thread block owns one (row tile,
// column panel, 128-column slice of the panel) and walks the panel's run
// itself, from per-panel offsets the host derives from the sorted bcol (as
// core/schedule.py::panel_runs does for the Gustavson kernel): the
// accumulator stays in registers for the whole run, blocks share nothing,
// use no atomics and write their tile once, so the result is
// deterministic.
//
// What bounds it. At granite-3-2b's SparseLinear down projection (x 8192 x
// 8192 bf16, W 8192 x 2048 in 128 x 128 blocks at density 0.25, 266
// blocks) a launch is 71 GFLOP against 210 MB (x's 134 MB read once, y's
// 67 MB written once): at an H100 SXM's data-sheet peaks (700 W), 72 us
// of bf16 tensor-core work against 63 us of bytes, so the tensor cores
// bound it, with memory close behind. Through L2 the bfloat16 kernel
// moves more: each block reads its panel's weight blocks and the matching
// slabs of x, 0.84 GB per launch at that shape with 256-row tiles (1.1 GB
// with 128-row ones, which read the weight twice as often).
//
// Two kernels, chosen by the operands' type (a static rule, no fallback):
//
// Float32 (bsr_spmm_kernel): float32 FMAs (tile_gemm.cuh), since float32
// parity rules out TF32: 8 x 8 outputs per thread at BM = 128, each block
// of the run one segment of x's [BM, bk] slab against the [bk, 128] weight
// slab.
//
// Bfloat16 (bsr_spmm_wgmma_kernel): wgmma fed by TMA, on the ring that the
// grouped matmul uses (sm90.cuh). The blocks [nnzb, bk, bn] are
// bn-contiguous, the grouped matmul's weight layout [E, D, F], so the
// product is computed transposed: y_panel^T = sum_t W_t^T . x_t^T, with
// W_t the MN-major A operand (64 panel columns per consumer warpgroup,
// through a 3-D tensor map [nnzb][bk][bn]) and x_t the K-major B operand,
// whose row tile is wgmma's N: 256 rows (one block per SM, four 48 KB
// stages), or 8 .. 128 for a smaller M (two blocks per SM). x is read through a 3-D
// tensor map [M][K/bk][bk] with a box of 64 along bk: a 64-wide step past
// the end of a narrower block comes back zero-filled from TMA and never
// reads the next block's columns; so does a ragged M, which the epilogue
// masks. The ring walks every (block of the run, 64-deep step) without
// resetting the accumulator, so the block writes its output once. TMA
// needs 16-byte strides: K is a multiple of bk, itself of 16; the blocks'
// rows are padded to a multiple of 8 values by the wrapper where bn is not
// (no model shape). Runs differ in length between panels (about 16.6
// blocks at granite's shape, with spread), so blocks of short runs finish
// early and the last wave is uneven; a persistent grid is later work.
// Blocks of one row tile are neighbours in the grid, so x's row tile is
// read from memory once and met in L2 by the other panels (a panel-major
// order, which re-reads x from memory for every panel, is slower).
#include <climits>

#include "sm90.cuh"
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

template <int BM>
cudaError_t launch_f32(const void* x, const void* blocks, const void* panel_ptr,
                       const void* brow, void* out, int m, int k, int n, int bk, int bn,
                       cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, n / bn, (bn + kBN - 1) / kBN);
  bsr_spmm_kernel<float, BM><<<grid, Tile<BM>::kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(blocks),
      static_cast<const int*>(panel_ptr), static_cast<const int*>(brow),
      static_cast<float*>(out), m, k, n, bk, bn);
  return cudaGetLastError();
}

// -- bfloat16: wgmma fed by TMA (the ring of sm90.cuh) -------------------------

template <int BN>
__global__ void __launch_bounds__(sm90::kRingThreads, sm90::Ring<BN>::kBlocksPerSm)
bsr_spmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap w_map,
                      const int* __restrict__ panel_ptr, const int* __restrict__ brow,
                      float* __restrict__ out, int m, int n, int bk, int bn, int n_panels,
                      int n_slices) {
  extern __shared__ uint8_t smem_raw[];
  const int tid = threadIdx.x;
  // blockIdx.x = (row tile * n_panels + panel) * n_slices + slice.
  const int slice = blockIdx.x % n_slices;
  const int panel = (blockIdx.x / n_slices) % n_panels;
  const int row0 = blockIdx.x / n_slices / n_panels * BN;
  const int c0 = slice * 128;  // the block's first column inside the panel
  const int lo = panel_ptr[panel];
  const int steps = (bk + sm90::kRingDepth - 1) / sm90::kRingDepth;  // per weight block
  const int n_stages = (panel_ptr[panel + 1] - lo) * steps;
  const int halves = bn - c0 > 64 ? 2 : 1;  // 64-column halves of the slice inside the panel
  const int wg = tid / 128;
  const sm90::RingAddr r = sm90::ring_setup<BN>(smem_raw);

  if (tid >= sm90::kRingConsumers) {
    if (tid == sm90::kRingConsumers) {
      sm90::tma_prefetch_map(&x_map);
      sm90::tma_prefetch_map(&w_map);
      const uint32_t bytes = halves * sm90::kRingABytes + sm90::Ring<BN>::kBBytes;
      // The block row of the next weight block is read one block ahead, so
      // its latency stays off the ring's critical path.
      int row = 0, row_next = n_stages > 0 ? brow[lo] : 0;
      sm90::ring_produce<BN>(r, n_stages, bytes, [&](int i, uint32_t stage, uint32_t bar) {
        const int t = lo + i / steps;
        const int k0 = (i % steps) * sm90::kRingDepth;
        if (k0 == 0) {
          row = row_next;
          if (i + steps < n_stages) row_next = brow[t + 1];
        }
        sm90::tma_load_3d(stage, &w_map, bar, c0, k0, t);
        if (halves > 1) sm90::tma_load_3d(stage + sm90::kRingABytes, &w_map, bar, c0 + 64, k0, t);
        sm90::tma_load_3d(stage + 2 * sm90::kRingABytes, &x_map, bar, k0, row, row0);
      });
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  sm90::fence_regs(acc);
  sm90::ring_consume<BN>(r, n_stages, wg < halves, wg, acc);
  const int col = panel * bn + c0 + 64 * wg;
  sm90::store_transposed<BN>(out + (size_t)row0 * n + col, n, m - row0, bn - c0 - 64 * wg, acc);
}

// Tensor maps of x [m][k / bk][bk] (boxes of 64 along bk x 1 block column x
// bn rows) and the blocks [nnzb][bk][ldw] (boxes of 64 columns x 64 rows x
// 1 block).
cudaError_t encode_maps(CUtensorMap* xm, CUtensorMap* wm, const void* x, const void* blocks,
                        int m, int k, int nnzb, int bk, int ldw, int bn_rows) {
  const cuuint64_t xdim[3] = {(cuuint64_t)bk, (cuuint64_t)(k / bk), (cuuint64_t)m};
  const cuuint64_t xstride[2] = {(cuuint64_t)bk * 2, (cuuint64_t)k * 2};
  const cuuint32_t xbox[3] = {(cuuint32_t)sm90::kRingDepth, 1, (cuuint32_t)bn_rows};
  cudaError_t err = sm90::encode_bf16_map(xm, x, 3, xdim, xstride, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdim[3] = {(cuuint64_t)ldw, (cuuint64_t)bk, (cuuint64_t)nnzb};
  const cuuint64_t wstride[2] = {(cuuint64_t)ldw * 2, (cuuint64_t)bk * ldw * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)sm90::kRingDepth, 1};
  return sm90::encode_bf16_map(wm, blocks, 3, wdim, wstride, wbox);
}

// The row tile (wgmma's N): 256 rows, or the least of 8 .. 128 that
// covers a smaller M.
int row_tile(int m) {
  int bn = 8;
  while (bn < 256 && bn < m) bn *= 2;
  return bn;
}

template <int BN>
cudaError_t launch_bf16(const void* x, const void* blocks, const void* panel_ptr,
                        const void* brow, void* out, int m, int k, int n, int bk, int bn,
                        int ldw, int nnzb, cudaStream_t stream) {
  using R = sm90::Ring<BN>;
  const int n_panels = n / bn;
  const int n_slices = (bn + 127) / 128;
  const long long blocks_total = (long long)((m + BN - 1) / BN) * n_panels * n_slices;
  if (blocks_total > INT_MAX || nnzb < 1) return cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  cudaError_t err = encode_maps(&xm, &wm, x, blocks, m, k, nnzb, bk, ldw, BN);
  if (err != cudaSuccess) return err;
  auto kernel = bsr_spmm_wgmma_kernel<BN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks_total, sm90::kRingThreads, R::kSmemBytes, stream>>>(
      xm, wm, static_cast<const int*>(panel_ptr), static_cast<const int*>(brow),
      static_cast<float*>(out), m, n, bk, bn, n_panels, n_slices);
  return cudaGetLastError();
}

using LaunchBf16 = cudaError_t (*)(const void*, const void*, const void*, const void*, void*,
                                   int, int, int, int, int, int, int, cudaStream_t);

LaunchBf16 pick_bf16(int m) {
  switch (row_tile(m)) {
    case 256: return launch_bf16<256>;
    case 128: return launch_bf16<128>;
    case 64: return launch_bf16<64>;
    case 32: return launch_bf16<32>;
    case 16: return launch_bf16<16>;
    default: return launch_bf16<8>;
  }
}

template <int BN>
int smem_of() { return sm90::Ring<BN>::kSmemBytes; }

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel), x and
// blocks alike; x [m, k], blocks [nnzb, bk, ldw] column-panel-major, of
// which the first bn columns of each row are W's (ldw = bn for float32; a
// multiple of 8 at least bn for bfloat16), panel_ptr int32 [n / bn + 1],
// brow int32 [nnzb] (each below k / bk), out float32 [m, n], all contiguous
// and 16-byte aligned. Needs bk a multiple of 16 dividing k and bn a
// multiple of 4 dividing n.
extern "C" int bsr_spmm_launch(const void* x, const void* blocks, const void* panel_ptr,
                               const void* brow, void* out, int dtype, int m, int k,
                               int n, int bk, int bn, int ldw, int nnzb, void* stream) {
  if (m < 1 || bk < 16 || bk % 16 || k < bk || k % bk || bn < 4 || bn % 4 || n < bn ||
      n % bn || nnzb < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (ldw != bn || n / bn > 65535 || (bn + kBN - 1) / kBN > 64)
      return (int)cudaErrorInvalidValue;
    if (m > 64) return (int)launch_f32<128>(x, blocks, panel_ptr, brow, out, m, k, n, bk, bn, s);
    return (int)launch_f32<64>(x, blocks, panel_ptr, brow, out, m, k, n, bk, bn, s);
  }
  if (dtype == 1) {
    if (ldw < bn || ldw % 8) return (int)cudaErrorInvalidValue;
    return (int)pick_bf16(m)(x, blocks, panel_ptr, brow, out, m, k, n, bk, bn, ldw, nnzb, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) a launch of the given type and M asks for:
// the bfloat16 kernel's ring; the float32 kernel uses static memory only.
extern "C" int bsr_spmm_smem_bytes(int dtype, int m) {
  if (dtype != 1 || m < 1) return 0;
  switch (row_tile(m)) {
    case 256: return smem_of<256>();
    case 128: return smem_of<128>();
    case 64: return smem_of<64>();
    case 32: return smem_of<32>();
    case 16: return smem_of<16>();
    default: return smem_of<8>();
  }
}

// Thread blocks of the launch of the given type and M that one SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 on an error.
extern "C" int bsr_spmm_blocks_per_sm(int dtype, int m) {
  int n = -1;
  cudaError_t err;
  if (dtype == 0) {
    err = m > 64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, bsr_spmm_kernel<float, 128>, Tile<128>::kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, bsr_spmm_kernel<float, 64>, Tile<64>::kThreads, 0);
    return err == cudaSuccess ? n : -1;
  }
  if (dtype != 1) return -1;
  const int smem = bsr_spmm_smem_bytes(dtype, m);
  switch (row_tile(m)) {
#define K3_OCC(BN)                                                                        \
  case BN:                                                                                \
    err = cudaFuncSetAttribute(bsr_spmm_wgmma_kernel<BN>,                                 \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);        \
    if (err == cudaSuccess)                                                               \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bsr_spmm_wgmma_kernel<BN>,  \
                                                          sm90::kRingThreads, smem);      \
    break;
    K3_OCC(256)
    K3_OCC(128)
    K3_OCC(64)
    K3_OCC(32)
    K3_OCC(16)
    K3_OCC(8)
#undef K3_OCC
    default: return -1;
  }
  return err == cudaSuccess ? n : -1;
}
