// Tile machinery shared by the grouped-matmul kernel (moe_gmm.cu) and the
// block-sparse-weight SpMM kernel (bsr_spmm.cu).
//
// Both kernels compute, per thread block, one float32 output tile of BM
// rows by kBN = 128 columns as a sum of *segments*: a segment is a slab of
// x (BM rows, `depth` columns) times a slab of W (`depth` rows, 128
// columns). K4 has one segment per tile (x's row tile against its
// expert's whole [D, F] weight); K3 has one per weight block of the
// tile's column panel.
//
// A segment is walked in chunks of kBK = 16 along the depth. Each chunk of
// x is stored transposed in shared memory (xs[k][row]) and each chunk of W
// as it is (ws[k][col]); two buffers alternate, and the next chunk is read
// from device memory into registers while the current one is multiplied,
// so its latency hides behind the FMAs. bfloat16 inputs are converted to
// float32 as they are read; all arithmetic is float32 FMA (no tensor
// cores: the float32 path is held to its plain version at 1e-4, which rules
// out TF32).
//
// Threads. kTY x kTX (kTX = 16) threads; thread (ty, tx) owns kRM rows
// ty*kRM + i and the 8 columns tx*4 + j and 64 + tx*4 + j (j < 4), so one
// chunk step reads kRM/4 float4 of xs and two float4 of ws from shared
// memory for 8*kRM FMAs. With BM = 128: 256 threads, 8 x 8 outputs each.
// Rows of x past `rows` and columns of W past `cols` read as zero, and
// the tile is written only where both are in range.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tile_gemm {

constexpr int kBN = 128;  // output columns of one thread block
constexpr int kBK = 16;   // depth of one chunk staged through shared memory
constexpr int kTX = 16;   // threads across the columns
constexpr int kPad = 4;   // row padding of the transposed x chunk (keeps float4 alignment)

template <int BM>
struct Tile {
  static_assert(BM == 8 || BM == 16 || BM == 32 || BM == 64 || BM == 128,
                "BM must be 8, 16, 32, 64 or 128");
  static constexpr int kRM = BM >= 16 ? BM / 16 : 1;  // rows per thread
  static constexpr int kTY = BM / kRM;                 // threads across the rows
  static constexpr int kThreads = kTY * kTX;
  static constexpr int kXStride = BM + kPad;
  static constexpr int kXGroups = BM * kBK / 4;  // float4 groups of one x chunk
  static constexpr int kWGroups = kBK * kBN / 4;
  static constexpr int kXPer = (kXGroups + kThreads - 1) / kThreads;
  static constexpr int kWPer = (kWGroups + kThreads - 1) / kThreads;
};

template <int BM>
struct __align__(16) Smem {
  float x[2][kBK][Tile<BM>::kXStride];
  float w[2][kBK][kBN];
};

// One segment, seen from the thread block: pointers at the block's first
// row of x and first column of W, both at the segment's first depth index.
template <typename T>
struct Segment {
  const T* x;
  int ldx;    // row stride of x, in elements
  int rows;   // rows of x in range from the first
  const T* w;
  int ldw;    // row stride of W, in elements
  int cols;   // columns of W in range from the first (a multiple of 4)
  int depth;  // a multiple of kBK
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Read chunk k0 of segment s into registers.
template <typename T, int BM>
__device__ __forceinline__ void fetch(const Segment<T>& s, int k0,
                                      float4 (&xr)[Tile<BM>::kXPer],
                                      float4 (&wr)[Tile<BM>::kWPer]) {
  using S = Tile<BM>;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < S::kXPer; ++i) {
    const int g = threadIdx.x + i * S::kThreads;
    const int r = g / (kBK / 4);
    const int c = (g % (kBK / 4)) * 4;
    xr[i] = (g < S::kXGroups && r < s.rows)
                ? load4(s.x + (size_t)r * s.ldx + k0 + c) : zero;
  }
#pragma unroll
  for (int i = 0; i < S::kWPer; ++i) {
    const int g = threadIdx.x + i * S::kThreads;
    const int r = g / (kBN / 4);
    const int c = (g % (kBN / 4)) * 4;
    wr[i] = (g < S::kWGroups && c < s.cols)
                ? load4(s.w + (size_t)(k0 + r) * s.ldw + c) : zero;
  }
}

// Store the registers' chunk into buffer `buf` of shared memory.
template <int BM>
__device__ __forceinline__ void stash(Smem<BM>& sm, int buf,
                                      const float4 (&xr)[Tile<BM>::kXPer],
                                      const float4 (&wr)[Tile<BM>::kWPer]) {
  using S = Tile<BM>;
#pragma unroll
  for (int i = 0; i < S::kXPer; ++i) {
    const int g = threadIdx.x + i * S::kThreads;
    if (g < S::kXGroups) {
      const int r = g / (kBK / 4);
      const int c = (g % (kBK / 4)) * 4;
      sm.x[buf][c + 0][r] = xr[i].x;
      sm.x[buf][c + 1][r] = xr[i].y;
      sm.x[buf][c + 2][r] = xr[i].z;
      sm.x[buf][c + 3][r] = xr[i].w;
    }
  }
#pragma unroll
  for (int i = 0; i < S::kWPer; ++i) {
    const int g = threadIdx.x + i * S::kThreads;
    if (g < S::kWGroups) {
      const int r = g / (kBN / 4);
      const int c = (g % (kBN / 4)) * 4;
      *reinterpret_cast<float4*>(&sm.w[buf][r][c]) = wr[i];
    }
  }
}

// acc += xs[buf]^T-chunk x ws[buf]-chunk for this thread's outputs.
template <int BM>
__device__ __forceinline__ void multiply(const Smem<BM>& sm, int buf,
                                         float (&acc)[Tile<BM>::kRM][8]) {
  using S = Tile<BM>;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float a[S::kRM];
    if constexpr (S::kRM % 4 == 0) {
#pragma unroll
      for (int q = 0; q < S::kRM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&sm.x[buf][kk][ty * S::kRM + 4 * q]);
        a[4 * q + 0] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < S::kRM; ++i) a[i] = sm.x[buf][kk][ty * S::kRM + i];
    }
    const float4 b0 = *reinterpret_cast<const float4*>(&sm.w[buf][kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&sm.w[buf][kk][64 + tx * 4]);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < S::kRM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc += segment s, chunk by chunk in depth order. Every thread of the
// block must call it with the same segment. Ends with a barrier, so the
// next call may overwrite either buffer.
template <typename T, int BM>
__device__ __forceinline__ void accumulate(Smem<BM>& sm, const Segment<T>& s,
                                           float (&acc)[Tile<BM>::kRM][8]) {
  using S = Tile<BM>;
  const int chunks = s.depth / kBK;
  if (chunks <= 0) return;
  float4 xr[S::kXPer];
  float4 wr[S::kWPer];
  fetch<T, BM>(s, 0, xr, wr);
  stash<BM>(sm, 0, xr, wr);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    const bool more = c + 1 < chunks;
    if (more) fetch<T, BM>(s, (c + 1) * kBK, xr, wr);
    multiply<BM>(sm, buf, acc);
    if (more) stash<BM>(sm, buf ^ 1, xr, wr);
    __syncthreads();
  }
}

// Write this thread's outputs of the tile at `out` (row stride ldo),
// where the row is below `rows` and the column below `cols`.
template <int BM>
__device__ __forceinline__ void store(float* out, int ldo, int rows, int cols,
                                      const float (&acc)[Tile<BM>::kRM][8]) {
  using S = Tile<BM>;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
#pragma unroll
  for (int i = 0; i < S::kRM; ++i) {
    const int r = ty * S::kRM + i;
    if (r >= rows) continue;
    float* o = out + (size_t)r * ldo;
    if (tx * 4 < cols)
      *reinterpret_cast<float4*>(o + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (64 + tx * 4 < cols)
      *reinterpret_cast<float4*>(o + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace tile_gemm
