// Block-Gustavson SpGEMM for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/gustavson_spgemm.py::
// spgemm_scheduled_impl (single value set) and ::spgemm_scheduled_batch_impl
// (a batch of value sets over one shared schedule).
//
// What it computes. For every output tile (batch element e, panel p,
// sub_row s) of bm x bn floats,
//
//     out[e][p][s*bm : (s+1)*bm][:] = sum over the tile's triples t, in
//         triple order, of A[e*nnzb_a + a_slot[t]] @ B[e*nnzb_b + b_slot[t]]
//
// accumulated in float32. A tile without triples is written as zeros, as
// the TPU kernel zeroes a whole panel on its first triple.
//
// Grid. The TPU kernel walks the whole triple stream in order on one core
// and keeps each panel in VMEM across consecutive grid steps. Here one
// thread block owns one tile (blockIdx.x = p*group + s, blockIdx.y = e) and
// walks that tile's run of triples (core/schedule.py::panel_runs): blocks
// share nothing, run in any order, use no atomics and write their tile
// exactly once. Per-element results are deterministic, so a batch launch
// equals a loop of single launches bit for bit.
//
// What bounds it. Each triple is 2*bm*bk*bn flops on (bm*bk + bk*bn)
// input values; on the plans' schedules every A block and every B block is
// used by several triples, so over the whole launch the flops outweigh the
// bytes and float32 work is bound by the FMA rate (no tensor cores: TF32
// would break float32 parity). Inside a block the limit is shared-memory
// bandwidth feeding the FMAs, so each thread owns a 4 x 4 micro-tile of
// the output and reads, per k, one float4 of A (stored transposed) and one
// float4 of B: 16 FMAs per two 16-byte shared loads. Loads are not
// overlapped with compute inside a block; several blocks per SM hide each
// other's loads. Within one tile's run the triples have distinct k, so
// b_slot never repeats there; the B tile is kept when it does (a schedule
// handed to the kernel directly may repeat it), and the G tiles of one
// panel, which read the same B blocks, are neighbouring blocks and meet
// those blocks in L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMicro = 4;      // each thread computes kMicro x kMicro outputs
constexpr int kAPad = 4;       // row padding of transposed A in shared memory
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gustavson_tile_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const int* __restrict__ run_ptr,
                      const int* __restrict__ run_a,
                      const int* __restrict__ run_b,
                      float* __restrict__ out,
                      int n_tiles, int nnzb_a, int nnzb_b,
                      int bm, int bk, int bn) {
  extern __shared__ __align__(16) float smem[];
  const int a_stride = bm + kAPad;       // As[k][r] at k * a_stride + r
  float* as = smem;                      // [bk][bm + kAPad]
  float* bs = smem + bk * a_stride;      // [bk][bn]

  const int tile = blockIdx.x;
  const long long elem = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int cols4 = bn / kMicro;
  const int tx = tid % cols4;            // output columns tx*4 .. tx*4+3
  const int ty = tid / cols4;            // output rows    ty*4 .. ty*4+3

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  const int lo = run_ptr[tile];
  const int hi = run_ptr[tile + 1];
  const long long a_size = (long long)bm * bk;
  const long long b_size = (long long)bk * bn;
  int b_loaded = -1;
  for (int t = lo; t < hi; ++t) {
    const int a_slot = run_a[t];
    const int b_slot = run_b[t];
    __syncthreads();  // the previous triple's reads of as/bs are done
    const T* ag = a + (elem * nnzb_a + a_slot) * a_size;
    for (int i = tid * kMicro; i < bm * bk; i += nthreads * kMicro) {
      float v[4];
      load4(ag + i, v);
      const int r = i / bk;
      const int k = i % bk;
#pragma unroll
      for (int q = 0; q < 4; ++q) as[(k + q) * a_stride + r] = v[q];
    }
    if (b_slot != b_loaded) {
      const T* bg = b + (elem * nnzb_b + b_slot) * b_size;
      for (int i = tid * kMicro; i < bk * bn; i += nthreads * kMicro) {
        float v[4];
        load4(bg + i, v);
        *reinterpret_cast<float4*>(bs + i) = make_float4(v[0], v[1], v[2], v[3]);
      }
      b_loaded = b_slot;
    }
    __syncthreads();
    const float* ap = as + ty * kMicro;
    const float* bp = bs + tx * kMicro;
#pragma unroll 4
    for (int k = 0; k < bk; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(ap + k * a_stride);
      const float4 bv = *reinterpret_cast<const float4*>(bp + k * bn);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

  const long long tile_base = (elem * n_tiles + tile) * (long long)bm * bn;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    float* o = out + tile_base + (long long)(ty * kMicro + i) * bn + tx * kMicro;
    *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* run_ptr,
                   const void* run_a, const void* run_b, void* out, int bsz,
                   int n_tiles, int nnzb_a, int nnzb_b, int bm, int bk, int bn,
                   cudaStream_t stream) {
  const int threads = (bm / kMicro) * (bn / kMicro);
  const size_t smem = sizeof(float) * ((size_t)bk * (bm + kAPad) + (size_t)bk * bn);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gustavson_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_tiles, bsz);
  gustavson_tile_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_a),
      static_cast<const int*>(run_b), static_cast<float*>(out), n_tiles,
      nnzb_a, nnzb_b, bm, bk, bn);
  return cudaGetLastError();
}

bool tile_dim_ok(int d) { return d >= 16 && d <= 128 && d % 16 == 0; }

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (A and B alike); out is float32
// [bsz][n_tiles][bm][bn]; run_ptr is int32 [n_tiles + 1]; run_a and run_b
// are int32 slot indices in run order.
extern "C" int gustavson_spgemm_launch(const void* a, const void* b,
                                       const void* run_ptr, const void* run_a,
                                       const void* run_b, void* out, int dtype,
                                       int bsz, int n_tiles, int nnzb_a,
                                       int nnzb_b, int bm, int bk, int bn,
                                       void* stream) {
  if (!tile_dim_ok(bm) || !tile_dim_ok(bk) || !tile_dim_ok(bn) || bsz < 1 ||
      bsz > 65535 || n_tiles < 1 || nnzb_a < 0 || nnzb_b < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(a, b, run_ptr, run_a, run_b, out, bsz, n_tiles,
                              nnzb_a, nnzb_b, bm, bk, bn, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(a, b, run_ptr, run_a, run_b, out, bsz,
                                      n_tiles, nnzb_a, nnzb_b, bm, bk, bn, s);
  return (int)cudaErrorInvalidValue;
}
