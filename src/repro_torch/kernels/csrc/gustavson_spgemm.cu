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
// accumulated in float32. A and B are both float32 or both bfloat16
// (widened exactly to float32). A tile without triples is written as
// zeros, as the TPU kernel zeroes a whole panel on its first triple.
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
// bytes, and the work is bound by the float32 FMA rate (no tensor cores:
// TF32 would break float32 parity, and the bfloat16 path keeps the float32
// path's sums). Inside a block, the latency of the loads and the
// shared-memory traffic that feeds the FMAs stand between the FMAs and
// their peak. The design:
//
// - Loads overlap compute. The tile's triples run as one stream of stages,
//   each a KC-deep chunk of one triple (A's bm x KC columns, B's KC x bn
//   rows; KC = 32, or 16 where bk is an odd multiple of 16), through a
//   ring of kStages shared-memory buffers filled by 16-byte cp.async.cg
//   copies: the copies of stage s + kStages - 1 are in flight while stage
//   s is multiplied. Stages stay small at every tile (at 128 x 128 x 128 in
//   float32 a whole triple would take 128 KB), and one barrier per stage
//   frees the buffer the next copies overwrite. The slot indices of the
//   next stage are read one stage ahead, so their latency hides behind the
//   multiply.
// - Each shared-memory load feeds several FMAs. A thread owns TM x TN
//   outputs: 8 x 4 where that keeps the block within 256 threads (64 x 64
//   tiles: 128 threads), 8 x 8 above, 4 x 4 below 64 x 64 tiles. Per 4
//   steps of k it reads TM 16-byte runs of A's rows and 4 x TN/4 of B's for
//   4 x TM x TN FMAs.
// - A stays in its stored row-major layout (cp.async cannot transpose); a
//   thread reads k-contiguous runs of its rows ty + i * TY, so threads of
//   one warp read neighbouring rows, which a 16-byte pad per row puts in
//   distinct banks; B's rows are read contiguously across the warp.
//   Neither meets bank conflicts.
// - bfloat16 operands are copied as bfloat16, half the bytes, and widened
//   once per stage: the block converts the landed stage into a float32
//   buffer (a second barrier) and multiplies from there, so each value is
//   widened once rather than at each of its TN or TM uses.
//
// Summation order. Each output's sum runs over the triples in run order
// and, within a triple, k ascending, as one FMA chain starting from zero:
// the order of the first kernel, so float32 results are bitwise equal to
// it. The dynamic shared memory, threads and blocks per SM of each tile
// shape are exported (gustavson_spgemm_smem_bytes, _threads,
// _blocks_per_sm) for reporting.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;      // ring depth
constexpr int kMaxThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One ring stage in T: A's chunk [bm][kLda] (KC values and a 16-byte pad
// per row), then B's chunk [KC][bn].
template <typename T, int KC>
struct Stage {
  static constexpr int kVec = 16 / sizeof(T);  // values per 16-byte copy
  static constexpr int kLda = KC + kVec;
  static __host__ __device__ int elems(int bm, int bn) { return bm * kLda + KC * bn; }
};

// The float32 chunk the multiply reads: the ring stage itself for float32
// operands, the widened copy of it for bfloat16 ones.
template <int KC>
using Work = Stage<float, KC>;

template <typename T, int KC>
__host__ __device__ size_t smem_bytes(int bm, int bn) {
  const size_t ring = sizeof(T) * (size_t)kStages * Stage<T, KC>::elems(bm, bn);
  return sizeof(T) == 4 ? ring : ring + sizeof(float) * (size_t)Work<KC>::elems(bm, bn);
}

// Start the copies of chunk k0 of A block `ag` [bm, bk] and B block `bg`
// [bk, bn] into the stage at `sa`.
template <typename T, int KC>
__device__ __forceinline__ void copy_stage(T* sa, const T* __restrict__ ag, const T* __restrict__ bg,
                                      int k0, int bm, int bk, int bn) {
  using S = Stage<T, KC>;
  constexpr int kRowCopies = KC / S::kVec;
  T* sb = sa + bm * S::kLda;
  for (int i = threadIdx.x; i < bm * kRowCopies; i += blockDim.x) {
    const int r = i / kRowCopies;
    const int v = (i % kRowCopies) * S::kVec;
    cp_async16(sa + r * S::kLda + v, ag + (size_t)r * bk + k0 + v);
  }
  const T* src = bg + (size_t)k0 * bn;
  for (int i = threadIdx.x; i < KC * bn / S::kVec; i += blockDim.x)
    cp_async16(sb + i * S::kVec, src + i * S::kVec);
}

// Eight bfloat16 values (one 16-byte chunk) widened exactly to float32.
__device__ __forceinline__ void widen8(const __nv_bfloat16* src, float* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
  float f[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(v[q] << 16);
    f[2 * q + 1] = __uint_as_float(v[q] & 0xFFFF0000u);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// Widen a landed bfloat16 stage into the float32 work chunk.
template <int KC>
__device__ __forceinline__ void widen_stage(const __nv_bfloat16* sa, float* wa, int bm, int bn) {
  using S = Stage<__nv_bfloat16, KC>;
  constexpr int kRowChunks = KC / 8;
  for (int i = threadIdx.x; i < bm * kRowChunks; i += blockDim.x) {
    const int r = i / kRowChunks;
    const int v = (i % kRowChunks) * 8;
    widen8(sa + r * S::kLda + v, wa + r * Work<KC>::kLda + v);
  }
  const __nv_bfloat16* sb = sa + bm * S::kLda;
  float* wb = wa + bm * Work<KC>::kLda;
  for (int i = threadIdx.x; i < KC * bn / 8; i += blockDim.x) widen8(sb + i * 8, wb + i * 8);
}

// acc += the chunk's A [bm][KC] . B [KC][bn] for this thread's outputs:
// rows ty + i * ty_n, columns q * part + tx * 4 + j.
template <int TM, int TN, int KC>
__device__ __forceinline__ void multiply(const float* __restrict__ as, const float* __restrict__ bs,
                                         int bm, int bn, int tx, int ty, int ty_n,
                                         float (&acc)[TM][TN]) {
  constexpr int kLda = Work<KC>::kLda;
  constexpr int kParts = TN / 4;
  const int part = bn / kParts;
#pragma unroll
  for (int k = 0; k < KC; k += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(as + (ty + i * ty_n) * kLda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[TN];
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(bs + (k + kk) * bn + q * part + tx * 4);
        bv[4 * q] = v.x; bv[4 * q + 1] = v.y; bv[4 * q + 2] = v.z; bv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
      }
    }
  }
}

template <typename T, int TM, int TN, int KC>
__global__ void __launch_bounds__(kMaxThreads)
gustavson_ring_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const int* __restrict__ run_ptr, const int* __restrict__ run_a,
                      const int* __restrict__ run_b, float* __restrict__ out, int n_tiles,
                      int nnzb_a, int nnzb_b, int bm, int bk, int bn) {
  static_assert(TN == 4 || TN == 8, "TN is one or two float4 groups");
  constexpr bool kWiden = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  const int stage_elems = Stage<T, KC>::elems(bm, bn);
  float* const work = reinterpret_cast<float*>(ring + kStages * stage_elems);

  const int tile = blockIdx.x;
  const long long elem = blockIdx.y;
  const int tx_n = bn / TN;  // threads across the columns
  const int ty_n = bm / TM;  // threads across the rows
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int lo = run_ptr[tile];
  const int chunks = bk / KC;  // stages per triple
  const int n = (run_ptr[tile + 1] - lo) * chunks;
  const T* const a_base = a + elem * nnzb_a * (long long)bm * bk;
  const T* const b_base = b + elem * nnzb_b * (long long)bk * bn;
  auto a_block = [&](int slot) { return a_base + (long long)slot * bm * bk; };
  auto b_block = [&](int slot) { return b_base + (long long)slot * bk * bn; };

  // Prologue: stages 0 .. kStages - 2.
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n) {
      const int t = lo + j / chunks;
      copy_stage<T, KC>(ring + j * stage_elems, a_block(run_a[t]), b_block(run_b[t]),
                   (j % chunks) * KC, bm, bk, bn);
    }
    cp_async_commit();
  }
  // Slots of the next stage to copy (kStages - 1), read one stage ahead.
  int next_a = 0, next_b = 0;
  if (kStages - 1 < n) {
    const int t = lo + (kStages - 1) / chunks;
    next_a = run_a[t];
    next_b = run_b[t];
  }

  for (int s = 0; s < n; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s landed
    __syncthreads();               // everyone's have; stage s - 1 is consumed
    const int j = s + kStages - 1;
    if (j < n)
      copy_stage<T, KC>(ring + (j % kStages) * stage_elems, a_block(next_a), b_block(next_b),
                   (j % chunks) * KC, bm, bk, bn);
    cp_async_commit();
    if (j + 1 < n) {
      const int t = lo + (j + 1) / chunks;
      next_a = __ldg(run_a + t);
      next_b = __ldg(run_b + t);
    }
    const T* const stage = ring + (s % kStages) * stage_elems;
    const float* as;
    if constexpr (kWiden) {
      widen_stage<KC>(stage, work, bm, bn);
      __syncthreads();
      as = work;
    } else {
      as = stage;
    }
    multiply<TM, TN, KC>(as, as + bm * Work<KC>::kLda, bm, bn, tx, ty, ty_n, acc);
  }
  cp_async_wait<0>();

  constexpr int kParts = TN / 4;
  const int part = bn / kParts;
  float* const o = out + (elem * n_tiles + tile) * (long long)bm * bn;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* const row = o + (long long)(ty + i * ty_n) * bn + tx * 4;
#pragma unroll
    for (int q = 0; q < kParts; ++q)
      *reinterpret_cast<float4*>(row + q * part) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
  }
}

bool tile_dim_ok(int d) { return d >= 16 && d <= 128 && d % 16 == 0; }

// The launch configuration of a tile shape: outputs per thread TM x TN and
// the stage depth KC.
struct Config {
  int tm, tn, kc;
  int threads(int bm, int bn) const { return (bm / tm) * (bn / tn); }
};

Config config(int bm, int bk, int bn) {
  Config c{4, 4, bk % 32 == 0 ? 32 : 16};
  if (bm * bn >= 64 * 64) {
    c.tm = 8;
    c.tn = (bm / 8) * (bn / 4) <= kMaxThreads ? 4 : 8;
  }
  return c;
}

template <typename T, int TM, int TN, int KC>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(gustavson_ring_kernel<T, TM, TN, KC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *a, *b, *run_ptr, *run_a, *run_b;
  void* out;
  int bsz, n_tiles, nnzb_a, nnzb_b, bm, bk, bn;
  cudaStream_t stream;
};

template <typename T, int TM, int TN, int KC>
cudaError_t launch(const Args& g) {
  const size_t smem = smem_bytes<T, KC>(g.bm, g.bn);
  const cudaError_t err = prepare<T, TM, TN, KC>(smem);
  if (err != cudaSuccess) return err;
  const int threads = (g.bm / TM) * (g.bn / TN);
  gustavson_ring_kernel<T, TM, TN, KC><<<dim3(g.n_tiles, g.bsz), threads, smem, g.stream>>>(
      static_cast<const T*>(g.a), static_cast<const T*>(g.b),
      static_cast<const int*>(g.run_ptr), static_cast<const int*>(g.run_a),
      static_cast<const int*>(g.run_b), static_cast<float*>(g.out), g.n_tiles, g.nnzb_a,
      g.nnzb_b, g.bm, g.bk, g.bn);
  return cudaGetLastError();
}

template <typename T, int TM, int TN, int KC>
int occupancy(int bm, int bn) {
  const size_t smem = smem_bytes<T, KC>(bm, bn);
  int n = -1;
  cudaError_t err = prepare<T, TM, TN, KC>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, gustavson_ring_kernel<T, TM, TN, KC>, (bm / TM) * (bn / TN), smem);
  return err == cudaSuccess ? n : -1;
}

// Calls F<T, TM, TN, KC>::run(args...) for the configuration of the tile.
template <typename T, template <typename, int, int, int> class F, typename... A>
auto dispatch(const Config& c, A... args) {
#define K1_CASE(TM, TN, KC) \
  if (c.tm == TM && c.tn == TN && c.kc == KC) return F<T, TM, TN, KC>::run(args...);
  K1_CASE(8, 4, 32)
  K1_CASE(8, 4, 16)
  K1_CASE(8, 8, 32)
  K1_CASE(8, 8, 16)
  K1_CASE(4, 4, 32)
#undef K1_CASE
  return F<T, 4, 4, 16>::run(args...);
}

template <typename T, int TM, int TN, int KC>
struct Launch {
  static cudaError_t run(const Args& g) { return launch<T, TM, TN, KC>(g); }
};

template <typename T, int TM, int TN, int KC>
struct Occupancy {
  static int run(int bm, int bn) { return occupancy<T, TM, TN, KC>(bm, bn); }
};

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (A and B alike); out is float32
// [bsz][n_tiles][bm][bn]; run_ptr is int32 [n_tiles + 1]; run_a and run_b
// are int32 slot indices in run order. A and B 16-byte aligned; tile dims
// multiples of 16 from 16 to 128.
extern "C" int gustavson_spgemm_launch(const void* a, const void* b,
                                       const void* run_ptr, const void* run_a,
                                       const void* run_b, void* out, int dtype,
                                       int bsz, int n_tiles, int nnzb_a,
                                       int nnzb_b, int bm, int bk, int bn,
                                       void* stream) {
  if (!tile_dim_ok(bm) || !tile_dim_ok(bk) || !tile_dim_ok(bn) || bsz < 1 ||
      bsz > 65535 || n_tiles < 1 || nnzb_a < 0 || nnzb_b < 0)
    return (int)cudaErrorInvalidValue;
  const Args g{a, b, run_ptr, run_a, run_b, out, bsz, n_tiles, nnzb_a, nnzb_b, bm, bk, bn,
               static_cast<cudaStream_t>(stream)};
  const Config c = config(bm, bk, bn);
  if (dtype == 0) return (int)dispatch<float, Launch>(c, g);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16, Launch>(c, g);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of a launch at (dtype, bm, bk, bn): the
// ring of kStages stages, and for bfloat16 the widened chunk; 0 for
// arguments the kernel refuses.
extern "C" int gustavson_spgemm_smem_bytes(int dtype, int bm, int bk, int bn) {
  if (!tile_dim_ok(bm) || !tile_dim_ok(bk) || !tile_dim_ok(bn)) return 0;
  const bool deep = config(bm, bk, bn).kc == 32;
  if (dtype == 0) return (int)(deep ? smem_bytes<float, 32>(bm, bn) : smem_bytes<float, 16>(bm, bn));
  if (dtype == 1)
    return (int)(deep ? smem_bytes<__nv_bfloat16, 32>(bm, bn)
                      : smem_bytes<__nv_bfloat16, 16>(bm, bn));
  return 0;
}

// Threads per block of a launch at (dtype, bm, bk, bn); 0 if refused.
extern "C" int gustavson_spgemm_threads(int dtype, int bm, int bk, int bn) {
  if (!tile_dim_ok(bm) || !tile_dim_ok(bk) || !tile_dim_ok(bn) || (dtype != 0 && dtype != 1))
    return 0;
  return config(bm, bk, bn).threads(bm, bn);
}

// Thread blocks one SM holds at once at (dtype, bm, bk, bn)
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 on an error.
extern "C" int gustavson_spgemm_blocks_per_sm(int dtype, int bm, int bk, int bn) {
  if (!tile_dim_ok(bm) || !tile_dim_ok(bk) || !tile_dim_ok(bn)) return -1;
  const Config c = config(bm, bk, bn);
  if (dtype == 0) return dispatch<float, Occupancy>(c, bm, bn);
  if (dtype == 1) return dispatch<__nv_bfloat16, Occupancy>(c, bm, bn);
  return -1;
}
