// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel). Plain version: repro_torch/kernels/ref.py::flash_attention_ref.
//
// What it computes. For q [BH, Sq, D], k and v [BH, Skv, D] (float32 or
// bfloat16, the same type for all three) and every row i of q:
//
//     qi = i + q_offset;  key j is visible iff  (!causal || j <= qi) &&
//                                               (!window || j > qi - window)
//     o[i] = sum_j softmax_j(scale * q[i].k[j]) v[j] over the visible j
//
// with an online softmax: a running max m (from -1e30), denominator l and
// numerator acc, all float32; masked logits are -1e30 and their
// probabilities 0, as in the TPU kernel, so a row whose first kv tiles are
// fully masked keeps m = -1e30 and alpha = exp(0) = 1 instead of
// exp(-inf - -inf) = NaN. A row that saw no key has l = 0, replaced by 1,
// and gives 0. The output has q's type; bfloat16 is converted to float32
// on load.
//
// Grid. The TPU kernel walks the kv blocks of one (bh, q block) in order
// on one core and carries (m, l, acc) in VMEM scratch between grid steps.
// Here one thread block owns one (bh, 64-row q tile) and loops over the kv
// tiles of 64 keys itself; blocks share nothing. Tiles wholly above the
// causal diagonal or wholly outside the window are skipped, which is exact:
// a fully masked tile leaves m, l and acc unchanged. Heavy q tiles (late
// rows under causal masking) are launched first to shorten the tail.
//
// Threads. 256 threads as a 16 x 16 grid (ty, tx). For the 64 x 64 logit
// tile S = Q K^T a thread owns rows ty + 16i and keys tx + 16j (i, j < 4)
// and reads Q and K rows from shared memory as float4 along D; rows are
// padded by 4 floats, so the 8 K rows read by a quarter warp fall in
// distinct banks. The 16 threads of one row are 16 lanes of one warp:
// the row max and row sum are warp shuffles. P goes to shared memory and
// O += P V gives each thread the same rows and NJ4 float4 column groups
// (tx + 16g)*4 of D; NJ4 = ceil(D / 64) is a template parameter.
//
// What bounds it. Causal attention at the LM's shape (BH = 128, S = 2048,
// D = 64) is 4*D FLOPs per visible (q, k) pair, 68.7 GFLOP, against 134
// MB of q, k, v and o: far above the card's ridge point, so the bound is
// the arithmetic. This first kernel does it with plain float32 FMAs, no
// tensor cores (float32 parity at 2e-4 rules out TF32), and loads the
// next kv tile only after the current one is done; the bfloat16 bound at
// 989 TFLOP/s is out of its reach. mma.sync / wgmma for bfloat16, loads
// overlapped by cp.async or TMA, and GQA indexing in place of the R-fold
// repeat of k and v are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // q rows per block
constexpr int kBK = 64;         // keys per kv tile
constexpr int kThreads = 256;
constexpr int kPad = 4;         // row padding in floats (keeps float4 alignment)
constexpr int kPStride = kBK + kPad;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const float* p, float4& a, float4& b) {
  a = *reinterpret_cast<const float4*>(p);
  b = *reinterpret_cast<const float4*>(p + 4);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float4& a, float4& b) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]);
  const float2 f3 = __bfloat1622float2(h[3]);
  a = make_float4(f0.x, f0.y, f1.x, f1.y);
  b = make_float4(f2.x, f2.y, f3.x, f3.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Copy rows [row0, row0 + 64) of a [rows, d] matrix into shared memory as
// float32 with row stride ld; rows past the end are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int rows, int d, int ld) {
  const int chunks = d / 8;
  for (int c = threadIdx.x; c < kBQ * chunks; c += kThreads) {
    const int r = c / chunks;
    const int col = (c - r * chunks) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row0 + r < rows) load8(src + (size_t)(row0 + r) * d + col, a, b);
    store4(dst + r * ld + col, a);
    store4(dst + r * ld + col + 4, b);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NJ4>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int bh, int sq, int skv, int d, float scale,
                       int causal, int has_window, int window, int q_offset) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + kPad;
  float* qs = smem;               // [kBQ][ld]
  float* ks = qs + kBQ * ld;      // [kBK][ld]
  float* vs = ks + kBK * ld;      // [kBK][ld]
  float* ps = vs + kBK * ld;      // [kBQ][kPStride]

  const int nq = (sq + kBQ - 1) / kBQ;
  const int qt = nq - 1 - (int)(blockIdx.x / bh);  // heavy tiles first
  const int b = (int)(blockIdx.x % bh);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kBQ;

  const T* qb = q + (size_t)b * sq * d;
  const T* kb = k + (size_t)b * skv * d;
  const T* vb = v + (size_t)b * skv * d;
  T* ob = o + (size_t)b * sq * d;

  load_tile(qs, qb, q0, sq, d, ld);

  float m[4], l[4], acc[4][NJ4 * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ4 * 4; ++c) acc[i][c] = 0.f;
  }

  // The keys any row of this tile can see: [lo, hi].
  const int qa0 = q0 + q_offset;
  const int qa1 = min(q0 + kBQ, sq) - 1 + q_offset;
  int lo = 0, hi = skv - 1;
  if (has_window) lo = max(lo, qa0 - window + 1);
  if (causal) hi = min(hi, qa1);
  const int t_lo = lo / kBK;
  const int t_hi = hi >= lo ? hi / kBK : t_lo - 1;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's reads of ks, vs and ps are done
    load_tile(ks, kb, k0, skv, d, ld);
    load_tile(vs, vb, k0, skv, d, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int dd = 0; dd < d; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * ld + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          s[i][j] = x;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i + q_offset;
      bool valid[4];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        valid[j] = kj < skv && (!causal || kj <= qi) && (!has_window || kj > qi - window);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row_max16(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        rsum += p;
      }
      rsum = row_sum16(rsum);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NJ4 * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPStride + kk);
#pragma unroll
      for (int g = 0; g < NJ4; ++g) {
        const int col = (tx + 16 * g) * 4;
        if (col < d) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 vv = *reinterpret_cast<const float4*>(vs + (kk + e) * ld + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
              acc[i][g * 4 + 0] = fmaf(p, vv.x, acc[i][g * 4 + 0]);
              acc[i][g * 4 + 1] = fmaf(p, vv.y, acc[i][g * 4 + 1]);
              acc[i][g * 4 + 2] = fmaf(p, vv.z, acc[i][g * 4 + 2]);
              acc[i][g * 4 + 3] = fmaf(p, vv.w, acc[i][g * 4 + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int g = 0; g < NJ4; ++g) {
      const int col = (tx + 16 * g) * 4;
      if (col < d) {
        store4(ob + (size_t)r * d + col,
               make_float4(acc[i][g * 4 + 0] / denom, acc[i][g * 4 + 1] / denom,
                           acc[i][g * 4 + 2] / denom, acc[i][g * 4 + 3] / denom));
      }
    }
  }
}

template <typename T, int NJ4>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                   int skv, int d, float scale, int causal, int has_window, int window,
                   int q_offset, cudaStream_t stream) {
  const size_t ld = (size_t)d + kPad;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * kBK) * ld + (size_t)kBQ * kPStride);
  auto kernel = flash_attention_kernel<T, NJ4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((sq + kBQ - 1) / kBQ) * bh;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), bh, sq, skv, d, scale, causal, has_window, window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                     int skv, int d, float scale, int causal, int has_window, int window,
                     int q_offset, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 1>(q, k, v, o, bh, sq, skv, d, scale, causal, has_window, window,
                        q_offset, stream);
  if (d <= 128)
    return launch<T, 2>(q, k, v, o, bh, sq, skv, d, scale, causal, has_window, window,
                        q_offset, stream);
  return launch<T, 4>(q, k, v, o, bh, sq, skv, d, scale, causal, has_window, window,
                      q_offset, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The caller checks shapes (d a multiple
// of 8 up to 256, contiguous [bh, s, d] operands, 16-byte aligned) and
// passes bh, sq > 0. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int bh, int sq, int skv, int d, float scale,
                                      int causal, int has_window, int window, int q_offset,
                                      void* stream) {
  if (d % 8 != 0 || d < 8 || d > 256 || bh <= 0 || sq <= 0 || skv < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, bh, sq, skv, d, scale, causal, has_window, window,
                          q_offset, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d, scale, causal, has_window,
                                  window, q_offset, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
