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
// numerator acc, all float32. Masked logits get probability 0, as in the
// TPU kernel, so a row whose first kv tiles are fully masked keeps
// m = -1e30 and alpha = 1 instead of exp(-inf - -inf) = NaN. A row that
// saw no key has l = 0, replaced by 1, and gives 0. The output has q's
// type.
//
// Grid. The TPU kernel walks the kv blocks of one (bh, q block) in order
// on one core and carries (m, l, acc) in VMEM scratch between grid steps.
// Here one thread block owns one (bh, q tile) and loops over the kv tiles
// of 64 keys itself; blocks share nothing. Tiles wholly above the causal
// diagonal or wholly outside the window are skipped, which is exact: a
// fully masked tile leaves m, l and acc unchanged. Heavy q tiles (late
// rows under causal masking) are launched first to shorten the tail.
//
// What bounds it. Causal attention at the LM's shape (BH = 128, S = 2048,
// D = 64) is 4*D FLOPs per visible (q, k) pair, 68.7 GFLOP, against 134
// MB of q, k, v and o: far above the card's ridge point, so the bound is
// the arithmetic. Two kernels, chosen by the type of the operands (a
// static rule, no fallback):
//
// Float32 (flash_attention_kernel): plain float32 FMAs, since float32
// parity at 2e-4 rules out TF32. 256 threads as a 16 x 16 grid (ty, tx)
// over a 64-row q tile; for the 64 x 64 logit tile a thread owns rows
// ty + 16i and keys tx + 16j and reads Q and K rows from shared memory as
// float4 (rows padded by 4 floats); the row max and sum are shuffles over
// 16 lanes; P goes through shared memory for O += P V. The next kv tile
// is loaded only after the current one is done.
//
// Bfloat16 (flash_attention_mma_kernel): the tensor cores through
// mma.sync.m16n8k16 (bf16 in, float32 sums), FA2's design. A block owns a
// 128-row q tile; each warp owns 16 * kMT rows (kMT = 2 at DP = 64, where
// the registers allow it, else 1) and reuses every K and V fragment it
// loads for all of its m-tiles. K and V tiles of 64 keys go through a
// two-stage cp.async ring (the next tile loads while this one is
// multiplied); Q stays in shared memory. Rows are DP = 64, 128 or 256
// values (a D below its template width is zero-padded in shared memory,
// which is exact) padded by 16 bytes, so the eight rows of an ldmatrix
// start 4 banks apart and every fragment offset is a constant. S = Q K^T
// comes from ldmatrix fragments of Q and K; the online softmax runs on the
// accumulator fragments in the exp2 domain (logits scaled by
// scale * log2 e, ex2.approx), with row max and sum over the four threads
// of a quad; masks are applied only on tiles that a causal diagonal, a
// window edge or the end of kv cuts, and a warp skips a tile its rows
// cannot see. P is packed straight from the registers into mma's A
// fragments for P V (V through ldmatrix.trans). Rounding P to bf16 there
// (FA2's and SDPA's choice) moves o by up to 2**-8 of a probability's
// share, which exceeds the check's atol of 1e-3 where the weights of a
// short row cancel; so P goes in as two bf16 halves, hi = bf16(p) and
// lo = bf16(p - hi), and P V takes two mma per fragment: P is carried to
// ~2**-17, and l sums the float32 p. That is 1.5x FA2's tensor-core work.
// The output is staged through the warp's own rows of the Q tile and
// written as 16-byte rows. At DP = 64 the kernel takes 204 registers, two
// blocks per SM; three (on an NVIDIA H100 80GB HBM3 at 700 W, 0.46 ms
// instead of 0.51 at the LM shape) would need 168 and spill. GQA indexing in place of the R-fold
// repeat of k and v, and a wgmma/TMA design in FA3's style, are later
// work.
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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

size_t f32_smem_bytes(int d) {
  const size_t ld = (size_t)d + kPad;
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * ld + (size_t)kBQ * kPStride);
}

template <int NJ4>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                       int skv, int d, float scale, int causal, int has_window, int window,
                       int q_offset, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(d);
  auto kernel = flash_attention_kernel<float, NJ4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((sq + kBQ - 1) / kBQ) * bh;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), bh, sq, skv, d, scale, causal, has_window, window, q_offset);
  return cudaGetLastError();
}

// -- bfloat16: mma.sync tensor cores ---------------------------------------------

constexpr int kTcBQ = 128;    // q rows per block
constexpr int kTcBK = 64;     // keys per kv tile
constexpr int kTcStages = 2;  // kv tiles in the cp.async ring

// Each warp owns MT m-tiles of 16 q rows and reuses every K and V fragment
// it loads for all of them: two at DP = 64 (4 warps), where registers
// allow it; one at DP = 128 and 256 (8 warps).
template <int DP>
struct TcShape {
  static constexpr int kMT = DP == 64 ? 2 : 1;
  static constexpr int kWarps = kTcBQ / (16 * kMT);
  static constexpr int kThreads = 32 * kWarps;
  // Shared rows are padded by 16 bytes: the eight rows an ldmatrix reads
  // start 4 banks apart, so they meet 32 distinct banks.
  static constexpr int kRowBytes = DP * 2 + 16;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16 x 8, float32) += a (16 x 16 bf16, row-major fragment) . b (16 x 8
// bf16, column-major fragment).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2**x (the hardware's approximation, ~2 ulp; 2**-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16(x - hi, y - hi),
// x in the low half of each.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of DP-wide
// bf16 rows.
template <int DP>
__device__ __forceinline__ uint32_t at(int row, int chunk) {
  return (uint32_t)(row * TcShape<DP>::kRowBytes + chunk * 16);
}

// Rows [row0, row0 + NROWS) of a [rows, d] bf16 matrix into the padded
// tile at shared address `tile`, with cp.async; rows past the end and
// columns past d are zero. Thread t copies chunk t % (DP / 8) of rows
// t / (DP / 8) + i * kStep: everything but row0 is worked out from the
// thread's index, which costs less than the registers to keep it.
template <int DP, int NROWS>
__device__ __forceinline__ void load_tile_async(uint32_t tile,
                                                const __nv_bfloat16* __restrict__ base, int row0,
                                                int rows, int d) {
  constexpr int kChunks = DP / 8;
  constexpr int kStep = TcShape<DP>::kThreads / kChunks;  // rows between a thread's copies
  const int r = threadIdx.x / kChunks;
  const int ch = threadIdx.x % kChunks;
  const __nv_bfloat16* src = base + (size_t)(row0 + r) * d + ch * 8;
  const uint32_t dst = tile + at<DP>(r, ch);
#pragma unroll
  for (int i = 0; i < NROWS / kStep; ++i) {
    const bool ok = 8 * ch < d && row0 + r + i * kStep < rows;
    cp_async16(dst + i * kStep * TcShape<DP>::kRowBytes,
               ok ? src + (size_t)i * kStep * d : base, ok ? 16 : 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(TcShape<DP>::kThreads, DP == 64 ? 2 : 1)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int bh, int sq, int skv, int d, float scale_log2, int causal,
                           int has_window, int window, int q_offset) {
  constexpr int kMT = TcShape<DP>::kMT;
  constexpr int kRows = 16 * kMT;      // q rows of one warp
  constexpr int kTile = kTcBK * TcShape<DP>::kRowBytes;  // bytes of one K or V tile
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t qs = smem_u32(smem_tc);    // [kTcBQ][DP]
  const uint32_t kvs = qs + kTcBQ * TcShape<DP>::kRowBytes;  // stage s: K, then V

  const int nq = (sq + kTcBQ - 1) / kTcBQ;
  const int qt = nq - 1 - (int)(blockIdx.x / bh);  // heavy tiles first
  const int b = (int)(blockIdx.x % bh);
  const int q0 = qt * kTcBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and row + 8)
  const int tq = lane % 4;  // fragment column pair

  const __nv_bfloat16* qb = q + (size_t)b * sq * d;
  const __nv_bfloat16* kb = k + (size_t)b * skv * d;
  const __nv_bfloat16* vb = v + (size_t)b * skv * d;
  __nv_bfloat16* ob = o + (size_t)b * sq * d;

  // The keys any row of this tile can see: [lo, hi].
  const int qa0 = q0 + q_offset;
  const int qa1 = min(q0 + kTcBQ, sq) - 1 + q_offset;
  int lo = 0, hi = skv - 1;
  if (has_window) lo = max(lo, qa0 - window + 1);
  if (causal) hi = min(hi, qa1);
  const int t_lo = lo / kTcBK;
  const int n_tiles = hi >= lo ? hi / kTcBK - t_lo + 1 : 0;

  load_tile_async<DP, kTcBQ>(qs, qb, q0, sq, d);
  if (n_tiles > 0) {
    load_tile_async<DP, kTcBK>(kvs, kb, t_lo * kTcBK, skv, d);
    load_tile_async<DP, kTcBK>(kvs + kTile, vb, t_lo * kTcBK, skv, d);
  }
  cp_async_commit();

  // This warp's rows: tile rows wrow.., absolute positions wr0..wr0 + kRows - 1.
  const int wrow = kRows * warp;
  const int wr0 = q0 + wrow + q_offset;
  const bool live = q0 + wrow < sq;

  float acc[kMT][DP / 8][4];
  float m[kMT][2], l[kMT][2];  // running max (log2 domain) and this thread's share of the sum
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (i + 1 < n_tiles) {
      const uint32_t next = kvs + ((i + 1) % kTcStages) * 2 * kTile;
      load_tile_async<DP, kTcBK>(next, kb, (t_lo + i + 1) * kTcBK, skv, d);
      load_tile_async<DP, kTcBK>(next + kTile, vb, (t_lo + i + 1) * kTcBK, skv, d);
    }
    cp_async_commit();

    const int k0 = (t_lo + i) * kTcBK;
    if (!live || (causal && k0 > wr0 + kRows - 1) ||
        (has_window && k0 + kTcBK - 1 <= wr0 - window))
      continue;  // no key of this tile is visible to the warp's rows
    const uint32_t ks = kvs + (i % kTcStages) * 2 * kTile;
    const uint32_t vs = ks + kTile;

    // S = Q K^T for kRows rows x 64 keys: s[mt][j] is keys 8j..8j+7.
    float s[kMT][kTcBK / 8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kTcBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (16 * kk >= d) break;
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldsm_x4(a[mt], qs + at<DP>(wrow + 16 * mt + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < kTcBK / 16; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + at<DP>(16 * jp + (lane & 7) + ((lane >> 4) << 3),
                                 2 * kk + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * jp], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * jp + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // Logits in the log2 domain; masked ones are -inf (probability 0).
    const bool edge = k0 + kTcBK > skv || (causal && k0 + kTcBK - 1 > wr0) ||
                      (has_window && k0 <= wr0 + kRows - 1 - window);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < kTcBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * tq + (e & 1);
            const int qi = wr0 + 16 * mt + g + (e & 2 ? 8 : 0);
            const bool vis = key < skv && (!causal || key <= qi) &&
                             (!has_window || key > qi - window);
            if (!vis) x = __int_as_float(0xff800000);
          }
          s[mt][j][e] = x;
        }
      }
    }

    // Online softmax; each row lives in the four threads of a quad. P is
    // packed at once as hi + lo bf16 halves in the layout of mma's A
    // fragment (kk: keys 16 kk..16 kk + 15), so the float32 logits die here.
    uint32_t ph[kMT][kTcBK / 16][4], pl[kMT][kTcBK / 16][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
      for (int j = 0; j < kTcBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][j][0], s[mt][j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][j][2], s[mt][j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = fast_exp2(m[mt][0] - mx0);
      const float alpha1 = fast_exp2(m[mt][1] - mx1);
      m[mt][0] = mx0;
      m[mt][1] = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kTcBK / 8; ++j) {
        const float p0 = fast_exp2(s[mt][j][0] - mx0);
        const float p1 = fast_exp2(s[mt][j][1] - mx0);
        const float p2 = fast_exp2(s[mt][j][2] - mx1);
        const float p3 = fast_exp2(s[mt][j][3] - mx1);
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        // Keys 8j..8j+7 are half (j % 2) of step j / 2: a0/a1 or a2/a3.
        split_bf16(p0, p1, ph[mt][j / 2][2 * (j % 2)], pl[mt][j / 2][2 * (j % 2)]);
        split_bf16(p2, p3, ph[mt][j / 2][2 * (j % 2) + 1], pl[mt][j / 2][2 * (j % 2) + 1]);
      }
      l[mt][0] = l[mt][0] * alpha0 + rs0;
      l[mt][1] = l[mt][1] * alpha1 + rs1;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[mt][n][0] *= alpha0;
        acc[mt][n][1] *= alpha0;
        acc[mt][n][2] *= alpha1;
        acc[mt][n][3] *= alpha1;
      }
    }

    // O += P V, V through ldmatrix.trans, each fragment shared by the m-tiles.
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        if (16 * np >= d) break;
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + at<DP>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                       2 * np + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * np], ph[mt][kk], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * np + 1], ph[mt][kk], bv[2], bv[3]);
          mma_bf16(acc[mt][2 * np], pl[mt][kk], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * np + 1], pl[mt][kk], bv[2], bv[3]);
        }
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();  // every copy into the Q tile has landed before it is reused
  if (!live) return;
  // The warp's rows of O, in bf16, into its own rows of the Q tile ...
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    const int r0 = wrow + 16 * mt + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      if (8 * n >= d) break;
      *reinterpret_cast<__nv_bfloat162*>(smem_tc + at<DP>(r0, n) + 4 * tq) =
          __floats2bfloat162_rn(acc[mt][n][0] * inv0, acc[mt][n][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(smem_tc + at<DP>(r0 + 8, n) + 4 * tq) =
          __floats2bfloat162_rn(acc[mt][n][2] * inv1, acc[mt][n][3] * inv1);
    }
  }
  __syncwarp();
  // ... then out as 16-byte pieces of rows.
  const int dc = d / 8;
  for (int c = lane; c < kRows * dc; c += 32) {
    const int r = c / dc;
    const int ch = c - r * dc;
    if (q0 + wrow + r < sq)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + wrow + r) * d + ch * 8) =
          *reinterpret_cast<const uint4*>(smem_tc + at<DP>(wrow + r, ch));
  }
}

template <int DP>
constexpr int bf16_smem_bytes() {
  return TcShape<DP>::kRowBytes * (kTcBQ + 2 * kTcStages * kTcBK);
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                        int skv, int d, float scale, int causal, int has_window, int window,
                        int q_offset, cudaStream_t stream) {
  const int smem = bf16_smem_bytes<DP>();
  auto kernel = flash_attention_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((sq + kTcBQ - 1) / kTcBQ) * bh;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  kernel<<<(unsigned)blocks, TcShape<DP>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), bh, sq, skv, d,
      scale_log2, causal, has_window, window, q_offset);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*, int, int, int, int,
                               float, int, int, int, int, cudaStream_t);

// Float32 by columns per thread (NJ4 float4 groups of 64 columns), bf16 by
// the padded row width DP.
Launch pick(int dtype, int d) {
  if (dtype == 0) {
    if (d <= 64) return launch_f32<1>;
    if (d <= 128) return launch_f32<2>;
    return launch_f32<4>;
  }
  if (d <= 64) return launch_bf16<64>;
  if (d <= 128) return launch_bf16<128>;
  return launch_bf16<256>;
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (mma.sync kernel). The
// caller checks shapes (d a multiple of 8 up to 256, contiguous [bh, s, d]
// operands, 16-byte aligned) and passes bh, sq > 0. Returns the launch's
// cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int bh, int sq, int skv, int d, float scale,
                                      int causal, int has_window, int window, int q_offset,
                                      void* stream) {
  if (d % 8 != 0 || d < 8 || d > 256 || bh <= 0 || sq <= 0 || skv < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)pick(dtype, d)(q, k, v, o, bh, sq, skv, d, scale, causal, has_window, window,
                             q_offset, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) a launch of the given type and d asks for.
extern "C" int flash_attention_smem_bytes(int dtype, int d) {
  if (dtype == 0) return (int)f32_smem_bytes(d);
  if (d <= 64) return bf16_smem_bytes<64>();
  if (d <= 128) return bf16_smem_bytes<128>();
  return bf16_smem_bytes<256>();
}
