// K1: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_fwd` of
// src/repro/kernels/flash_attention.py, and computes the function of the
// model's chunked jnp form `_flash_fwd_impl` (src/repro/models/attention.py):
// q (B,Hq,Sq,hd), k/v (B,Hk,Skv,hd); GQA with q head h reading KV head
// h / (Hq/Hk); top-left causal mask shifted by q0 (query row i sits at
// position q0 + i); optional sliding window (q_pos - kv_pos < window);
// masked scores are -1e30, the denominator is clamped at 1e-30; `out` in
// the input type, `lse = m + log(l)` in f32 (kept for the backward pass).
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): for a
// causal prefill at GPT-65B width (S = 2048, 64 heads, hd 128, bf16) the
// work is 2 * S^2 * hd * H ~= 6.9e10 FLOP (QK^T and PV, halved by the
// mask) -> 69 us at the tensor-core peak, while q, k, v and o are ~134 MB
// -> 40 us at the memory rate. So the bound is compute, and only the
// tensor cores can approach it.
//
// Design (simple first; wgmma, TMA, cp.async pipelining and warp
// specialisation come later). Both kernels take one block per (64-row Q
// tile, q head, batch), stage K/V tiles in shared memory and keep the
// online softmax (running max m, denominator l, rescale by exp(m - m'))
// in f32 registers. KV tiles that lie wholly above the causal diagonal of
// the block are skipped: every score in them is masked for every row, and
// the rows' running max is already finite there, so they add exactly 0.
// Heavy (late) Q tiles are launched first.
//
// * bf16 (the serving path): 4 warps, each owning 16 query rows, issue
//   `mma.sync.m16n8k16` bf16 products with f32 accumulation for S = Q K^T
//   and O += P V over 64-key tiles. Q stays in registers as A fragments;
//   K is staged row-major and V transposed (padded rows, so fragment
//   loads hit 32 distinct banks); the S accumulator is reused in
//   registers as the A fragment of P (rounded to bf16 for the product,
//   while l sums the f32 probabilities).
// * f32: the tensor cores would round to TF32, far outside the 1e-5
//   tolerance, so f32 runs on the CUDA cores: two threads per query row,
//   each owning half of the row's hd in interleaved float4 chunks, K/V
//   tiles of 32 keys staged as f32 and read by broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block (both kernels)
constexpr int THREADS = 128;    // 4 warps
constexpr float NEG_BIG = -1e30f;

typedef __nv_bfloat16 bf16;

// keys that may be unmasked for some row of the block start below this
__device__ __forceinline__ int kv_limit(int Skv, int causal, int q0, int qt,
                                        int Sq) {
  if (!causal) return Skv;
  const int last = q0 + min(qt * BQ + BQ, Sq) - 1;
  return max(0, min(Skv, last + 1));
}

__device__ __forceinline__ float masked(float x, int col, int qpos, int Skv,
                                        int causal, int window) {
  if (col >= Skv) return -INFINITY;  // past the end: not a key at all
  if ((causal && col > qpos) || (window >= 0 && qpos - col >= window))
    return NEG_BIG;
  return x;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int MK = 64;  // keys per tile

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile (A row-major 16x16, B col-major 16x8)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int Hq, int Hk, int Sq, int Skv, int q0,
              int causal, int window, float scale) {
  constexpr int KS = HD + 8;  // K row stride (bf16): fragment loads hit
  constexpr int VS = MK + 8;  // V^T row stride       distinct banks
  __shared__ __align__(16) bf16 ks[MK * KS];
  __shared__ __align__(16) bf16 vt[HD * VS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int64_t q_base = (int64_t)(b * Hq + h) * Sq * HD;
  const int64_t kv_base = (int64_t)(b * Hk + hk) * Skv * HD;
  const int row0 = qt * BQ + warp * 16 + g;  // this thread's rows: row0
  const int row1 = row0 + 8;                 // and row0 + 8
  const int qp0 = q0 + row0, qp1 = q0 + row1;

  uint32_t qa[HD / 16][4];  // Q as A fragments, one per 16-wide k step
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    const bf16* r0 = q + q_base + (int64_t)row0 * HD + c;
    const bf16* r1 = q + q_base + (int64_t)row1 * HD + c;
    qa[kk][0] = row0 < Sq ? ld32(r0) : 0u;
    qa[kk][1] = row1 < Sq ? ld32(r1) : 0u;
    qa[kk][2] = row0 < Sq ? ld32(r0 + 8) : 0u;
    qa[kk][3] = row1 < Sq ? ld32(r1 + 8) : 0u;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  const int kv_end = kv_limit(Skv, causal, q0, qt, Sq);
  const int ntiles = (kv_end + MK - 1) / MK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * MK;
    __syncthreads();  // the previous tile is fully consumed
    // K row-major: neighbouring threads read neighbouring 16-byte chunks
    for (int idx = tid; idx < MK * HD / 8; idx += THREADS) {
      const int j = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < Skv)
        kk = *reinterpret_cast<const uint4*>(k + kv_base +
                                             (int64_t)(k0 + j) * HD + d);
      *reinterpret_cast<uint4*>(&ks[j * KS + d]) = kk;
    }
    // V transposed: neighbouring threads take neighbouring keys, so the
    // 2-byte stores of one warp land in neighbouring shared addresses
    for (int idx = tid; idx < MK * HD / 8; idx += THREADS) {
      const int j = idx % MK, d = (idx / MK) * 8;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < Skv)
        vv = *reinterpret_cast<const uint4*>(v + kv_base +
                                             (int64_t)(k0 + j) * HD + d);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(d + i) * VS + j] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys per warp
    float s[MK / 8][4];
#pragma unroll
    for (int n = 0; n < MK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const bf16* kr = &ks[(n * 8 + g) * KS + kk * 16 + t4 * 2];
        mma16816(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mt0 = NEG_BIG, mt1 = NEG_BIG;
#pragma unroll
    for (int n = 0; n < MK / 8; ++n) {
      const int col = k0 + n * 8 + t4 * 2;
      s[n][0] = masked(s[n][0] * scale, col, qp0, Skv, causal, window);
      s[n][1] = masked(s[n][1] * scale, col + 1, qp0, Skv, causal, window);
      s[n][2] = masked(s[n][2] * scale, col, qp1, Skv, causal, window);
      s[n][3] = masked(s[n][3] * scale, col + 1, qp1, Skv, causal, window);
      mt0 = fmaxf(mt0, fmaxf(s[n][0], s[n][1]));
      mt1 = fmaxf(mt1, fmaxf(s[n][2], s[n][3]));
    }
    // a row's 64 scores sit in the 4 threads of its quad
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;  // per-thread partial sums; the quad is summed at the end
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
#pragma unroll
    for (int n = 0; n < MK / 8; ++n) {
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // O += P V: the S accumulator layout is the A fragment layout of P
#pragma unroll
    for (int j = 0; j < MK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack2(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack2(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack2(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack2(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const bf16* vr = &vt[(n * 8 + g) * VS + j * 16 + t4 * 2];
        mma16816(acc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(o + q_base + (int64_t)row0 * HD + c) =
          pack2(acc[n][0] / lc0, acc[n][1] / lc0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(o + q_base + (int64_t)row1 * HD + c) =
          pack2(acc[n][2] / lc1, acc[n][3] / lc1);
  }
  if (t4 == 0) {
    const int64_t lb = (int64_t)(b * Hq + h) * Sq;
    if (row0 < Sq) lse[lb + row0] = m0 + logf(lc0);
    if (row1 < Sq) lse[lb + row1] = m1 + logf(lc1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int FK = 32;  // keys per tile

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int Hq, int Hk, int Sq, int Skv, int q0,
              int causal, int window, float scale) {
  constexpr int NC = HD / 8;  // float4 chunks per thread (half a row)
  __shared__ __align__(16) float ks[FK][HD];
  __shared__ __align__(16) float vs[FK][HD];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int r = tid >> 1;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int row = qt * BQ + r;
  const bool valid = row < Sq;
  const int qpos = q0 + row;
  const int64_t q_base = (int64_t)(b * Hq + h) * Sq * HD;
  const int64_t kv_base = (int64_t)(b * Hk + hk) * Skv * HD;

  float4 qr[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (2 * c + half) * 4;
    qr[c] = valid ? *reinterpret_cast<const float4*>(q + q_base +
                                                     (int64_t)row * HD + d)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_BIG, l = 0.f;

  const int kv_end = kv_limit(Skv, causal, q0, qt, Sq);
  const int ntiles = (kv_end + FK - 1) / FK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * FK;
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < FK * HD / 4; idx += THREADS) {
      const int j = idx / (HD / 4);
      const int d = (idx % (HD / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + j < Skv) {
        const int64_t off = kv_base + (int64_t)(k0 + j) * HD + d;
        kk = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&ks[j][d]) = kk;
      *reinterpret_cast<float4*>(&vs[j][d]) = vv;
    }
    __syncthreads();

    float s[FK];
    float mt = NEG_BIG;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ks[j][(2 * c + half) * 4]);
        dot = fmaf(qr[c].x, kk.x, dot);
        dot = fmaf(qr[c].y, kk.y, dot);
        dot = fmaf(qr[c].z, kk.z, dot);
        dot = fmaf(qr[c].w, kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      s[j] = masked(dot * scale, k0 + j, qpos, Skv, causal, window);
      mt = fmaxf(mt, s[j]);
    }

    const float m2 = fmaxf(m, mt);
    const float corr = expf(m - m2);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c].x *= corr;
      acc[c].y *= corr;
      acc[c].z *= corr;
      acc[c].w *= corr;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      const float p = expf(s[j] - m2);
      psum += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j][(2 * c + half) * 4]);
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    l = corr * l + psum;
    m = m2;
  }

  if (!valid) return;
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (2 * c + half) * 4;
    *reinterpret_cast<float4*>(o + q_base + (int64_t)row * HD + d) =
        make_float4(acc[c].x / lc, acc[c].y / lc, acc[c].z / lc,
                    acc[c].w / lc);
  }
  if (half == 0) lse[(int64_t)(b * Hq + h) * Sq + row] = m + logf(lc);
}

template <typename T, int HD, typename K>
void launch(K kernel, const void* q, const void* k, const void* v, void* o,
            float* lse, int B, int Hq, int Hk, int Sq, int Skv, int q0,
            int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hk, Sq, Skv, q0,
      causal, window, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window < 0 means no window.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int Hq, int Hk, int Sq, int Skv, int hd,
                                   int dtype, int q0, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hk <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    launch<float, 64>(flash_fwd_f32<64>, q, k, v, o, lse, B, Hq, Hk, Sq, Skv,
                      q0, causal, window, scale, st);
  else if (dtype == 0 && hd == 128)
    launch<float, 128>(flash_fwd_f32<128>, q, k, v, o, lse, B, Hq, Hk, Sq,
                       Skv, q0, causal, window, scale, st);
  else if (dtype == 1 && hd == 64)
    launch<bf16, 64>(flash_fwd_mma<64>, q, k, v, o, lse, B, Hq, Hk, Sq, Skv,
                     q0, causal, window, scale, st);
  else if (dtype == 1 && hd == 128)
    launch<bf16, 128>(flash_fwd_mma<128>, q, k, v, o, lse, B, Hq, Hk, Sq,
                      Skv, q0, causal, window, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
