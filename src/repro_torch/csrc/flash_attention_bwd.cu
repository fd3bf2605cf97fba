// K1 backward: flash-attention backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces: K1's Pallas kernel (src/repro/kernels/flash_attention.py) is
// forward only; the reference's backward is the chunked jnp VJP
// `_flash_vjp_bwd` (src/repro/models/attention.py), which this computes:
// for q (B,Hq,Sq,hd), k (B,Hk,Skv,hd), v (B,Hk,Skv,hdv), the forward's out
// and lse (f32) and dO (B,Hq,Sq,hdv), with GQA (q head h reads KV head h / (Hq/Hk)), the top-left
// causal mask from position 0 and an optional sliding window,
//
//   delta_i = sum_d dO_id O_id
//   P_ij    = exp(scale q_i.k_j - lse_i)   (0 where masked)
//   dV_j    = sum_i P_ij dO_i              dP_ij = dO_i.v_j
//   dS_ij   = P_ij (dP_ij - delta_i) scale
//   dQ_i    = sum_j dS_ij k_j              dK_j  = sum_i dS_ij q_i
//
// with dK and dV summed over the G query heads of each KV head. Outputs
// are in the inputs' type (f32 or bf16); sums are f32.
//
// Bound on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at the GPT-65B
// training shape (S = 2048, 64 heads, hd 128, bf16, causal) the five
// S x S x hd products (QK^T, dO V^T, P^T dO, dS K, dS^T Q), halved by the
// mask, are 5 S^2 hd H ~= 1.72e11 FLOP -> 0.174 ms on the tensor cores,
// while q, k, v, o, dO, dq, dk, dv and lse are ~134 MB -> 0.040 ms at the
// memory rate. So the bound is the tensor cores' rate.
//
// Determinism: no float atomics. Three launches on one stream (delta,
// then dK/dV, then dQ), each output element written by one thread after
// a sum in a fixed order, so two runs give the same bits. The dQ pass
// recomputes S and dP, so the kernels do 7 products where the bound
// counts 5.
//
// bf16: tensor cores (`mma.sync.m16n8k16` bf16 -> f32), 4 warps a block.
// Tiles live in shared memory as bf16 rows padded by 16 bytes (row
// stride hd + 8), so the 8 row addresses of an `ldmatrix` land in 8
// distinct 16-byte bank groups; they are filled by 16-byte
// `cp.async.cg` copies (zero-filled past S) into two-stage rings, so the
// next tile is in flight while the current one is computed.
//  1. delta: one warp per query row, a fixed shuffle tree.
//  2. dK/dV: a block per (64-key tile, KV head, batch), each warp owning
//     16 keys. K and V stay resident; the block walks the G query heads
//     of the KV head and, within each, the BQ-row Q tiles that can see
//     its keys (the causal mask and the window bound the range), as one
//     sequence, so the ring prefetches across heads too. Per step a warp
//     computes S^T = K Q^T and dP^T = V dO^T (keys as the M dimension),
//     so the f32 accumulators of P^T and dS^T = P^T (dP^T - delta),
//     rounded to bf16, are directly the A fragments of dV += P^T dO and
//     dK += dS^T Q: no score tile goes through shared memory. dO and Q
//     enter those products through `ldmatrix.trans`.
//  3. dQ: a block per (64-row Q tile, q head, batch), heavy tiles
//     first, each warp owning 16 rows. Q, dO, lse and delta stay
//     resident; K and V are double-buffered. dS is the A fragment of
//     dQ += dS K (K through `ldmatrix.trans`).
// P = exp2(S scale log2(e) - lse log2(e)); the scale of dS is applied
// once to the f32 dK and dQ. Tiles wholly outside the causal mask or
// the window are never visited; per-element masks run only on tiles
// that cross an edge (diagonal, window edge, ragged S).
//
// Per kernel (`-Xptxas -v`, CUDA 12.8, sm_90a; no spills; blocks per SM
// from registers and shared memory):
//   hd 128: dK/dV 32 query rows a step, 236 registers, 70,144 B of
//           shared memory, 2 blocks (8 warps) per SM; dQ 64 keys a step,
//           171 registers, 104,448 B, 2 blocks per SM.
//   hd 64:  dK/dV 64 rows a step, 188 registers, 56,320 B, 2 blocks;
//           dQ 168 registers, 55,296 B, 3 blocks per SM.
//   hd 32:  the hd 64 tiling with two k16 steps along hd and rows of 40
//           bf16 (80 bytes: the 8 rows of an `ldmatrix` still fall in 8
//           distinct 16-byte bank groups), 4 16-byte copies a row.
//   (48, 32) (MLA at SMOKE size): q/k rows of 56 bf16 (112 bytes, again
//           8 distinct bank groups), 6 16-byte copies a row, three k16
//           steps along q/k (columns 0-47, none past the row), dK and dQ
//           as three n16 column pairs; v rows as at hd 32.
// Per step a dK/dV warp at hd 128 keeps 128 f32 accumulators (dK and dV
// for 16 keys) and 32 for S^T and dP^T; the 32-row step is what keeps
// that without a spill.
//   hd 256 (gemma3) and (192, 128) (MLA, v head dim 128): a block writes
//   half of the output columns (NS = 2 column parts, a grid dimension),
//   so its accumulators are those of hd 128 or fewer; each part
//   recomputes S and dP over the whole head dim. Shared memory at 256:
//   dK/dV 135,168 B, dQ 202,752 B (one block per SM).
//
// f32: the tensor cores would round to TF32, outside the 1e-5 tolerance,
// so f32 keeps the CUDA-core design: BT x BT tiles staged as f32 with a
// row stride of hd + 1, 256 threads as 16 x 16, each owning an R x R
// sub-tile of the score tile (R = BT / 16) and R rows x hd/16 columns of
// the outputs. BT is 64, or 32 when hd + hdv passes 256 (the four staged
// tiles then stay in shared memory).
//
// Later work: Hopper's own path for the bf16 kernels (`wgmma` with the
// K/V tile as the shared-memory operand, TMA loads into an mbarrier
// ring, warp specialisation), and one fused dK/dV + dQ pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ bool allowed(int r, int c, int Sq, int Skv,
                                        int causal, int window) {
  if (r >= Sq || c >= Skv) return false;
  if (causal && c > r) return false;
  if (window >= 0 && r - c >= window) return false;
  return true;
}

// rows [r0, r0 + BT) of a (S, HD) matrix -> f32 shared tile, zero past S
template <typename T, int HD, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S) {
  for (int idx = threadIdx.x; idx < BT * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    dst[r * (HD + 1) + d] =
        r0 + r < S ? to_f(src[(int64_t)(r0 + r) * HD + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
             float* __restrict__ delta, int64_t rows, int hd) {
  const int64_t row =
      (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32)
    s = fmaf(to_f(o[row * hd + d]), to_f(dO[row * hd + d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int HQK, int HV>
struct F32Tiles {
  static constexpr int BT = HQK + HV > 256 ? 32 : 64;  // rows and keys a tile
  static constexpr int R = BT / 16;                    // sub-tile side
  static constexpr int SLD = BT + 1;                   // score-tile stride
  static constexpr int LDQ = HQK + 1, LDV = HV + 1;
  static constexpr size_t DKDV_SMEM =
      sizeof(float) * (2 * BT * LDQ + 2 * BT * LDV + 2 * BT * SLD + 2 * BT);
  static constexpr size_t DQ_SMEM =
      sizeof(float) * (2 * BT * LDQ + 2 * BT * LDV + BT * SLD + 2 * BT);
};

// S = Q K^T and dP = dO V^T for the thread's R x R sub-tile (rows
// ty + 16 i of qs/dos, keys tx + 16 j of ks/vs), then P and dS
template <int HQK, int HV>
__device__ __forceinline__ void scores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* del_s, int r0, int c0, int Sq, int Skv,
    int causal, int window, float scale,
    float p[F32Tiles<HQK, HV>::R][F32Tiles<HQK, HV>::R],
    float ds[F32Tiles<HQK, HV>::R][F32Tiles<HQK, HV>::R]) {
  using F = F32Tiles<HQK, HV>;
  constexpr int R = F::R, LDQ = F::LDQ, LDV = F::LDV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HQK; ++d) {
    float qa[R], kk[R];
#pragma unroll
    for (int i = 0; i < R; ++i) qa[i] = qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
    for (int j = 0; j < R; ++j) kk[j] = ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
  }
#pragma unroll 4
  for (int d = 0; d < HV; ++d) {
    float da[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) da[i] = dos[(ty + 16 * i) * LDV + d];
#pragma unroll
    for (int j = 0; j < R; ++j) vv[j] = vs[(tx + 16 * j) * LDV + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) dp[i][j] = fmaf(da[i], vv[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int ri = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool ok =
          allowed(r0 + ri, c0 + tx + 16 * j, Sq, Skv, causal, window);
      p[i][j] = ok ? expf(s[i][j] * scale - lse_s[ri]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - del_s[ri]) * scale;
    }
  }
}

template <typename T, int HQK, int HV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hk, int Sq,
               int Skv, int causal, int window, float scale) {
  using F = F32Tiles<HQK, HV>;
  constexpr int BT = F::BT, R = F::R, SLD = F::SLD;
  constexpr int LDQ = F::LDQ, LDV = F::LDV;
  constexpr int NJQ = HQK / 16, NJV = HV / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BT * LDQ;
  float* qs = vs + BT * LDV;
  float* dos = qs + BT * LDQ;
  float* ps = dos + BT * LDV;
  float* dss = ps + BT * SLD;
  float* lse_s = dss + BT * SLD;
  float* del_s = lse_s + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int c0 = blockIdx.x * BT;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hk;
  const int64_t kb = ((int64_t)b * Hk + hk) * Skv;
  load_tile<T, HQK, BT>(ks, k + kb * HQK, c0, Skv);
  load_tile<T, HV, BT>(vs, v + kb * HV, c0, Skv);

  float dka[R][NJQ], dva[R][NJV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < NJQ; ++j) dka[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NJV; ++j) dva[i][j] = 0.f;
  }

  // query rows that can see a key of this tile
  const int c_last = min(c0 + BT, Skv) - 1;
  const int r_lo = causal ? c0 : 0;
  const int r_hi = window >= 0 ? min(Sq, c_last + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int64_t qb = ((int64_t)b * Hq + hk * G + g) * Sq;
    for (int r0 = (r_lo / BT) * BT; r0 < r_hi; r0 += BT) {
      __syncthreads();  // the previous tile is fully consumed
      load_tile<T, HQK, BT>(qs, q + qb * HQK, r0, Sq);
      load_tile<T, HV, BT>(dos, dO + qb * HV, r0, Sq);
      for (int i = threadIdx.x; i < BT; i += THREADS) {
        lse_s[i] = r0 + i < Sq ? lse[qb + r0 + i] : 0.f;
        del_s[i] = r0 + i < Sq ? delta[qb + r0 + i] : 0.f;
      }
      __syncthreads();
      float p[R][R], ds[R][R];
      scores<HQK, HV>(qs, dos, ks, vs, lse_s, del_s, r0, c0, Sq, Skv, causal,
                      window, scale, p, ds);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          ps[(ty + 16 * i) * SLD + tx + 16 * j] = p[i][j];
          dss[(ty + 16 * i) * SLD + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV_c += sum_r P_rc dO_r ; dK_c += sum_r dS_rc q_r (keys ty + 16 i)
      for (int r = 0; r < BT; ++r) {
        float pv[R], dsv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = ps[r * SLD + ty + 16 * i];
          dsv[i] = dss[r * SLD + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJV; ++j) {
          const float dov = dos[r * LDV + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i) dva[i][j] = fmaf(pv[i], dov, dva[i][j]);
        }
#pragma unroll
        for (int j = 0; j < NJQ; ++j) {
          const float qv = qs[r * LDQ + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i) dka[i][j] = fmaf(dsv[i], qv, dka[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= Skv) continue;
#pragma unroll
    for (int j = 0; j < NJQ; ++j)
      store(&dk[(kb + c) * HQK + tx + 16 * j], dka[i][j]);
#pragma unroll
    for (int j = 0; j < NJV; ++j)
      store(&dv[(kb + c) * HV + tx + 16 * j], dva[i][j]);
  }
}

template <typename T, int HQK, int HV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int Hq, int Hk, int Sq, int Skv, int causal,
             int window, float scale) {
  using F = F32Tiles<HQK, HV>;
  constexpr int BT = F::BT, R = F::R, SLD = F::SLD;
  constexpr int LDQ = F::LDQ, LDV = F::LDV;
  constexpr int NJ = HQK / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BT * LDQ;
  float* ks = dos + BT * LDV;
  float* vs = ks + BT * LDQ;
  float* dss = vs + BT * LDV;
  float* lse_s = dss + BT * SLD;
  float* del_s = lse_s + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BT;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int64_t qb = ((int64_t)b * Hq + h) * Sq;
  const int64_t kb = ((int64_t)b * Hk + hk) * Skv;
  load_tile<T, HQK, BT>(qs, q + qb * HQK, r0, Sq);
  load_tile<T, HV, BT>(dos, dO + qb * HV, r0, Sq);
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    lse_s[i] = r0 + i < Sq ? lse[qb + r0 + i] : 0.f;
    del_s[i] = r0 + i < Sq ? delta[qb + r0 + i] : 0.f;
  }

  float acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // keys that some row of this tile can see
  const int r_last = min(r0 + BT, Sq) - 1;
  const int c_hi = causal ? min(Skv, r_last + 1) : Skv;
  const int c_lo = window >= 0 ? max(0, r0 - window + 1) : 0;
  for (int c0 = (c_lo / BT) * BT; c0 < c_hi; c0 += BT) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile<T, HQK, BT>(ks, k + kb * HQK, c0, Skv);
    load_tile<T, HV, BT>(vs, v + kb * HV, c0, Skv);
    __syncthreads();
    float p[R][R], ds[R][R];
    scores<HQK, HV>(qs, dos, ks, vs, lse_s, del_s, r0, c0, Sq, Skv, causal,
                    window, scale, p, ds);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        dss[(ty + 16 * i) * SLD + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ_r += sum_c dS_rc k_c (rows ty + 16 i)
    for (int c = 0; c < BT; ++c) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dss[(ty + 16 * i) * SLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[c * LDQ + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store(&dq[(qb + r) * HQK + tx + 16 * j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int MT = 128;                  // threads of a bf16 block: 4 warps
constexpr float LOG2E = 1.4426950408889634f;

template <int HQK, int HV>
struct Tiles {
  static constexpr int LDQ = HQK + 8;    // padded row strides (bf16) of
  static constexpr int LDV = HV + 8;     // q/k/dq/dk rows and v/o/dv rows
  static constexpr int NS = HQK > 128 ? 2 : 1;  // output column parts
  static constexpr int QC = HQK / NS;    // dK / dQ columns a block writes
  static constexpr int VC = HV / NS;     // dV columns a block writes
  static constexpr int BK = 64;          // dK/dV: keys a block, 16 a warp
  static constexpr int BQ = HQK + HV >= 256 ? 32 : 64;  // dK/dV: rows a step
  static constexpr int QR = 64;          // dQ: rows a block, 16 a warp
  static constexpr int KC = 64;          // dQ: keys a step
  static constexpr size_t DKDV_SMEM =
      2 * (BK + 2 * BQ) * (LDQ + LDV) + 4 * 4 * BQ;
  static constexpr size_t DQ_SMEM = 2 * (QR + 2 * KC) * (LDQ + LDV);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives its fragment of each
__device__ __forceinline__ void ldsm4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix address offsets (in elements, row stride LDS) of the three
// fragment kinds, for a 16 x 16 block at (row 0, column 0):
//  A (16 rows x 16 k, k contiguous): matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
template <int LDS>
__device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * LDS + (lane >> 4) * 8;
}
//  B of two n8 tiles from rows = n, k contiguous (x4: b0 b1 of n 0-7,
//  then of n 8-15)
template <int LDS>
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
}
//  B of two n8 tiles from rows = k, n contiguous, through .trans
template <int LDS>
__device__ __forceinline__ int bt_off(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDS + (lane >> 4) * 8;
}

// rows [r0, r0 + ROWS) of a (S, HD) bf16 matrix -> padded shared rows
template <int HD, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0,
                                           int S) {
  constexpr int LDS = HD + 8, CPR = HD / 8;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += MT) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LDS + c * 8,
               src + (int64_t)(ok ? r0 + r : 0) * HD + c * 8, ok ? 16 : 0);
  }
}

template <int ROWS>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int r0, int S) {
  for (int i = threadIdx.x; i < ROWS; i += MT) {
    const bool ok = r0 + i < S;
    cp_async4(dst + i, src + (ok ? r0 + i : 0), ok ? 4 : 0);
  }
}

template <int HQK, int HV>
__global__ void __launch_bounds__(MT)
bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq, int Hk,
             int Sq, int Skv, int causal, int window, float scale) {
  using T = Tiles<HQK, HV>;
  constexpr int LDQ = T::LDQ, LDV = T::LDV, BK = T::BK, BQ = T::BQ;
  constexpr int QC = T::QC, VC = T::VC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BK * LDQ;
  bf16* qs = vs + BK * LDV;       // [2][BQ][LDQ]
  bf16* dos = qs + 2 * BQ * LDQ;  // [2][BQ][LDV]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LDV);  // [2][BQ]
  float* del_s = lse_s + 2 * BQ;                                // [2][BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * BK;
  const int hk = blockIdx.y / T::NS, b = blockIdx.z;
  const int cq = (blockIdx.y % T::NS) * QC, cv = (blockIdx.y % T::NS) * VC;
  const int G = Hq / Hk;
  const int64_t kb = ((int64_t)b * Hk + hk) * Skv;

  // query rows that can see a key of this tile
  const int c_last = min(c0 + BK, Skv) - 1;
  const int r_lo = causal ? (c0 / BQ) * BQ : 0;
  const int r_hi = window >= 0 ? min(Sq, c_last + window) : Sq;
  const int nq = r_hi > r_lo ? (r_hi - r_lo + BQ - 1) / BQ : 0;
  const int nsteps = G * nq;  // (query head, Q tile) steps, heads outer

  auto prefetch = [&](int s) {
    const int st = s & 1, r0 = r_lo + (s % nq) * BQ;
    const int64_t qb = ((int64_t)b * Hq + hk * G + s / nq) * Sq;
    stage_rows<HQK, BQ>(qs + st * BQ * LDQ, q + qb * HQK, r0, Sq);
    stage_rows<HV, BQ>(dos + st * BQ * LDV, dO + qb * HV, r0, Sq);
    stage_vec<BQ>(lse_s + st * BQ, lse + qb, r0, Sq);
    stage_vec<BQ>(del_s + st * BQ, delta + qb, r0, Sq);
  };
  stage_rows<HQK, BK>(ks, k + kb * HQK, c0, Skv);
  stage_rows<HV, BK>(vs, v + kb * HV, c0, Skv);
  if (nsteps > 0) prefetch(0);
  cp_commit();

  float dka[QC / 8][4], dva[VC / 8][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < QC / 8; ++n) dka[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < VC / 8; ++n) dva[n][e] = 0.f;
  }

  const float sl2 = scale * LOG2E;
  const int kr = warp * 16;  // the warp's keys in the tile
  const int key0 = c0 + kr + g, key1 = key0 + 8;
  const bf16* kw = ks + kr * LDQ + a_off<LDQ>(lane);
  const bf16* vw = vs + kr * LDV + a_off<LDV>(lane);

  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) prefetch(s + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = s & 1, r0 = r_lo + (s % nq) * BQ;
    const bf16* qt = qs + st * BQ * LDQ;
    const bf16* dot = dos + st * BQ * LDV;
    const float* lt = lse_s + st * BQ;
    const float* dt = del_s + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ rows per warp
    float sT[BQ / 8][4], dpT[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HQK / 16; ++kk) {
      uint32_t ka[4];
      ldsm4(ka, kw + kk * 16);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t fb[4];
        ldsm4(fb, qt + np * 16 * LDQ + b_off<LDQ>(lane) + kk * 16);
        mma16816(sT[2 * np], ka, fb[0], fb[1]);
        mma16816(sT[2 * np + 1], ka, fb[2], fb[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < HV / 16; ++kk) {
      uint32_t va[4];
      ldsm4(va, vw + kk * 16);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t fb[4];
        ldsm4(fb, dot + np * 16 * LDV + b_off<LDV>(lane) + kk * 16);
        mma16816(dpT[2 * np], va, fb[0], fb[1]);
        mma16816(dpT[2 * np + 1], va, fb[2], fb[3]);
      }
    }

    // P^T and dS^T (unscaled) in place; per-element masks on edge tiles
    const bool edge = r0 + BQ > Sq || c0 + BK > Skv ||
                      (causal && c0 + BK - 1 > r0) ||
                      (window >= 0 && r0 + BQ - 1 - c0 >= window);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const int qi = n * 8 + t4 * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + qi);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        float p = exp2f(fmaf(sT[n][e], sl2, -lv * LOG2E));
        if (edge && !allowed(r0 + qi + (e & 1), e < 2 ? key0 : key1, Sq, Skv,
                             causal, window))
          p = 0.f;
        sT[n][e] = p;
        dpT[n][e] = p * (dpT[n][e] - dl);
      }
    }

    // dV += P^T dO and dK += dS^T Q: the accumulators of P^T / dS^T are
    // the A fragments (keys x query rows), dO and Q enter transposed
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint32_t pa[4] = {pack2(sT[2 * j][0], sT[2 * j][1]),
                              pack2(sT[2 * j][2], sT[2 * j][3]),
                              pack2(sT[2 * j + 1][0], sT[2 * j + 1][1]),
                              pack2(sT[2 * j + 1][2], sT[2 * j + 1][3])};
      const uint32_t da[4] = {pack2(dpT[2 * j][0], dpT[2 * j][1]),
                              pack2(dpT[2 * j][2], dpT[2 * j][3]),
                              pack2(dpT[2 * j + 1][0], dpT[2 * j + 1][1]),
                              pack2(dpT[2 * j + 1][2], dpT[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < VC / 16; ++np) {
        uint32_t fb[4];
        ldsm4t(fb, dot + j * 16 * LDV + bt_off<LDV>(lane) + cv + np * 16);
        mma16816(dva[2 * np], pa, fb[0], fb[1]);
        mma16816(dva[2 * np + 1], pa, fb[2], fb[3]);
      }
#pragma unroll
      for (int np = 0; np < QC / 16; ++np) {
        uint32_t fb[4];
        ldsm4t(fb, qt + j * 16 * LDQ + bt_off<LDQ>(lane) + cq + np * 16);
        mma16816(dka[2 * np], da, fb[0], fb[1]);
        mma16816(dka[2 * np + 1], da, fb[2], fb[3]);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int n = 0; n < QC / 8; ++n) {
    const int c = cq + n * 8 + t4 * 2;
    if (key0 < Skv)
      *reinterpret_cast<uint32_t*>(dk + (kb + key0) * HQK + c) =
          pack2(dka[n][0] * scale, dka[n][1] * scale);
    if (key1 < Skv)
      *reinterpret_cast<uint32_t*>(dk + (kb + key1) * HQK + c) =
          pack2(dka[n][2] * scale, dka[n][3] * scale);
  }
#pragma unroll
  for (int n = 0; n < VC / 8; ++n) {
    const int c = cv + n * 8 + t4 * 2;
    if (key0 < Skv)
      *reinterpret_cast<uint32_t*>(dv + (kb + key0) * HV + c) =
          pack2(dva[n][0], dva[n][1]);
    if (key1 < Skv)
      *reinterpret_cast<uint32_t*>(dv + (kb + key1) * HV + c) =
          pack2(dva[n][2], dva[n][3]);
  }
}

template <int HQK, int HV>
__global__ void __launch_bounds__(MT)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dO,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dq, int Hq, int Hk, int Sq, int Skv, int causal,
           int window, float scale) {
  using T = Tiles<HQK, HV>;
  constexpr int LDQ = T::LDQ, LDV = T::LDV, QR = T::QR, KC = T::KC;
  constexpr int QC = T::QC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + QR * LDQ;
  bf16* ks = dos + QR * LDV;     // [2][KC][LDQ]
  bf16* vs = ks + 2 * KC * LDQ;  // [2][KC][LDV]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * QR;  // heavy tiles first
  const int h = blockIdx.y / T::NS, b = blockIdx.z;
  const int cq = (blockIdx.y % T::NS) * QC;
  const int hk = h / (Hq / Hk);
  const int64_t qb = ((int64_t)b * Hq + h) * Sq;
  const int64_t kb = ((int64_t)b * Hk + hk) * Skv;

  // keys that some row of this tile can see
  const int r_last = min(r0 + QR, Sq) - 1;
  const int c_hi = causal ? min(Skv, r_last + 1) : Skv;
  const int c_lo = window >= 0 ? (max(0, r0 - window + 1) / KC) * KC : 0;
  const int nsteps = c_hi > c_lo ? (c_hi - c_lo + KC - 1) / KC : 0;

  auto prefetch = [&](int s) {
    const int st = s & 1;
    stage_rows<HQK, KC>(ks + st * KC * LDQ, k + kb * HQK, c_lo + s * KC,
                        Skv);
    stage_rows<HV, KC>(vs + st * KC * LDV, v + kb * HV, c_lo + s * KC, Skv);
  };
  stage_rows<HQK, QR>(qs, q + qb * HQK, r0, Sq);
  stage_rows<HV, QR>(dos, dO + qb * HV, r0, Sq);
  if (nsteps > 0) prefetch(0);
  cp_commit();

  const int qr = warp * 16;  // the warp's rows in the tile
  const int row0 = r0 + qr + g, row1 = row0 + 8;
  const float ln0 = row0 < Sq ? -lse[qb + row0] * LOG2E : 0.f;
  const float ln1 = row1 < Sq ? -lse[qb + row1] * LOG2E : 0.f;
  const float dl0 = row0 < Sq ? delta[qb + row0] : 0.f;
  const float dl1 = row1 < Sq ? delta[qb + row1] : 0.f;
  const float sl2 = scale * LOG2E;
  const bf16* qw = qs + qr * LDQ + a_off<LDQ>(lane);
  const bf16* dw = dos + qr * LDV + a_off<LDV>(lane);

  float dqa[QC / 8][4];
#pragma unroll
  for (int n = 0; n < QC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) prefetch(s + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int st = s & 1, c0 = c_lo + s * KC;
    const bf16* kt = ks + st * KC * LDQ;
    const bf16* vt = vs + st * KC * LDV;

    // S = Q K^T and dP = dO V^T: 16 rows x KC keys per warp
    float sc[KC / 8][4], dp[KC / 8][4];
#pragma unroll
    for (int n = 0; n < KC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HQK / 16; ++kk) {
      uint32_t qa[4];
      ldsm4(qa, qw + kk * 16);
#pragma unroll
      for (int np = 0; np < KC / 16; ++np) {
        uint32_t fb[4];
        ldsm4(fb, kt + np * 16 * LDQ + b_off<LDQ>(lane) + kk * 16);
        mma16816(sc[2 * np], qa, fb[0], fb[1]);
        mma16816(sc[2 * np + 1], qa, fb[2], fb[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < HV / 16; ++kk) {
      uint32_t oa[4];
      ldsm4(oa, dw + kk * 16);
#pragma unroll
      for (int np = 0; np < KC / 16; ++np) {
        uint32_t fb[4];
        ldsm4(fb, vt + np * 16 * LDV + b_off<LDV>(lane) + kk * 16);
        mma16816(dp[2 * np], oa, fb[0], fb[1]);
        mma16816(dp[2 * np + 1], oa, fb[2], fb[3]);
      }
    }

    const bool edge = r0 + QR > Sq || c0 + KC > Skv ||
                      (causal && c0 + KC - 1 > r0) ||
                      (window >= 0 && r0 + QR - 1 - c0 >= window);
#pragma unroll
    for (int n = 0; n < KC / 8; ++n) {
      const int col = c0 + n * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[n][e], sl2, e < 2 ? ln0 : ln1));
        if (edge && !allowed(e < 2 ? row0 : row1, col + (e & 1), Sq, Skv,
                             causal, window))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1));
      }
    }

    // dQ += dS K: the dS accumulator is the A fragment, K enters
    // transposed
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      const uint32_t da[4] = {pack2(dp[2 * j][0], dp[2 * j][1]),
                              pack2(dp[2 * j][2], dp[2 * j][3]),
                              pack2(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack2(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < QC / 16; ++np) {
        uint32_t fb[4];
        ldsm4t(fb, kt + j * 16 * LDQ + bt_off<LDQ>(lane) + cq + np * 16);
        mma16816(dqa[2 * np], da, fb[0], fb[1]);
        mma16816(dqa[2 * np + 1], da, fb[2], fb[3]);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int n = 0; n < QC / 8; ++n) {
    const int c = cq + n * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + (qb + row0) * HQK + c) =
          pack2(dqa[n][0] * scale, dqa[n][1] * scale);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(dq + (qb + row1) * HQK + c) =
          pack2(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

template <typename T>
int launch_delta(const void* o, const void* dO, float* delta, int64_t rows,
                 int hd, cudaStream_t st) {
  delta_kernel<T><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)),
                    THREADS, 0, st>>>(static_cast<const T*>(o),
                                      static_cast<const T*>(dO), delta, rows,
                                      hd);
  return (int)cudaGetLastError();
}

template <int HQK, int HV>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dO, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Hq, int Hk, int Sq, int Skv,
               int causal, int window, float scale, cudaStream_t st) {
  typedef float T;
  using F = F32Tiles<HQK, HV>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dOt = static_cast<const T*>(dO);
  int err = launch_delta<T>(o, dO, delta, (int64_t)B * Hq * Sq, HV, st);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(flash_bwd_dkdv<T, HQK, HV>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)F::DKDV_SMEM);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(flash_bwd_dq<T, HQK, HV>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)F::DQ_SMEM);
  if (err) return err;
  flash_bwd_dkdv<T, HQK, HV>
      <<<dim3((Skv + F::BT - 1) / F::BT, Hk, B), THREADS, F::DKDV_SMEM, st>>>(
          qt, kt, vt, dOt, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), Hq, Hk, Sq, Skv, causal, window, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq<T, HQK, HV>
      <<<dim3((Sq + F::BT - 1) / F::BT, Hq, B), THREADS, F::DQ_SMEM, st>>>(
          qt, kt, vt, dOt, lse, delta, static_cast<T*>(dq), Hq, Hk, Sq, Skv,
          causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HQK, int HV>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dO, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Hq, int Hk, int Sq, int Skv,
                int causal, int window, float scale, cudaStream_t st) {
  using T = Tiles<HQK, HV>;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dOt = static_cast<const bf16*>(dO);
  int err = launch_delta<bf16>(o, dO, delta, (int64_t)B * Hq * Sq, HV, st);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(bwd_dkdv_mma<HQK, HV>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)T::DKDV_SMEM);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(bwd_dq_mma<HQK, HV>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)T::DQ_SMEM);
  if (err) return err;
  bwd_dkdv_mma<HQK, HV><<<dim3((Skv + T::BK - 1) / T::BK, Hk * T::NS, B), MT,
                          T::DKDV_SMEM, st>>>(
      qt, kt, vt, dOt, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Hq, Hk, Sq, Skv, causal, window, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dq_mma<HQK, HV><<<dim3((Sq + T::QR - 1) / T::QR, Hq * T::NS, B), MT,
                        T::DQ_SMEM, st>>>(qt, kt, vt, dOt, lse, delta,
                                          static_cast<bf16*>(dq), Hq, Hk, Sq,
                                          Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd is q's and k's head dim, hdv v's
// (and o's and dO's); the instantiated (dtype, hd, hdv) are the
// forward's. window < 0 means no window. `delta` is caller-allocated f32
// scratch of B*Hq*Sq. Returns the first CUDA error of the three launches
// (0 = all launched), cudaErrorInvalidValue for a shape not instantiated.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dO, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int Hq, int Hk, int Sq, int Skv,
                                   int hd, int hdv, int dtype, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hk <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1B_CASE(DT, HQK, HV, FN)                                          \
  if (dtype == DT && hd == HQK && hdv == HV)                               \
    return FN<HQK, HV>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Hq, Hk,  \
                       Sq, Skv, causal, window, scale, st);
  K1B_CASE(0, 32, 32, launch_f32)
  K1B_CASE(0, 64, 64, launch_f32)
  K1B_CASE(0, 128, 128, launch_f32)
  K1B_CASE(0, 256, 256, launch_f32)
  K1B_CASE(0, 192, 128, launch_f32)
  K1B_CASE(0, 48, 32, launch_f32)
  K1B_CASE(1, 32, 32, launch_bf16)
  K1B_CASE(1, 64, 64, launch_bf16)
  K1B_CASE(1, 128, 128, launch_bf16)
  K1B_CASE(1, 256, 256, launch_bf16)
  K1B_CASE(1, 192, 128, launch_bf16)
  K1B_CASE(1, 48, 32, launch_bf16)
#undef K1B_CASE
  return (int)cudaErrorInvalidValue;
}
