// K1 backward: flash-attention backward for Hopper (sm_90a), plain C
// interface.
//
// The TPU kernel of src/repro/kernels/flash_attention.py is forward only;
// the reference's backward is the chunked jnp VJP `_flash_vjp_bwd`
// (src/repro/models/attention.py), which this kernel computes: for q
// (B,Hq,Sq,hd), k/v (B,Hk,Skv,hd), the forward's out and lse (f32) and
// dO, with GQA (q head h reads KV head h / (Hq/Hk)), the top-left causal
// mask from position 0 and an optional sliding window,
//
//   delta_i = sum_d dO_id O_id
//   P_ij    = exp(scale q_i.k_j - lse_i)   (0 where masked)
//   dV_j    = sum_i P_ij dO_i              dP_ij = dO_i.v_j
//   dS_ij   = P_ij (dP_ij - delta_i) scale
//   dQ_i    = sum_j dS_ij k_j              dK_j  = sum_i dS_ij q_i
//
// with dK and dV summed over the G query heads of each KV head. Outputs
// are in the inputs' type (f32 or bf16); all arithmetic is f32.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// GPT-65B training shape (S = 2048, 64 heads, hd 128, bf16, causal) the
// five S x S x hd products (QK^T, dO V^T, P^T dO, dS K, dS^T Q), halved
// by the mask, are 5 S^2 hd H ~= 1.72e11 FLOP -> 0.174 ms at the
// tensor-core peak, while q, k, v, o, dO, dq, dk, dv and lse are ~134 MB
// -> 0.040 ms at the memory rate. So the bound is compute.
//
// Design (simple and deterministic first; tensor cores, cp.async/TMA
// pipelining and warp specialisation are later work). No float atomics:
// three launches on one stream, each output element written by exactly
// one thread in a fixed summation order, so the result is the same bits
// on every run.
//  1. delta: one warp per query row, a fixed shuffle tree.
//  2. dK/dV: one block per (64-key tile, KV head, batch) loops over the
//     G query heads of the KV head and over the 64-row Q tiles that can
//     see the tile (the causal mask and the window bound the range),
//     keeping dK and dV for its keys in registers.
//  3. dQ: one block per (64-row Q tile, q head, batch) loops over the KV
//     tiles its rows can see, keeping dQ in registers.
// Tiles are staged in shared memory as f32 with a row stride of hd + 1
// (so a warp's 16 distinct key rows hit 16 distinct banks); 256 threads
// as 16 x 16, each owning a 4 x 4 interleaved sub-tile of the 64 x 64
// score tile and 4 rows x hd/16 columns of the outputs, on the CUDA
// cores with fmaf. The f32 path needs the CUDA cores anyway (the tensor
// cores would round to TF32, outside the 1e-5 tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;         // query rows and keys per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int SLD = BT + 1;    // score-tile row stride

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool allowed(int r, int c, int Sq, int Skv,
                                        int causal, int window) {
  if (r >= Sq || c >= Skv) return false;
  if (causal && c > r) return false;
  if (window >= 0 && r - c >= window) return false;
  return true;
}

// rows [r0, r0 + BT) of a (S, HD) matrix -> f32 shared tile, zero past S
template <typename T, int HD>
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

// S = Q K^T and dP = dO V^T for the thread's 4 x 4 sub-tile (rows
// ty + 16 i of qs/dos, keys tx + 16 j of ks/vs), then P and dS
template <int HD>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       const float* lse_s,
                                       const float* del_s, int r0, int c0,
                                       int Sq, int Skv, int causal,
                                       int window, float scale, float p[4][4],
                                       float ds[4][4]) {
  constexpr int LD = HD + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[4], da[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = qs[(ty + 16 * i) * LD + d];
      da[i] = dos[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = ks[(tx + 16 * j) * LD + d];
      vv[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ri = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok =
          allowed(r0 + ri, c0 + tx + 16 * j, Sq, Skv, causal, window);
      p[i][j] = ok ? expf(s[i][j] * scale - lse_s[ri]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - del_s[ri]) * scale;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hk, int Sq,
               int Skv, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BT * LD;
  float* qs = vs + BT * LD;
  float* dos = qs + BT * LD;
  float* ps = dos + BT * LD;
  float* dss = ps + BT * SLD;
  float* lse_s = dss + BT * SLD;
  float* del_s = lse_s + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int c0 = blockIdx.x * BT;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hk;
  const int64_t kb = ((int64_t)b * Hk + hk) * Skv;
  load_tile<T, HD>(ks, k + kb * HD, c0, Skv);
  load_tile<T, HD>(vs, v + kb * HD, c0, Skv);

  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  // query rows that can see a key of this tile
  const int c_last = min(c0 + BT, Skv) - 1;
  const int r_lo = causal ? c0 : 0;
  const int r_hi = window >= 0 ? min(Sq, c_last + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int64_t qb = ((int64_t)b * Hq + hk * G + g) * Sq;
    for (int r0 = (r_lo / BT) * BT; r0 < r_hi; r0 += BT) {
      __syncthreads();  // the previous tile is fully consumed
      load_tile<T, HD>(qs, q + qb * HD, r0, Sq);
      load_tile<T, HD>(dos, dO + qb * HD, r0, Sq);
      for (int i = threadIdx.x; i < BT; i += THREADS) {
        lse_s[i] = r0 + i < Sq ? lse[qb + r0 + i] : 0.f;
        del_s[i] = r0 + i < Sq ? delta[qb + r0 + i] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      scores<HD>(qs, dos, ks, vs, lse_s, del_s, r0, c0, Sq, Skv, causal,
                 window, scale, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(ty + 16 * i) * SLD + tx + 16 * j] = p[i][j];
          dss[(ty + 16 * i) * SLD + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV_c += sum_r P_rc dO_r ; dK_c += sum_r dS_rc q_r (keys ty + 16 i)
      for (int r = 0; r < BT; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[r * SLD + ty + 16 * i];
          dsv[i] = dss[r * SLD + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float dov = dos[r * LD + tx + 16 * j];
          const float qv = qs[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][j] = fmaf(pv[i], dov, dva[i][j]);
            dka[i][j] = fmaf(dsv[i], qv, dka[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= Skv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store(&dk[(kb + c) * HD + tx + 16 * j], dka[i][j]);
      store(&dv[(kb + c) * HD + tx + 16 * j], dva[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int Hq, int Hk, int Sq, int Skv, int causal,
             int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BT * LD;
  float* ks = dos + BT * LD;
  float* vs = ks + BT * LD;
  float* dss = vs + BT * LD;
  float* lse_s = dss + BT * SLD;
  float* del_s = lse_s + BT;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BT;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int64_t qb = ((int64_t)b * Hq + h) * Sq;
  const int64_t kb = ((int64_t)b * Hk + hk) * Skv;
  load_tile<T, HD>(qs, q + qb * HD, r0, Sq);
  load_tile<T, HD>(dos, dO + qb * HD, r0, Sq);
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    lse_s[i] = r0 + i < Sq ? lse[qb + r0 + i] : 0.f;
    del_s[i] = r0 + i < Sq ? delta[qb + r0 + i] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // keys that some row of this tile can see
  const int r_last = min(r0 + BT, Sq) - 1;
  const int c_hi = causal ? min(Skv, r_last + 1) : Skv;
  const int c_lo = window >= 0 ? max(0, r0 - window + 1) : 0;
  for (int c0 = (c_lo / BT) * BT; c0 < c_hi; c0 += BT) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile<T, HD>(ks, k + kb * HD, c0, Skv);
    load_tile<T, HD>(vs, v + kb * HD, c0, Skv);
    __syncthreads();
    float p[4][4], ds[4][4];
    scores<HD>(qs, dos, ks, vs, lse_s, del_s, r0, c0, Sq, Skv, causal,
               window, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * SLD + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ_r += sum_c dS_rc k_c (rows ty + 16 i)
    for (int c = 0; c < BT; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * SLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store(&dq[(qb + r) * HD + tx + 16 * j], acc[i][j]);
  }
}

constexpr size_t dkdv_smem(int hd) {
  return sizeof(float) * (4 * BT * (hd + 1) + 2 * BT * SLD + 2 * BT);
}
constexpr size_t dq_smem(int hd) {
  return sizeof(float) * (4 * BT * (hd + 1) + BT * SLD + 2 * BT);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int B, int Hq, int Hk, int Sq, int Skv, int causal,
           int window, float scale, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dOt = static_cast<const T*>(dO);
  const int64_t rows = (int64_t)B * Hq * Sq;
  delta_kernel<T><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)),
                     THREADS, 0, st>>>(static_cast<const T*>(o), dOt, delta,
                                       rows, HD);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t s1 = dkdv_smem(HD), s2 = dq_smem(HD);
  err = (int)cudaFuncSetAttribute(flash_bwd_dkdv<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s1);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(flash_bwd_dq<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s2);
  if (err) return err;
  flash_bwd_dkdv<T, HD><<<dim3((Skv + BT - 1) / BT, Hk, B), THREADS, s1, st>>>(
      qt, kt, vt, dOt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hk, Sq, Skv, causal, window, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq<T, HD><<<dim3((Sq + BT - 1) / BT, Hq, B), THREADS, s2, st>>>(
      qt, kt, vt, dOt, lse, delta, static_cast<T*>(dq), Hq, Hk, Sq, Skv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window < 0 means no window. `delta`
// is caller-allocated f32 scratch of B*Hq*Sq. Returns the first CUDA
// error of the three launches (0 = all launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dO, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int Hq, int Hk, int Sq, int Skv,
                                   int hd, int dtype, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hk <= 0 || Sq <= 0 || Skv <= 0 || Hq % Hk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Hq,
                             Hk, Sq, Skv, causal, window, scale, st);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Hq,
                              Hk, Sq, Skv, causal, window, scale, st);
  if (dtype == 1 && hd == 64)
    return launch<bf16, 64>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Hq,
                            Hk, Sq, Skv, causal, window, scale, st);
  if (dtype == 1 && hd == 128)
    return launch<bf16, 128>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Hq,
                             Hk, Sq, Skv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
