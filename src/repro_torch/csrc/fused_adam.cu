// K2: fused Adam for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_adam_kernel` / `fused_adam` of
// src/repro/kernels/fused_adam.py: one pass over flat vectors p (f32 or
// bf16), m, v, g (f32) that writes p' (f32), m', v' (f32) and a bf16 copy
// of p'. Only elements whose global index lies in [lo, hi) are updated;
// every other output element is the unchanged input (the alpha-partial
// update of GreedySnake 4.4 as two launches, [0, k) and [k, n)).
//
//   m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) g^2
//   p' = p - lr (m' / (1 - b1^t) / (sqrt(v' / (1 - b2^t)) + eps) + wd p)
//
// (1 - b1) and (1 - b2) come from the caller, rounded once from double
// to f32 as the reference's Python scalars are; b1^t and b2^t are
// raised in f32 from the integer step t here.
//
// What bounds it on an H100 (3.35 TB/s): it is elementwise, about 20
// FLOP per element against 26-28 bytes moved, so the bound is bytes.
// At the training path's largest call (the embedding, 50304 x 8192 =
// 412 M elements, bf16 p): 14 B read + 14 B written per element ~= 11.5
// GB -> 3.4 ms at the memory rate.
//
// Design: a grid-stride loop, four consecutive elements per thread per
// iteration through 16-byte loads and stores of m, v, g and the f32
// outputs (p itself is read element by element), scalar code for the
// ragged end. No shared memory, no reduction: each element is
// independent, so any launch shape gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct AdamArgs {
  float lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2;
  int64_t lo, hi;
};

__device__ __forceinline__ float load_p(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_p(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void adam_one(float p, float m, float v, float g,
                                         bool sel, const AdamArgs& a,
                                         float* po, float* mo, float* vo) {
  const float m2 = a.b1 * m + a.omb1 * g;
  const float v2 = a.b2 * v + a.omb2 * g * g;
  const float mhat = m2 / a.bc1;
  const float vhat = v2 / a.bc2;
  const float p2 = p - a.lr * (mhat / (sqrtf(vhat) + a.eps) + a.wd * p);
  *po = sel ? p2 : p;
  *mo = sel ? m2 : m;
  *vo = sel ? v2 : v;
}

template <typename T>
__global__ void __launch_bounds__(256)
fused_adam_kernel(const T* __restrict__ p, const float* __restrict__ m,
                  const float* __restrict__ v, const float* __restrict__ g,
                  float* __restrict__ po, float* __restrict__ mo,
                  float* __restrict__ vo, bf16* __restrict__ lpo, int64_t n,
                  AdamArgs a) {
  const int64_t nvec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < nvec;
       j += stride) {
    const int64_t i = 4 * j;
    const float4 mm = reinterpret_cast<const float4*>(m)[j];
    const float4 vv = reinterpret_cast<const float4*>(v)[j];
    const float4 gg = reinterpret_cast<const float4*>(g)[j];
    float pp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pp[e] = load_p(p, i + e);
    const float ms[4] = {mm.x, mm.y, mm.z, mm.w};
    const float vs[4] = {vv.x, vv.y, vv.z, vv.w};
    const float gs[4] = {gg.x, gg.y, gg.z, gg.w};
    float pr[4], mr[4], vr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      adam_one(pp[e], ms[e], vs[e], gs[e], i + e >= a.lo && i + e < a.hi, a,
               &pr[e], &mr[e], &vr[e]);
    reinterpret_cast<float4*>(po)[j] = make_float4(pr[0], pr[1], pr[2], pr[3]);
    reinterpret_cast<float4*>(mo)[j] = make_float4(mr[0], mr[1], mr[2], mr[3]);
    reinterpret_cast<float4*>(vo)[j] = make_float4(vr[0], vr[1], vr[2], vr[3]);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(pr[0], pr[1]);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(pr[2], pr[3]);
    reinterpret_cast<__nv_bfloat162*>(lpo)[2 * j] = l01;
    reinterpret_cast<__nv_bfloat162*>(lpo)[2 * j + 1] = l23;
  }
  // ragged end: fewer than four elements, one thread each
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = 4 * nvec + t;
  if (i < n) {
    float pr, mr, vr;
    adam_one(load_p(p, i), m[i], v[i], g[i], i >= a.lo && i < a.hi, a, &pr,
             &mr, &vr);
    po[i] = pr;
    mo[i] = mr;
    vo[i] = vr;
    lpo[i] = __float2bfloat16_rn(pr);
  }
}

}  // namespace

// p_dtype: 0 = float32, 1 = bfloat16. Every pointer 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_adam(const void* p, const float* m, const float* v,
                          const float* g, float* po, float* mo, float* vo,
                          void* lpo, long long n, int p_dtype, int step,
                          long long lo, long long hi, float lr, float b1,
                          float b2, float omb1, float omb2, float eps,
                          float wd, void* stream) {
  if (n <= 0 || step < 1) return (int)cudaErrorInvalidValue;
  AdamArgs a;
  a.lr = lr;
  a.b1 = b1;
  a.b2 = b2;
  a.omb1 = omb1;
  a.omb2 = omb2;
  a.eps = eps;
  a.wd = wd;
  a.bc1 = 1.f - powf(b1, (float)step);
  a.bc2 = 1.f - powf(b2, (float)step);
  a.lo = lo;
  a.hi = hi;
  const int threads = 256;
  const long long nvec = n / 4;
  long long blocks = (nvec + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 waves
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0)
    fused_adam_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(p), m, v, g, po, mo, vo,
        static_cast<bf16*>(lpo), n, a);
  else if (p_dtype == 1)
    fused_adam_kernel<bf16><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const bf16*>(p), m, v, g, po, mo, vo,
        static_cast<bf16*>(lpo), n, a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
