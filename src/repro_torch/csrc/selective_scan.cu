// K3: the Mamba-1 selective-scan forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_scan_kernel` / `selective_scan_fwd` of
// src/repro/kernels/selective_scan.py. For x, dt (B, S, di), Bc, Cc
// (B, S, st), A (di, st) and D (di,) it computes, with h in f32 and
// h_0 = 0,
//
//   h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t      (per channel d)
//   y_t = sum_s h_t[s] C_t[s] + D x_t
//
// and writes y (B, S, di) in x's dtype and the final state h_S
// (B, di, st) in f32. x, Bc, Cc and y are f32 or bf16 (one dtype);
// dt, A, D are f32. Bc and Cc may be strided along batch and time (on
// the model path they are column slices of the x_proj output); their
// state axis has unit stride.
//
// What bounds it on an H100: the recurrence is elementwise in (d, s),
// 6 f32 operations and one exp per (t, d, s) and 3 more per (t, d). At
// falcon-mamba-7b's prefill (B = 1, S = 2048, di = 8192, st = 16: 268 M
// (t, d, s)) the exps on the special-function units (16 per SM per
// clock, one MUFU.EX2 per expf) take ~0.064 ms at 1.98 GHz, the 135 MB
// the call must move (bf16 x and y, f32 dt, each once) ~0.040 ms at
// 3.35 TB/s, and the f32 arithmetic ~0.025 ms at 67 TFLOP/s: the exps
// bound it. The scan over S is sequential per (b, d, s), so the card is
// filled across (b, d, s) only.
//
// Design: one thread per (channel d, state s); LANES (4, 8 or 16, the
// state size rounded up to a power of two) neighbouring lanes hold one
// channel's states and y_t is their sum by an xor-shuffle butterfly in a
// fixed order (no atomics: two launches give the same bits). A block of
// 256 threads owns 256 / LANES channels of one batch row and walks S in
// chunks of 4 * LANES time steps: the chunk's x, dt (the block's
// channels) and B, C (shared by every channel) are staged in shared
// memory, and the next chunk's loads are issued into registers before
// the current chunk's steps run, so a step never waits on device
// memory. y of a chunk is gathered in shared memory and written back
// with the channels contiguous. Ragged edges (S not a multiple of the
// chunk, di not a multiple of the block's channels, st below LANES) are
// masked: dead lanes hold h = 0 and contribute 0 to y. exp is the
// accurate expf, not __expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
// Four resident blocks per SM cap the kernel at 64 registers a thread
// (it takes 94 unbounded, which leaves room for only two blocks; at 64 the
// 16-lane variant spills 88 bytes). At falcon-mamba-7b's B = 1 prefill
// shape on an H100 80GB HBM3 (700 W) that took chip_smoke.py's K3 time
// from 0.736 ms to 0.554 ms; six or eight blocks (40 or 32 registers)
// spill more and run slower.
constexpr int BLOCKS_PER_SM = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, bf16* o) {
  *o = __float2bfloat16_rn(v);
}

struct ScanArgs {
  int S, di, st;
  long long b_sb, b_st, c_sb, c_st;  // Bc / Cc strides (batch, time)
};

template <typename T, int LANES>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bc,
                      const T* __restrict__ Cc, const float* __restrict__ D,
                      T* __restrict__ y, float* __restrict__ hout,
                      ScanArgs a) {
  constexpr int CH = THREADS / LANES;        // channels per block
  constexpr int CT = 4 * LANES;              // time steps per chunk
  constexpr int NX = (CT * CH + THREADS - 1) / THREADS;     // x/dt per thread
  constexpr int NB = (CT * LANES + THREADS - 1) / THREADS;  // B/C per thread
  __shared__ float xs[CT][CH];
  __shared__ float dts[CT][CH];
  __shared__ float ys[CT][CH];
  __shared__ float bs[CT][LANES];
  __shared__ float cs[CT][LANES];

  const int S = a.S, di = a.di, st = a.st;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int c = tid / LANES;
  const int s = tid % LANES;
  const int d = d0 + c;
  const bool live = d < di && s < st;
  const float av = live ? A[(long long)d * st + s] : 0.f;
  const float dv = d < di ? D[d] : 0.f;
  const long long row0 = (long long)b * S;   // first (b, t) row of x/dt/y
  const T* bp = Bc + b * a.b_sb;
  const T* cp = Cc + b * a.c_sb;

  float rx[NX], rdt[NX], rb[NB], rc[NB];
  auto load = [&](int t0) {                  // chunk at t0 -> registers
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const int i = tid + k * THREADS;
      const int tt = i / CH, cc = i % CH;
      rx[k] = 0.f;
      rdt[k] = 0.f;
      if (i < CT * CH && t0 + tt < S && d0 + cc < di) {
        const long long off = (row0 + t0 + tt) * di + d0 + cc;
        rx[k] = to_f32(x[off]);
        rdt[k] = dt[off];
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int i = tid + k * THREADS;
      const int tt = i / LANES, ss = i % LANES;
      rb[k] = 0.f;
      rc[k] = 0.f;
      if (i < CT * LANES && t0 + tt < S && ss < st) {
        rb[k] = to_f32(bp[(long long)(t0 + tt) * a.b_st + ss]);
        rc[k] = to_f32(cp[(long long)(t0 + tt) * a.c_st + ss]);
      }
    }
  };

  float h = 0.f;
  load(0);
  for (int t0 = 0; t0 < S; t0 += CT) {
    // registers -> shared: every thread has finished the previous chunk's
    // steps (second barrier below), so xs/dts/bs/cs are free
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const int i = tid + k * THREADS;
      if (i < CT * CH) {
        xs[i / CH][i % CH] = rx[k];
        dts[i / CH][i % CH] = rdt[k];
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int i = tid + k * THREADS;
      if (i < CT * LANES) {
        bs[i / LANES][i % LANES] = rb[k];
        cs[i / LANES][i % LANES] = rc[k];
      }
    }
    __syncthreads();
    if (t0 + CT < S) load(t0 + CT);          // in flight during the steps
    const int nt = min(CT, S - t0);
    for (int tt = 0; tt < nt; ++tt) {
      const float xv = xs[tt][c];
      const float dtv = dts[tt][c];
      const float da = expf(dtv * av);
      h = da * h + (dtv * xv) * bs[tt][s];
      float p = h * cs[tt][s];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off, LANES);
      if (s == 0) ys[tt][c] = p + dv * xv;
    }
    __syncthreads();
    for (int i = tid; i < nt * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      if (d0 + cc < di) store(ys[tt][cc], &y[(row0 + t0 + tt) * di + d0 + cc]);
    }
  }
  if (live) hout[((long long)b * di + d) * st + s] = h;
}

template <typename T, int LANES>
int launch(const void* x, const float* dt, const float* A, const void* Bc,
           const void* Cc, const float* D, void* y, float* hout, int batch,
           const ScanArgs& a, cudaStream_t stream) {
  constexpr int CH = THREADS / LANES;
  dim3 grid((a.di + CH - 1) / CH, batch);
  selective_scan_kernel<T, LANES><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), D, static_cast<T*>(y), hout, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* Bc,
             const void* Cc, const float* D, void* y, float* hout, int batch,
             const ScanArgs& a, cudaStream_t stream) {
  if (a.st <= 4)
    return launch<T, 4>(x, dt, A, Bc, Cc, D, y, hout, batch, a, stream);
  if (a.st <= 8)
    return launch<T, 8>(x, dt, A, Bc, Cc, D, y, hout, batch, a, stream);
  return launch<T, 16>(x, dt, A, Bc, Cc, D, y, hout, batch, a, stream);
}

}  // namespace

// dtype (of x, Bc, Cc, y): 0 = float32, 1 = bfloat16. 1 <= st <= 16.
// x, dt, y contiguous (B, S, di); A (di, st), D (di,), hout (B, di, st)
// contiguous; Bc / Cc strides in elements. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int selective_scan_fwd(const void* x, const float* dt,
                                  const float* A, const void* Bc,
                                  const void* Cc, const float* D, void* y,
                                  float* hout, int batch, int S, int di,
                                  int st, long long b_sb, long long b_st,
                                  long long c_sb, long long c_st, int dtype,
                                  void* stream) {
  if (batch < 1 || S < 1 || di < 1 || st < 1 || st > 16)
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.S = S;
  a.di = di;
  a.st = st;
  a.b_sb = b_sb;
  a.b_st = b_st;
  a.c_sb = c_sb;
  a.c_st = c_st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, A, Bc, Cc, D, y, hout, batch, a, s);
  if (dtype == 1)
    return dispatch<bf16>(x, dt, A, Bc, Cc, D, y, hout, batch, a, s);
  return (int)cudaErrorInvalidValue;
}
