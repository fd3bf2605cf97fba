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
// Bound on an H100: one exp per (t, d, s). At falcon-mamba-7b's prefill
// (B = 1, S = 2048, di = 8192, st = 16: 268 M (t, d, s)) the exps on the
// special-function units (16 per SM per clock) take ~0.064 ms at 1.98
// GHz; the 135 MB the call must move (bf16 x and y, f32 dt, each once)
// ~0.040 ms at 3.35 TB/s come second. The scan is serial in t, so the
// card is filled across (b, d, s) only.
//
// Design. A thread owns one channel and K consecutive states (K = 4;
// K = 1 and 2 for st = 1 and 2), L = 1, 2 or 4 lanes a channel (st <= 4,
// <= 8, <= 16), and keeps h[K] and A log2(e) [K] in registers for the
// whole scan. A block is CH = 32 channels of one batch row, 32 L threads,
// and walks S in chunks of TC = 32 steps. Per pipe, per (t, d, s):
// - special-function units: exp2f's instruction, ex2.approx.ftz, on
//   dt A log2(e): one MUFU.EX2 and nothing around it. The exps and u B
//   of U = 4 steps are computed before the serial h = da h + u B of those
//   steps, and the chunk's step loop is unrolled, so the exps of later
//   steps issue while the FMA chain of earlier ones runs;
// - FP32 pipe: dt A, u B, the h FMA, the h C FMA, and u = dt x once a
//   thread (not once a state);
// - shared memory and shuffles: a step reads x_t and dt_t (one 32-bit
//   load each, broadcast over the channel's lanes) and its K values of
//   B_t and C_t (one vector load each, broadcast over the warp's
//   channels). y of U steps is K - 1 in-thread adds a step, then a
//   halving exchange over the L lanes (U/2 + U/4 shuffles for U steps at
//   L = 4: 0.19 a (t, d, s)), after which lane g holds steps g U/L ..;
//   every sum runs in a fixed order (no atomics: two launches give the
//   same bits);
// - bytes: x and dt come through a ring of STAGES = 3 chunk tiles filled
//   by cp.async, two chunks ahead (16-byte copies where x's, dt's and y's
//   rows and bases are 16-byte aligned, else 4-byte copies and, for bf16
//   x, plain element copies; past S and di the copies write zeros). B
//   and C (a few KB a chunk, shared by the block, strided, not always
//   aligned) are loaded into registers one chunk ahead, 16 bytes a load
//   where a row is st = 4, 8 or 16 states of 16-byte multiple and
//   aligned, else by element, and stored as f32 into a double buffer
//   after the chunk's steps. y_t + D x_t goes into a double-buffered
//   shared tile that is written back, channels contiguous (16 bytes a
//   store where aligned), after the next chunk's barrier: one
//   __syncthreads per chunk.
// Ragged edges need no branch in the step loop: past S and di, x and dt
// are zero, so da = 1 and u = 0 leave h unchanged; dead states have
// A = B = C = 0.
//
// Registers, shared bytes and blocks per SM (`-Xptxas -v`, sm_90a, no
// spill in any instantiation; PERF.md has the run):
//   <bf16, K 4, L 4>: 128 threads, 122 registers, 30,720 B static
//   shared memory: 4 blocks per SM (registers);
//   <f32, K 4, L 4>: 128 threads, 128 registers, 40,960 B: 4 blocks.
// At (1, 2048, 8192, 16) that is 256 blocks of 4 warps, ~2 blocks and ~8
// warps per SM; at B = 2 the 512 blocks run in one wave on 132 SMs, which
// needs at most 128 registers a thread.
//
// Left for later: a split of S across blocks (a two-pass chunked scan)
// to put more than ~8 warps on each SM at B = 1, and part of the exps as
// a polynomial on the FMA pipe beside the special-function units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CH = 32;      // channels a block
constexpr int TC = 32;      // time steps a chunk
constexpr int STAGES = 3;   // x/dt ring depth (chunks)
constexpr int U = 4;        // steps whose exps are computed together
static_assert(U >= 4, "the y exchange gives each of 4 lanes a step");
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
// an element's bits in a 32-bit register, and the f32 value of such bits
__device__ __forceinline__ uint32_t to_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t to_bits(bf16 v) {
  return __bfloat16_as_ushort(v);
}
template <typename T>
__device__ __forceinline__ float bits_f32(uint32_t w) {
  return sizeof(T) == 2 ? __uint_as_float(w << 16) : __uint_as_float(w);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, bf16* o) {
  *o = __float2bfloat16_rn(v);
}

// 2^v on the special-function unit; subnormal results flush to zero
__device__ __forceinline__ float exp2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

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

// one element of x into the ring: f32 by a 4-byte cp.async, bf16 by a
// plain copy (no cp.async moves 2 bytes)
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          const float* base, bool ok) {
  cp_async4(dst, ok ? src : base, ok ? 4 : 0);
}
__device__ __forceinline__ void copy_elem(bf16* dst, const bf16* src,
                                          const bf16*, bool ok) {
  *dst = ok ? *src : __float2bfloat16_rn(0.f);
}

// K consecutive f32 from shared memory in one load
template <int K>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

struct ScanArgs {
  int S, di, st;
  long long b_sb, b_st, c_sb, c_st;  // Bc / Cc strides (batch, time)
  int vec;                           // x, dt, y rows by 16-byte copies
  int bc_vec;                        // B, C rows by 16-byte loads
};

template <typename T, int SPAD>
struct __align__(16) Tiles {
  T xs[STAGES][TC][CH];        // x ring
  float dts[STAGES][TC][CH];   // dt ring
  float bc[2][2][TC][SPAD];    // [buffer][B, C][step][state]
  T ys[2][TC][CH];             // y of a chunk, double-buffered
};

template <typename T, int K, int L>
__global__ void __launch_bounds__(CH * L)
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bc,
                      const T* __restrict__ Cc, const float* __restrict__ D,
                      T* __restrict__ y, float* __restrict__ hout,
                      ScanArgs a) {
  constexpr int THREADS = CH * L;
  constexpr int SPAD = K * L;                 // states held by a channel
  constexpr int NBC = (2 * TC * SPAD + THREADS - 1) / THREADS;
  __shared__ Tiles<T, SPAD> sm;

  const int S = a.S, di = a.di, st = a.st;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int c = tid / L;                      // channel in the block
  const int g = tid % L;                      // state group: K g .. K g + K-1
  const int d = d0 + c;
  const long long row0 = (long long)b * S;    // first (b, t) row of x/dt/y
  const T* bp = Bc + b * a.b_sb;
  const T* cp = Cc + b * a.c_sb;
  const int nch = (S + TC - 1) / TC;

  float a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = g * K + k;
    a2[k] = d < di && s < st ? A[(long long)d * st + s] * LOG2E : 0.f;
    h[k] = 0.f;
  }
  const float dv = d < di ? D[d] : 0.f;

  // x and dt of chunk j -> ring stage j % STAGES; one commit group a call
  auto fill = [&](int j) {
    if (j < nch) {
      const int t0 = j * TC, s = j % STAGES;
      if (a.vec) {
        constexpr int XV = 16 / sizeof(T);    // x per copy
#pragma unroll
        for (int k = 0; k < (TC * CH / XV + THREADS - 1) / THREADS; ++k) {
          const int i = tid + k * THREADS;
          if (i >= TC * CH / XV) break;
          const int tt = i / (CH / XV), cc = i % (CH / XV) * XV;
          const bool ok = t0 + tt < S && d0 + cc < di;
          cp_async16(&sm.xs[s][tt][cc],
                     ok ? x + (row0 + t0 + tt) * di + d0 + cc : x,
                     ok ? 16 : 0);
        }
#pragma unroll
        for (int k = 0; k < (TC * CH / 4 + THREADS - 1) / THREADS; ++k) {
          const int i = tid + k * THREADS;
          if (i >= TC * CH / 4) break;
          const int tt = i / (CH / 4), cc = i % (CH / 4) * 4;
          const bool ok = t0 + tt < S && d0 + cc < di;
          cp_async16(&sm.dts[s][tt][cc],
                     ok ? dt + (row0 + t0 + tt) * di + d0 + cc : dt,
                     ok ? 16 : 0);
        }
      } else {
#pragma unroll 4
        for (int k = 0; k < (TC * CH + THREADS - 1) / THREADS; ++k) {
          const int i = tid + k * THREADS;
          if (i >= TC * CH) break;
          const int tt = i / CH, cc = i % CH;
          const bool ok = t0 + tt < S && d0 + cc < di;
          const long long off = (row0 + t0 + tt) * di + d0 + cc;
          copy_elem(&sm.xs[s][tt][cc], x + off, x, ok);
          cp_async4(&sm.dts[s][tt][cc], ok ? dt + off : dt, ok ? 4 : 0);
        }
      }
    }
    cp_commit();
  };

  // B and C of chunk j -> registers, later -> bc[buf] as f32: 16 bytes
  // a load where a row is SPAD elements of 16-byte multiple, aligned, else
  // element by element. The loads are unconditional (a masked one reads
  // Bc's first elements) and their values are first used at the store,
  // after the chunk's steps, so no thread waits on them
  constexpr int VB = 16 / sizeof(T);          // B/C elements a 16-byte load
  constexpr bool CAN_VEC = SPAD % VB == 0;
  constexpr int NBV = (2 * TC * SPAD / VB + THREADS - 1) / THREADS;
  constexpr int NW = NBC > 4 * NBV ? NBC : 4 * NBV;
  uint32_t rbc[NW];
  unsigned live = 0;                          // bit k: load k is data
  auto load_bc = [&](int j) {
    const int t0 = j * TC;
    live = 0;
    if constexpr (CAN_VEC) {
      if (a.bc_vec) {
        constexpr int RV = SPAD / VB;         // loads a row
#pragma unroll
        for (int v = 0; v < NBV; ++v) {
          const int i = tid + v * THREADS;
          const int r = i % (TC * RV);
          const int tt = r / RV, cc = r % RV * VB;
          const bool ok = i < 2 * TC * RV && t0 + tt < S;
          const T* src = i < TC * RV
                             ? bp + (long long)(t0 + tt) * a.b_st + cc
                             : cp + (long long)(t0 + tt) * a.c_st + cc;
          const int4 q = *reinterpret_cast<const int4*>(ok ? src : bp);
          rbc[4 * v] = q.x;
          rbc[4 * v + 1] = q.y;
          rbc[4 * v + 2] = q.z;
          rbc[4 * v + 3] = q.w;
          live |= (unsigned)ok << v;
        }
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < NBC; ++k) {
      const int i = tid + k * THREADS;
      const int r = i % (TC * SPAD);
      const int tt = r / SPAD, ss = r % SPAD;
      const bool ok = i < 2 * TC * SPAD && t0 + tt < S && ss < st;
      const T* src = i < TC * SPAD
                         ? bp + (long long)(t0 + tt) * a.b_st + ss
                         : cp + (long long)(t0 + tt) * a.c_st + ss;
      rbc[k] = to_bits(*(ok ? src : bp));
      live |= (unsigned)ok << k;
    }
  };
  auto store_bc = [&](int buf) {
    float* dst = &sm.bc[buf][0][0][0];
    if constexpr (CAN_VEC) {
      if (a.bc_vec) {
#pragma unroll
        for (int v = 0; v < NBV; ++v) {
          const int i = tid + v * THREADS;
          if (i >= 2 * TC * SPAD / VB) break;
          float f[VB];
#pragma unroll
          for (int e = 0; e < VB; ++e) {       // element e of the 16 bytes
            const uint32_t w = rbc[4 * v + e * sizeof(T) / 4];
            const int shift = sizeof(T) == 2 ? 16 * (e & 1) : 0;
            f[e] = live >> v & 1 ? bits_f32<T>(w >> shift) : 0.f;
          }
#pragma unroll
          for (int e = 0; e < VB; e += 4)
            *reinterpret_cast<float4*>(dst + i * VB + e) =
                make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
        }
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < NBC; ++k) {
      const int i = tid + k * THREADS;
      if (i < 2 * TC * SPAD)
        dst[i] = live >> k & 1 ? bits_f32<T>(rbc[k]) : 0.f;
    }
  };
  // y of chunk j, from its shared tile, channels contiguous: 16 bytes a
  // store where the rows are 16-byte aligned, else element by element
  auto write_y = [&](int j) {
    const int t0 = j * TC;
    if (a.vec) {
      constexpr int YV = 16 / sizeof(T);
#pragma unroll
      for (int k = 0; k < (TC * CH / YV + THREADS - 1) / THREADS; ++k) {
        const int i = tid + k * THREADS;
        if (i >= TC * CH / YV) break;
        const int tt = i / (CH / YV), cc = i % (CH / YV) * YV;
        if (t0 + tt < S && d0 + cc < di)
          *reinterpret_cast<int4*>(y + (row0 + t0 + tt) * di + d0 + cc) =
              *reinterpret_cast<const int4*>(&sm.ys[j & 1][tt][cc]);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < (TC * CH + THREADS - 1) / THREADS; ++k) {
        const int i = tid + k * THREADS;
        if (i >= TC * CH) break;
        const int tt = i / CH, cc = i % CH;
        if (t0 + tt < S && d0 + cc < di)
          y[(row0 + t0 + tt) * di + d0 + cc] = sm.ys[j & 1][tt][cc];
      }
    }
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) fill(j);
  load_bc(0);
  store_bc(0);
  for (int i = 0; i < nch; ++i) {
    // chunk i has landed (this thread's copies), and after the barrier
    // every thread's; every thread has also finished chunk i - 1, so its
    // ring stage, its B/C buffer and its y tile's predecessor are free
    cp_wait<STAGES - 2>();
    __syncthreads();
    fill(i + STAGES - 1);                   // into chunk i - 1's stage
    if (i + 1 < nch) load_bc(i + 1);
    if (i > 0) write_y(i - 1);

    const int s = i % STAGES, buf = i & 1;
    const T* xr = &sm.xs[s][0][c];
    const float* dtr = &sm.dts[s][0][c];
    const float* br = &sm.bc[buf][0][0][g * K];
    const float* cr = &sm.bc[buf][1][0][g * K];
    T* yr = &sm.ys[buf][0][c];
#pragma unroll
    for (int t = 0; t < TC; t += U) {
      // off the recurrence: the exps and u B of U steps
      float da[U][K], ub[U][K], cv[U][K], xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        xv[u] = to_f32(xr[(t + u) * CH]);
        const float dtv = dtr[(t + u) * CH];
        const float uv = dtv * xv[u];
        float bv[K];
        ld_vec<K>(br + (t + u) * SPAD, bv);
        ld_vec<K>(cr + (t + u) * SPAD, cv[u]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          da[u][k] = exp2_ftz(dtv * a2[k]);
          ub[u][k] = uv * bv[k];
        }
      }
      // the recurrence: one FMA a step and state; lane 0 starts y at D x
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = g == 0 ? dv * xv[u] : 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          h[k] = fmaf(da[u][k], h[k], ub[u][k]);
          p[u] = fmaf(h[k], cv[u][k], p[u]);
        }
      }
      // y of the U steps summed over the channel's L lanes by halving
      // exchanges (log2(L) levels, U/2 + U/4 + ... shuffles in all): lane
      // g ends with the sums of steps g U/L .. g U/L + U/L - 1
#pragma unroll
      for (int off = L / 2, n = U / 2; off > 0; off >>= 1, n >>= 1) {
        const bool upper = (g & off) != 0;
#pragma unroll
        for (int j = 0; j < n; ++j) {
          const float keep = upper ? p[j + n] : p[j];
          const float send = upper ? p[j] : p[j + n];
          p[j] = keep + __shfl_xor_sync(0xffffffffu, send, off, L);
        }
      }
#pragma unroll
      for (int j = 0; j < U / L; ++j)
        store(p[j], &yr[(t + g * (U / L) + j) * CH]);
    }
    if (i + 1 < nch) store_bc(buf ^ 1);
  }
  __syncthreads();
  write_y(nch - 1);
  if (d < di) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = g * K + k;
      if (s < st) hout[((long long)b * di + d) * st + s] = h[k];
    }
  }
}

template <typename T, int K, int L>
int launch(const void* x, const float* dt, const float* A, const void* Bc,
           const void* Cc, const float* D, void* y, float* hout, int batch,
           const ScanArgs& a, cudaStream_t stream) {
  dim3 grid((a.di + CH - 1) / CH, batch);
  selective_scan_kernel<T, K, L><<<grid, CH * L, 0, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), D, static_cast<T*>(y), hout, a);
  return (int)cudaGetLastError();
}

// K states a thread, L lanes a channel: K L >= st
template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* Bc,
             const void* Cc, const float* D, void* y, float* hout, int batch,
             const ScanArgs& a, cudaStream_t stream) {
  if (a.st == 1)
    return launch<T, 1, 1>(x, dt, A, Bc, Cc, D, y, hout, batch, a, stream);
  if (a.st == 2)
    return launch<T, 2, 1>(x, dt, A, Bc, Cc, D, y, hout, batch, a, stream);
  if (a.st <= 4)
    return launch<T, 4, 1>(x, dt, A, Bc, Cc, D, y, hout, batch, a, stream);
  if (a.st <= 8)
    return launch<T, 4, 2>(x, dt, A, Bc, Cc, D, y, hout, batch, a, stream);
  return launch<T, 4, 4>(x, dt, A, Bc, Cc, D, y, hout, batch, a, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  // 16-byte copies need every x and dt row to start 16-byte aligned
  const int elem = dtype == 0 ? 4 : 2;
  a.vec = di % (16 / elem) == 0 && aligned16(x) && aligned16(dt) &&
          aligned16(y);
  // the kernel's B/C rows hold st = 1, 2, 4, 8 or 16 states without padding
  const bool unpadded = (st & (st - 1)) == 0;
  a.bc_vec = unpadded && st * elem % 16 == 0 && aligned16(Bc) &&
             aligned16(Cc) && (b_sb | b_st | c_sb | c_st) * elem % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, A, Bc, Cc, D, y, hout, batch, a, s);
  if (dtype == 1)
    return dispatch<bf16>(x, dt, A, Bc, Cc, D, y, hout, batch, a, s);
  return (int)cudaErrorInvalidValue;
}
