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
// Bound on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): for a causal
// prefill at GPT-65B width (S = 2048, 64 heads, hd 128, bf16) the work is
// 2 * S^2 * hd * H ~= 6.9e10 FLOP (QK^T and PV, halved by the mask) ->
// 69 us on the tensor cores, while q, k, v and o are ~134 MB -> 40 us at
// the memory rate. So the bound is the tensor cores' rate, which only
// `wgmma` reaches.
//
// bf16 design (`flash_fwd_wgmma`): a block per (128-row Q tile, q head,
// batch), heavy (late) Q tiles launched first; 288 threads: two consumer
// warpgroups of 64 query rows each and one producer warp.
//  * Loads: one thread of the producer warp starts TMA copies: Q once,
//    then K and V tiles of 128 keys into a two-stage ring in shared
//    memory. A `full` mbarrier per stage counts the bytes in (expect_tx);
//    an `empty` mbarrier per stage takes one arrival from each of the 8
//    consumer warps once their products on the stage have completed, and
//    the producer waits on it before refilling the stage. The tensor maps
//    are 3-D, (hd, S, B*H), built on the host for each call and passed as
//    `__grid_constant__ const CUtensorMap`; a box is (64, rows, 1): 64
//    bf16 columns are the 128 bytes that the 128-byte swizzle spans, so hd
//    128 takes two boxes per tile. Rows past S are zero-filled and never
//    read from the next head. `cuTensorMapEncodeTiled` is looked up at run
//    time (`cudaGetDriverEntryPointByVersion`, or the unversioned lookup
//    before CUDA 12.5), so the library needs no -lcuda.
//  * S = Q K^T: `wgmma.m64n128k16`, both operands in shared memory, K in
//    its natural K-major layout, 128-byte swizzle descriptors matching
//    the TMA boxes.
//  * Online softmax in f32 registers with `exp2f`: scores scaled by
//    scale * log2(e), running max m, rescale of O and l by exp2(m - m'),
//    l summed from the unrounded f32 probabilities.
//  * O += P V: `wgmma.m64n{hd}k16` with P from registers (the S
//    accumulator rounded to bf16 is the register-A fragment) and V from
//    shared memory with the transpose bit (V's rows are the reduction
//    dimension): no transposed copy of V.
//  * Tiles wholly above the causal diagonal or below the window of every
//    row of the block are skipped: their scores are -1e30 against a
//    running max that is finite, so they add exactly 0. (A block where
//    some row sees no key at all visits every tile: the reference then
//    averages every masked score.) Per-element masks run only on tiles
//    that cross an edge.
//  * Epilogue: O / max(l, 1e-30) stored as bf16 from registers, lse in
//    f32.
//   hd 128: 32 KB of Q + 2 stages x (32 KB K + 32 KB V) = 160 KB of
//   dynamic shared memory (164,904 B with the barriers and the 1 KB
//   alignment slack), 168 registers a thread (`-Xptxas -v`, CUDA 12.8,
//   no spills): one block, 9 warps, per SM. hd 64: 82,984 B, 154
//   registers: one block per SM (the registers of 288 threads).
//   hd 32: a row is 64 bytes, so its box is the whole row under the
//   64-byte swizzle (TMA map and descriptors alike, 8-row groups 512 B
//   apart); Q K^T takes two k16 steps, P V is `wgmma.m64n32k16`.
// Later work: `setmaxnreg` to move registers from the producer to the
// consumers, ping-pong scheduling of the two consumer warpgroups (one's
// softmax under the other's products), overlap of the next S product with
// the current softmax inside a warpgroup, and a persistent grid.
//
// f32 (`flash_fwd_f32`): the tensor cores would round to TF32, far
// outside the 1e-5 tolerance, so f32 runs on the CUDA cores: two threads
// per query row, each owning half of the row's hd in interleaved float4
// chunks, K/V tiles of 32 keys staged as f32 and read by broadcast.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block (f32 kernel)
constexpr int THREADS = 128;    // f32 kernel: 4 warps
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
// bf16: wgmma kernel fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int WQ = 128;                  // query rows per block
constexpr int WK = 128;                  // keys per tile
constexpr int STAGES = 2;                // K/V ring depth
constexpr int W_THREADS = 2 * 128 + 32;  // two consumer warpgroups + producer
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A box is BOX bf16 columns of SW bytes, the span of its swizzle: 64
// columns under the 128-byte swizzle (hd 64 and 128: HD / 64 boxes a row),
// or hd 32's whole 64-byte row under the 64-byte swizzle.
template <int HD>
struct WgLayout {
  static constexpr int BOX = HD < 64 ? HD : 64;  // bf16 columns of a box
  static constexpr int SW = 2 * BOX;             // bytes of a swizzled row
  static constexpr int NH = HD / BOX;            // boxes per row
  static constexpr int Q_BYTES = NH * WQ * SW;   // one Q tile
  static constexpr int KV_BYTES = NH * WK * SW;  // one K (or V) tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // + Q barrier, full and empty per stage; + slack to align to 1024
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of this parity has completed; a wait
// that never completes (a broken ring) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor for rows of SW bytes under the SW-byte
// swizzle (128 or 64): 8-row groups 8 SW bytes apart (SBO), layout type 1
// (128-byte swizzle) or 2 (64-byte); `lbo` is the MN-direction step
// between boxes of an MN-major operand (unused for K-major, and when the
// operand's N is one box)
template <int SW>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo) {
  static_assert(SW == 128 || SW == 64, "128- or 64-byte swizzle");
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((8 * SW) >> 4) << 32) |
         ((uint64_t)(SW == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from reading (or reusing) registers of an
// asynchronous wgmma before it has been waited on
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (m64 x n128) += A (smem, K-major) * B (smem, K-major); scale_d 0 starts the sum
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n128) += A (registers) * B (smem, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n64) += A (registers) * B (smem, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// d (m64 x n32) += A (registers) * B (smem, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 128)
    wgmma_rs_n128(d, a, db);
  else if constexpr (HD == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n32(d, a, db);
}

template <int HD>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ lse, int Hq, int Hk, int Sq, int Skv,
                int q0, int causal, int window, float scale) {
  using L = WgLayout<HD>;
  constexpr int SW = L::SW;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t q_bar = base + L::BAR_OFF;
  const uint32_t full_bar = q_bar + 8, empty_bar = full_bar + 8 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);

  // the KV tiles some row of the block can see
  const int first = qt * WQ, last = min(first + WQ, Sq) - 1;
  int kv_lo = window >= 0 ? max(0, q0 + first - window + 1) : 0;
  int kv_hi = causal ? min(Skv, q0 + last + 1) : Skv;
  if (window >= 0 &&
      q0 + last - window + 1 > (causal ? min(Skv - 1, q0 + last) : Skv - 1)) {
    kv_lo = 0;  // the last row sees no key: the reference averages every
    kv_hi = Skv;  // masked score, so every tile is visited
  }
  const int t_lo = kv_lo / WK, ntiles = (kv_hi + WK - 1) / WK - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp: one thread starts every copy
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
      for (int x = 0; x < L::NH; ++x)
        tma_load(q_s + x * WQ * SW, &tq, q_bar, x * L::BOX, first, b * Hq + h);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty_bar + 8 * st, (i / STAGES - 1) & 1);
        const uint32_t fb = full_bar + 8 * st;
        mbar_expect_tx(fb, 2 * L::KV_BYTES);
        const int k0 = (t_lo + i) * WK;
#pragma unroll
        for (int x = 0; x < L::NH; ++x) {
          tma_load(k_s + st * L::KV_BYTES + x * WK * SW, &tk, fb, x * L::BOX,
                   k0, b * Hk + hk);
          tma_load(v_s + st * L::KV_BYTES + x * WK * SW, &tv, fb, x * L::BOX,
                   k0, b * Hk + hk);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [first + 64 wg, +64); a thread holds
  // rows r0 and r0 + 8 of its warp's 16, columns 8 n + 2 t4 (+1)
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = first + wg * 64 + warp * 16 + g, r1 = r0 + 8;
  const int qp0 = q0 + r0, qp1 = q0 + r1;
  const float sl2 = scale * LOG2E;

  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float sacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_bar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % STAGES;
    const int k0 = (t_lo + i) * WK;
    mbar_wait(full_bar + 8 * st, (i / STAGES) & 1);

    // S = Q K^T over hd in k16 steps (32 bytes along a swizzled row)
    fence_regs<64>(sacc);
    wg_fence();
#pragma unroll
    for (int x = 0; x < L::NH; ++x)
#pragma unroll
      for (int kk = 0; kk < L::BOX / 16; ++kk)
        wgmma_ss_n128(
            sacc, sw_desc<SW>(q_s + x * WQ * SW + wg * 64 * SW + kk * 32, 0),
            sw_desc<SW>(k_s + st * L::KV_BYTES + x * WK * SW + kk * 32, 0),
            (x | kk) != 0);
    wg_commit();
    wg_wait0();
    fence_regs<64>(sacc);

    // online softmax in the log2 domain
    const bool edge = k0 + WK > Skv || (causal && k0 + WK - 1 > q0 + first) ||
                      (window >= 0 && q0 + last - k0 >= window);
    float mt0 = NEG_BIG, mt1 = NEG_BIG;
#pragma unroll
    for (int n = 0; n < WK / 8; ++n) {
      float* s = sacc + 4 * n;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] *= sl2;
      if (edge) {
        const int col = k0 + n * 8 + t4 * 2;
        s[0] = masked(s[0], col, qp0, Skv, causal, window);
        s[1] = masked(s[1], col + 1, qp0, Skv, causal, window);
        s[2] = masked(s[2], col, qp1, Skv, causal, window);
        s[3] = masked(s[3], col + 1, qp1, Skv, causal, window);
      }
      mt0 = fmaxf(mt0, fmaxf(s[0], s[1]));
      mt1 = fmaxf(mt1, fmaxf(s[2], s[3]));
    }
    // a row's 128 scores sit in the 4 threads of its quad
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;  // per-thread partial sums; the quad is summed at the end
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      oacc[4 * n] *= c0;
      oacc[4 * n + 1] *= c0;
      oacc[4 * n + 2] *= c1;
      oacc[4 * n + 3] *= c1;
    }
    uint32_t pa[WK / 16][4];  // P as register-A fragments, one per k16 step
#pragma unroll
    for (int j = 0; j < WK / 16; ++j) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        p[e] = exp2f(sacc[8 * j + e] - ((e & 2) ? m1 : m0));
      l0 += p[0] + p[1] + p[4] + p[5];
      l1 += p[2] + p[3] + p[6] + p[7];
      pa[j][0] = pack2(p[0], p[1]);
      pa[j][1] = pack2(p[2], p[3]);
      pa[j][2] = pack2(p[4], p[5]);
      pa[j][3] = pack2(p[6], p[7]);
    }

    // O += P V: V's rows (keys) are the reduction dimension, so V is the
    // MN-major operand; 16 keys are 16 SW bytes of a box
    fence_regs<HD / 2>(oacc);
    fence_regs<4 * (WK / 16)>(&pa[0][0]);
    wg_fence();
#pragma unroll
    for (int j = 0; j < WK / 16; ++j)
      wgmma_pv<HD>(oacc, pa[j],
                   sw_desc<SW>(v_s + st * L::KV_BYTES + j * 16 * SW, WK * SW));
    wg_commit();
    wg_wait0();
    fence_regs<HD / 2>(oacc);
    fence_regs<4 * (WK / 16)>(&pa[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * st);  // the stage is free
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float i0 = 1.f / lc0, i1 = 1.f / lc1;
  const int64_t q_base = (int64_t)(b * Hq + h) * Sq * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(o + q_base + (int64_t)r0 * HD + c) =
          pack2(oacc[4 * n] * i0, oacc[4 * n + 1] * i0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(o + q_base + (int64_t)r1 * HD + c) =
          pack2(oacc[4 * n + 2] * i1, oacc[4 * n + 3] * i1);
  }
  if (t4 == 0) {
    // a row that saw only masked scores keeps the reference's -1e30
    const int64_t lb = (int64_t)(b * Hq + h) * Sq;
    if (r0 < Sq) lse[lb + r0] = m0 <= NEG_BIG ? NEG_BIG : m0 * LN2 + logf(lc0);
    if (r1 < Sq) lse[lb + r1] = m1 <= NEG_BIG ? NEG_BIG : m1 * LN2 + logf(lc1);
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

template <int HD>
void launch_f32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hk, int Sq, int Skv, int q0,
                int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_f32<HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hk, Sq,
      Skv, q0, causal, window, scale);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (hd, rows, planes) bf16 tensor map with (box_cols, box_rows, 1)
// boxes, swizzled over box_cols * 2 bytes (128 or 64), zero fill past the
// edges
bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int rows,
                int planes, int box_cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hk, int Sq, int Skv, int q0,
                int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BOX = WgLayout<HD>::BOX;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, HD, Sq, B * Hq, BOX, WQ) ||
      !tensor_map(&tk, k, HD, Skv, B * Hk, BOX, WK) ||
      !tensor_map(&tv, v, HD, Skv, B * Hk, BOX, WK))
    return (int)cudaErrorInvalidValue;
  const int smem = WgLayout<HD>::SMEM;
  const int err = (int)cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid((Sq + WQ - 1) / WQ, Hq, B);
  flash_fwd_wgmma<HD><<<grid, W_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, Hq, Hk, Sq, Skv, q0, causal,
      window, scale);
  return (int)cudaGetLastError();
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
  if (dtype == 0 && hd == 32)
    launch_f32<32>(q, k, v, o, lse, B, Hq, Hk, Sq, Skv, q0, causal, window,
                   scale, st);
  else if (dtype == 0 && hd == 64)
    launch_f32<64>(q, k, v, o, lse, B, Hq, Hk, Sq, Skv, q0, causal, window,
                   scale, st);
  else if (dtype == 0 && hd == 128)
    launch_f32<128>(q, k, v, o, lse, B, Hq, Hk, Sq, Skv, q0, causal, window,
                    scale, st);
  else if (dtype == 1 && hd == 32)
    return launch_bf16<32>(q, k, v, o, lse, B, Hq, Hk, Sq, Skv, q0, causal,
                           window, scale, st);
  else if (dtype == 1 && hd == 64)
    return launch_bf16<64>(q, k, v, o, lse, B, Hq, Hk, Sq, Skv, q0, causal,
                           window, scale, st);
  else if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, o, lse, B, Hq, Hk, Sq, Skv, q0, causal,
                            window, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
