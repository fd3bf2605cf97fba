// The offload engine's host Adam, plain C interface (`optim/cpu_adam.py`).
//
// One pass over n elements of flat f32 vectors p (the master copy), m, v
// and g: each element reads p, m, v, g (16 B) and writes p, m, v (12 B),
// so the pass is bound by the host's memory bandwidth. The caller splits
// an update into blocks and runs them on a shared pool of threads; every
// element is independent, so any block size or thread count gives the
// same bits.
//
// The order of operations is the f32 numpy formula the tests hold this
// against, one IEEE f32 rounding per operation:
//
//   m = m * b1;  m = m + omb1 * g
//   v = v * b2;  v = v + omb2 * (g * g)
//   denom = sqrt(v / bc2) + eps
//   upd = (m / bc1) / denom;  upd = upd + wd * p   (only when decay)
//   p = p - lr * upd
//
// Every scalar arrives from the caller already rounded to f32 (omb1 =
// f32(1 - b1), bc1 = f32(1 - b1^step), both computed in double), as
// numpy rounds a Python scalar; `decay` is the caller's `wd != 0` on the
// unrounded weight decay. The library must be built with
// -ffp-contract=off (a fused multiply-add rounds once where the formula
// rounds twice) and without -ffast-math, approximate reciprocals or
// rsqrt. -fno-math-errno only lets sqrt vectorise: it drops the errno
// write on a negative argument, never a bit of the result.

#include <math.h>

namespace {

template <bool kDecay>
void adam_block(float* __restrict p, float* __restrict m, float* __restrict v,
                const float* __restrict g, long long n, float b1, float b2,
                float omb1, float omb2, float bc1, float bc2, float eps,
                float wd, float lr) {
  for (long long i = 0; i < n; ++i) {
    const float gi = g[i];
    float mi = m[i] * b1;
    mi = mi + omb1 * gi;
    float vi = v[i] * b2;
    vi = vi + omb2 * (gi * gi);
    const float denom = sqrtf(vi / bc2) + eps;
    float upd = (mi / bc1) / denom;
    if (kDecay) upd = upd + wd * p[i];
    p[i] = p[i] - lr * upd;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

extern "C" void cpu_adam_block(float* p, float* m, float* v, const float* g,
                               long long n, float b1, float b2, float omb1,
                               float omb2, float bc1, float bc2, float eps,
                               float wd, float lr, int decay) {
  if (decay)
    adam_block<true>(p, m, v, g, n, b1, b2, omb1, omb2, bc1, bc2, eps, wd, lr);
  else
    adam_block<false>(p, m, v, g, n, b1, b2, omb1, omb2, bc1, bc2, eps, wd,
                      lr);
}
