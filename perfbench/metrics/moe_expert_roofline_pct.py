"""The grouped expert products' share of their roofline in the traced
window: the least time the products of the window's computed
assignments (``moe_local``) could take, forward, recomputed and backward
(``harness/flops_moe.py``), over the device time the profiler gave the
kernels ``torch._grouped_mm`` launches (CUTLASS's grouped GEMM and its
problem-set-up kernel), in %."""
from harness.flops import roofline_seconds
from harness.flops_moe import expert_products

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(w):
    moe = getattr(w, "moe", None)
    if w.device is None or not moe or not moe.get("moe_local"):
        return None
    secs, launches = w.device.kernel_time(KERNELS)
    if not launches or secs <= 0:
        return None
    f, b = expert_products(w.cfg, moe["moe_local"], w.moe_calls)
    return 100.0 * roofline_seconds(f, b) / secs
