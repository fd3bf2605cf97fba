"""K1's backward's share of its roofline at MLA's head sizes in the
traced window: the least time of its launches (``harness/flops_moe.py``)
over the device time of its three kernels (the row-sum, dK/dV and dQ
kernels), in %."""
from harness.flops import roofline_seconds
from harness.flops_moe import k1_mla_bwd

KERNELS = ("bwd_dq_mma", "bwd_dkdv_mma", "delta_kernel")


def read(w):
    if w.device is None:
        return None
    secs, launches = w.device.kernel_time(KERNELS)
    if not launches or secs <= 0:
        return None
    f, b = k1_mla_bwd(w.cfg, int(w.mix["micro_batch"]), int(w.mix["seq_len"]))
    return 100.0 * launches * roofline_seconds(f, b) / secs
