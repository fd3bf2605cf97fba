"""K1's backward's share of its roofline in the traced window: the least
time its launches could take (``harness/flops.py``) over the device time
of its three kernels (the row-sum, dK/dV and dQ kernels), in %."""
from harness.flops import k1_bwd, roofline_seconds

KERNELS = ("bwd_dq_mma", "bwd_dkdv_mma", "delta_kernel")


def read(w):
    if w.device is None:
        return None
    secs, launches = w.device.kernel_time(KERNELS)
    if not launches or secs <= 0:
        return None
    f, b = k1_bwd(w.cfg, int(w.mix["micro_batch"]), int(w.mix["seq_len"]))
    return 100.0 * launches * roofline_seconds(f, b) / secs
