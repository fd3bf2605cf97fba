"""K1's forward kernels' share of their roofline in the traced window:
the least time the launches could take, max(FLOPs / bf16 peak, bytes /
HBM peak) a launch at the cell's shape (``harness/flops.py``), over the
device time the profiler gave the kernels, in %."""
from harness.flops import k1_fwd, roofline_seconds

KERNELS = ("flash_fwd_wgmma",)


def read(w):
    if w.device is None:
        return None
    secs, launches = w.device.kernel_time(KERNELS)
    if not launches or secs <= 0:
        return None
    f, b = k1_fwd(w.cfg, int(w.mix["micro_batch"]), int(w.mix["seq_len"]))
    return 100.0 * launches * roofline_seconds(f, b) / secs
