"""K1's forward kernels' share of their roofline at MLA's head sizes
(q/k ``nope + rope``, v ``v_head_dim``, one key head a query head) in the
traced window: the least time of its launches at the cell's shape
(``harness/flops_moe.py``) over the profiler's device time of the
kernels, in %."""
from harness.flops import roofline_seconds
from harness.flops_moe import k1_mla_fwd

KERNELS = ("flash_fwd_wgmma",)


def read(w):
    if w.device is None:
        return None
    secs, launches = w.device.kernel_time(KERNELS)
    if not launches or secs <= 0:
        return None
    f, b = k1_mla_fwd(w.cfg, int(w.mix["micro_batch"]), int(w.mix["seq_len"]))
    return 100.0 * launches * roofline_seconds(f, b) / secs
