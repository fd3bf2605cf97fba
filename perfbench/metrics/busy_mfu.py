"""Model FLOPs of the traced window's steps (``harness/flops.py``) over
the seconds the profiler saw the card busy times its bf16 peak, in %:
the share of the peak the card reaches while it works, beside the
kernels' rooflines. ``mfu`` is this times the busy share of the window."""
from harness.flops import PEAK_BF16_FLOPS


def read(w):
    if w.device is None or w.device.busy_s <= 0:
        return None
    return 100.0 * w.model_flops / (w.device.busy_s * PEAK_BF16_FLOPS)
