"""Model FLOPs of the window's steps (``harness/flops.py``: forward and
backward of every layer and of the head, causal attention, recompute not
counted) over the window's seconds times the card's bf16 peak, in %."""
from harness.flops import PEAK_BF16_FLOPS


def read(w):
    return 100.0 * w.model_flops / (w.seconds * PEAK_BF16_FLOPS)
