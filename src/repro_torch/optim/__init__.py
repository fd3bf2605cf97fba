"""Optimizers of the port: the in-memory Adam and its α-delayed split
(torch, on the parameters' device), and the host Adam the offload
engine runs per layer (``CpuAdam``: a fused C++ pass on a shared pool
of host threads)."""
from repro_torch.optim.adam import (  # noqa: F401
    AdamConfig,
    AdamState,
    apply_update,
    clip_by_global_norm,
    global_norm,
    init_state,
)
from repro_torch.optim.partial import (  # noqa: F401
    DelayedAdamState,
    apply_early,
    flush_late,
    init_delayed,
)
from repro_torch.optim.cpu_adam import CpuAdam  # noqa: F401
