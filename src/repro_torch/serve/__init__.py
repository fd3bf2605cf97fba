"""Serving on the GreedySnake substrate, in PyTorch.

The design is the reference's ``repro.serve``: each request's KV cache
is addressed per cache unit (one per layer for a dense stack) and padded
to fixed-size blocks; evicted blocks go warm to host memory and cold to
SSD through ``repro_torch.io`` at ``IOPriority.KV``; every step compiles
one plan in the schedule IR (``SPILL_KV`` evictions, ``FETCH_KV``
resumes, per-unit ``FETCH_PARAM`` fetches of the tiered params, then
``PHASE`` prefill/decode ops), which ``plan_traffic`` prices exactly;
admission refuses a request whose block footprint alone exceeds the KV
budget. Preempt/resume round-trips are bitwise.
"""
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine  # noqa: F401
from repro_torch.serve.plan import compile_serve_step, lint_kv_plan  # noqa: F401
