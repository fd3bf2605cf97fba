"""Test helper: reuse the reference engines' jitted block functions.

Every reference ``OffloadEngine`` / ``DataParallelOffloadEngine`` builds
its own ``jax.jit`` closures (``repro.offload.engine.build_block_fns``),
so each engine a parity test constructs compiles its layer, head and
embedding functions again (~2 s at gpt-tiny on the CPU). Within one
config, kind and parameter dtype those functions are the same
computation, so a parity module that builds many reference engines may
hand every engine the first one's functions: the engines then run the
same compiled code (the reference's own DP engine relies on exactly
that for its bitwise R-rank == 1-rank property) and only the first
compiles.
"""
import contextlib

import pytest


@contextlib.contextmanager
def shared_jax_block_fns(param_dtype: str = "float32"):
    """Within the block, reference engines built with ``param_dtype``
    params share one set of jitted block functions per (config, kind).
    Engines of another dtype must not be built inside it."""
    import repro.offload.dp as jdp
    import repro.offload.engine as jeng

    build = jeng.build_block_fns
    cache = {}

    def shared(cfg, kind, unflatten):
        key = (cfg, kind, param_dtype)
        if key not in cache:
            cache[key] = build(cfg, kind, unflatten)
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng, "build_block_fns", shared)
        mp.setattr(jdp, "build_block_fns", shared)
        yield
