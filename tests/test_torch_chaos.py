"""The port's fault unwind under chaos: the twin of
``tests/test_chaos.py::test_failed_step_unwind_leaves_engine_clean``,
plus deterministic faults in the α tail that outlives its step.

* The sweep: retries 0, so every injected fault escalates and kills its
  step, over several steps; once the chaos is lifted the same engine runs
  a clean step and ``finish()``, and nothing is left behind (no param
  futures, benign gates, an empty act coordinator, no ``pending_grad``
  tails or retained flush segments, no budget, a drainable staging pool).
* One name-targeted fuse fails exactly one α-tail write of
  ``flush_late``, or one ``prefetch_late`` hint read, in a step that
  itself succeeds: the next step runs, and the final parameters and
  masters are bitwise those of the run without the fault (the port's
  semantics: a failed hint is a miss, a failed flush is retried once from
  its retained segments where it is waited on).
"""
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ArchConfig
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.data import SyntheticLM
from repro_torch.io import ChaosSpec, IOConfig, install_chaos
from repro_torch.offload import OffloadConfig, OffloadEngine

T = 5.0

# tests/test_chaos.py's config
CFG = ArchConfig(name="chaos-tiny", family="dense", source="test",
                 num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                 head_dim=16, d_ff=64, vocab_size=256, act="gelu")
MB, S, M = 1, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and the
    parallel test workers would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ocfg(policy="recompute"):
    return OffloadConfig(schedule="vertical", num_microbatches=M,
                         micro_batch=MB, seq_len=S,
                         ratios=StorageRatios(0.5, 0.5, 0.5), alpha=0.5,
                         io=IOConfig(retries=0, chunk_bytes=1 << 10),
                         activation_policy=policy)


def _drainable(eng, nbufs=None):
    """Can the full staging pool be acquired (nothing leaked)?"""
    nbufs = nbufs if nbufs is not None else eng.config.staging_buffers
    got = threading.Event()

    def drain():
        bufs = [eng.staging.acquire(64) for _ in range(nbufs)]
        got.set()
        for b in bufs:
            b.release()

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    ok = got.wait(T)
    t.join(T)
    return ok


@pytest.mark.parametrize("rate,policy", [(0.02, "recompute"),
                                         (0.1, "spill")])
def test_failed_step_unwind_leaves_engine_clean(rate, policy):
    """retries=0 so every injected fault escalates and kills its step;
    after the chaos is lifted the same engine runs a clean step (no fault
    of an earlier step's α tail re-raised into it) and ``finish()``
    leaves nothing behind."""
    data = SyntheticLM(CFG.vocab_size, seed=0)
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, _ocfg(policy), 0, d, device="cpu")
        files = install_chaos(eng.ssd, ChaosSpec(error_rate=rate, seed=3))
        failed = 0
        for _ in range(6):
            try:
                eng.train_step(data.batch(M * MB, S))
            except OSError:
                failed += 1
        assert failed > 0, "chaos never killed a step"
        files.spec = ChaosSpec()                 # lift the chaos
        loss = eng.train_step(data.batch(M * MB, S))
        assert np.isfinite(loss)
        eng.finish()
        assert eng.params_c._futures == {}
        # gates left by the clean step are benign: finish() flushed every
        # α tail, so firing them must be a no-op, not a re-raise
        for fn in list(eng.params_c._gate.values()):
            fn()
        assert eng.act_c._pending == {} and eng.act_c._prefetched == {}
        assert not any(f"pending_grad:{l}" in eng.host
                       for l in range(eng.L)), "stale α-tail gradient"
        assert eng.opt_c._late_tails == {}, "retained α-tail segments"
        s = eng.ioe.metrics_snapshot()
        assert s["inflight_bytes"] == 0, "failed steps leaked budget"
        assert _drainable(eng.ioe), "failed steps leaked staging"
        eng.close()


def _run(fuse=None, steps=3):
    """Final (losses, params, masters) of ``steps`` f32 steps. ``fuse``
    fails one α-tail access of layer 1 once step 1 has returned. Layer 1's
    optimizer state is half on the host, half on the SSD, and the α split
    puts the early update's [0, k) on the host and the tail's [k, n) on
    the SSD, so only α-tail flushes touch ``<state>:1:s``. ``"write"``
    fails the first write of the m tail, after the master tail has
    landed (a retry that re-ran Adam on that partly written state would
    apply the update twice); ``"read"`` the first read of the master tail
    (the ``prefetch_late`` hint's, or the flush's own when the hint did
    not start)."""
    data = SyntheticLM(CFG.vocab_size, seed=0)
    batches = [data.batch(M * MB, S) for _ in range(steps)]
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(CFG, _ocfg(), 0, d, device="cpu")
        files = install_chaos(eng.ssd)
        losses = [eng.train_step(batches[0])]
        if fuse == "write":
            files.fail_name_writes["m:1:s"] = 1
        elif fuse == "read":
            files.fail_name_reads["master:1:s"] = 1
        losses += [eng.train_step(b) for b in batches[1:]]
        eng.finish()
        fired = files.injected["fuse"]
        params = [v.read().copy() for v in eng.p_vecs]
        masters = [v.read().copy() for v in eng.m_master]
        assert eng.opt_c._late_tails == {}
        eng.close()
    return losses, params, masters, fired


@pytest.mark.parametrize("fuse", ["write", "read"])
def test_failed_alpha_tail_access_is_retried_bitwise(fuse):
    """One failed tail write (retried from the retained segments at the
    next step's gate) or one failed hint read (a miss: the flush reads
    the tail itself): every step runs, and the final params and masters
    are bitwise the uninterrupted run's — the tail applied once, not
    twice, and not lost."""
    ref_losses, ref_params, ref_masters, _ = _run()
    losses, params, masters, fired = _run(fuse)
    assert fired == 1, "the fuse never fired"
    assert losses == ref_losses
    for a, b in zip(params + masters, ref_params + ref_masters):
        np.testing.assert_array_equal(a, b)
