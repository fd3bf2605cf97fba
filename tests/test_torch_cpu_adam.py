"""The host Adam (``optim/cpu_adam.py``, ``csrc/cpu_adam.cpp``) against
the f32 numpy formula it replaced, kept here as the oracle: bitwise, for
ragged sizes, unaligned ranges, weight decay on and off, early and late
steps, gradients of other dtypes, split updates, any pool width and
concurrent callers."""
from __future__ import annotations

import shutil
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro_torch.kernels import _build
from repro_torch.optim import cpu_adam
from repro_torch.optim.cpu_adam import BLOCK, CpuAdam

BIG = 3 * BLOCK + 3          # a few million, a ragged tail, >1 block


def oracle(adam: CpuAdam, master, m, v, grad, step, lo=0, hi=None):
    """The numpy update the port ran before the C++ pass, verbatim."""
    hi = master.size if hi is None else hi
    if hi <= lo:
        return
    p = master[lo:hi]
    g = grad[lo:hi].astype(np.float32)
    m_ = m[lo:hi]
    v_ = v[lo:hi]
    np.multiply(m_, adam.b1, out=m_)
    m_ += (1 - adam.b1) * g
    np.multiply(v_, adam.b2, out=v_)
    v_ += (1 - adam.b2) * (g * g)
    bc1 = 1 - adam.b1 ** step
    bc2 = 1 - adam.b2 ** step
    denom = np.sqrt(v_ / bc2) + adam.eps
    upd = (m_ / bc1) / denom
    if adam.wd:
        upd = upd + adam.wd * p
    p -= adam.lr * upd


def _state(n: int, seed: int, gdtype=np.float32):
    rng = np.random.default_rng(seed)
    master = rng.standard_normal(n, dtype=np.float32)
    m = rng.standard_normal(n, dtype=np.float32) * np.float32(1e-2)
    v = np.abs(rng.standard_normal(n, dtype=np.float32)) * np.float32(1e-4)
    g = (rng.standard_normal(n) * 0.1).astype(gdtype)
    return master, m, v, g


def _assert_same(got, want):
    for name, a, b in zip(("master", "m", "v"), got, want):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), name


@pytest.mark.parametrize("step", [1, 2, 1000])
@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["no_decay", "decay"])
@pytest.mark.parametrize("n,lo,hi", [(1, 0, None), (7, 0, None),
                                     (7, 3, 5), (4097, 0, None),
                                     (4097, 1, 4093), (BIG, 0, None),
                                     (BIG, 5, BIG - 2)],
                         ids=["1", "7", "7[3:5]", "4097", "4097[1:4093]",
                              "big", "big[5:-2]"])
def test_update_is_bitwise_the_numpy_formula(n, lo, hi, wd, step):
    adam = CpuAdam(lr=3e-4, weight_decay=wd)
    state = _state(n, seed=n + step)
    want = [a.copy() for a in state[:3]]
    oracle(adam, *want, state[3], step, lo, hi)
    adam.update(*state, step, lo, hi)
    _assert_same(state[:3], want)
    # outside [lo, hi) nothing moved
    if hi is not None:
        fresh = _state(n, seed=n + step)
        for a, b in zip(state[:3], fresh[:3]):
            assert np.array_equal(a[:lo], b[:lo])
            assert np.array_equal(a[hi:], b[hi:])


@pytest.mark.parametrize("gdtype", [np.float16, np.float64])
@pytest.mark.parametrize("n", [4097, BIG])
def test_a_grad_of_another_dtype_is_converted_first(n, gdtype):
    adam = CpuAdam(lr=1e-3)
    state = _state(n, seed=7, gdtype=gdtype)
    want = [a.copy() for a in state[:3]]
    oracle(adam, *want, state[3], 3, 2, n - 1)
    adam.update(*state, 3, 2, n - 1)
    _assert_same(state[:3], want)


@pytest.mark.parametrize("k", [1, BLOCK - 1, BLOCK + 17, BIG - 1])
def test_split_updates_compose_to_one(k):
    """[0, k) then [k, n) is the whole update (the α split)."""
    adam = CpuAdam(weight_decay=0.01)
    split = _state(BIG, seed=11)
    whole = [a.copy() for a in split]
    adam.update(*split, 5, 0, k)
    adam.update(*split, 5, k, BIG)
    adam.update(*whole, 5)
    _assert_same(split[:3], whole[:3])


def test_pool_width_one_matches_the_full_pool(monkeypatch):
    adam = CpuAdam(weight_decay=0.1)
    full = _state(BIG, seed=3)
    one = [a.copy() for a in full]
    adam.update(*full, 2)
    assert 1 <= adam.last_threads <= cpu_adam.pool_width()
    with ThreadPoolExecutor(1) as narrow:
        monkeypatch.setattr(cpu_adam, "_pool", narrow)
        adam.update(*one, 2)
        assert adam.last_threads == 1
    _assert_same(one[:3], full[:3])
    adam.update(*_state(7, seed=3), 2)      # one block runs on the caller
    assert adam.last_threads == 1


def test_concurrent_calls_match_serial_calls():
    """Callers on several threads at once share the pool and each get the
    bits a serial call gives."""
    adam = CpuAdam(lr=1e-3, weight_decay=0.05)
    sizes = [BLOCK + 5, 2 * BLOCK + 1, 5 * BLOCK // 2, BLOCK * 3 + 9,
             4097, 2 * BLOCK]
    serial = [_state(n, seed=i) for i, n in enumerate(sizes)]
    conc = [[a.copy() for a in s] for s in serial]
    for i, s in enumerate(serial):
        adam.update(*s, 4, i, s[0].size - i)
    errors = []

    def call(i):
        try:
            s = conc[i]
            adam.update(*s, 4, i, s[0].size - i)
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for got, want in zip(conc, serial):
        _assert_same(got[:3], want[:3])


def test_malformed_state_is_refused():
    adam = CpuAdam()
    master, m, v, g = _state(64, seed=0)
    with pytest.raises(ValueError, match="master"):
        adam.update(master[::2], m[:32], v[:32], g[:32], 1)
    with pytest.raises(ValueError, match="m must"):
        adam.update(master, m.astype(np.float64), v, g, 1)
    with pytest.raises(ValueError, match="past the"):
        adam.update(master, m[:10], v, g, 1)
    with pytest.raises(ValueError, match="overlap"):
        adam.update(master, m, m, g, 1)
    with pytest.raises(ValueError, match="grad"):
        adam.update(master, m, v, g[:10], 1)
    _assert_same((master, m, v), _state(64, seed=0)[:3])   # untouched


def test_host_build_keeps_ieee_rounding():
    flags = _build.CXX_FLAGS
    assert "-ffp-contract=off" in flags
    assert not any(f.startswith(("-march", "-ffast-math", "-Ofast",
                                 "-mrecip", "-funsafe"))
                   for f in flags)


def test_a_missing_compiler_is_named(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build._start("cpu_adam")
