"""The port's pinned-buffer packing DP (``repro_torch.offload.buffers``,
GreedySnake §5): the cases of ``tests/test_property.py`` and the
reference's own answers on the same inputs."""
import pytest

pytest.importorskip("hypothesis")

import hypothesis.strategies as st
from hypothesis import given, settings

from repro.offload import buffers as ref
from repro_torch.offload import naive_padded, pack, waste_ratio


def _brute_force(n, size, max_log2=22):
    """Exhaustive search over block multisets for small instances."""
    blocks = []
    b = 1
    while b < size:
        b <<= 1
    while b <= (1 << max_log2):
        blocks.append(b)
        b <<= 1
    best = [float("inf")]

    def rec(remaining, total):
        if total >= best[0]:
            return
        if remaining <= 0:
            best[0] = min(best[0], total)
            return
        for blk in blocks:
            rec(remaining - blk // size, total + blk)

    rec(n, 0)
    return best[0]


@given(n=st.integers(1, 12), size=st.integers(1, 5000))
@settings(max_examples=60, deadline=None)
def test_pack_optimal_vs_bruteforce(n, size):
    total, blks = pack(n, size, max_block_log2=22)
    assert total == _brute_force(n, size)
    assert sum(b // size for b in blks) >= n
    assert total <= naive_padded(n, size)


@given(n=st.integers(1, 64), size=st.integers(1, 10 ** 7))
@settings(max_examples=60, deadline=None)
def test_pack_feasible_and_bounded(n, size):
    total, blks = pack(n, size)
    assert sum(b // size for b in blks) >= n
    assert total >= n * size
    assert all(b & (b - 1) == 0 for b in blks)  # powers of two


@given(n=st.integers(0, 48), size=st.integers(1, 10 ** 8))
@settings(max_examples=80, deadline=None)
def test_pack_matches_reference(n, size):
    """The same blocks (sizes and order) and the same padding as the
    reference's DP."""
    assert pack(n, size) == ref.pack(n, size)
    assert naive_padded(n, size) == ref.naive_padded(n, size)
    if n:
        assert waste_ratio(n, size) == ref.waste_ratio(n, size)


@pytest.mark.parametrize("n,size", [(8, 3 << 20), (3, 5 << 30), (1, 1)])
def test_pack_at_engine_sizes(n, size):
    """Buffers of a few MiB to GiB (staging chunks, a GPT-65B layer's bf16
    parameters): never more than naive padding, and at most one block
    of waste beyond the useful bytes' power-of-two cover."""
    total, blks = pack(n, size)
    assert n * size <= total <= naive_padded(n, size)
    assert total == ref.pack(n, size)[0]
    dp, naive = waste_ratio(n, size)
    assert 0.0 <= dp <= naive
