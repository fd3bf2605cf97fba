"""Pinned-buffer packing (GreedySnake §5).

PyTorch pads each pinned allocation to a power-of-two size, wasting up to
half the allocation. GreedySnake instead allocates a small set of
power-of-two blocks, each holding multiple same-size buffers, chosen by
dynamic programming to minimise waste. This is the reference's DP
(``repro.offload.buffers``), copied: pure Python, no device.

``pack(n, size, max_block_log2)`` returns the list of block sizes (bytes,
powers of two) that hold ``n`` buffers of ``size`` bytes with minimum
total allocated memory (ties: fewer blocks).
"""
from __future__ import annotations

from typing import List, Tuple


def pack(n: int, size: int, max_block_log2: int = 34) -> Tuple[int, List[int]]:
    """Minimise total allocated power-of-two bytes to hold n buffers of
    ``size`` bytes (buffers must not span blocks).

    Returns (total_allocated_bytes, block_sizes)."""
    assert n >= 0 and size > 0
    if n == 0:
        return 0, []
    # candidate blocks: powers of two that hold >= 1 buffer
    blocks = []
    b = 1
    while b < size:
        b <<= 1
    while b <= (1 << max_block_log2):
        blocks.append(b)
        if b // size >= n:   # one block already holds everything
            break
        b <<= 1
    INF = float("inf")
    # dp[j] = (min total bytes to hold >= j buffers, blocks used)
    dp: List[Tuple[float, List[int]]] = [(INF, [])] * (n + 1)
    dp[0] = (0, [])
    for j in range(1, n + 1):
        best = (INF, [])
        for blk in blocks:
            cap = blk // size
            prev = dp[max(0, j - cap)]
            cand = prev[0] + blk
            if cand < best[0] or (cand == best[0]
                                  and len(prev[1]) + 1 < len(best[1])):
                best = (cand, prev[1] + [blk])
        dp[j] = best
    total, blks = dp[n]
    return int(total), sorted(blks, reverse=True)


def naive_padded(n: int, size: int) -> int:
    """PyTorch-style: each buffer padded to its own power of two."""
    b = 1
    while b < size:
        b <<= 1
    return n * b


def waste_ratio(n: int, size: int) -> Tuple[float, float]:
    """(DP waste, naive waste) as fractions of the useful bytes."""
    useful = n * size
    dp_total, _ = pack(n, size)
    return dp_total / useful - 1.0, naive_padded(n, size) / useful - 1.0
