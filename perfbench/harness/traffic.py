"""The token generator every training mix is read by.

A training mix (``perfbench/traffic/<name>.json``) states the step's
shape (``micro_batches`` x ``micro_batch`` rows of ``seq_len`` tokens)
and how ids are drawn. ``"uniform"`` draws each id uniformly from the
configuration's vocabulary, as the program's synthetic batches do
(``rng.integers(0, vocab, (rows, seq_len))``). Step ``k`` of seed ``s``
comes from its own stream ``(s, k)``, so every step's rows differ and
every seed draws the same sizes.
"""
from __future__ import annotations

import numpy as np

DISTRIBUTIONS = ("uniform",)


def rows(mix: dict) -> int:
    return int(mix["micro_batches"]) * int(mix["micro_batch"])


def step_tokens(mix: dict, vocab: int, seed: int, step: int) -> np.ndarray:
    """The (rows, seq_len) int32 ids of step ``step`` (1-based)."""
    dist = mix["tokens"]
    if dist not in DISTRIBUTIONS:
        raise ValueError(f"unknown token distribution {dist!r}; "
                         f"known: {DISTRIBUTIONS}")
    rng = np.random.default_rng([int(seed) % (1 << 63), int(step)])
    return rng.integers(0, vocab, (rows(mix), int(mix["seq_len"])),
                        dtype=np.int32)


def half_batch(tokens: np.ndarray, micro_batches: int, micro_batch: int
               ) -> np.ndarray:
    """The fault "half of the batch left out, the mean taken over the
    rest": the second half of the micro-batches repeat the first half."""
    t = tokens.reshape(micro_batches, micro_batch, -1).copy()
    h = micro_batches // 2
    t[h:2 * h] = t[:h]
    return t.reshape(tokens.shape)
