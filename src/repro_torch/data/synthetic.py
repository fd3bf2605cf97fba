"""Synthetic LM data with learnable structure.

A noisy Markov chain over the vocab: with probability ``p_det`` the next
token is a fixed permutation of the current one, else uniform. A model
that learns the permutation reaches loss ≈ -[p ln p + (1-p) ln((1-p)/V)],
so integration tests can assert a concrete loss drop (not just "finite").
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seed: int = 0, p_det: float = 0.9):
        self.vocab = vocab
        self.p_det = p_det
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab).astype(np.int32)
        self._rng = np.random.default_rng(seed + 1)

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        rng = self._rng
        out = np.empty((batch_size, seq_len), np.int32)
        cur = rng.integers(0, self.vocab, batch_size, dtype=np.int32)
        for t in range(seq_len):
            out[:, t] = cur
            det = rng.random(batch_size) < self.p_det
            rnd = rng.integers(0, self.vocab, batch_size, dtype=np.int32)
            cur = np.where(det, self.perm[cur], rnd)
        return out

    def ideal_loss(self) -> float:
        p, v = self.p_det, self.vocab
        return float(-(p * np.log(p + (1 - p) / v)
                       + (1 - p) * (v - 1) / v * np.log((1 - p) / v)))


def make_batch(cfg, batch_size: int, seq_len: int, *, seed: int = 0,
               data: Optional[SyntheticLM] = None) -> Dict[str, np.ndarray]:
    """Assemble the per-family batch dict (tokens + stub frontends)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        text = seq_len - cfg.frontend_tokens
        tokens = (data.batch(batch_size, text) if data
                  else rng.integers(0, cfg.vocab_size, (batch_size, text), dtype=np.int32))
        img = rng.standard_normal((batch_size, cfg.frontend_tokens,
                                   cfg.d_model)).astype(np.float32) * (cfg.d_model ** -0.5)
        return {"tokens": tokens, "image_embeds": img}
    tokens = (data.batch(batch_size, seq_len) if data
              else rng.integers(0, cfg.vocab_size, (batch_size, seq_len), dtype=np.int32))
    out = {"tokens": tokens}
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (batch_size, cfg.encoder_seq, cfg.d_model)).astype(np.float32) \
            * (cfg.d_model ** -0.5)
    return out
