"""Plain PyTorch reference of a dense decoder stack's training steps.

Written from the configuration alone (``perfbench/configs/<name>.json``),
with the block equations of a pre-norm decoder as the system under test
states them:

* RMSNorm with a zero-centred scale (``x * rsqrt(mean(x^2) + eps) * (1 +
  s)``), no biases anywhere;
* GQA: query head ``i`` reads key/value head ``i // (Hq / Hk)``; RoPE in
  the split-halves convention at positions ``0 .. S-1`` with angles
  ``p * theta^(-2j / hd)``; causal softmax attention scaled by
  ``hd^-0.5``;
* the MLP: ``gelu_tanh(h W_in) W_out``, or SwiGLU ``(silu(h W_gate) *
  (h W_up)) W_down``;
* a final RMSNorm, an untied LM head over the vocabulary padded up to a
  multiple of ``vocab_pad_multiple`` (the pad rows take part in the
  softmax), next-token cross-entropy summed over every position but each
  sequence's last and divided by their count over the whole step;
* Adam (bias-corrected, no weight decay) per leaf. Layer leaves keep an
  f32 master and are used rounded to ``param_dtype``; the embedding, LM
  head and final norm have no master: a bf16 one is rounded to bf16
  after each update.

Weights are a flat dict of named leaves: ``layers.<i>.attn.wq``, ...,
``layers.<i>.norm2``, ``embed`` (V, d), ``unembed`` (d, V),
``final_norm`` (d,). Departures from the published models are the
configuration file's ``departures`` list. Everything is computed in
float32 with TF32 off (``precision="f32"``). ``precision="fp8"`` is the
control: every matrix product's operands rounded to float8 (e4m3
forward, e5m2 for the gradients flowing back, one scale per tensor), the
rest unchanged.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

HEAD_LEAVES = ("embed", "unembed", "final_norm")


def configure_precision() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def padded_vocab(cfg) -> int:
    mult = int(cfg["vocab_pad_multiple"])
    return -(-int(cfg["vocab_size"]) // mult) * mult


def block_shapes(cfg) -> Dict[str, tuple]:
    """One block's leaves, by name within the block, in the ``(in,
    out)`` layout."""
    d, hq, hk, hd, f = (cfg["d_model"], cfg["num_heads"],
                        cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"])
    if cfg["act"] == "swiglu":
        mlp = {"mlp.w_gate": (d, f), "mlp.w_up": (d, f), "mlp.w_down": (f, d)}
    elif cfg["act"] == "gelu":
        mlp = {"mlp.w_in": (d, f), "mlp.w_out": (f, d)}
    else:
        raise ValueError(f"unknown activation {cfg['act']!r}")
    return {"attn.wq": (d, hq * hd), "attn.wk": (d, hk * hd),
            "attn.wv": (d, hk * hd), "attn.wo": (hq * hd, d), **mlp,
            "norm1": (d,), "norm2": (d,)}


def weight_shapes(cfg) -> Dict[str, tuple]:
    """Every leaf of the model, by its full name."""
    out = {f"layers.{i}.{n}": s for i in range(cfg["num_layers"])
           for n, s in block_shapes(cfg).items()}
    v, d = padded_vocab(cfg), cfg["d_model"]
    out.update({"embed": (v, d), "unembed": (d, v), "final_norm": (d,)})
    return out


# ---------------------------------------------------------------------------
# the control's rounding
# ---------------------------------------------------------------------------

def _round_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8) under one per-tensor scale
    that maps its largest magnitude to the format's largest value."""
    top = torch.finfo(dtype).max
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


class Precision:
    """Where the arithmetic is rounded: nowhere ("f32"), or at every
    matrix product's operands ("fp8")."""

    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8Operand.apply(x) if self.name == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.operand(a) @ self.operand(b)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + scale)


def rope(x, theta: float):
    """x: (B, S, H, hd); split halves rotated by position."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w, pre, h, cfg, pr: Precision):
    B, S, _ = h.shape
    hq, hk, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    g = hq // hk
    q = rope(pr.mm(h, w[pre + "attn.wq"]).view(B, S, hq, hd),
             cfg["rope_theta"])
    k = rope(pr.mm(h, w[pre + "attn.wk"]).view(B, S, hk, hd),
             cfg["rope_theta"])
    v = pr.mm(h, w[pre + "attn.wv"]).view(B, S, hk, hd)
    q = q.view(B, S, hk, g, hd).permute(0, 2, 3, 1, 4)     # (B,hk,g,S,hd)
    k = k.permute(0, 2, 1, 3)                               # (B,hk,S,hd)
    v = v.permute(0, 2, 1, 3)
    s = torch.einsum("bhgqd,bhkd->bhgqk", pr.operand(q), pr.operand(k))
    s = s * (1.0 / math.sqrt(hd))
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", pr.operand(a), pr.operand(v))
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, hq * hd)
    return pr.mm(o, w[pre + "attn.wo"])


def mlp(w, pre, h, act: str, pr: Precision):
    if act == "swiglu":
        gate = F.silu(pr.mm(h, w[pre + "mlp.w_gate"]))
        return pr.mm(gate * pr.mm(h, w[pre + "mlp.w_up"]),
                     w[pre + "mlp.w_down"])
    return pr.mm(F.gelu(pr.mm(h, w[pre + "mlp.w_in"]), approximate="tanh"),
                 w[pre + "mlp.w_out"])


def token_loss_sum(w, tokens, cfg, pr: Precision):
    """Summed next-token cross-entropy of ``tokens`` (B, S) under the
    weights ``w``; the last position of each sequence predicts nothing."""
    eps = cfg["norm_eps"]
    x = w["embed"][tokens]
    for i in range(cfg["num_layers"]):
        pre = f"layers.{i}."
        x = x + attention(w, pre, rms_norm(x, w[pre + "norm1"], eps), cfg, pr)
        x = x + mlp(w, pre, rms_norm(x, w[pre + "norm2"], eps), cfg["act"],
                    pr)
    h = rms_norm(x, w["final_norm"], eps)
    logits = pr.mm(h[:, :-1], w["unembed"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1), reduction="sum")


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

def _adam(p, g, m, v, step: int, adam) -> torch.Tensor:
    b1, b2 = adam["b1"], adam["b2"]
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    upd = (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step))
                                    + adam["eps"])
    return p - adam["lr"] * upd


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def train_readings(cfg, train, weights0: Dict[str, torch.Tensor],
                   token_steps: Sequence, micro_batch: int, device,
                   precision: str = "f32") -> Dict[str, object]:
    """Run ``len(token_steps)`` Adam steps from ``weights0`` and return
    what the benchmark compares: each step's mean token loss, the norm of
    each leaf's first gradient, and the norm of each leaf's change over
    all the steps (layer leaves: of the master).

    ``weights0``: the initial values by leaf name (any device, any float
    dtype). ``token_steps``: one (rows, S) integer array or tensor a
    step, run ``micro_batch`` rows at a time. ``train``: the
    configuration's ``train`` block (``param_dtype``, ``adam``)."""
    configure_precision()
    pr = Precision(precision)
    adam = {k: float(train["adam"][k]) for k in ("lr", "b1", "b2", "eps")}
    lowp = getattr(torch, train["param_dtype"])
    f32 = torch.float32
    start = {n: torch.as_tensor(t).to(device=device, dtype=f32)
             for n, t in weights0.items()}
    names = sorted(start)
    # what each leaf is used as, and what Adam updates: layer leaves
    # update an f32 master and are used rounded to param_dtype; head
    # leaves update themselves and are stored in their own type
    state = {n: start[n].clone() for n in names}
    store = {n: (f32 if n == "final_norm" else lowp) for n in names}
    moments = {n: (torch.zeros_like(t), torch.zeros_like(t))
               for n, t in state.items()}
    losses: List[float] = []
    first_grad = None
    for step, tokens in enumerate(token_steps, start=1):
        tokens = torch.as_tensor(tokens).to(device=device, dtype=torch.long)
        rows, S = tokens.shape
        denom = float(rows * (S - 1))
        used = {n: state[n].to(store[n]).to(f32).requires_grad_()
                for n in names}
        flat = [used[n] for n in names]
        grads = [torch.zeros_like(t) for t in flat]
        total = 0.0
        for lo in range(0, rows, micro_batch):
            loss = token_loss_sum(used, tokens[lo:lo + micro_batch], cfg,
                                  pr) / denom
            for acc, g in zip(grads, torch.autograd.grad(loss, flat)):
                acc += g
            total += float(loss.detach())
        del used, flat
        losses.append(total)
        if first_grad is None:
            first_grad = {n: _norm(g) for n, g in zip(names, grads)}
        for n, g in zip(names, grads):
            p = _adam(state[n], g, *moments[n], step, adam)
            state[n] = p.to(store[n]).to(f32) if n in HEAD_LEAVES else p
        del grads
    change = {n: _norm(state[n] - start[n]) for n in names}
    return {"loss": losses, "grad_norm": first_grad, "change_norm": change}
