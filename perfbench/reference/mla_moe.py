"""Plain PyTorch reference of a DeepSeek-V2 stack's training steps on one
chip's share of the routed experts.

Written from the configuration file alone (``perfbench/configs/<name>.json``,
the published ``config.json``'s keys), with the equations of the
published model:

* MLA without query compression: ``q = h W_q`` split per head into a
  ``qk_nope_head_dim`` part and a ``qk_rope_head_dim`` part; ``c = h
  W_dkv`` split into the latent (``kv_lora_rank``, RMS-normalised) and
  one rope key shared by every head; ``k_nope = latent W_uk``, ``v =
  latent W_uv``; causal softmax attention over ``[q_nope, q_rope]`` and
  ``[k_nope, k_rope]``, then ``W_o``;
* RoPE on the rope parts in the split-halves convention, with YaRN's
  frequencies (``rope_scaling``): ``inv = f_inter r + f_extra (1 - r)``,
  ``f_extra = theta^(-2i/dim)``, ``f_inter = f_extra / factor``, ``r`` the
  linear ramp over ``i`` from ``floor(d(beta_fast))`` to
  ``ceil(d(beta_slow))``, ``d(n) = dim ln(original / (2 pi n)) / (2 ln
  theta)``; cos and sin times ``m(mscale) / m(mscale_all_dim)``; the
  softmax scale ``(nope + rope)^-1/2 m(mscale_all_dim)^2``, ``m(x) = 0.1 x
  ln(factor) + 1``;
* RMSNorm with a zero-centred scale (``x rsqrt(mean(x^2) + eps) (1 +
  s)``), no biases;
* the first ``first_k_dense_replace`` layers: a SwiGLU MLP of
  ``intermediate_size``; the others MoE: a router over all
  ``n_routed_experts`` (logits in float32), softmax scores, the top
  ``num_experts_per_tok`` (greedy), gates the scores themselves unless
  ``norm_topk_prob``, times ``routed_scaling_factor``; the routed experts
  held here (``num_experts`` of them from ``experts_first``: the chip's
  share) add their gated SwiGLU outputs, an expert not held adds
  nothing; plus ``n_shared_experts`` shared experts as one SwiGLU of
  ``n_shared_experts x moe_intermediate_size``;
* the balance loss taken per sequence (``seq_aux``): ``aux_alpha x
  mean_b sum_i (E count_{b,i} / (S K)) mean_s p_{b,s,i}`` over all E
  experts, summed over the MoE layers and added to the loss;
* a final RMSNorm, an untied LM head over the vocabulary padded to a
  multiple of ``vocab_pad_multiple``, next-token cross-entropy summed over
  every position but each sequence's last and divided by their count
  over the whole step;
* Adam per leaf as ``dense.py`` has it (layer leaves on an f32 master,
  used rounded to ``param_dtype``).

Each leaf's name is the program's: ``layers.<i>.attn.wq``, ...,
``layers.<i>.moe.w_gate`` (held experts, in, out), ``layers.<i>.moe.shared
.w_gate``, ..., ``embed``, ``unembed``, ``final_norm``. A step is run
``block_rows`` sequences at a time, so that a sequence's attention
scores and logits are the largest tensors (a sequence's loss and balance
term do not depend on the others). Everything in float32 with TF32 off;
``precision="fp8"`` rounds every matrix product's operands to float8 as
``dense.py``'s control does.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import dense

HEAD_LEAVES = dense.HEAD_LEAVES


def padded_vocab(cfg) -> int:
    mult = int(cfg["vocab_pad_multiple"])
    return -(-int(cfg["vocab_size"]) // mult) * mult


def is_moe(cfg, i: int) -> bool:
    return i >= int(cfg["first_k_dense_replace"])


def block_shapes(cfg, i: int) -> Dict[str, tuple]:
    """Layer ``i``'s leaves, by name within the block, ``(in, out)``."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    out = {"attn.wq": (d, H * (nope + rope)), "attn.w_dkv": (d, r + rope),
           "attn.kv_norm": (r,), "attn.w_uk": (r, H * nope),
           "attn.w_uv": (r, H * vd), "attn.wo": (H * vd, d),
           "norm1": (d,), "norm2": (d,)}
    if not is_moe(cfg, i):
        f = cfg["intermediate_size"]
        out.update({"mlp.w_gate": (d, f), "mlp.w_up": (d, f),
                    "mlp.w_down": (f, d)})
        return out
    E, n, f = cfg["n_routed_experts"], cfg["num_experts"], \
        cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * f
    out.update({"moe.router": (d, E), "moe.w_gate": (n, d, f),
                "moe.w_up": (n, d, f), "moe.w_down": (n, f, d),
                "moe.shared.w_gate": (d, fs), "moe.shared.w_up": (d, fs),
                "moe.shared.w_down": (fs, d)})
    return out


def weight_shapes(cfg) -> Dict[str, tuple]:
    out = {f"layers.{i}.{n}": s for i in range(cfg["num_layers"])
           for n, s in block_shapes(cfg, i).items()}
    v, d = padded_vocab(cfg), cfg["hidden_size"]
    out.update({"embed": (v, d), "unembed": (d, v), "final_norm": (d,)})
    return out


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(cfg, device=None) -> torch.Tensor:
    """The rope part's inverse frequencies (dim / 2,)."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    extra = 1.0 / base ** (2 * i / dim)
    if rs is None:
        return extra

    def corr(n):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (n * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((i - low) / (high - low)).clamp(0, 1)
    return extra / rs["factor"] * ramp + extra * (1 - ramp)


def softmax_scale(cfg) -> float:
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs is not None and rs.get("mscale_all_dim"):
        s *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return s


def _rope(x, inv, scale: float):
    """x: (B, S, H, dim), split halves rotated by position."""
    S, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = (torch.cos(ang) * scale)[None, :, None]
    sin = (torch.sin(ang) * scale)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

def mla(w, pre, h, cfg, pr):
    B, S, _ = h.shape
    H = cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    r, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    rs = cfg["rope_scaling"]
    cs = (_mscale(rs["factor"], rs["mscale"])
          / _mscale(rs["factor"], rs["mscale_all_dim"])) if rs else 1.0
    inv = yarn_inv_freq(cfg, h.device)
    q = pr.mm(h, w[pre + "attn.wq"]).view(B, S, H, nope + rope)
    c = pr.mm(h, w[pre + "attn.w_dkv"])
    latent = dense.rms_norm(c[..., :r], w[pre + "attn.kv_norm"], eps)
    k_rope = _rope(c[..., r:].view(B, S, 1, rope), inv, cs)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], inv, cs)], dim=-1)
    k = torch.cat([pr.mm(latent, w[pre + "attn.w_uk"]).view(B, S, H, nope),
                   k_rope.expand(B, S, H, rope)], dim=-1)
    v = pr.mm(latent, w[pre + "attn.w_uv"]).view(B, S, H, vd)
    s = torch.einsum("bqhd,bkhd->bhqk", pr.operand(q), pr.operand(k))
    s = s * softmax_scale(cfg)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr.operand(a), pr.operand(v))
    return pr.mm(o.reshape(B, S, H * vd), w[pre + "attn.wo"])


def swiglu(h, w_gate, w_up, w_down, pr):
    return pr.mm(F.silu(pr.mm(h, w_gate)) * pr.mm(h, w_up), w_down)


def moe(w, pre, h, cfg, pr):
    """(the held routed experts' part + the shared experts, each
    sequence's balance term (B,))."""
    B, S, d = h.shape
    E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    lo, n = cfg["experts_first"], cfg["num_experts"]
    x = h.reshape(B * S, d)
    p = torch.softmax(pr.mm(x, w[pre + "moe.router"]), dim=-1)   # (T,E)
    gate, idx = torch.topk(p, K, dim=-1)
    if cfg["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    gate = gate * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for j in range(n):
        sel = idx == lo + j                                       # (T,K)
        rows = sel.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        g = (gate * sel).sum(-1)[rows]
        out = swiglu(x[rows], w[pre + "moe.w_gate"][j],
                     w[pre + "moe.w_up"][j], w[pre + "moe.w_down"][j], pr)
        y = y.index_add(0, rows, out * g[:, None])
    y = y + swiglu(x, w[pre + "moe.shared.w_gate"],
                   w[pre + "moe.shared.w_up"],
                   w[pre + "moe.shared.w_down"], pr)
    count = F.one_hot(idx.view(B, S * K), E).sum(1).float()       # (B,E)
    frac = count * E / (S * K)
    bal = (frac * p.view(B, S, E).mean(1)).sum(-1)
    return y.view(B, S, d), bal


def loss_terms(w, tokens, cfg, pr):
    """(summed next-token cross-entropy of ``tokens`` (B, S), summed over
    its sequences and MoE layers balance term)."""
    eps = cfg["rms_norm_eps"]
    x = w["embed"][tokens]
    bal = torch.zeros((), device=x.device)
    for i in range(cfg["num_layers"]):
        pre = f"layers.{i}."
        x = x + mla(w, pre, dense.rms_norm(x, w[pre + "norm1"], eps), cfg,
                    pr)
        h = dense.rms_norm(x, w[pre + "norm2"], eps)
        if is_moe(cfg, i):
            y, b = moe(w, pre, h, cfg, pr)
            bal = bal + b.sum()
        else:
            y = swiglu(h, w[pre + "mlp.w_gate"], w[pre + "mlp.w_up"],
                       w[pre + "mlp.w_down"], pr)
        x = x + y
    h = dense.rms_norm(x, w["final_norm"], eps)
    logits = pr.mm(h[:, :-1], w["unembed"])
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1), reduction="sum")
    return ce, bal


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

def train_readings(cfg, train, weights0: Dict[str, torch.Tensor],
                   token_steps: Sequence, device, precision: str = "f32",
                   block_rows: int = 1, tensors: bool = False
                   ) -> Dict[str, object]:
    """Run ``len(token_steps)`` Adam steps from ``weights0`` and return
    each step's loss (cross-entropy over the step's predicted tokens plus
    the balance loss), the norm of each leaf's first gradient and the norm
    of each leaf's change over all the steps (layer leaves: of the
    master); with ``tensors`` also the first gradients (``grad``) and the
    final values (``state``) themselves. ``train``: the configuration's
    ``train`` block."""
    dense.configure_precision()
    pr = dense.Precision(precision)
    adam = {k: float(train["adam"][k]) for k in ("lr", "b1", "b2", "eps")}
    lowp = getattr(torch, train["param_dtype"])
    f32 = torch.float32
    alpha = float(cfg["aux_alpha"])
    start = {n: torch.as_tensor(t).to(device=device, dtype=f32)
             for n, t in weights0.items()}
    names = sorted(start)
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
        used = {n: state[n].to(store[n]).to(f32).detach().requires_grad_()
                for n in names}
        flat = [used[n] for n in names]
        grads = [torch.zeros_like(t) for t in flat]
        total = 0.0
        for lo in range(0, rows, block_rows):
            ce, bal = loss_terms(used, tokens[lo:lo + block_rows], cfg, pr)
            loss = ce / denom + alpha * bal / rows
            for acc, g in zip(grads, torch.autograd.grad(loss, flat)):
                acc += g
            total += float(loss.detach())
        del used, flat
        losses.append(total)
        if first_grad is None:
            first_grad = {n: dense._norm(g) for n, g in zip(names, grads)}
            if tensors:
                grad0 = dict(zip(names, grads))
        for n, g in zip(names, grads):
            p = dense._adam(state[n], g, *moments[n], step, adam)
            state[n] = p.to(store[n]).to(f32) if n in HEAD_LEAVES else p
        del grads
    change = {n: dense._norm(state[n] - start[n]) for n in names}
    out = {"loss": losses, "grad_norm": first_grad, "change_norm": change}
    if tensors:
        out.update(grad=grad0, state=state)
    return out
