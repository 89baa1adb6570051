"""Model building blocks in plain PyTorch.

Counterpart of ``repro/models/layers.py`` for the dense decoder:
``rms_norm``, ``rope``, ``gqa_attention`` and ``swiglu``, op for op as
the reference writes them (weights f32, cast to the activation type at
use; attention logits and softmax in f32). ``local_block_attention``,
``moe_block``, ``mamba1_scan`` and ``mamba2_ssd`` are not ported yet
(ROADMAP.md, queue A item 11).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


# -------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """x: (..., S, H, D). positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), expo)
    ang = positions[..., None].to(torch.float32) * freq       # (..., S, half)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], -1).to(x.dtype)


# --------------------------------------------------------------- attention
def gqa_attention(q, k, v):
    """Causal attention over the full sequence. q: (B,S,Hq,D), k/v:
    (B,S,Hkv,D), Hq % Hkv == 0 -> (B,S,Hq,D). The reference's
    ``window``, ``softcap``, ``q_offset`` and non-causal options wait for
    local attention, decode and the gemma and encdec families (ROADMAP.md,
    queue A item 11)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, S, Hkv, g, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    logits = logits / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, S, Hq, D)


# --------------------------------------------------------------------- mlp
def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate.to(x.dtype))
    h = h * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)
