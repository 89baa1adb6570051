"""Model building blocks in plain PyTorch.

Counterpart of ``repro/models/layers.py``: ``rms_norm``, ``rope``,
``gqa_attention``, ``local_block_attention``, ``swiglu``, ``moe_block``,
``mamba1_scan`` and ``mamba2_ssd``, op for op as the reference writes
them (weights f32, cast to the activation type at use; attention logits
and softmax in f32, masked with -1e30; the mamba recurrences in f32).
The attention einsums run as batched matmuls over the same operands.
On DTensors (the sharded step, the dry run) some activations are pinned
to plain layouts and the mamba-1 recurrence runs on each rank's shards
(``dist.mesh_rules``); on plain tensors those calls do nothing.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.mesh_rules import is_dtensor, on_shards, pin_layout


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
    # theta filled on the card (a tensor built from the host would copy)
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=x.device), expo)
    ang = positions[..., None].to(torch.float32) * freq       # (..., S, half)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], -1).to(x.dtype)


# --------------------------------------------------------------- attention
def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


def _scores(qg, k):
    """``einsum("...qhgd,...khd->...hgqk", qg, k)`` as one batched
    matmul over (..., h, g): the query rows stay a dim of their own, so a
    query-sharded DTensor keeps a plain ``Shard`` placement (einsum would
    fold them with ``g`` into one dim)."""
    n = qg.dim()
    qp = qg.movedim(n - 4, n - 2)                          # (...,h,g,q,d)
    kt = k.movedim(n - 4, n - 3).transpose(-1, -2)         # (...,h,d,k)
    return torch.matmul(qp, kt.unsqueeze(-3))


def _weighted(probs, v):
    """``einsum("...hgqk,...khd->...qhgd", probs, v)`` as one batched
    matmul (see ``_scores``)."""
    n = v.dim()
    vp = v.movedim(n - 3, n - 2)                           # (...,h,k,d)
    out = torch.matmul(probs, vp.unsqueeze(-3))            # (...,h,g,q,d)
    return out.movedim(-2, -4)


def gqa_attention(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset=0):
    """q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D), Hq % Hkv == 0 -> (B,Sq,Hq,D).

    ``q_offset`` is the absolute position of q[0] (an int or a 0-d
    tensor); ``window`` the sliding-window size (None: full)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D)
    logits = _scores(qg, k).to(torch.float32)              # (B,Hkv,g,Sq,Sk)
    logits = logits / math.sqrt(D)
    logits = _softcap(logits, softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = _weighted(probs, v)                              # (B,Sq,Hkv,g,D)
    return out.reshape(B, Sq, Hq, D)


def _previous_block(t: torch.Tensor) -> torch.Tensor:
    """(B,nb,...) -> each block's previous block, zeros for block 0."""
    pad = [0, 0] * (t.dim() - 2) + [1, 0]
    return F.pad(t, pad)[:, :-1]


def local_block_attention(q, k, v, *, window: int,
                          softcap: Optional[float] = None):
    """Sliding-window attention over blocks of ``window`` queries, each
    against its own and the previous block's keys: O(S * 2W) instead of
    O(S^2). Exact for window <= block size. q,k,v: (B,S,H*,D) with
    S % window == 0. Block 0's previous block is zero padding, masked."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    nb = S // window
    qb = q.reshape(B, nb, window, Hq, D)
    kb = k.reshape(B, nb, window, Hkv, D)
    vb = v.reshape(B, nb, window, Hkv, D)
    # each block's previous one, zeros before block 0 (on a DTensor,
    # each rank pads its own rows: torch 2.11's DTensor fails to plan pad)
    kprev = on_shards(_previous_block, kb)
    vprev = on_shards(_previous_block, vb)
    k2 = torch.cat([kprev, kb], dim=2)                 # (B,nb,2W,Hkv,D)
    v2 = torch.cat([vprev, vb], dim=2)
    g = Hq // Hkv
    # a DTensor's block rows on the mesh's "model" dim
    qg = pin_layout(qb.reshape(B, nb, window, Hkv, g, D), 2)
    logits = _scores(qg, k2).to(torch.float32)             # (B,nb,h,g,q,k)
    logits = logits / math.sqrt(D)
    logits = _softcap(logits, softcap)
    qpos = torch.arange(window, device=q.device)[:, None] + window
    kpos = torch.arange(2 * window, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    mask0 = mask & (kpos >= window)                    # block 0: no padding
    first = (torch.arange(nb, device=q.device) == 0)[:, None, None]
    m = torch.where(first, mask0[None], mask[None])    # (nb,W,2W)
    logits = torch.where(m[None, :, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = pin_layout(_weighted(probs, v2))    # whole blocks, then merged
    return out.reshape(B, S, Hq, D)


# --------------------------------------------------------------------- mlp
def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate.to(x.dtype))
    h = h * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


# --------------------------------------------------------------------- moe
_DROPS: Optional[list] = None


@contextlib.contextmanager
def record_drops():
    """While active, each ``moe_block`` call appends to the yielded list
    the number (a 0-d tensor) of its token-to-expert assignments that
    fell at or beyond their expert's capacity."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an all-zero row where ``idx`` is outside
    [0, n) (``F.one_hot`` raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_block(x, router_w, w_gate, w_up, w_down, *, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 512):
    """Top-k token-choice MoE with capacity (GShard-style grouped
    dispatch), the reference's arithmetic. x: (B,S,D); router_w: (D,E);
    expert weights (E,D,F)/(E,F,D).

    As in the reference, a token's slot in an expert is counted over the
    group separately for each choice rank, so a first and a second
    choice of two tokens can share an (expert, slot) and the expert
    computes on their sum; an assignment at or beyond the capacity is
    dropped (its one-hot slot row is zero). The capacity follows the
    group size: a 1-token decode group has capacity 1."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    T = B * S
    gsz = min(group_size, T)
    G = T // gsz
    xt = x.reshape(G, gsz, D)
    # the dispatch below runs on whole groups: a DTensor's rows on the
    # mesh's batch dims, replicated over "model"
    logits = pin_layout(torch.einsum("gtd,de->gte", xt.to(torch.float32),
                                     router_w.to(torch.float32)))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, experts = torch.topk(probs, top_k, dim=-1)       # (G,t,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    cap = int(capacity_factor * (gsz * top_k) / E) + 1
    onehot = _one_hot(experts, E, torch.float32)                # (G,t,k,E)
    pos = torch.cumsum(onehot, dim=1) - onehot                  # per rank
    pos = (pos * onehot).sum(2)                                 # (G,t,E)
    keep = (pos < cap) & (onehot.sum(2) > 0)                    # (G,t,E)
    gates_e = (gate_vals[..., None] * onehot).sum(2) * keep     # (G,t,E)
    if _DROPS is not None:
        _DROPS.append(top_k * G * gsz - keep.sum())

    slot = _one_hot(pos.to(torch.int32), cap, x.dtype)
    disp = slot * keep[..., None].to(x.dtype)                   # (G,t,E,C)
    xe = pin_layout(torch.einsum("gtec,gtd->gecd", disp, xt))   # (G,E,C,D)

    h = F.silu(pin_layout(torch.einsum("gecd,edf->gecf", xe,
                                       w_gate.to(x.dtype)), 3))
    h = h * pin_layout(torch.einsum("gecd,edf->gecf", xe,
                                    w_up.to(x.dtype)), 3)
    ye = pin_layout(torch.einsum("gecf,efd->gecd", h, w_down.to(x.dtype)))

    comb = disp * gates_e[..., None].to(x.dtype)                # (G,t,E,C)
    yt = pin_layout(torch.einsum("gtec,gecd->gtd", comb, ye))
    return yt.reshape(B, S, D)


# ------------------------------------------------------------------- mamba
def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in ``x``'s dtype:
    ``max(x, 0) + log1p(exp(-|x|))``, with no linear cut-off."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv4(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of kernel 4 over axis 1 of (B,S,C):
    the reference's sum of four shifted products, added in its order.
    On DTensors each rank convolves its own rows and channels (the
    channels on ``model``)."""
    if is_dtensor(x):
        return on_shards(causal_conv4, pin_layout(x, 2),
                         pin_layout(w, 1, rows=False))
    S = x.shape[1]
    xpad = F.pad(x, (0, 0, 3, 0))
    out = 0
    for i in range(4):
        out = out + xpad[:, i:i + S, :] * w[i]
    return out


def _chunks(S: int, chunk: int) -> int:
    """Number of chunks; the reference's reshape refuses a ragged one."""
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"scan chunk {chunk}")
    return S // chunk


def _mamba1_chunk(h: torch.Tensor, A: torch.Tensor, xi: torch.Tensor,
                  dt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor):
    """One chunk of the S6 recurrence, f32. h: (B,Di,N); xi, dt:
    (B,c,Di); Bc, Cc: (B,c,N) -> (h after the chunk, y (B,c,Di)). The
    per-position factors are elementwise, so they are formed for the
    whole chunk at once; the loop carries only ``h = h*dA + dBx``."""
    dA = torch.exp(dt[..., None] * A)                         # (B,c,Di,N)
    dBx = (dt * xi)[..., None] * Bc[:, :, None, :]            # (B,c,Di,N)
    hs = []
    for t in range(xi.shape[1]):
        h = h * dA[:, t] + dBx[:, t]
        hs.append(h)
    y = torch.einsum("bcin,bcn->bci", torch.stack(hs, 1), Cc)
    return h, y


def _replicated(p: dict, names) -> dict:
    """``p`` with the DTensor leaves ``names`` (weights the recurrence
    meets elementwise) replicated over the mesh; plain leaves as they
    are."""
    return {k: pin_layout(v, rows=False) if k in names else v
            for k, v in p.items()}


def mamba1_scan(x: torch.Tensor, p: dict, *, chunk: int = 128):
    """Mamba-1 (S6) selective scan. x: (B,S,D). ``p``: in_proj (D,2Di),
    conv_w (4,Di), x_proj (Di,dt_rank+2N), dt_proj (dt_rank,Di), A_log
    (Di,N), D_skip (Di,), out_proj (Di,D). A sequential scan over S in
    chunks, each chunk under ``torch.utils.checkpoint`` when gradients
    are on (the reference's ``jax.checkpoint(chunk_step)``)."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    nchunk = _chunks(S, chunk)
    dt_rank = p["dt_proj"].shape[0]
    N = p["A_log"].shape[1]

    p = _replicated(p, ("A_log", "D_skip"))
    # on DTensors: the projections split below replicated over "model",
    # the channels of each (B,S,Di) activation on it
    xz = pin_layout(x @ p["in_proj"].to(x.dtype))
    xi, z = xz.chunk(2, dim=-1)                               # (B,S,Di)
    xi = F.silu(causal_conv4(xi, p["conv_w"].to(x.dtype)))

    proj = pin_layout(xi @ p["x_proj"].to(x.dtype))
    dt, Bc, Cc = proj.split([dt_rank, N, N], dim=-1)
    dt = softplus(pin_layout(dt @ p["dt_proj"].to(x.dtype), 2))
    A = -torch.exp(p["A_log"].to(torch.float32))              # (Di,N)

    def scan(xi, dt, Bc, Cc, A):
        xs = [a.to(torch.float32) for a in (xi, dt, Bc, Cc)]
        h = torch.zeros((xi.shape[0], A.shape[0], N), dtype=torch.float32,
                        device=xi.device)
        ys = []
        for c in range(nchunk):
            part = [a[:, c * chunk:(c + 1) * chunk] for a in xs]
            if torch.is_grad_enabled():
                h, y = checkpoint(_mamba1_chunk, h, A, *part,
                                  use_reentrant=False)
            else:
                h, y = _mamba1_chunk(h, A, *part)
            ys.append(y)
        return torch.cat(ys, 1)

    # on DTensors each rank scans its own rows and channels (the
    # channels on "model"): one local loop, not a DTensor op a position
    xi, dt = pin_layout(xi, 2), pin_layout(dt, 2)
    y = on_shards(scan, xi, dt, pin_layout(Bc), pin_layout(Cc),
                  pin_layout(A, 0, rows=False)).to(x.dtype)
    y = y + xi * p["D_skip"].to(x.dtype)
    # (its gradient too, see mamba2_ssd)
    y = pin_layout(y * F.silu(pin_layout(z, 2)))
    return y @ p["out_proj"].to(x.dtype)


def mamba2_ssd(x: torch.Tensor, p: dict, *, chunk: int = 128):
    """Mamba-2 (SSD) block in the chunked dual form. x: (B,S,D). ``p``:
    in_proj (D, 2Di+2N+H), conv_w (4, Di+2N), A_log (H,), D_skip (H,),
    norm_scale (Di,), out_proj (Di,D); head dim P = Di/H.

    As in the reference, the intra-chunk decay is
    ``where(causal, exp(seg), 0)``: above the diagonal ``seg`` is a
    positive sum of ``dt*|A|`` that can overflow ``exp`` to inf, which
    the forward discards and the backward turns into NaN (0 * inf)."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    nb = _chunks(S, chunk)
    Di = p["norm_scale"].shape[0]
    H = p["A_log"].shape[0]
    P = Di // H
    N = (p["in_proj"].shape[1] - 2 * Di - H) // 2

    p = _replicated(p, ("A_log", "D_skip", "norm_scale"))
    # the projections split below, replicated over a mesh's "model" dim
    zxbcdt = pin_layout(x @ p["in_proj"].to(x.dtype))
    z, xbc, dt = zxbcdt.split([Di, Di + 2 * N, H], dim=-1)
    xbc = pin_layout(F.silu(causal_conv4(xbc, p["conv_w"].to(x.dtype))))
    xi, Bc, Cc = xbc.split([Di, N, N], dim=-1)
    def ssd(xi, Bc, Cc, dt, A_log, D_skip):
        """(B,S,Di) ssm output of the block's inputs, in x's dtype."""
        B = xi.shape[0]
        dt = softplus(dt.to(torch.float32))                   # (B,S,H)
        A = -torch.exp(A_log.to(torch.float32))               # (H,)

        xh = xi.reshape(B, nb, chunk, H, P).to(torch.float32)
        Bh = Bc.reshape(B, nb, chunk, N).to(torch.float32)
        Ch = Cc.reshape(B, nb, chunk, N).to(torch.float32)
        dth = dt.reshape(B, nb, chunk, H)

        dA = dth * A                                          # (B,nb,c,H)
        cs = torch.cumsum(dA, dim=2)
        seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (B,nb,c,c,H)
        causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                       device=xi.device))
        Lm = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
        att = torch.einsum("bncm,bnkm->bnck", Ch, Bh)         # (B,nb,c,c)
        att = att[..., None] * Lm                             # (B,nb,c,c,H)
        y_intra = torch.einsum("bnckh,bnkh,bnkhp->bnchp", att, dth, xh)

        decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)       # (B,nb,c,H)
        state = torch.einsum("bncm,bnch,bnchp->bnhmp", Bh,
                             dth * decay_to_end, xh)          # (B,nb,H,N,P)
        chunk_decay = torch.exp(cs[:, :, -1, :])              # (B,nb,H)
        h = torch.zeros((B, H, N, P), dtype=torch.float32, device=xi.device)
        h_prev = []
        for c in range(nb):                 # state entering chunk c
            h_prev.append(h)
            h = h * chunk_decay[:, c, :, None, None] + state[:, c]
        h_prev = torch.stack(h_prev, 1)                       # (B,nb,H,N,P)
        decay_in = torch.exp(cs)                              # (B,nb,c,H)
        y_inter = torch.einsum("bncm,bnch,bnhmp->bnchp", Ch, decay_in, h_prev)

        y = (y_intra + y_inter).reshape(B, S, H, P)
        y = y + xh.reshape(B, S, H, P) \
            * D_skip.to(torch.float32)[None, None, :, None]
        return y.reshape(B, S, Di).to(x.dtype)

    # on DTensors each rank runs the block on its own rows (replicated
    # over "model"), and DTensor's rules meet none of its ops
    y = on_shards(ssd, xi, Bc, Cc, dt, p["A_log"], p["D_skip"])
    # replicated over "model", and so its gradient, which out_proj's
    # backward would hand back sharded on the heads
    y = pin_layout(rms_norm(y * F.silu(z), p["norm_scale"]))
    return y @ p["out_proj"].to(x.dtype)
