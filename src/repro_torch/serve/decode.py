"""Single-token decode with per-family caches (serve_step).

Counterpart of ``repro/serve/decode.py``. The cache is the reference's
layout, leaves stacked over layers:
- attention: ``attn.k``/``attn.v`` (L, B, Smax, Kv, hd) in the
  activation dtype (dense, moe, vlm; encdec's decoder self-attention);
- Mamba-1 (ssm): ``conv`` (L, B, 3, Di) in the activation dtype and
  ``ssm`` (L, B, Di, N) in float32;
- Mamba-2 (hybrid): ``conv`` (L, B, 3, Di+2N), ``ssm`` (L, B, H, N, 64),
  and ``shared.k``/``shared.v`` with one row per application site of the
  shared attention block (``ceil(L / shared_attn_every)``): layer ``i``'s
  block reads and writes site ``i // shared_attn_every``;
- encdec: ``cross.k``/``cross.v`` (L, B, enc_seq, Kv, hd), the encoder's
  keys and values, which ``prefill_cross_cache`` computes once.
Layer ``i`` reads and writes row ``i``; with gemma2's local/global pairs
that is the reference's ``k[0::2]`` (local, even layers) and ``k[1::2]``
(global, odd layers) stacked back in layer order.

``decode_step`` updates the cache IN PLACE (``index_copy_`` at ``pos``
for keys and values, ``copy_`` for the mamba states), where the
reference returns a new cache; ``pos`` may be a 0-d tensor on the
cache's device, so a step reads nothing back to the host. As in the
reference, the vlm family decodes as a dense decoder, without the patch
prefix its ``forward`` prepends.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import device as devmod
from repro_torch.dist.mesh_rules import on_shards, pin_layout
from repro_torch.models import arch as A
from repro_torch.models import layers as L
from repro_torch.models.arch import ArchConfig


# ----------------------------------------------------------------- caches
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None, *,
               device=devmod.DEFAULT) -> dict:
    """The family's zeroed cache (module docstring) on ``device`` (or
    ``"meta"``, shapes without storage); the attention and conv leaves
    in ``dtype`` (default: the activation dtype), the ssm states in
    float32."""
    dev = devmod.resolve_or_meta(device)
    dtype = dtype or cfg.adt
    Lx, B = cfg.n_layers, batch
    Di = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def kv(n, s):
        return dict(k=zeros(n, B, s, cfg.n_kv, cfg.hd),
                    v=zeros(n, B, s, cfg.n_kv, cfg.hd))

    if cfg.family in ("dense", "moe", "vlm"):
        return dict(attn=kv(Lx, max_seq))
    if cfg.family == "ssm":
        return dict(conv=zeros(Lx, B, 3, Di),
                    ssm=zeros(Lx, B, Di, N, dt=torch.float32))
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        sites = -(-cfg.n_layers // every) if every else 0
        return dict(conv=zeros(Lx, B, 3, Di + 2 * N),
                    ssm=zeros(Lx, B, Di // 64, N, 64, dt=torch.float32),
                    shared=kv(max(sites, 1), max_seq))
    if cfg.family == "encdec":
        return dict(attn=kv(Lx, max_seq), cross=kv(Lx, cfg.enc_seq))
    raise ValueError(cfg.family)


@torch.no_grad()
def prefill_cross_cache(params: dict, cfg: ArchConfig,
                        enc_out: torch.Tensor) -> dict:
    """Encoder-side keys and values of every decoder layer's
    cross-attention: ``{"k", "v"}``, each (L, B, enc_seq, Kv, hd) in
    ``enc_out``'s dtype. ``enc_out`` is the encoder's output
    (``models.arch.encode``)."""
    B, S, _ = enc_out.shape
    xattn = params["layers"]["xattn"]

    def proj(w):
        return torch.stack([(enc_out @ w[i].to(enc_out.dtype))
                            .reshape(B, S, cfg.n_kv, cfg.hd)
                            for i in range(cfg.n_layers)])
    return dict(k=proj(xattn["wk"]), v=proj(xattn["wv"]))


# ------------------------------------------------------------ attn decode
def _attn_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: torch.Tensor, *, local: bool = False,
                 cross: bool = False, use_rope: bool = True) -> torch.Tensor:
    """x: (B,1,D); kc/vc: (B,Smax,Kv,hd), written in place at ``pos``
    (a cross-attention cache is read whole, unmasked, and not written).
    Returns the residual stream after attention."""
    B = x.shape[0]
    h = pin_layout(L.rms_norm(x, p["ln"]))
    q = pin_layout(h @ p["wq"].to(h.dtype)).reshape(B, 1, cfg.n_heads, cfg.hd)
    if not cross:
        k = pin_layout(h @ p["wk"].to(h.dtype)).reshape(B, 1, cfg.n_kv, cfg.hd)
        v = pin_layout(h @ p["wv"].to(h.dtype)).reshape(B, 1, cfg.n_kv, cfg.hd)
        if cfg.qk_norm:
            q = L.rms_norm(q, p["q_norm"])
            k = L.rms_norm(k, p["k_norm"])
        if use_rope:
            pp = pos.expand(B, 1)
            q = L.rope(q, pp, cfg.rope_theta)
            k = L.rope(k, pp, cfg.rope_theta)
        at = pos.reshape(1)

        def write(c, new):
            c.index_copy_(1, at, new)
            return c
        # each rank writes its own shards (the new rows laid out as the
        # cache: DTensor has no rule for index_copy_)
        on_shards(write, kc, pin_layout(k.to(kc.dtype), 2))
        on_shards(write, vc, pin_layout(v.to(vc.dtype), 2))
    elif cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])

    Smax = kc.shape[1]
    g = cfg.n_heads // cfg.n_kv
    mask = None
    if not cross:
        kpos = torch.arange(Smax, device=x.device)
        mask = kpos <= pos
        if local and cfg.window:
            mask = mask & (kpos > pos - cfg.window)

    def attend(q4, kc, vc):
        """(B,Kv,g,hd) queries against (B,S,Kv,hd) keys and values ->
        (B,Kv,g,hd): one matmul over (B,Kv) each way."""
        logits = torch.matmul(q4, kc.movedim(1, 2).transpose(-1, -2))
        logits = logits.to(torch.float32) / math.sqrt(cfg.hd)
        if cfg.attn_softcap:
            logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
        if mask is not None:
            logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return torch.matmul(probs, vc.movedim(1, 2))

    # the kv heads on the cache's "model" placement; each rank attends
    # with its own shards (DTensor has no rule for a matmul over a batch
    # sharded on two mesh dims)
    q4 = pin_layout(q.reshape(B, cfg.n_kv, g, cfg.hd), 1)
    o = on_shards(attend, q4, pin_layout(kc, 2), pin_layout(vc, 2))
    o = pin_layout(o.reshape(B, 1, cfg.n_heads * cfg.hd), 2)
    return x + pin_layout(o @ p["wo"].to(h.dtype))


# ----------------------------------------------------------- mamba decode
def _conv_step(conv: torch.Tensor, new: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """One step of the kernel-4 causal conv: ``conv`` (B,3,C) holds the
    last three inputs and takes ``new`` (B,C) in place -> silu(conv)."""
    hist = torch.cat([conv, new[:, None, :]], 1)              # (B,4,C)
    conv.copy_(hist[:, 1:])
    return F.silu(torch.einsum("bki,ki->bi", hist, w))


def _mamba1_decode(p: dict, x: torch.Tensor, conv: torch.Tensor,
                   ssm: torch.Tensor) -> torch.Tensor:
    """One Mamba-1 step. As the reference's decode (and unlike its
    forward, which casts first), ``dt * xi`` multiplies in the activation
    dtype and the product is cast to float32. On DTensors the channels
    lie as the cache's conv and ssm states do (``Rules.cache_specs``),
    and the states update on each rank's own shards."""
    h = pin_layout(L.rms_norm(x, p["ln"]))[:, 0]
    xi, z = pin_layout(h @ p["in_proj"].to(h.dtype)).chunk(2, dim=-1)
    xi, z = pin_layout(xi, 1), pin_layout(z, 1)
    w = pin_layout(p["conv_w"].to(h.dtype), 1, rows=False)
    xi = on_shards(_conv_step, conv, xi, w, like=xi)
    dt_rank = p["dt_proj"].shape[0]
    N = p["A_log"].shape[1]
    dt, Bc, Cc = pin_layout(xi @ p["x_proj"].to(h.dtype)).split(
        [dt_rank, N, N], -1)
    dt = L.softplus(pin_layout(dt @ p["dt_proj"].to(h.dtype), 1))
    A = pin_layout(-torch.exp(p["A_log"].to(torch.float32)), 0, rows=False)
    D = pin_layout(p["D_skip"].to(h.dtype), 0, rows=False)

    def update(ssm, dt, xi, Bc, Cc, A, D):
        dA = torch.exp(dt.to(torch.float32)[..., None] * A)
        dBx = (dt * xi).to(torch.float32)[..., None] \
            * Bc.to(torch.float32)[:, None, :]
        ssm.copy_(ssm * dA + dBx)
        y = torch.einsum("bin,bn->bi", ssm, Cc.to(torch.float32))
        return y.to(xi.dtype) + xi * D
    y = on_shards(update, ssm, dt, xi, Bc, Cc, A, D, like=xi)
    y = y * F.silu(z)
    return x + pin_layout(y @ p["out_proj"].to(h.dtype))[:, None]


def _mamba2_decode(p: dict, x: torch.Tensor, conv: torch.Tensor,
                   ssm: torch.Tensor) -> torch.Tensor:
    """One Mamba-2 step; ``dt`` through softplus in float32. On DTensors
    as ``_mamba1_decode`` (the conv state's channels, the ssm state's
    heads)."""
    B = x.shape[0]
    h = pin_layout(L.rms_norm(x, p["ln"]))[:, 0]
    Di = p["norm_scale"].shape[0]
    H = p["A_log"].shape[0]
    P = Di // H
    N = (p["in_proj"].shape[1] - 2 * Di - H) // 2
    z, xbc, dt = pin_layout(h @ p["in_proj"].to(h.dtype)).split(
        [Di, Di + 2 * N, H], -1)
    xbc = pin_layout(xbc, 1)
    w = pin_layout(p["conv_w"].to(h.dtype), 1, rows=False)
    xbc = pin_layout(on_shards(_conv_step, conv, xbc, w,
                               like=xbc))
    xi, Bc, Cc = xbc.split([Di, N, N], -1)
    dt = pin_layout(L.softplus(dt.to(torch.float32)), 1)      # (B,H)
    A = pin_layout(-torch.exp(p["A_log"].to(torch.float32)), 0, rows=False)
    D = pin_layout(p["D_skip"].to(torch.float32), 0, rows=False)
    xh = pin_layout(xi.reshape(B, H, P).to(torch.float32), 1)

    def update(ssm, dt, xh, Bc, Cc, A, D):
        dA = torch.exp(dt * A)                                # (B,H)
        dBx = dt[..., None, None] * Bc.to(torch.float32)[:, None, :, None] \
            * xh[:, :, None, :]                               # (B,H,N,P)
        ssm.copy_(ssm * dA[..., None, None] + dBx)
        y = torch.einsum("bhnp,bn->bhp", ssm, Cc.to(torch.float32))
        return y + xh * D[None, :, None]
    y = on_shards(update, ssm, dt, xh, Bc, Cc, A, D, like=xh)
    y = pin_layout(y.reshape(B, Di).to(h.dtype))
    y = L.rms_norm(y * F.silu(z), pin_layout(p["norm_scale"], rows=False))
    return x + pin_layout(y @ p["out_proj"].to(h.dtype))[:, None]


# -------------------------------------------------------------- serve step
@torch.no_grad()
def decode_step(params: dict, cfg: ArchConfig, cache: dict,
                tokens: torch.Tensor, pos):
    """tokens (B,1), pos: an int or a 0-d integer tensor -> (logits
    (B,1,V) float32, cache). The cache is updated in place and returned."""
    fam = cfg.family
    if fam not in A.FAMILIES:
        raise ValueError(fam)
    # an int position is filled on the card, not copied from the host
    pos = (pos.to(tokens.device, torch.long) if isinstance(pos, torch.Tensor)
           else torch.full((), pos, dtype=torch.long, device=tokens.device))
    x = A.embed(params, cfg, tokens)
    layers = A._unstack(params["layers"], cfg.n_layers)
    if fam in ("dense", "moe", "vlm"):
        kc, vc = cache["attn"]["k"], cache["attn"]["v"]
        for i, lp in enumerate(layers):
            local = A.layer_is_local(cfg, i)
            local = bool(cfg.window) if local is None else local
            x = _attn_decode(lp["attn"], cfg, x, kc[i], vc[i], pos, local=local)
            if fam == "moe":
                x = A._moe_apply(lp["moe"], x, cfg)
            else:
                x = A._mlp_apply(lp["mlp"], x)
    elif fam == "ssm":
        for i, lp in enumerate(layers):
            x = _mamba1_decode(lp["mamba"], x, cache["conv"][i],
                               cache["ssm"][i])
    elif fam == "hybrid":
        every = cfg.shared_attn_every
        sk, sv = cache["shared"]["k"], cache["shared"]["v"]
        for i, lp in enumerate(layers):
            if every and i % every == 0:
                site = i // every
                x = _attn_decode(params["shared_attn"], cfg, x, sk[site],
                                 sv[site], pos)
            x = _mamba2_decode(lp["mamba"], x, cache["conv"][i],
                               cache["ssm"][i])
    else:                                                     # encdec
        kc, vc = cache["attn"]["k"], cache["attn"]["v"]
        xk, xv = cache["cross"]["k"], cache["cross"]["v"]
        for i, lp in enumerate(layers):
            x = _attn_decode(lp["attn"], cfg, x, kc[i], vc[i], pos,
                             use_rope=False)
            x = _attn_decode(lp["xattn"], cfg, x, xk[i], xv[i], pos,
                             cross=True, use_rope=False)
            x = A._mlp_apply(lp["mlp"], x)
    return A.head(params, cfg, x), cache
