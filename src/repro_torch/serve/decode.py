"""Single-token decode with KV caches (serve_step).

Counterpart of ``repro/serve/decode.py`` for the attention decoders
(the ``dense`` and ``moe`` families). The cache is the reference's
layout, leaves stacked over layers: ``attn.k``/``attn.v`` of shape
``(L, B, Smax, Kv, hd)`` in the activation dtype. Layer ``i`` reads and
writes row ``i``; with gemma2's local/global pairs that is the
reference's ``k[0::2]`` (local, even layers) and ``k[1::2]`` (global,
odd layers) stacked back in layer order.

``decode_step`` writes each layer's new key and value into the cache
IN PLACE at ``pos`` (``index_copy_``), where the reference returns a new
cache; ``pos`` may be a 0-d tensor on the cache's device, so a step reads
nothing back to the host. The mamba caches (``ssm``, ``hybrid``), the
encoder-decoder's cross cache (``prefill_cross_cache``) and the vlm's
patch prefix are not ported yet (ROADMAP.md, queue A item 11).
"""
from __future__ import annotations

import math

import torch

from repro_torch import device as devmod
from repro_torch.models import arch as A
from repro_torch.models import layers as L
from repro_torch.models.arch import ArchConfig


def _require_attention(cfg: ArchConfig) -> None:
    if cfg.family not in A.PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family's decode cache ({cfg.name}) is not "
            "ported yet (ROADMAP.md, queue A item 11); the port decodes the "
            "dense and moe families")


# ----------------------------------------------------------------- caches
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None, *,
               device=devmod.DEFAULT) -> dict:
    """Zeroed ``{"attn": {"k", "v"}}``, each ``(L, B, max_seq, Kv, hd)``
    in ``dtype`` (default: the activation dtype) on ``device``."""
    _require_attention(cfg)
    dev = devmod.resolve(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.hd)
    dtype = dtype or cfg.adt
    return dict(attn=dict(k=torch.zeros(shape, dtype=dtype, device=dev),
                          v=torch.zeros(shape, dtype=dtype, device=dev)))


def prefill_cross_cache(params, cfg: ArchConfig, enc_out):
    raise NotImplementedError(
        "the encdec family's cross-attention cache is not ported yet "
        "(ROADMAP.md, queue A item 11)")


# ------------------------------------------------------------ attn decode
def _attn_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: torch.Tensor, *,
                 local: bool = False) -> torch.Tensor:
    """x: (B,1,D); kc/vc: (B,Smax,Kv,hd), written in place at ``pos``.
    Returns the residual stream after attention."""
    B = x.shape[0]
    h = L.rms_norm(x, p["ln"])
    q = (h @ p["wq"].to(h.dtype)).reshape(B, 1, cfg.n_heads, cfg.hd)
    k = (h @ p["wk"].to(h.dtype)).reshape(B, 1, cfg.n_kv, cfg.hd)
    v = (h @ p["wv"].to(h.dtype)).reshape(B, 1, cfg.n_kv, cfg.hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    pp = pos.expand(B, 1)
    q = L.rope(q, pp, cfg.rope_theta)
    k = L.rope(k, pp, cfg.rope_theta)
    at = pos.reshape(1)
    kc.index_copy_(1, at, k.to(kc.dtype))
    vc.index_copy_(1, at, v.to(vc.dtype))

    Smax = kc.shape[1]
    g = cfg.n_heads // cfg.n_kv
    qg = q.reshape(B, 1, cfg.n_kv, g, cfg.hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc).to(torch.float32)
    logits = logits / math.sqrt(cfg.hd)
    if cfg.attn_softcap:
        logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
    kpos = torch.arange(Smax, device=x.device)
    mask = kpos <= pos
    if local and cfg.window:
        mask = mask & (kpos > pos - cfg.window)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", probs, vc)
    o = o.reshape(B, 1, cfg.n_heads * cfg.hd)
    return x + o @ p["wo"].to(h.dtype)


# -------------------------------------------------------------- serve step
@torch.no_grad()
def decode_step(params: dict, cfg: ArchConfig, cache: dict,
                tokens: torch.Tensor, pos):
    """tokens (B,1), pos: an int or a 0-d integer tensor -> (logits
    (B,1,V) float32, cache). The cache is updated in place and returned."""
    _require_attention(cfg)
    kc, vc = cache["attn"]["k"], cache["attn"]["v"]
    pos = torch.as_tensor(pos, device=kc.device)
    x = A.embed(params, cfg, tokens)
    for i, lp in enumerate(A._unstack(params["layers"], cfg.n_layers)):
        local = A.layer_is_local(cfg, i)
        local = bool(cfg.window) if local is None else local
        x = _attn_decode(lp["attn"], cfg, x, kc[i], vc[i], pos, local=local)
        if cfg.family == "moe":
            x = A._moe_apply(lp["moe"], x, cfg)
        else:
            x = A._mlp_apply(lp["mlp"], x)
    return A.head(params, cfg, x), cache
