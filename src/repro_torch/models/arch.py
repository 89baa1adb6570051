"""Architecture definitions: ``ArchConfig`` and the six families.

Counterpart of ``repro/models/arch.py``. ``ArchConfig`` is the
reference's, field for field. ``param_count`` (from the parameter
shapes), ``active_param_count``, ``init_params`` and ``forward`` cover
every family: ``dense`` (GQA, qk-norm, SwiGLU, untied head, and gemma2's
sliding-window local layers alternating with global ones, attention and
final logit softcaps and ``sqrt(d)`` embedding scale), ``moe`` (top-k
token-choice experts with capacity), ``ssm`` (Mamba-1 layers),
``hybrid`` (Mamba-2 layers with one shared attention block applied
before every ``shared_attn_every``-th layer), ``encdec`` (a non-causal
encoder over frame embeddings; decoder layers with causal
self-attention, cross-attention and an MLP, no rope) and ``vlm`` (a
dense decoder over patch embeddings prepended to the tokens).

Parameters are a nested dict of float32 tensors in the reference's
layout: per-layer leaves stacked on axis 0 (``layers.attn.wq`` is
``(L, D, H*hd)``, input dimension first, not ``nn.Linear``'s
``(out, in)``; ``layers.moe.w_gate`` is ``(L, E, D, F)``), so the flat
gradient, its 1024-element scale blocks and its buckets are the
reference's. Each decoder layer runs under ``torch.utils.checkpoint``,
as the reference's ``jax.checkpoint``; the encoder's layers do not, as
the reference's encoder scan is not rematerialized.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as devmod
from repro_torch.dist.mesh_rules import is_dtensor, lookup_rows, pin_layout
from repro_torch.models import layers as L

# scales, initialized to 0
_NORMS = ("ln", "q_norm", "k_norm", "final_ln", "norm_scale", "enc_final_ln")
_STACKS = ("layers", "enc_layers")                  # leaves stacked per layer


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None         # default d_model // n_heads
    # attention flavor
    rope_theta: float = 10_000.0
    window: Optional[int] = None           # sliding window size
    alt_local_global: bool = False         # gemma2: even layers local
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qk_norm: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    # ssm
    ssm_state: int = 0
    ssm_expand: int = 2
    mamba_version: int = 2
    # hybrid (zamba2): shared attention block every k layers
    shared_attn_every: int = 0
    # encdec
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # vlm
    n_patches: int = 0
    # numerics
    act_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def adt(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)

    def param_count(self) -> int:
        """Total N (for MODEL_FLOPS accounting), from the shapes."""
        return _count(param_shapes(self))

    def active_param_count(self) -> int:
        """Active N per token (MoE counts top_k of n_experts experts)."""
        total = self.param_count()
        if self.family != "moe" or self.n_experts == 0:
            return total
        expert = 3 * self.d_model * self.d_ff * self.n_layers
        dense_part = total - self.n_experts * expert
        return dense_part + self.top_k * expert


# ------------------------------------------------------------------ shapes
def _attn_shapes(cfg: ArchConfig) -> dict:
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = dict(ln=(D,), wq=(D, H * hd), wk=(D, Kv * hd), wv=(D, Kv * hd),
             wo=(H * hd, D))
    if cfg.qk_norm:
        p["q_norm"] = (hd,)
        p["k_norm"] = (hd,)
    return p


def _mlp_shapes(cfg: ArchConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return dict(ln=(D,), w_gate=(D, Fd), w_up=(D, Fd), w_down=(Fd, D))


def _moe_shapes(cfg: ArchConfig) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return dict(ln=(D,), router=(D, E), w_gate=(E, D, Fd),
                w_up=(E, D, Fd), w_down=(E, Fd, D))


def _mamba_shapes(cfg: ArchConfig) -> dict:
    D, N = cfg.d_model, cfg.ssm_state
    Di = cfg.ssm_expand * D
    if cfg.mamba_version == 1:
        dt_rank = max(D // 16, 1)
        return dict(ln=(D,), in_proj=(D, 2 * Di), conv_w=(4, Di),
                    x_proj=(Di, dt_rank + 2 * N), dt_proj=(dt_rank, Di),
                    A_log=(Di, N), D_skip=(Di,), out_proj=(Di, D))
    H = Di // 64                                  # head dim P = 64
    return dict(ln=(D,), in_proj=(D, 2 * Di + 2 * N + H),
                conv_w=(4, Di + 2 * N), A_log=(H,), D_skip=(H,),
                norm_scale=(Di,), out_proj=(Di, D))


def _stack(tree: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict) else (n, *v)
            for k, v in tree.items()}


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _layer_shapes(cfg: ArchConfig) -> dict:
    """One decoder layer of the config's family."""
    if cfg.family in ("dense", "vlm"):
        return dict(attn=_attn_shapes(cfg), mlp=_mlp_shapes(cfg))
    if cfg.family == "moe":
        return dict(attn=_attn_shapes(cfg), moe=_moe_shapes(cfg))
    if cfg.family in ("ssm", "hybrid"):
        return dict(mamba=_mamba_shapes(cfg))
    if cfg.family == "encdec":
        return dict(attn=_attn_shapes(cfg), mlp=_mlp_shapes(cfg),
                    xattn=_attn_shapes(cfg))
    raise ValueError(cfg.family)


def param_shapes(cfg: ArchConfig) -> dict:
    """The reference's parameter tree of the config, as a nested dict of
    shapes."""
    p = dict(embed=(cfg.vocab, cfg.d_model),
             lm_head=(cfg.vocab, cfg.d_model), final_ln=(cfg.d_model,),
             layers=_stack(_layer_shapes(cfg), cfg.n_layers))
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        p["shared_attn"] = _attn_shapes(cfg)
    if cfg.family == "encdec":
        enc = _layer_shapes(dataclasses.replace(cfg, family="dense"))
        p["enc_layers"] = _stack(enc, cfg.n_enc_layers)
        p["enc_final_ln"] = (cfg.d_model,)
    return p


def _count(tree: dict) -> int:
    return sum(_count(v) if isinstance(v, dict) else math.prod(v)
               for v in tree.values())


# ------------------------------------------------------------------- init
def init_params(cfg: ArchConfig, seed: int = 0, *, device=devmod.DEFAULT):
    """Random float32 parameters from ``seed``, the reference's scheme
    (norm scales 0; ``embed`` unit normal; every other matrix normal over
    the square root of its (per-layer) input dimension; the mamba layers'
    ``A_log`` is ``log(1..N)`` on each Mamba-1 row and 0 for Mamba-2, and
    ``D_skip`` is 1). The numbers differ from the reference's PRNG;
    tests carry the reference's weights over with ``models.carry``."""
    dev = devmod.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(name: str, shape, stacked: bool) -> torch.Tensor:
        if name == "A_log" and cfg.mamba_version == 1:      # (.., Di, N)
            t = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=dev).log().expand(shape).contiguous()
        elif name in _NORMS or name == "A_log":
            t = torch.zeros(shape, dtype=torch.float32, device=dev)
        elif name == "D_skip":
            t = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            # the reference's per-layer shape[0]: D for a matrix, E for
            # an expert stack
            fan_in = shape[1] if stacked else shape[0]
            scale = 1.0 if name == "embed" else 1.0 / math.sqrt(fan_in)
            t = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev).mul_(scale)
        return t.requires_grad_()

    def walk(tree: dict, stacked: bool) -> dict:
        return {k: walk(v, stacked or k in _STACKS) if isinstance(v, dict)
                else make(k, v, stacked) for k, v in sorted(tree.items())}
    return walk(param_shapes(cfg), False)


# ----------------------------------------------------------------- forward
def _attn_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                layer_local: bool = False, kv_x=None, causal: bool = True,
                positions=None, use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (train/prefill). kv_x: cross-attn source."""
    B, S, D = x.shape
    h = pin_layout(L.rms_norm(x, p["ln"]))
    src = h if kv_x is None else kv_x
    q = pin_layout(h @ p["wq"].to(h.dtype))
    k = pin_layout(src @ p["wk"].to(h.dtype))
    v = pin_layout(src @ p["wv"].to(h.dtype))
    Sk = src.shape[1]
    window = cfg.window if (cfg.window and layer_local) else None
    block = bool(window and S > 2 * window and S % window == 0
                 and kv_x is None)
    # the queries' rows on a mesh's "model" dim (the block path shards
    # each block's rows instead)
    q = pin_layout(q.reshape(B, S, cfg.n_heads, cfg.hd), None if block else 1)
    # (and their gradients: the backward would shard the keys' rows)
    k = pin_layout(k.reshape(B, Sk, cfg.n_kv, cfg.hd))
    v = pin_layout(v.reshape(B, Sk, cfg.n_kv, cfg.hd))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    if use_rope and kv_x is None:
        pos = (positions if positions is not None
               else torch.arange(S, device=x.device)[None])
        q = L.rope(q, pos, cfg.rope_theta)
        k = L.rope(k, pos, cfg.rope_theta)
    if block:
        o = L.local_block_attention(q, k, v, window=window,
                                    softcap=cfg.attn_softcap)
    else:
        o = L.gqa_attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_softcap)
    o = pin_layout(o.reshape(B, S, cfg.n_heads * cfg.hd), 2)
    return x + pin_layout(o @ p["wo"].to(h.dtype))


def _mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = pin_layout(L.rms_norm(x, p["ln"]))
    return x + pin_layout(L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"]))


def _moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = pin_layout(L.rms_norm(x, p["ln"]))
    return x + L.moe_block(h, p["router"], p["w_gate"], p["w_up"],
                           p["w_down"], top_k=cfg.top_k)


def _mamba_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = pin_layout(L.rms_norm(x, p["ln"]))
    fn = L.mamba1_scan if cfg.mamba_version == 1 else L.mamba2_ssd
    return x + pin_layout(fn(h, p))


def _decoder_layer(cfg: ArchConfig, params: dict, x: torch.Tensor,
                   local: Optional[bool] = None, enc=None):
    """One decoder layer. ``local`` picks the sliding-window attention
    of a dense layer (default: whenever the config has a window); a moe
    layer is local whenever the config has a window. ``enc`` is the
    encoder's output an encdec layer cross-attends to."""
    if cfg.family in ("dense", "vlm"):
        local = bool(cfg.window) if local is None else local
        x = _attn_apply(params["attn"], x, cfg, layer_local=local)
        return _mlp_apply(params["mlp"], x)
    if cfg.family == "moe":
        x = _attn_apply(params["attn"], x, cfg, layer_local=bool(cfg.window))
        return _moe_apply(params["moe"], x, cfg)
    if cfg.family in ("ssm", "hybrid"):
        return _mamba_apply(params["mamba"], x, cfg)
    if cfg.family == "encdec":
        x = _attn_apply(params["attn"], x, cfg, use_rope=False)
        x = _attn_apply(params["xattn"], x, cfg, kv_x=enc, causal=False,
                        use_rope=False)
        return _mlp_apply(params["mlp"], x)
    raise ValueError(cfg.family)


def layer_is_local(cfg: ArchConfig, i: int) -> Optional[bool]:
    """gemma2's pair order: with ``alt_local_global`` even layers are
    local and odd ones global; otherwise the layer's default."""
    return (i % 2 == 0) if cfg.alt_local_global else None


def embed(params: dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the activation dtype; gemma's dense configs
    scale them by sqrt(d_model) cast to that dtype first (59.75 in
    bfloat16 for d_model 3584)."""
    table = params["embed"]
    x = pin_layout(lookup_rows(table, tokens)) if is_dtensor(table) \
        else table[tokens]
    x = x.to(cfg.adt)
    if cfg.family == "dense" and cfg.name.startswith("gemma"):
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=cfg.adt,
                           device=x.device)
    return x


def head(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, untied LM head and ``final_softcap`` -> f32 logits."""
    x = pin_layout(L.rms_norm(x, params["final_ln"]))
    logits = (x @ params["lm_head"].to(x.dtype).t()).to(torch.float32)
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _unstack(tree: dict, n: int) -> list:
    """Stacked layer leaves -> one dict per layer (views; the gradient
    of ``unbind`` stacks the layers' gradients back in one pass)."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """The encdec family's encoder: frame embeddings (B, enc_seq, D) in
    the activation dtype through non-causal, rope-free dense layers, then
    ``enc_final_ln``."""
    e = frames.to(cfg.adt)
    for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
        e = _attn_apply(lp["attn"], e, cfg, causal=False, use_rope=False)
        e = _mlp_apply(lp["mlp"], e)
    return L.rms_norm(e, params["enc_final_ln"])


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            extra=None) -> torch.Tensor:
    """Training/prefill forward -> logits (B, S, V) in float32.

    ``extra``: vlm patch embeddings (B, n_patches, D), prepended to the
    tokens and stripped before the head; encdec frame embeddings
    (B, enc_seq, D), the encoder's input. Other families ignore it."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    if cfg.alt_local_global and cfg.n_layers % 2:
        raise ValueError(f"{cfg.name}: local/global pairs need an even "
                         f"n_layers, got {cfg.n_layers}")
    if cfg.family in ("vlm", "encdec") and extra is None:
        raise ValueError(f"the {cfg.family} family needs extra inputs "
                         "(patch or frame embeddings)")
    x = embed(params, cfg, tokens)
    if cfg.family == "vlm":
        x = torch.cat([extra.to(cfg.adt), x], dim=1)
    enc = encode(params, cfg, extra) if cfg.family == "encdec" else None
    shared = params.get("shared_attn")
    every = cfg.shared_attn_every

    def layer(h: torch.Tensor, lp: dict, i: int, local: Optional[bool]):
        if shared is not None and every and i % every == 0:
            h = _attn_apply(shared, h, cfg)
        return _decoder_layer(cfg, lp, h, local, enc)

    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        local = layer_is_local(cfg, i)
        if torch.is_grad_enabled():
            x = checkpoint(layer, x, lp, i, local, use_reentrant=False)
        else:
            x = layer(x, lp, i, local)
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches:, :]
    return head(params, cfg, x)
