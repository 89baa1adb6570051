"""AdamW in float32 over a parameter tree.

Counterpart of ``repro/train/optim.py``, op for op: warm-up plus cosine
schedule, clipping by the global norm, decoupled weight decay. The
reference is functional; ``adamw_update`` here updates the parameters
and both moments IN PLACE (a full-width model would otherwise hold them
twice) and returns the same tensors with a new ``count``. Divisions by
a schedule value are tensor divisions, as the reference writes them.

DTensor leaves (the sharded step, ``train.step.ShardedStep``): each
gradient comes placed as its parameter (the step redistributes it), the
norm is the global norm over every rank's shards, and the update runs
on each rank's local shards of the parameter and both moments, in
place; the moments are DTensors placed as their parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.dist.lcmp_collectives import tree_flatten
from repro_torch.dist.mesh_rules import is_dtensor


class AdamWState(NamedTuple):
    count: torch.Tensor      # () int32
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def adamw_init(params) -> AdamWState:
    leaves, rebuild = tree_flatten(params)
    zeros = lambda: rebuild([torch.zeros_like(p, requires_grad=False)
                             for p in leaves])
    return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                        device=leaves[0].device),
                      mu=zeros(), nu=zeros())


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a float32 scalar tensor)."""
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed leaf by leaf in
    tree order (DTensor leaves: each rank's shards, then summed over the
    mesh), as a plain tensor."""
    total = sum(g.to(torch.float32).square().sum()
                for g in tree_flatten(grads)[0])
    if is_dtensor(total):
        total = total.full_tensor()
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm) -> torch.Tensor:
    return torch.clamp(_f32(max_norm, gn) / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    leaves, rebuild = tree_flatten(grads)
    return rebuild([g * scale for g in leaves]), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step. Updates ``params``, ``state.mu`` and ``state.nu``
    in place; returns ``(params, AdamWState(count + 1, mu, nu), gnorm)``.
    The clipped gradient is formed leaf by leaf, so no clipped copy of
    the whole gradient is held. A DTensor gradient must be placed as its
    parameter."""
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, cfg.grad_clip)
    count = state.count + 1
    cf = count.to(torch.float32)
    lr = _schedule(cfg, cf)
    b1c = 1 - torch.pow(_f32(cfg.b1, cf), cf)
    b2c = 1 - torch.pow(_f32(cfg.b2, cf), cf)

    flat_p, _ = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state.mu)
    flat_v, _ = tree_flatten(state.nu)
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if is_dtensor(p):           # this rank's shards, updated in place
            p, g, m, v = (x.to_local() for x in (p, g, m, v))
        g = g.to(torch.float32) * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        del g
        step = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        step.add_(cfg.weight_decay * p)
        p.sub_(lr * step)
    return params, AdamWState(count=count, mu=state.mu, nu=state.nu), gnorm
