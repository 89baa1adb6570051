"""The train step: the multi-pod LCMP train step in PyTorch.

Counterpart of ``repro/train/step.py`` (``TrainConfig``, ``loss_fn``,
``make_train_step``, ``make_serve_step``, ``init_train_state``). Compute flows as there:
parameters f32, activations ``cfg.act_dtype`` (bf16 by default),
gradients f32, AdamW f32, and the cross-pod gradient reduction through
the LCMP-scheduled collective layer (``dist.lcmp_collectives``), with an
int8 wire for ``pod_reduce="lcmp_int8"``.

Pods live on one device (``dist.lcmp_collectives.PodAxis``). Where the
reference's ``shard_map(..., in_specs=P("pod"))`` hands each pod its
slice of the batch, the step runs each pod's forward and backward in
turn on its contiguous ``B/n`` rows, writing the gradient into row ``p``
of one ``(n, M)`` float32 buffer in the reference's leaf order; then it
reduces the rows and applies one AdamW update. Parameters and optimizer
state are held once (every pod of the reference holds the same copy),
and are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import device as devmod
from repro_torch.dist import lcmp_collectives as lc
from repro_torch.dist.lcmp_collectives import PodAxis, tree_flatten
from repro_torch.models.arch import ArchConfig, forward, init_params
from repro_torch.serve.decode import decode_step
from repro_torch.train.optim import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update)

POD_REDUCES = ("psum", "lcmp", "lcmp_int8")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: AdamWConfig = AdamWConfig()
    microbatches: int = 1              # gradient accumulation
    pod_reduce: str = "psum"           # psum | lcmp | lcmp_int8
    pod_axis: Optional[PodAxis] = None  # pods held on this device


def loss_fn(params, cfg: ArchConfig, tokens, labels, extra=None):
    """Mean next-token negative log-likelihood over labels >= 0."""
    logits = forward(params, cfg, tokens, extra=extra)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels >= 0
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


class TrainStep:
    """``step(params, opt, batch) -> (params, opt, metrics)``.

    ``metrics["loss"]`` is each pod's loss, shape ``(n,)`` (a scalar
    without a pod axis), and ``metrics["grad_norm"]`` the norm of the
    reduced gradient before clipping. After a step, ``grads`` holds each
    pod's flat gradient ``(n, M)`` (the buffer is reused by the next
    step) and ``reduced`` the ``(M,)`` gradient the update applied; on
    CUDA, ``split_ms()`` gives the step's phases from CUDA events.
    """

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig):
        if tcfg.pod_reduce not in POD_REDUCES:
            raise ValueError(f"pod_reduce must be one of {POD_REDUCES}, "
                             f"got {tcfg.pod_reduce!r}")
        self.cfg, self.tcfg = cfg, tcfg
        self.n_pods = tcfg.pod_axis.size if tcfg.pod_axis is not None else 1
        self.grads: Optional[torch.Tensor] = None
        self.reduced: Optional[torch.Tensor] = None
        self._events: list = []

    def _mark(self, dev: torch.device) -> None:
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append(ev)

    def _pod_grads(self, params, leaves, tokens, labels, extra,
                   out) -> torch.Tensor:
        """One pod's loss; its gradient, averaged over the microbatches,
        goes into ``out`` (M,) in leaf order. ``extra`` (vlm patches,
        encdec frames) splits with the tokens, or is None."""
        mb = self.tcfg.microbatches
        b = tokens.shape[0] // mb
        tk = tokens.reshape(mb, b, -1)
        lb = labels.reshape(mb, b, -1)
        ex = extra.reshape(mb, b, *extra.shape[1:]) if extra is not None \
            else [None] * mb
        lsum = None
        for j in range(mb):
            loss = loss_fn(params, self.cfg, tk[j], lb[j], extra=ex[j])
            grads = torch.autograd.grad(loss, leaves)
            o = 0
            for leaf, g in zip(leaves, grads):
                dst = out[o:o + leaf.numel()]
                if j == 0:
                    dst.copy_(g.reshape(-1))
                else:
                    dst.add_(g.reshape(-1))
                o += leaf.numel()
            del grads
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
        if mb > 1:
            div = torch.full((), float(mb), device=out.device)
            out.div_(div)
            lsum = lsum / div
        return lsum

    def _reduce(self, flat: torch.Tensor) -> torch.Tensor:
        ax = self.tcfg.pod_axis
        if ax is None or ax.size == 1:
            return flat[0]
        if self.tcfg.pod_reduce == "psum":      # pmean of every leaf
            return lc._reduce_flat_f32(flat, ax.size)
        return lc.pod_reduce_flat(flat, ax,
                                  compress=self.tcfg.pod_reduce == "lcmp_int8")

    def __call__(self, params, opt: AdamWState, batch):
        leaves, rebuild = tree_flatten(params)
        sizes = [leaf.numel() for leaf in leaves]
        dev = leaves[0].device
        n, mb = self.n_pods, self.tcfg.microbatches
        tokens, labels = batch["tokens"], batch["labels"]
        extra = batch.get("extra")
        if tokens.shape[0] % (n * mb):
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{n} pods x {mb} microbatches")
        if self.grads is None or self.grads.shape != (n, sum(sizes)) \
                or self.grads.device != dev:
            self.grads = torch.empty((n, sum(sizes)), dtype=torch.float32,
                                     device=dev)
        self.reduced = None
        self._events = []
        b = tokens.shape[0] // n
        self._mark(dev)
        losses = []
        for p in range(n):
            rows = slice(p * b, (p + 1) * b)
            losses.append(self._pod_grads(
                params, leaves, tokens[rows], labels[rows],
                None if extra is None else extra[rows], self.grads[p]))
            self._mark(dev)
        g = self.reduced = self._reduce(self.grads)
        self._mark(dev)
        views, o = [], 0
        for leaf, s in zip(leaves, sizes):
            views.append(g[o:o + s].view(leaf.shape))
            o += s
        params, opt, gnorm = adamw_update(self.tcfg.optim, params,
                                          rebuild(views), opt)
        self._mark(dev)
        loss = torch.stack(losses) if self.tcfg.pod_axis is not None else losses[0]
        return params, opt, dict(loss=loss, grad_norm=gnorm)

    def split_ms(self) -> dict:
        """Device time of the last step's phases, from CUDA events
        (waits for the step to finish): each pod's forward and backward,
        the pod reduce, the optimizer, and the whole step. Empty off
        CUDA."""
        ev = self._events
        if not ev:
            return {}
        ev[-1].synchronize()
        n = self.n_pods
        out = {f"fwd_bwd_pod{p}": ev[p].elapsed_time(ev[p + 1]) for p in range(n)}
        out["pod_reduce"] = ev[n].elapsed_time(ev[n + 1])
        out["optimizer"] = ev[n + 1].elapsed_time(ev[n + 2])
        out["step"] = ev[0].elapsed_time(ev[-1])
        return out


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(params, opt, batch) -> (params, opt, metrics)``."""
    return TrainStep(cfg, tcfg)


def make_serve_step(cfg: ArchConfig):
    """Returns ``serve_step(params, cache, tokens, pos) -> (logits,
    cache)``, one ``decode_step`` (the cache is updated in place)."""

    def serve_step(params, cache, tokens, pos):
        return decode_step(params, cfg, cache, tokens, pos)

    return serve_step


def init_train_state(cfg: ArchConfig, seed: int = 0, *,
                     device=devmod.DEFAULT):
    params = init_params(cfg, seed, device=device)
    return params, adamw_init(params)
