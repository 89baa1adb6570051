"""The train step: the multi-pod LCMP train step in PyTorch.

Counterpart of ``repro/train/step.py`` (``TrainConfig``, ``loss_fn``,
``make_train_step``, ``make_serve_step``, ``init_train_state``). Compute flows as there:
parameters f32, activations ``cfg.act_dtype`` (bf16 by default),
gradients f32, AdamW f32, and the cross-pod gradient reduction through
the LCMP-scheduled collective layer (``dist.lcmp_collectives``), with an
int8 wire for ``pod_reduce="lcmp_int8"``.

Where the reference's ``shard_map(..., in_specs=P("pod"))`` hands each
pod its contiguous ``B/n`` rows of the batch, the step runs each pod's
forward and backward on them, writing the gradient into a float32
buffer in the reference's leaf order; then it reduces the pods'
gradients and applies one AdamW update, in place. The pod axis is either
a ``PodAxis`` (every pod on this device, in turn, into the rows of one
``(n, M)`` buffer; parameters and optimizer state held once, as every
pod of the reference holds the same copy) or a ``PodGroup`` (one pod on
each rank of a process group: each rank takes the global batch, runs its
own rows into a ``(1, M)`` buffer and reduces over the group, so every
rank ends with the one-device step's parameters, bit for bit).

``ShardedStep`` is the FSDP x TP step on a ``DeviceMesh`` (the
reference's ``jit`` step under ``NamedSharding``): parameters and AdamW
moments are DTensors placed by ``dist.mesh_rules``, the batch is
sharded on its rows, and DTensor's sharding propagation inserts the
collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch import device as devmod
from repro_torch.dist import lcmp_collectives as lc
from repro_torch.dist.lcmp_collectives import PodAxis, PodGroup, tree_flatten
from repro_torch.dist.mesh_rules import (check_mesh_device, is_dtensor,
                                         make_rules, map_with_path,
                                         on_shards, pin_layout, placements)
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
    pod_axis: Optional[Union[PodAxis, PodGroup]] = None


def _token_nll(logits, labels):
    """Each token's negative log-likelihood, 0 where ``labels`` < 0."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.where(labels >= 0, lse - gold, 0.0)


def _sharded_token_nll(logits, labels):
    """``_token_nll`` of DTensor logits whose vocab stays sharded over
    the mesh's ``model`` dim (where it divides): the log-sum-exp from the
    shards' maxima and sums, and the gold logit from the one shard that
    holds it, summed over ``model``. Each rank reads its rows only, and
    no rank holds the whole vocab (DTensor's own gather over a sharded
    dim fails, and its backward would build the whole logits' zeros on
    every rank)."""
    from torch.distributed.tensor import Partial, Shard
    logits = pin_layout(logits, 2)
    labels = pin_layout(labels)
    mesh = logits.device_mesh
    # the reductions over the vocab shards replicated over "model", so the
    # backward hands every rank the whole rows' gradient to scale its
    # shard by (DTensor would otherwise gather the shards instead)
    m = pin_layout(logits.detach().amax(-1, keepdim=True))
    lse = (m + pin_layout((logits - m).exp().sum(-1, keepdim=True)).log())
    lse = lse[..., 0]
    model = (mesh.mesh_dim_names.index("model")
             if "model" in mesh.mesh_dim_names else None)
    split = model is not None and logits.placements[model] == Shard(2)
    place = list(labels.placements)
    if split:
        place[model] = Partial()

    def gold(lg, lb):
        v = lg.shape[-1]
        idx = lb.clamp(min=0) - (mesh.get_local_rank(model) * v if split
                                 else 0)
        mine = (idx >= 0) & (idx < v)
        g = lg.gather(-1, idx.clamp(0, v - 1)[..., None])[..., 0]
        return torch.where(mine, g, 0.0)
    g = pin_layout(on_shards(gold, logits, labels, placements=place))
    return torch.where(labels >= 0, lse - g, 0.0)


def loss_fn(params, cfg: ArchConfig, tokens, labels, extra=None):
    """Mean next-token negative log-likelihood over labels >= 0."""
    logits = forward(params, cfg, tokens, extra=extra)
    nll = (_sharded_token_nll if is_dtensor(logits) else _token_nll)(
        logits, labels)
    mask = labels >= 0
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def _microbatches(batch: dict, mb: int) -> list:
    """``batch``'s rows (its tensors; a None ``extra`` is left out) in
    ``mb`` consecutive microbatches."""
    b = batch["tokens"].shape[0] // mb
    return [{k: v[j * b:(j + 1) * b] for k, v in batch.items()
             if v is not None} for j in range(mb)]


class TrainStep:
    """``step(params, opt, batch) -> (params, opt, metrics)``.

    ``metrics["loss"]`` is each pod's loss, shape ``(n,)`` (a scalar
    without a pod axis; over a ``PodGroup`` every rank gathers all the
    pods' losses), and ``metrics["grad_norm"]`` the norm of the reduced
    gradient before clipping. After a step, ``grads`` holds the flat
    gradient of each pod this process ran, ``(n, M)`` over a
    ``PodAxis`` and ``(1, M)`` over a ``PodGroup`` (the buffer is reused
    by the next step), and ``reduced`` the ``(M,)`` gradient the update
    applied; on CUDA, ``split_ms()`` gives the step's phases from CUDA
    events.
    """

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig):
        if tcfg.pod_reduce not in POD_REDUCES:
            raise ValueError(f"pod_reduce must be one of {POD_REDUCES}, "
                             f"got {tcfg.pod_reduce!r}")
        self.cfg, self.tcfg = cfg, tcfg
        ax = tcfg.pod_axis
        self.n_pods = ax.size if ax is not None else 1
        # the pods this process runs: all of them, or this rank's own
        self.local = [ax.rank] if isinstance(ax, PodGroup) \
            else list(range(self.n_pods))
        self.grads: Optional[torch.Tensor] = None
        self.reduced: Optional[torch.Tensor] = None
        self._events: list = []

    def _mark(self, dev: torch.device) -> None:
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append(ev)

    def _pod_grads(self, params, leaves, part: dict, out) -> torch.Tensor:
        """One pod's loss on its rows ``part`` (tokens, labels, and a vlm
        or encdec batch's ``extra``); its gradient, averaged over the
        microbatches, goes into ``out`` (M,) in leaf order."""
        mb = self.tcfg.microbatches
        lsum = None
        for j, m in enumerate(_microbatches(part, mb)):
            loss = loss_fn(params, self.cfg, m["tokens"], m["labels"],
                           extra=m.get("extra"))
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
        if isinstance(ax, PodGroup):
            flat = flat[0]
        if self.tcfg.pod_reduce == "psum":      # pmean of every leaf
            return lc.reduce_mean(flat, ax)
        return lc.pod_reduce_flat(flat, ax,
                                  compress=self.tcfg.pod_reduce == "lcmp_int8")

    def _losses(self, losses: list) -> torch.Tensor:
        """Each pod's loss, ``(n,)``; over a group, gathered from the
        ranks."""
        mine = torch.stack(losses)
        ax = self.tcfg.pod_axis
        if not isinstance(ax, PodGroup) or ax.size == 1:
            return mine
        out = mine.new_empty((ax.size,))
        torch.distributed.all_gather_into_tensor(out, mine, group=ax.group)
        return out

    def __call__(self, params, opt: AdamWState, batch):
        leaves, rebuild = tree_flatten(params)
        sizes = [leaf.numel() for leaf in leaves]
        dev = leaves[0].device
        n, mb = self.n_pods, self.tcfg.microbatches
        tokens = batch["tokens"]
        if tokens.shape[0] % (n * mb):
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{n} pods x {mb} microbatches")
        shape = (len(self.local), sum(sizes))
        if self.grads is None or self.grads.shape != shape \
                or self.grads.device != dev:
            self.grads = torch.empty(shape, dtype=torch.float32, device=dev)
        self.reduced = None
        self._events = []
        b = tokens.shape[0] // n
        self._mark(dev)
        losses = []
        for row, p in enumerate(self.local):
            rows = slice(p * b, (p + 1) * b)
            losses.append(self._pod_grads(
                params, leaves, {k: v[rows] for k, v in batch.items()
                                 if v is not None},
                self.grads[row]))
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
        loss = self._losses(losses) if self.tcfg.pod_axis is not None \
            else losses[0]
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
        n = len(self.local)
        out = {f"fwd_bwd_pod{p}": ev[i].elapsed_time(ev[i + 1])
               for i, p in enumerate(self.local)}
        out["pod_reduce"] = ev[n].elapsed_time(ev[n + 1])
        out["optimizer"] = ev[n + 1].elapsed_time(ev[n + 2])
        out["step"] = ev[0].elapsed_time(ev[-1])
        return out


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(params, opt, batch) -> (params, opt, metrics)``."""
    return TrainStep(cfg, tcfg)


class ShardedStep:
    """The FSDP x TP step on a ``DeviceMesh`` with named dims ``data`` and
    ``model`` (and ``pod``): ``step(params, opt, batch) -> (params, opt,
    metrics)`` with the state from ``place``.

    Every rank passes the same global batch; each microbatch's rows are
    placed by ``Rules.train_batch_specs`` (each rank keeps its own rows,
    with no communication). The forward and backward run on DTensors
    under ``implicit_replication`` (the forward's constant tensors, rope
    tables and masks, are plain tensors and count as replicated), and
    DTensor's sharding propagation inserts the collectives. The model
    pins some activations to plain layouts (``mesh_rules.pin_layout``)
    where DTensor's rules would fail, and ``loss_fn`` takes the
    cross-entropy over the vocab shards (``_sharded_token_nll``).
    Each microbatch's gradients are redistributed to their parameters'
    placements (they may come back ``Partial``, or sharded on another
    mesh dim) before they are summed, and AdamW updates every rank's
    shards in place (``train.optim``). Tensors handed to ``place`` and
    the batch must lie on the mesh's device type: the step raises rather
    than let DTensor move them.
    ``metrics["loss"]`` is the global batch's loss and
    ``metrics["grad_norm"]`` the global norm, both plain tensors."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig, mesh):
        if tcfg.pod_axis is not None:
            raise ValueError("the sharded step takes no pod axis: pods are "
                             "the mesh's 'pod' dim")
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.rules = make_rules(cfg, mesh)

    def _put(self, t: torch.Tensor, spec: tuple, what: str):
        from torch.distributed.tensor import distribute_tensor
        check_mesh_device(t, self.mesh, what)
        return distribute_tensor(t.detach(), self.mesh,
                                 placements(spec, self.mesh),
                                 src_data_rank=None)

    def specs(self, params) -> dict:
        """The spec trees of ``{"params", "opt"}``, as the checkpoint
        manifest records them."""
        ps = self.rules.param_specs(params)
        return {"params": ps, "opt": AdamWState(count=(), mu=ps, nu=ps)}

    def place(self, params, opt: AdamWState):
        """``(params, opt)`` of whole tensors (the same on every rank) as
        DTensors placed by ``Rules.param_specs``; each rank keeps only
        its shards. ``count`` stays a plain tensor."""
        def put(tree, grad: bool):
            return map_with_path(tree, lambda path, t: self._put(
                t, self.rules._leaf_spec(path, tuple(t.shape)),
                f"leaf {'/'.join(map(str, path))}").requires_grad_(grad))
        return put(params, True), AdamWState(
            count=opt.count, mu=put(opt.mu, False), nu=put(opt.nu, False))

    def __call__(self, params, opt: AdamWState, batch):
        from torch.distributed.tensor.experimental import implicit_replication
        leaves, rebuild = tree_flatten(params)
        mb = self.tcfg.microbatches
        tokens = batch["tokens"]
        if tokens.shape[0] % mb:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{mb} microbatches")
        specs = self.rules.train_batch_specs(tokens.shape[0] // mb,
                                             tokens.shape[1])
        acc, lsum = None, None
        for m in _microbatches(batch, mb):
            part = {k: self._put(v, specs[k], f"batch {k}")
                    for k, v in m.items()}
            with implicit_replication():
                loss = loss_fn(params, self.cfg, part["tokens"],
                               part["labels"], extra=part.get("extra"))
                grads = torch.autograd.grad(loss, leaves)
            # to the parameters' placements (a gradient may come back
            # Partial, or sharded on another mesh dim), as AdamW takes them
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for p, g in zip(leaves, grads)]
            acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
            loss = loss.detach().full_tensor()
            lsum = loss if lsum is None else lsum + loss
        if mb > 1:
            div = torch.full((), float(mb), device=lsum.device)
            acc = [a / div for a in acc]
            lsum = lsum / div
        params, opt, gnorm = adamw_update(self.tcfg.optim, params,
                                          rebuild(acc), opt)
        return params, opt, dict(loss=lsum, grad_norm=gnorm)


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
