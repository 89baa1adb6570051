"""FSDP x TP sharding rules over the named mesh axes (counterpart of
``repro/dist/mesh_rules.py``), as host arithmetic.

``Rules`` maps every tree the training and serving stack holds
(parameters, optimizer state, train batches, decode caches) to specs:

- ``model`` (tensor parallel): the output-feature dim of column-parallel
  projections (wq/wk/wv, w_gate/w_up, in_proj, dt_proj), the
  input-feature dim of row-parallel projections (wo, out_proj, w_down),
  and the vocab dim of embed/lm_head;
- ``data`` (FSDP): one remaining weight dim per leaf (the largest that
  it divides) plus the batch dim of inputs and caches;
- ``pod`` (data parallel across pods): batch only; parameters stay
  replicated across pods and gradients cross the long haul through
  ``dist.lcmp_collectives``.

A spec is a tuple with one entry per dimension, where the reference
builds a ``PartitionSpec``: the mesh axis (or tuple of axes) that shards
the dimension, or None. An axis is only given to a dim it divides, so
every configuration shards on any mesh; leaves stacked over the layer
axis (``layers``/``enc_layers``) never shard dim 0. ``placements`` turns
a spec into DTensor placements on a ``DeviceMesh`` with named dims, and
``spec_string`` into the reference's checkpoint manifest string.

For the model on DTensors, ``pin_layout`` redistributes an activation
to a plain layout (its gradient back in the backward), ``on_shards``
runs a function on each rank's own shards, and ``lookup_rows`` is an
embedding lookup that keeps the vocab sharded.

The reference's ``layers.MOE_CAPACITY_AXIS`` (a knob that shards the moe
dispatch's capacity dim, None by default) is not ported: the moe
dispatch runs on a mesh without it.
"""
from __future__ import annotations

import sys
from typing import Any, Callable, Dict, Optional

import torch

# leaf name -> which dim carries the tensor-parallel "model" axis
_TP_LAST = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "dt_proj"}
_TP_PENULT = {"wo", "out_proj", "w_down"}
_TP_VOCAB = {"embed", "lm_head"}
_STACKED = {"layers", "enc_layers"}       # leading dim = the layer axis


class Field(str):
    """A NamedTuple field's name in a ``map_with_path`` path: equal to
    the plain name, told apart from a dict key by its type."""


def map_with_path(tree: Any, fn: Callable, *,
                  is_leaf: Optional[Callable] = None, path: tuple = ()) -> Any:
    """``tree`` (nested dicts, lists, tuples and NamedTuples) with each
    leaf replaced by ``fn(path, leaf)``, ``path`` the keys down to it: a
    dict key as it is, a NamedTuple field as a ``Field``, a list index
    as an int. Dict keys are walked in sorted order (the reference's
    ``jax.tree`` order) and the containers rebuilt in their own types;
    a node for which ``is_leaf`` holds is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(tree[k], fn, is_leaf=is_leaf,
                                 path=path + (k,)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(getattr(tree, f), fn,
                                          is_leaf=is_leaf,
                                          path=path + (Field(f),))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(v, fn, is_leaf=is_leaf,
                                        path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor's module,
    which no tensor can come from until something has imported it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def check_mesh_device(t, mesh, what: str) -> None:
    """Raise unless tensor ``t`` lies on ``mesh``'s device type (DTensor
    would otherwise move it there without a word)."""
    if t.device.type != mesh.device_type:
        raise ValueError(f"{what} lies on {t.device.type}, the mesh on "
                         f"{mesh.device_type}: move it, or build the mesh "
                         f"for {t.device.type}")


def axis_sizes_of(mesh) -> Dict[str, int]:
    """{axis_name: size} of a ``DeviceMesh`` with named dims (the Rules
    constructor input)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def make_rules(cfg, mesh) -> "Rules":
    return Rules(cfg, axis_sizes_of(mesh))


def spec_string(spec: tuple) -> str:
    """The reference's ``str(PartitionSpec(*spec))``, as its checkpoint
    manifests record it (``PartitionSpec('data', 'model')``)."""
    return "PartitionSpec" + repr(tuple(spec))


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: each mesh dim that
    names an axis of the spec shards that tensor dim (``Shard(dim)``;
    ``("pod", "data")`` on one dim shards it on both, pod first), the
    others ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in entry if isinstance(entry, tuple) else (entry,):
            if ax not in names:
                raise ValueError(f"spec {spec} names axis {ax!r}, which the "
                                 f"mesh {tuple(names)} does not have")
            out[names.index(ax)] = Shard(dim)
    return out


class Rules:
    """Spec builders bound to one arch config and one mesh shape
    (``{axis_name: size}``)."""

    def __init__(self, cfg, axis_sizes: Dict[str, int]):
        self.cfg = cfg
        self.axis_sizes = dict(axis_sizes)
        self.data = int(axis_sizes.get("data", 1))
        self.model = int(axis_sizes.get("model", 1))
        self.pod = int(axis_sizes.get("pod", 1))

    # ------------------------------------------------------------ batch
    @property
    def _dp_size(self) -> int:
        return self.pod * self.data

    def _batch_axes(self, batch: int):
        """Axes for a batch dim (pods are plain data-parallel for inputs)."""
        if self._dp_size <= 1 or batch % self._dp_size != 0:
            return None
        return ("pod", "data") if self.pod > 1 else "data"

    def train_batch_specs(self, batch: int, seq: int) -> Dict[str, tuple]:
        b = self._batch_axes(batch)
        return {"tokens": (b, None), "labels": (b, None),
                "extra": (b, None, None)}

    def decode_token_spec(self, batch: int) -> tuple:
        return (self._batch_axes(batch), None)

    # ----------------------------------------------------------- params
    def _leaf_spec(self, path, shape) -> tuple:
        name = path[-1] if path else ""
        ndim = len(shape)
        spec = [None] * ndim
        reserved = {0} if path and path[0] in _STACKED and ndim else set()

        def fits(dim: int, size: int) -> bool:
            return (size > 1 and 0 <= dim < ndim and dim not in reserved
                    and spec[dim] is None and shape[dim] % size == 0)

        tp = None
        if name in _TP_LAST:
            tp = ndim - 1
        elif name in _TP_PENULT:
            tp = ndim - 2
        elif name in _TP_VOCAB:
            tp = 0
        if tp is not None and fits(tp, self.model):
            spec[tp] = "model"
            reserved.add(tp)

        if self.data > 1:
            cands = [d for d in range(ndim) if fits(d, self.data)]
            if cands:
                spec[max(cands, key=lambda d: shape[d])] = "data"
        return tuple(spec)

    def param_specs(self, params):
        """Spec tree matching ``params`` (tensors, or anything with a
        ``shape``) leaf for leaf."""
        return map_with_path(params, lambda path, leaf:
                             self._leaf_spec(path, tuple(leaf.shape)))

    # ------------------------------------------------------------ cache
    def _cache_leaf_spec(self, path, shape) -> tuple:
        name = path[-1] if path else ""
        ndim = len(shape)
        spec = [None] * ndim
        b = self._batch_axes(shape[1]) if ndim >= 2 else None
        if b is not None and ndim >= 2:
            spec[1] = b
        # head / state-channel dim gets tensor parallelism where it divides
        tp = None
        if name in ("k", "v") and ndim == 5:
            tp = 3                        # (L, B, S, Kv, hd): kv heads
        elif name == "conv" and ndim == 4:
            tp = 3                        # (L, B, 3, Di): channels
        elif name == "ssm" and ndim >= 4:
            tp = 2                        # (L, B, Di|H, ...): inner dim
        if (tp is not None and self.model > 1 and spec[tp] is None
                and shape[tp] % self.model == 0):
            spec[tp] = "model"
        return tuple(spec)

    def cache_specs(self, cache):
        return map_with_path(cache, lambda path, leaf:
                             self._cache_leaf_spec(path, tuple(leaf.shape)))


def pin_layout(t, model_dim: Optional[int] = None, *, rows: bool = True):
    """A DTensor activation redistributed to a plain layout: dim 0 (the
    batch rows) on the mesh's ``pod`` and ``data`` dims where it divides
    their product (as ``Rules`` places batches and caches), ``model_dim``
    on ``model`` where it divides it, every other mesh dim replicated.
    Its gradient is redistributed back in the backward, so the ops on
    either side see only ``Shard``, ``Replicate`` and ``Partial``
    placements: DTensor's view rules otherwise hand the attention
    activations and gradients strided shards, whose sharding
    propagation reads a tensor back to the host (and fails under fake
    tensors). With ``rows=False`` dim 0 is not a batch (a parameter
    that meets activations elementwise): replicated like the rest. A
    plain tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, _pinned(tuple(mesh.mesh_dim_names),
                                        tuple(mesh.shape), tuple(t.shape),
                                        model_dim, rows))


def _pinned(names: tuple, sizes: tuple, shape: tuple,
            model_dim: Optional[int], rows: bool) -> list:
    """``pin_layout``'s placements for a tensor of ``shape`` on a mesh
    with dims ``names`` of ``sizes``."""
    from torch.distributed.tensor import Replicate, Shard
    size = dict(zip(names, sizes))
    dp = size.get("pod", 1) * size.get("data", 1)
    rows = rows and len(shape) > 0 and shape[0] % dp == 0
    out = []
    for name in names:
        if name in ("pod", "data") and rows:
            out.append(Shard(0))
        elif (name == "model" and model_dim is not None
              and shape[model_dim] % size["model"] == 0):
            out.append(Shard(model_dim))
        else:
            out.append(Replicate())
    return out


def on_shards(fn: Callable, *args, like=None, placements=None):
    """``fn(*args)`` on each rank's local shards when the arguments are
    DTensors (all on one mesh, laid out so that ``fn`` needs no data of
    another rank), the result placed as ``placements``, or as ``like``'s
    (default: the first argument's). Where the result is sharded on a
    mesh dim and an argument replicated, that argument's gradient is
    each rank's part (``Partial``). Plain tensors go to ``fn`` as they
    are."""
    if not is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial
    first = args[0]
    placements = placements or (first if like is None else like).placements
    out = fn(*(a.to_local(grad_placements=[
        Partial() if o.is_shard() and p.is_replicate() else p
        for o, p in zip(placements, a.placements)]) for a in args))
    return DTensor.from_local(out, first.device_mesh, placements,
                              run_check=False)


def lookup_rows(table, idx):
    """``table[idx]`` for a DTensor ``table`` (V, D) and DTensor indices:
    the vocab stays sharded over ``model`` where it divides (the columns
    are gathered), each rank looks up its own rows of ``idx`` in its own
    vocab shard (0 elsewhere), and the shards' rows are summed over
    ``model``. (DTensor's indexing and embedding rules gather the whole
    batch, fail, or mask the wrong rows, by torch version.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    split = ("model" in names
             and table.shape[0] % axis_sizes_of(mesh)["model"] == 0)
    table = table.redistribute(mesh, [
        Shard(0) if split and n == "model" else Replicate() for n in names])
    idx = pin_layout(idx)

    def rows(tab, i):
        v = tab.shape[0]
        j = i - (mesh.get_local_rank("model") * v if split else 0)
        mine = ((j >= 0) & (j < v))[..., None]
        return torch.where(mine, tab[j.clamp(0, v - 1)], 0.0)
    return on_shards(rows, table, idx, placements=[
        Partial() if split and n == "model" else p
        for n, p in zip(names, idx.placements)])
