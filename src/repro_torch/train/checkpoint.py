"""Atomic checkpoints with auto-resume, in the reference's on-disk format.

Counterpart of ``repro/train/checkpoint.py``. A checkpoint of ``step``
is the directory ``step-%08d/`` holding ``shard-0.npz`` (one array per
leaf) and ``MANIFEST.json`` (the step, and each leaf's shape and
dtype). Leaf names are the reference's ``jax.tree_util`` key paths:
a dict key ``k`` reads ``['k']``, a NamedTuple field ``.field``, a list
index ``[i]``, joined by ``/`` (``['params']/['layers']/['attn']/['wq']``,
``['opt']/.mu/['embed']``) and written with ``/`` as ``__`` in the npz;
dict keys are taken in sorted order. So a checkpoint written by either
package restores in the other, bit for bit.

A save is atomic: it writes into ``step-%08d.tmp-0``, writes the
manifest as ``manifest.json`` and renames it to ``MANIFEST.json`` (the
completeness marker), then renames the directory into place; a partial
save never shadows the last good step.

Sharded state: ``save(..., specs=)`` records each leaf's spec in the
manifest in the reference's string form (``PartitionSpec('data',
'model')``). DTensor leaves are gathered whole, one leaf at a time
(``full_tensor()``, a collective every rank of the mesh makes), and rank
0 writes the one ``shard-0.npz`` of whole arrays; every rank returns
after the write. ``restore(path, like, mesh=, specs=)`` reads the whole
arrays and places each on ``mesh`` by its spec (``dist.mesh_rules``), so
a checkpoint saved on one mesh restores on another bit for bit (the
elastic re-shard), and a sharded checkpoint restores in the reference
without a mesh.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.mesh_rules import (Field, check_mesh_device, is_dtensor,
                                         map_with_path, placements,
                                         spec_string)


def _is_spec(x) -> bool:
    """A spec (``dist.mesh_rules``): a plain tuple of axis names, tuples
    of them, and None."""
    return (type(x) is tuple
            and all(e is None or isinstance(e, (str, tuple)) for e in x))


def _name(path: tuple) -> str:
    """The reference's leaf name of a ``map_with_path`` path."""
    return "/".join(f".{k}" if isinstance(k, Field) else f"[{k!r}]"
                    for k in path)


def _map(tree: Any, fn: Callable, specs: bool = False) -> Any:
    """``tree`` with each leaf replaced by ``fn(name, leaf)``, in the
    reference's order; with ``specs`` a spec tuple is a leaf."""
    return map_with_path(tree, lambda path, leaf: fn(_name(path), leaf),
                         is_leaf=_is_spec if specs else None)


def leaf_names(tree: Any) -> List[str]:
    """The reference's leaf names of ``tree``, in its flatten order."""
    names: List[str] = []
    _map(tree, lambda name, leaf: names.append(name))
    return names


def _to_numpy(leaf) -> np.ndarray:
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()           # every rank of the mesh gathers
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _ranks() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save(ckpt_dir: str, step: int, tree: Any, specs: Any = None) -> str:
    """Atomic save of a tree of tensors (params/opt/anything) at ``step``;
    returns the checkpoint's directory. Under a process group every rank
    calls it (DTensor leaves gather collectively), rank 0 writes, and all
    return once the checkpoint is in place."""
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    rank, world = _ranks()
    arrays, manifest = {}, {"step": step, "leaves": {}}

    def put(name, leaf):
        arr = _to_numpy(leaf)
        if rank == 0:
            arrays[name.replace("/", "__")] = arr
            manifest["leaves"][name] = dict(shape=list(arr.shape),
                                            dtype=str(arr.dtype))
    _map(tree, put)
    if specs is not None:
        manifest["specs"] = {}
        _map(specs, lambda name, sp: manifest["specs"].__setitem__(
            name, spec_string(sp)), specs=True)
    if rank == 0:
        _write(final, arrays, manifest)
    if world > 1:
        dist.barrier()
    return final


def _write(final: str, arrays: dict, manifest: dict) -> None:
    tmp = final + ".tmp-0"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard-0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(os.path.join(tmp, "manifest.json"),
               os.path.join(tmp, "MANIFEST.json"))  # completeness marker
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


_STEP_DIR = re.compile(r"^step-(\d{8})$")


def latest(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """Newest complete checkpoint ``(step, path)``, or None.

    Only exact ``step-<8 digits>`` names with a ``MANIFEST.json`` count:
    an interrupted save leaves a ``step-XXXXXXXX.tmp-<host>`` directory
    behind (possibly with a MANIFEST inside), which is never picked up."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in sorted(os.listdir(ckpt_dir)):
        m = _STEP_DIR.match(d)
        full = os.path.join(ckpt_dir, d)
        if m and os.path.exists(os.path.join(full, "MANIFEST.json")):
            best = (int(m.group(1)), full)
    return best


def restore(path: str, like: Any, mesh=None, specs: Any = None) -> Any:
    """The checkpoint at ``path`` in the structure of ``like``: each leaf
    a tensor of the saved dtype on the device of ``like``'s leaf (the CPU
    for a non-tensor leaf), requiring grad where ``like``'s leaf does
    (restored parameters are leaf tensors). With ``mesh`` and ``specs``
    (a spec tree matching ``like``) each whole array is placed on
    ``mesh`` by its spec instead: a DTensor whose local shard each rank
    cuts from its own read of the file, with no communication; a scalar
    whose spec is ``()`` (the optimizer's count) stays a plain tensor on
    the mesh's device. ``like``'s tensor leaves must lie on the mesh's
    device type: restore raises rather than move them."""
    if (mesh is None) != (specs is None):
        raise ValueError("restore: give both mesh and specs, or neither")
    spec_of = {}
    if specs is not None:
        _map(specs, lambda name, sp: spec_of.__setitem__(name, sp),
             specs=True)
    with np.load(os.path.join(path, "shard-0.npz")) as data:
        def get(name, leaf):
            t = torch.from_numpy(np.array(data[name.replace("/", "__")]))
            grad = isinstance(leaf, torch.Tensor) and leaf.requires_grad
            if mesh is not None and isinstance(leaf, torch.Tensor):
                check_mesh_device(leaf, mesh, f"restore: leaf {name}")
            if mesh is not None and spec_of[name] == () and t.dim() == 0:
                t = t.to(mesh.device_type)
            elif mesh is not None:
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(t.to(mesh.device_type), mesh,
                                      placements(spec_of[name], mesh),
                                      src_data_rank=None)
            elif isinstance(leaf, torch.Tensor):
                t = t.to(leaf.device)
            return t.requires_grad_(grad) if t.is_floating_point() else t
        return _map(like, get)
