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
save never shadows the last good step. The port is one process, so it
writes shard 0 only. Re-sharding onto a device mesh (``mesh``/``specs``)
is not ported (ROADMAP.md, queue A item 9).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def _map(tree: Any, fn: Callable, path: Tuple[str, ...] = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(name, leaf)``; the
    containers are rebuilt in their own types."""
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn, path + (f"[{k!r}]",))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(getattr(tree, f), fn, path + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def leaf_names(tree: Any) -> List[str]:
    """The reference's leaf names of ``tree``, in its flatten order."""
    names: List[str] = []
    _map(tree, lambda name, leaf: names.append(name))
    return names


def _no_mesh(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} onto a device mesh is not ported yet (ROADMAP.md, queue A "
        "item 9); the port saves and restores whole tensors")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, specs: Any = None) -> str:
    """Atomic save of a tree of tensors (params/opt/anything) at ``step``;
    returns the checkpoint's directory."""
    if specs is not None:
        raise _no_mesh("saving partition specs")
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    tmp = final + ".tmp-0"
    os.makedirs(tmp, exist_ok=True)
    arrays, manifest = {}, {"step": step, "leaves": {}}

    def put(name, leaf):
        arr = _to_numpy(leaf)
        arrays[name.replace("/", "__")] = arr
        manifest["leaves"][name] = dict(shape=list(arr.shape),
                                        dtype=str(arr.dtype))
    _map(tree, put)
    np.savez(os.path.join(tmp, "shard-0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(os.path.join(tmp, "manifest.json"),
               os.path.join(tmp, "MANIFEST.json"))  # completeness marker
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


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
    (restored parameters are leaf tensors)."""
    if mesh is not None or specs is not None:
        raise _no_mesh("re-sharding a checkpoint")
    with np.load(os.path.join(path, "shard-0.npz")) as data:
        def get(name, leaf):
            t = torch.from_numpy(np.array(data[name.replace("/", "__")]))
            if isinstance(leaf, torch.Tensor):
                t = t.to(leaf.device).requires_grad_(leaf.requires_grad)
            return t
        return _map(like, get)
