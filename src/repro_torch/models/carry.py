"""Carry model and optimizer state across from the reference package.

The reference's parameter tree and ``AdamWState`` arrive as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, tree)`` on the
reference's side), so this module never sees the reference's types;
``to_numpy`` turns the port's trees back, for comparisons.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.train.optim import AdamWState


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(tree, device=devmod.DEFAULT) -> dict:
    """Nested dict of numpy arrays -> float32 parameter tensors on
    ``device`` that require grad."""
    dev = devmod.resolve(device)
    return _tree(tree, lambda a: torch.tensor(np.asarray(a, np.float32),
                                              device=dev).requires_grad_())


def opt_from_reference(count, mu, nu, device=devmod.DEFAULT) -> AdamWState:
    """The reference's ``AdamWState`` fields as numpy -> the port's."""
    dev = devmod.resolve(device)
    moment = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return AdamWState(count=torch.tensor(int(count), dtype=torch.int32,
                                         device=dev),
                      mu=_tree(mu, moment), nu=_tree(nu, moment))


def to_numpy(tree):
    """A nested dict of tensors -> the same dict of numpy arrays."""
    return _tree(tree, lambda t: t.detach().cpu().numpy())
