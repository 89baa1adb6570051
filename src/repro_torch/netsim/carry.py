"""Carry engine state across from the reference package.

The reference's ``SimArrays``/``SimState`` (or ``PacketState``) arrive
as flat dicts of numpy arrays keyed by field name, nested fields dotted
(``tables.q_thresh``, ``cong.trend``), so this module never sees the
reference's types. ``to_numpy`` flattens the port's dataclasses the same
way, for comparisons.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core.cong import CongState
from repro_torch.core.tables import SwitchTables
from repro_torch.netsim.engine import SimArrays, SimState
from repro_torch.netsim.packet import PacketState


def _tensor(x, dev: torch.device) -> torch.Tensor:
    a = np.array(x)                 # a writable, contiguous copy
    if a.dtype == np.uint32:        # hash keys: uint32 values in int64
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(dev)


def _nested(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + ".")}


def from_reference(arrays: Dict[str, np.ndarray], state: Dict[str, np.ndarray],
                   device=devmod.DEFAULT) -> Tuple[SimArrays, SimState]:
    """Flat numpy dicts of the reference's arrays and state -> the port's
    ``SimArrays`` and ``SimState`` on ``device``; a packet engine's state
    (the dict holds ``fq``) becomes a ``PacketState``. An optional array
    field the dict lacks (the reference has no ``pair_policy``) stays
    None."""
    dev = devmod.resolve(device)
    tb = _nested(arrays, "tables")
    tables = SwitchTables(
        cap_thresh=_tensor(tb["cap_thresh"], dev),
        level_score=_tensor(tb["level_score"], dev),
        q_thresh=_tensor(tb["q_thresh"], dev),
        trend_thresh=_tensor(tb["trend_thresh"], dev),
        high_water_level=int(np.asarray(tb["high_water_level"])))
    arr = SimArrays(tables=tables, **{
        f.name: _tensor(arrays[f.name], dev)
        for f in dataclasses.fields(SimArrays)
        if f.name != "tables" and f.name in arrays})
    cg = _nested(state, "cong")
    cong = CongState(**{f.name: _tensor(cg[f.name], dev)
                        for f in dataclasses.fields(CongState)})
    cls = PacketState if "fq" in state else SimState
    st = cls(cong=cong, **{
        f.name: _tensor(state[f.name], dev)
        for f in dataclasses.fields(cls) if f.name != "cong"})
    return arr, st


def to_numpy(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """A port dataclass (``SimArrays``, ``SimState``) -> flat dict of
    numpy arrays keyed as ``from_reference`` takes them."""
    out: Dict[str, np.ndarray] = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(to_numpy(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.cpu().numpy()
        elif v is not None:
            out[key] = np.asarray(v)
    return out
