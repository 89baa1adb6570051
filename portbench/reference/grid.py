"""A grid of cells run as the reference: the cells of each static group
(same world and configuration; the policy is a per-pair law code) built
one by one, joined into one block-diagonal world, run over the horizon
and sliced back out for scoring. Cells share no link, so each cell's
numbers are what it computes alone, whichever other cells share its
world.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import engine, metrics
from .experiment import ExpSpec, build_world, make_flows, spec_to_cfg


def static_key(spec: ExpSpec, sum_dtype: str):
    scen, _ = build_world(spec.topology)
    return (spec.topology, dataclasses.replace(
        spec_to_cfg(spec, scen, sum_dtype), policy="sweep"))


def run_grid(fields: Sequence[dict], device="cpu", sum_dtype="float64",
             cells: Optional[Sequence[int]] = None) -> Dict[int, dict]:
    """Run cells ``cells`` (default: all) of the grid whose cells are
    given by ``ExpSpec`` field dicts ``fields``, on ``device``, with the
    per-link sums in ``sum_dtype``. Returns per cell index: its flows'
    arrival, size and pair (numpy), the final ``done``, ``fct_us``,
    ``flow_path`` and per-link ``serv_bytes``, and ``p50``, ``p99``,
    ``completed``, ``offered``."""
    dev = torch.device(device)
    idxs = range(len(fields)) if cells is None else cells
    groups: Dict[tuple, List[int]] = {}
    for i in idxs:
        groups.setdefault(static_key(ExpSpec(**fields[i]), sum_dtype),
                          []).append(i)
    out = {}
    for (topology, cfg), members in groups.items():
        specs = [ExpSpec(**fields[i]) for i in members]
        present = {s.policy for s in specs}
        cfg = dataclasses.replace(cfg, sweep_policies=tuple(
            p for p in engine.POLICIES if p in present))
        scen, table = build_world(topology)
        eng = engine.get_engine(cfg.engine)
        built, flows = [], []
        for spec in specs:
            fl = make_flows(spec, scen, table)
            built.append(eng.build(table, fl, dataclasses.replace(
                cfg, policy=spec.policy), device=dev))
            flows.append(fl)
        arrs, state, slices = engine.merge_cells(built)
        del built
        final = eng.run(arrs, state, cfg)
        for i, sl, fl in zip(members, slices, flows):
            cell = engine.slice_cell(final, sl)
            st = metrics.fct_stats(cell, table, fl, cfg)
            out[i] = {
                "arrival_us": np.asarray(fl.arrival_us),
                "size_bytes": np.asarray(fl.size_bytes),
                "pair_id": np.asarray(fl.pair_id),
                "done": cell.done.cpu().numpy(),
                "fct_us": cell.fct_us.cpu().numpy(),
                "flow_path": cell.flow_path.cpu().numpy(),
                "serv_bytes": cell.serv_bytes.cpu().numpy(),
                "p50": st.p50, "p99": st.p99,
                "completed": st.completed, "offered": st.offered}
        del arrs, state, final
    return out
