"""The comparison that decides ``correct``: each checked cell of each
grid the window ran, against the reference's run of the same cell.

Each number is the worst over the checked cells of a grid, and the worst
over the grids is held to its limit (``limits/<workload>.json``, set
from the readings that PERF.md gives). A cell fails when any number of
its own passes a limit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

FLOW_TABLE = ("arrival_us", "size_bytes", "pair_id")


def cell_view(res) -> dict:
    """A program ``CellResult`` as the plain numbers the comparison reads
    (copied out of the program's objects)."""
    return {"arrival_us": np.array(res.flows.arrival_us),
            "size_bytes": np.array(res.flows.size_bytes),
            "pair_id": np.array(res.flows.pair_id),
            "done": np.array(res.final.done), "fct_us": np.array(res.final.fct_us),
            "serv_bytes": np.array(res.final.serv_bytes),
            "p50": float(res.stats.p50), "p99": float(res.stats.p99),
            "completed": int(res.stats.completed),
            "offered": int(res.stats.offered)}


def _rel(a: float, b: float) -> float:
    """|a - b| / |b|: 0 where both are equal or both NaN (no completed
    flow on either side), inf where only one is NaN or b is 0."""
    if a == b or (np.isnan(a) and np.isnan(b)):
        return 0.0
    if np.isnan(a) or np.isnan(b) or not b:
        return float("inf")
    return abs(a - b) / abs(b)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """One cell's numbers, program against reference:
    - ``flows_differ``: 1 if the generated flow table (arrival, size,
      pair of every flow) differs, else 0 (world and traffic build);
    - ``done_gap``: flows completed on one side only, over offered;
    - ``fct_gap``: the widest relative FCT gap over the flows both sides
      completed (the engine step, flow by flow);
    - ``serv_gap``: the widest relative gap of a link's served bytes over
      the horizon (the engine's link sharing and queues, link by link);
    - ``p50_gap``, ``p99_gap``: relative gaps of the slowdown percentiles
      (scoring)."""
    same_table = all(prog[k].shape == ref[k].shape
                     and np.array_equal(prog[k], ref[k]) for k in FLOW_TABLE)
    out = {"flows_differ": 0.0 if same_table else 1.0}
    if not same_table or prog["done"].shape != ref["done"].shape:
        out.update(done_gap=1.0, fct_gap=float("inf"), serv_gap=float("inf"),
                   p50_gap=float("inf"), p99_gap=float("inf"))
        return out
    n = max(int(ref["offered"]), 1)
    out["done_gap"] = float((prog["done"] != ref["done"]).sum()) / n
    both = prog["done"] & ref["done"]
    a = prog["fct_us"][both].astype(np.float64)
    b = ref["fct_us"][both].astype(np.float64)
    gap = np.abs(a - b) / np.maximum(np.abs(b), 1e-9)
    out["fct_gap"] = float(gap.max()) if gap.size else 0.0
    a = prog["serv_bytes"].astype(np.float64)
    b = ref["serv_bytes"].astype(np.float64)
    out["serv_gap"] = (float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())
                       if a.shape == b.shape and a.size else float("inf"))
    out["p50_gap"] = _rel(prog["p50"], ref["p50"])
    out["p99_gap"] = _rel(prog["p99"], ref["p99"])
    return out


def judge(grids: List[Dict[int, dict]], ref: Dict[int, dict],
          limits: Dict[str, float]) -> dict:
    """``grids``: per window grid, the checked cells' program views by
    cell index. Returns the worst reading of each number over every grid
    and cell, the failed cell count (a cell of a grid with any number
    past its limit) and ``correct``."""
    worst: Dict[str, float] = {}
    failed = 0
    for cells in grids:
        for i, r in ref.items():
            got = numbers(cells[i], r)
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
            failed += any(not got[k] <= lim for k, lim in limits.items())
    checked = {k: {"value": worst.get(k, float("inf")), "limit": lim}
               for k, lim in limits.items()}
    correct = bool(grids) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checked.values())
    return {"correct": correct, "failed": failed, "checks": checked,
            "readings": worst}
