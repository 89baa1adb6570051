"""Batched scenario sweep: a figure's whole grid as one world per static
group (counterpart of ``repro/netsim/sweep.py``).

The paper's evaluation is a grid of experiment cells (topologies x
workloads x loads x policies x seeds, §6). ``run_sweep``:

1. groups the cells by their *static* key (``static_key``), as the
   reference does: the scenario string and the configuration with the
   policy replaced by the ``sweep`` meta-policy, so every cell of a
   group has the same world, engine, schedules, CC law, horizon and
   parameters, and the policy is a per-cell law code (fluid and packet
   cells form separate groups);
2. builds each cell of a group with its own policy and traffic and joins
   them into one block-diagonal world (``engine.merge_cells``): cell c's
   links, paths, pairs and flows follow the earlier cells', a step's
   arrival row is the cells' rows side by side, and each pair carries
   its cell's law code (``SimArrays.pair_policy``), which the route and
   decide kernels read per arrival;
3. runs that world through the group's engine once (one
   ``monitor_tick`` and one ``route_arrivals`` launch a step on the card
   for the whole group) and slices each cell's final state back out
   (``engine.slice_cell``) for its metrics.

The cells share no link, so no float sum mixes two cells: on the CPU
each cell's result equals the sequential loop's bit for bit (the packet
step's parked 0.0 contributions may land on another cell's links, which
leaves its sums as they were). On the card both steps sum per link in
float64, where the order of the atomics does not show, so a cell's sums
are its sequential run's. With ``checks`` the merged run is sanitized
and raises after it, as the reference's group runner does.

Not carried over from the reference, since nothing is padded: the
per-cell padding of the flow tables (``_pad_cell``, the reference
engine's ``FLOW_FIELDS``/``STATE_PAD``), the chunking of a group by flow
count (``_chunk_by_flows``, ``max_pad_frac``) and the 512-flow
vmap/map crossover (``_VMAP_MAX_FLOWS``, a measurement of XLA's
batched-scatter lowering on a CPU), with the reference's
``batch_mode`` and ``devices`` options: every group runs merged, and
``sequential=True`` is the cell-by-cell loop. ``use_mesh`` is a no-op
with one visible card and raises with more (ROADMAP.md queue A item 9).
"""
from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.netsim import engine, metrics
from repro_torch.netsim.experiment import (ExpSpec, build_world, make_flows,
                                           run_experiment, spec_to_cfg)

@dataclasses.dataclass
class CellResult:
    """One cell's outputs, sliced back out of its group (numpy)."""
    spec: ExpSpec
    stats: metrics.FCTStats
    util: np.ndarray           # (L,) effective-capacity utilization
    # done / fct_us / flow_path / serv_bytes / c_path / route_nonce
    final: SimpleNamespace
    flows: object              # the cell's FlowSet
    # foreground/background split when the cell doses cross-traffic
    # (spec.bg_load > 0); stats_fg is stats and stats_bg None otherwise
    stats_fg: metrics.FCTStats = None
    stats_bg: metrics.FCTStats = None


@dataclasses.dataclass
class SweepReport:
    results: List[CellResult]  # in the order of the input specs
    num_cells: int
    num_groups: int            # static groups (one world each)
    wall_s: float
    group_cells: List[int]     # cells per group

    def __iter__(self):
        return iter(self.results)


@dataclasses.dataclass
class Group:
    """One static group, built and merged: ``arrs``/``state`` the merged
    world, ``cfg`` its sweep configuration, and per cell (in the order of
    ``specs``) its slice, flows and own arrays."""
    specs: List[ExpSpec]
    table: object
    cfg: engine.SimConfig
    arrs: engine.SimArrays
    state: engine.SimState
    slices: List[engine.CellSlice]
    flows: list
    cell_arrs: list


def static_key(spec: ExpSpec):
    """Everything that makes a separate world: the scenario string and
    the configuration with the policy replaced by ``sweep``. Load, seed,
    workload, pairs, bg_load and load_sched only change the traffic, and
    the policy is a per-cell law code."""
    scen, _ = build_world(spec.topology)
    return (spec.topology,
            dataclasses.replace(spec_to_cfg(spec, scen), policy="sweep"))


def group_config(specs: Sequence[ExpSpec], key=None):
    """``(topology, cfg)`` of one static group: its ``static_key`` (the
    one ``key`` given, else computed and checked for every spec), with the
    sweep narrowed to the policies present (in ``engine.POLICIES``
    order), so a law no cell takes costs nothing in the step."""
    if key is None:
        keys = {static_key(s) for s in specs}
        if len(keys) != 1:
            raise ValueError(f"the specs span {len(keys)} static groups, "
                             "not one")
        key, = keys
    topology, cfg = key
    present = {s.policy for s in specs}
    return topology, dataclasses.replace(cfg, sweep_policies=tuple(
        p for p in engine.POLICIES if p in present))


def build_group(specs: Sequence[ExpSpec], device=devmod.DEFAULT,
                key=None) -> Group:
    """Build the cells of one static group on ``device``, each with its
    own policy, and merge them into one world (``group_config``)."""
    dev = devmod.resolve(device)
    topology, cfg = group_config(specs, key)
    scen, table = build_world(topology)
    eng = engine.get_engine(cfg.engine)
    built, flows = [], []
    for spec in specs:
        fl = make_flows(spec, scen, table)
        built.append(eng.build(table, fl, dataclasses.replace(
            cfg, policy=spec.policy), device=dev))
        flows.append(fl)
    arrs, state, slices = engine.merge_cells(built)
    return Group(list(specs), table, cfg, arrs, state, slices, flows,
                 [a for a, _ in built])


def _view(st) -> SimpleNamespace:
    return SimpleNamespace(**{n: getattr(st, n).cpu().numpy() for n in (
        "done", "fct_us", "flow_path", "serv_bytes", "c_path",
        "route_nonce")})


def run_group(group: Group) -> List[CellResult]:
    """Run a merged group over its horizon and score each cell. The
    group's state is consumed (updated in place)."""
    final = engine.get_engine(group.cfg.engine).run(group.arrs, group.state,
                                                    group.cfg)
    out, cfg, table = [], group.cfg, group.table
    for spec, sl, flows, arrs in zip(group.specs, group.slices, group.flows,
                                     group.cell_arrs):
        cell = engine.slice_cell(final, sl)
        stats = metrics.fct_stats(cell, table, flows, cfg)
        fg, bg = metrics.fg_bg_stats(cell, table, flows, cfg, overall=stats)
        out.append(CellResult(
            spec=spec, stats=stats,
            util=metrics.link_utilization(cell, arrs, cfg),
            final=_view(cell), flows=flows, stats_fg=fg, stats_bg=bg))
    return out


def run_sweep(specs: Sequence[ExpSpec], sequential: bool = False,
              use_mesh: bool = False,
              device=devmod.DEFAULT) -> SweepReport:
    """Run a grid of experiment cells on ``device``, one merged world per
    static group.

    Args:
      specs: the grid, any mix of scenarios, loads, policies, seeds, ...
      sequential: run ``run_experiment`` cell by cell instead (the
        baseline the batched run must equal).
      use_mesh: spread the groups over the visible cards: a no-op with
        one, ``NotImplementedError`` with more (ROADMAP.md queue A item 9).
      device: ``"cuda"`` (default; raises without a card) or ``"cpu"``.
    """
    dev = devmod.resolve(device)
    if use_mesh and dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "run_sweep across more than one card is not ported yet: "
            "ROADMAP.md queue A item 9")
    t0 = time.perf_counter()
    if sequential:
        results = []
        for spec in specs:
            stats, util, (_, table, flows, cfg, final) = run_experiment(
                spec, device=dev)
            fg, bg = metrics.fg_bg_stats(final, table, flows, cfg,
                                         overall=stats)
            results.append(CellResult(spec=spec, stats=stats, util=util,
                                      final=_view(final), flows=flows,
                                      stats_fg=fg, stats_bg=bg))
        return SweepReport(results, len(results), len(results),
                           time.perf_counter() - t0, [1] * len(results))

    groups: dict = {}
    for i, spec in enumerate(specs):
        groups.setdefault(static_key(spec), []).append(i)
    results: List[Optional[CellResult]] = [None] * len(specs)
    for key, idxs in groups.items():
        group = build_group([specs[i] for i in idxs], device=dev, key=key)
        for i, res in zip(idxs, run_group(group)):
            results[i] = res
        del group             # the world's memory, before the next is built
    return SweepReport(results, len(specs), len(groups),
                       time.perf_counter() - t0,
                       [len(idxs) for idxs in groups.values()])
