"""A grid cell's world, traffic and configuration: ``ExpSpec`` (the
fields a cell is given by), ``build_world``, ``make_flows`` and
``spec_to_cfg``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

from . import cdf as cdfmod
from . import engine, paths, scenarios
from . import sched as schedmod
from .engine import SimConfig
from .gen import generate


@dataclasses.dataclass(frozen=True)
class ExpSpec:
    """One cell of a grid: scenario, traffic, policy, CC law, engine and
    horizon, with the program's field names and defaults."""
    topology: str = "testbed8"       # any scenario string (scenarios.names())
    workload: str = "websearch"
    load: float = 0.3
    policy: str = "lcmp"
    cc: str = "dcqcn"
    engine: str = "fluid"            # fluid | packet
    duration_us: int = 1_500_000
    seed: int = 0
    pairs: str = "main"              # main | all | <src>-<dst>
    bg_load: float = 0.0             # cross-traffic on the other pairs
    load_sched: str = ""             # per-pair load schedule (sched.py)
    cap_scale: float = 0.125
    sig_delay_scale: float = 1.0     # routing-signal propagation-delay scale
    ctrl_period_us: int = 100_000    # C_path re-install period (0 = frozen)
    flowlet_gap_us: int = 0          # packet engine: flowlet idle gap
    redecide_period_us: int = 0      # fluid engine: re-decision epoch
    n_subflows: int = 1              # amp: subflows per flow
    select: Optional[object] = None  # optional SelectParams override
    pathq: Optional[object] = None   # optional PathQParams override
    congp: Optional[object] = None   # optional CongParams override


@functools.lru_cache(maxsize=32)
def build_world(topology: str):
    """Scenario + path table for a scenario string (cached: the path
    enumeration is the expensive numpy part)."""
    scen = scenarios.get(topology)
    t = scen.topology
    pair_list = (list(scen.traffic_pairs) if scen.traffic_pairs is not None
                 else paths.all_pairs(t))
    table = paths.build_path_table(t, pair_list, max_hops=scen.max_hops,
                                   detour_delay=scen.detour_delay,
                                   detour_hops=scen.detour_hops)
    engine.attach_link_caps(table, t)
    return scen, table


def traffic_pair_ids(spec: ExpSpec, scen: scenarios.Scenario, table) -> list:
    pidx = table.pair_index()
    if spec.pairs in ("main", "dc1dc8"):     # dc1dc8: legacy spelling
        main = pidx[scen.main_pair]
        if table.pair_ncand[main] == 0:
            raise ValueError(
                f"scenario {spec.topology!r}: main pair {scen.main_pair} has "
                "no installed candidate paths (parameters out of range?)")
        return [main]
    if spec.pairs == "all":
        return [pidx[p] for p in pidx if table.pair_ncand[pidx[p]] > 0]
    s, d = spec.pairs.split("-")
    return [pidx[(int(s), int(d))]]


def background_pair_ids(table, fg_ids) -> list:
    """Every advertised pair with candidates that is not a foreground
    pair."""
    fg = set(int(i) for i in fg_ids)
    return [i for i in range(len(table.pair_src))
            if table.pair_ncand[i] > 0 and i not in fg]


def make_flows(spec: ExpSpec, scen: scenarios.Scenario, table):
    fg_ids = traffic_pair_ids(spec, scen, table)
    bg_ids = (background_pair_ids(table, fg_ids)
              if spec.bg_load > 0 else None)
    kw = {}
    if spec.load_sched:
        sched_t, fg_rows, bg_rows = schedmod.build(
            spec.load_sched, spec.duration_us, table, scen,
            fg_ids, bg_ids or ())
        kw = dict(sched_t=sched_t, load_rows=fg_rows, bg_rows=bg_rows)
    fs = generate(table, cdfmod.WORKLOADS[spec.workload], spec.load,
                  spec.duration_us, pair_ids=fg_ids,
                  seed=spec.seed, cap_scale=spec.cap_scale,
                  bg_pair_ids=bg_ids, bg_load=spec.bg_load,
                  n_subflows=spec.n_subflows, **kw)
    return fs


def spec_to_cfg(spec: ExpSpec, scen: scenarios.Scenario,
                sum_dtype: str = "float64") -> SimConfig:
    kw = {}
    if spec.select is not None:
        kw["select"] = spec.select
    if spec.pathq is not None:
        kw["pathq"] = spec.pathq
    if spec.congp is not None:
        kw["congp"] = spec.congp
    return SimConfig(engine=spec.engine, policy=spec.policy, cc=spec.cc,
                     horizon_us=spec.duration_us * 2,  # let tail flows finish
                     cap_scale=spec.cap_scale,
                     sig_delay_scale=spec.sig_delay_scale,
                     ctrl_period_us=spec.ctrl_period_us,
                     flowlet_gap_us=spec.flowlet_gap_us,
                     redecide_period_us=spec.redecide_period_us,
                     n_subflows=spec.n_subflows, sum_dtype=sum_dtype,
                     fail_sched=scen.fail_sched,
                     degrade_sched=scen.degrade_sched, **kw)
