"""One-call experiment driver: scenario + workload + policy -> FCT stats.
Counterpart of ``repro/netsim/experiment.py`` (``ExpSpec``,
``build_world``, ``make_flows``, ``spec_to_cfg``, ``run_experiment``).

``run_experiment(spec)`` runs on the GPU; pass ``device="cpu"`` to run
the same path on the CPU with the kernels' plain versions. Both engines
(``spec.engine``: ``fluid`` or ``packet``), every policy, every CC law,
the scenarios' fail and degrade schedules, ``ctrl_period_us``,
``sig_delay_scale``, ``redecide_period_us`` (fluid), ``flowlet_gap_us``
(packet), ``n_subflows`` and ``load_sched`` run; a grid of specs runs
batched through ``netsim.sweep.run_sweep``. ``checks`` (or
``REPRO_CHECKS=1``) arms the physics-invariant sanitizer
(``netsim.sanitize``); ``cosim_model`` overlays a training job's
collective buckets on the traffic (``repro_torch.cosim``).
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Optional, Sequence

from repro_torch import device as devmod
from repro_torch.netsim import engine, metrics, paths, scenarios
from repro_torch.netsim.engine import SimConfig
from repro_torch.traffic import cdf as cdfmod
from repro_torch.traffic import sched as schedmod
from repro_torch.traffic.gen import generate


@dataclasses.dataclass(frozen=True)
class ExpSpec:
    """Same fields and defaults as the reference's ``ExpSpec``."""
    topology: str = "testbed8"       # any scenario string (scenarios.names())
    workload: str = "websearch"
    load: float = 0.3
    policy: str = "lcmp"
    cc: str = "dcqcn"
    engine: str = "fluid"            # fluid | packet (engine.ENGINES)
    duration_us: int = 1_500_000
    seed: int = 0
    pairs: str = "main"              # main | all | <src>-<dst>
    bg_load: float = 0.0             # cross-traffic on the other pairs
    load_sched: str = ""             # per-pair load schedule (traffic/sched.py)
    cap_scale: float = 0.125
    sig_delay_scale: float = 1.0     # routing-signal propagation-delay scale
    ctrl_period_us: int = 100_000    # C_path re-install period (0 = frozen)
    flowlet_gap_us: int = 0          # packet engine: flowlet idle gap
    redecide_period_us: int = 0      # fluid engine: re-decision epoch
    n_subflows: int = 1              # amp: subflows per flow
    cosim_model: str = ""            # training co-simulation (repro_torch.cosim)
    cosim_cell: str = "train_4k"
    cosim_iters: int = 6
    cosim_compress: int = 1
    checks: int = 0                  # physics-invariant sanitizer
    select: Optional[object] = None  # optional SelectParams override
    pathq: Optional[object] = None   # optional PathQParams override
    congp: Optional[object] = None   # optional CongParams override


# The reference's sweep-axis contract, kept beside the port's ExpSpec so
# its fields stay classified the same way: static fields reach the
# configuration through spec_to_cfg, dynamic ones only reshape the flow
# tables.
AXES_STATIC = (
    "engine", "cc", "duration_us", "cap_scale", "sig_delay_scale",
    "ctrl_period_us", "flowlet_gap_us", "redecide_period_us",
    "n_subflows", "checks", "select", "pathq", "congp",
)
AXES_DYNAMIC = (
    "workload", "load", "seed", "pairs", "bg_load", "load_sched",
    "cosim_model", "cosim_cell", "cosim_iters", "cosim_compress",
)
AXES_EXEMPT = {
    "topology": "selects the world built by build_world, not a"
                " configuration field",
    "policy": "the per-cell dynamic law code of the sweep"
              " (SimArrays.pair_policy); the spec_to_cfg read is overridden"
              " by static_key's policy='sweep' replace",
}


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
    if spec.cosim_model:
        # the training job's collective rows, overlaid after every rng
        # draw (the plan is rng-free and the merge a stable sort, so the
        # background rows stay as generated); imported here, since plain
        # runs never need the model-config registry
        from repro_torch.cosim import workload as cosim_workload
        fs = cosim_workload.overlay(
            fs, cosim_workload.build_plan(spec, scen, table))
    return fs


def spec_to_cfg(spec: ExpSpec, scen: scenarios.Scenario) -> SimConfig:
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
                     n_subflows=spec.n_subflows,
                     checks=bool(spec.checks)
                     or os.environ.get("REPRO_CHECKS") == "1",
                     fail_sched=scen.fail_sched,
                     degrade_sched=scen.degrade_sched, **kw)


def build_experiment(spec: ExpSpec):
    scen, table = build_world(spec.topology)
    cfg = spec_to_cfg(spec, scen)
    engine.check_slice(cfg)
    flows = make_flows(spec, scen, table)
    return scen.topology, table, flows, cfg


def run_experiment(spec: ExpSpec, device=devmod.DEFAULT):
    """Build the world and traffic, run the spec's engine on ``device``,
    and score it: ``(FCTStats, link utilization, (topology, table,
    flows, cfg, final state))``."""
    dev = devmod.resolve(device)
    t, table, flows, cfg = build_experiment(spec)
    eng = engine.get_engine(cfg.engine)
    arrs, state = eng.build(table, flows, cfg, device=dev)
    final = eng.run(arrs, state, cfg)
    stats = metrics.fct_stats(final, table, flows, cfg)
    util = metrics.link_utilization(final, arrs, cfg)
    return stats, util, (t, table, flows, cfg, final)


def compare_policies(base: ExpSpec, policies: Sequence[str],
                     device=devmod.DEFAULT) -> Dict[str, metrics.FCTStats]:
    """``run_experiment`` of ``base`` under each policy -> FCT stats."""
    return {p: run_experiment(dataclasses.replace(base, policy=p),
                              device=device)[0] for p in policies}
