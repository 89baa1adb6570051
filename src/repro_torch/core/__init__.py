"""repro_torch.core — the LCMP integer decision core as torch ops.

  tables : control-plane bootstrap vectors (Fig. 3)
  pathq  : Alg. 1/2 + Eq. 2 path-quality scores
  cong   : Q/T/D on-switch congestion estimator (Eqs. 3-5)
  select : Eq. 1 fused cost + diversity-preserving selection (§3.4)
  baselines : the baseline routing laws
  flowcache, switchd : the switch-local object model (Fig. 2): on the
           card one standalone cong_update launch a monitor tick and one
           switch_route call a batch, through launchers bound once per
           switch; ``candidate_costs`` reads a switch's per-candidate
           (C_path, C_cong, valid), C_cong recomputed from the registers
           with plain torch ops, off the route path

Every function is integer-only and bit-exact with ``repro.core`` (the
flow cache on batches whose slots are distinct). The package re-exports
the reference's 26 names, in its order; ``switchd``'s are loaded on
first use, since ``switchd`` imports ``kernels.ops``, whose modules
import this package's submodules.
"""
from repro_torch.core.tables import SwitchTables, bootstrap_tables, level_score_table
from repro_torch.core.pathq import (PathQParams, calc_delay_cost, calc_linkcap_cost,
                                    calc_path_quality)
from repro_torch.core.cong import (CongParams, CongState, monitor_update, cong_signals,
                                   calc_cong_cost)
from repro_torch.core.select import (SelectParams, fused_cost, select_egress,
                                     ecmp_select, fmix32)
from repro_torch.core.flowcache import FlowCache

__all__ = [
    "SwitchTables", "bootstrap_tables", "level_score_table",
    "PathQParams", "calc_delay_cost", "calc_linkcap_cost", "calc_path_quality",
    "CongParams", "CongState", "monitor_update", "cong_signals", "calc_cong_cost",
    "SelectParams", "fused_cost", "select_egress", "ecmp_select", "fmix32",
    "FlowCache",
    "SwitchParams", "SwitchState", "make_switch", "monitor_tick",
    "route_batch", "gc_tick", "candidate_costs", "set_port_liveness",
]

_SWITCHD = ("SwitchParams", "SwitchState", "make_switch", "monitor_tick",
            "route_batch", "gc_tick", "candidate_costs", "set_port_liveness")


def __getattr__(name):
    if name in _SWITCHD:
        from repro_torch.core import switchd
        return getattr(switchd, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
