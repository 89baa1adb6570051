"""FCT-slowdown and utilization metrics (paper §6 "Metrics"); counterpart
of ``repro/netsim/metrics.py`` (``FCTStats``, ``fct_stats``,
``link_utilization``).

Slowdown = actual FCT / ideal FCT, the ideal being the flow alone on the
pair's minimum-propagation-delay candidate: prop(best) + size /
bottleneck_cap(best). Final states are read back to numpy once, after
the run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.netsim.engine import SimArrays, SimConfig, SimState
from repro_torch.netsim.paths import PathTable
from repro_torch.traffic.gen import FlowSet


@dataclasses.dataclass
class FCTStats:
    slowdown: np.ndarray     # (F_done,)
    sizes: np.ndarray        # (F_done,)
    completed: int
    offered: int

    def pct(self, q: float) -> float:
        return (float(np.percentile(self.slowdown, q)) if len(self.slowdown)
                else float("nan"))

    @property
    def p50(self) -> float:
        return self.pct(50)

    @property
    def p99(self) -> float:
        return self.pct(99)


def fct_stats(final: SimState, table: PathTable, flows: FlowSet,
              cfg: SimConfig) -> FCTStats:
    """Slowdown stats over all flows (the fg/bg ``mask`` split is a later
    slice)."""
    if getattr(flows, "subflow_of", None) is not None:
        raise NotImplementedError(
            "subflow (amp) scoring is not ported yet: ROADMAP.md queue A "
            "item 4")
    done = final.done.cpu().numpy()
    fct = final.fct_us.cpu().numpy()
    sizes = flows.size_bytes
    prop = table.pair_ideal_prop[flows.pair_id].astype(np.float64)
    cap = table.pair_ideal_cap[flows.pair_id] * 125.0 * cfg.cap_scale
    ideal = prop + sizes / cap
    sl = fct[done] / ideal[done]
    return FCTStats(slowdown=np.maximum(sl, 1.0), sizes=sizes[done],
                    completed=int(done.sum()), offered=len(done))


def link_utilization(final: SimState, arrs: SimArrays,
                     cfg: SimConfig) -> np.ndarray:
    """Average served utilization per link over the horizon (Fig. 1b),
    normalized by the effective capacity-time integral."""
    T = cfg.num_steps
    cap = arrs.link_cap.cpu().numpy().astype(np.float64)
    alive = np.clip(arrs.link_fail_step.cpu().numpy().astype(np.int64), 0, T)
    deg = np.clip(arrs.link_deg_step.cpu().numpy().astype(np.int64), 0, T)
    full = np.minimum(alive, deg)
    fac = arrs.link_deg_factor.cpu().numpy().astype(np.float64)
    eff_steps = full + fac * np.maximum(alive - full, 0)
    cap_total = cap * eff_steps * cfg.dt_us
    return final.serv_bytes.cpu().numpy() / np.maximum(cap_total, 1e-9)
