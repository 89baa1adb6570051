"""FCT slowdown (paper §6 "Metrics"): actual FCT over the ideal FCT of
the flow alone on its pair's minimum-propagation-delay candidate,
prop(best) + size / bottleneck_cap(best), over the completed flows;
amp's subflows are scored per parent flow.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine import SimConfig, SimState
from .paths import PathTable
from .gen import FlowSet


@dataclasses.dataclass
class FCTStats:
    slowdown: np.ndarray     # (F_done,)
    sizes: np.ndarray        # (F_done,)
    completed: int
    offered: int

    @property
    def completion_rate(self) -> float:
        """completed/offered: slowdown percentiles cover completed flows
        only, so read this beside them."""
        return self.completed / self.offered if self.offered else float("nan")

    def pct(self, q: float) -> float:
        return (float(np.percentile(self.slowdown, q)) if len(self.slowdown)
                else float("nan"))

    @property
    def p50(self) -> float:
        return self.pct(50)

    @property
    def p99(self) -> float:
        return self.pct(99)


def as_numpy(x) -> np.ndarray:
    """A state field as numpy: a tensor read back, else as it is."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _collapse_subflows(flows: FlowSet, done, fct, mask):
    """Per-subflow rows back to parent flows (amp): a parent is done when
    all its subflows delivered, its FCT is the last subflow's, its size
    the summed bytes; ``mask`` and the pair are uniform within a parent."""
    sof = np.asarray(flows.subflow_of)
    n = int(sof.max()) + 1 if len(sof) else 0
    done_p = np.ones(n, bool)
    np.logical_and.at(done_p, sof, done)
    fct_p = np.zeros(n, np.float64)
    np.maximum.at(fct_p, sof, np.where(done, fct, 0.0))
    size_p = np.zeros(n, np.float64)
    np.add.at(size_p, sof, flows.size_bytes)
    pair_p = np.zeros(n, np.int32)
    pair_p[sof] = flows.pair_id
    mask_p = None
    if mask is not None:
        mask_p = np.zeros(n, bool)
        mask_p[sof] = np.asarray(mask)
        done_p = done_p & mask_p
    return done_p, fct_p, size_p, pair_p, mask_p


def fct_stats(final: SimState, table: PathTable, flows: FlowSet,
              cfg: SimConfig, mask=None) -> FCTStats:
    """Slowdown stats over all flows, or the ``mask``-selected subset;
    subflow sets (``flows.subflow_of``) are scored per parent flow."""
    done = as_numpy(final.done)
    fct = as_numpy(final.fct_us)
    sizes = flows.size_bytes
    pair = flows.pair_id
    if getattr(flows, "subflow_of", None) is not None:
        done, fct, sizes, pair, mask = _collapse_subflows(
            flows, done, fct, mask)
    elif mask is not None:
        done = done & mask
    prop = table.pair_ideal_prop[pair].astype(np.float64)
    cap = table.pair_ideal_cap[pair] * 125.0 * cfg.cap_scale
    ideal = prop + sizes / cap
    sl = fct[done] / ideal[done]
    offered = int(mask.sum()) if mask is not None else len(done)
    return FCTStats(slowdown=np.maximum(sl, 1.0), sizes=sizes[done],
                    completed=int(done.sum()), offered=offered)
