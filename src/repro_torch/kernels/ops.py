"""Public wrappers of the port's kernels (counterpart of
``repro/kernels/ops.py``), with the same signatures as the plain versions
in ``ref.py``. Each wrapper runs the plain version for CPU tensors and
its CUDA kernel for CUDA tensors; what the kernel does not take (on the
card, ``lcmp_decide`` candidate sets wider than 8, or int64 random bits
for ``qsr_int8``) raises.

``monitor_tick`` and ``route_arrivals`` are the fluid engine's two fused
phases and ``decide`` its failover and re-decision decision;
``MonitorTick`` and ``RouteArrivals`` are their launchers for a run on
the card (``netsim.fluid.make_step`` builds one of each). On the card
``decide`` launches only through a run's ``RouteArrivals.decide``; its
wrapper here is the plain version and raises for CUDA tensors.

``switch_monitor`` and ``switch_route`` are the switch's monitor pass
and batch of arrivals (``core.switchd``), each taking the switch:
``SwitchMonitor`` (one ``cong_update`` launch a tick, counted as
``cong_update``) and ``SwitchRoute`` (one ``switch_route`` call of two
kernels a batch) are their launchers, which ``core.switchd.make_switch``
builds once per switch on the card. No path launches the standalone
``lcmp_decide`` entry; it stays for the TPU kernel's contract.
"""
from __future__ import annotations

from repro_torch.core.cong import CongParams
from repro_torch.core.select import SelectParams
from repro_torch.kernels import cong_update as _cong
from repro_torch.kernels import lcmp_decide as _decide
from repro_torch.kernels.cong_update import (MonitorTick, SwitchMonitor,
                                             monitor_tick, switch_monitor)
from repro_torch.kernels.lcmp_decide import (RouteArrivals, SwitchRoute,
                                             decide, route_arrivals,
                                             switch_route)
from repro_torch.kernels.qsr_int8 import qsr_dequant, qsr_int8


def lcmp_decide(flow_ids, c_path, c_cong, valid, params=None):
    params = params or SelectParams()
    return _decide.lcmp_decide(flow_ids, c_path, c_cong, valid, params)


def cong_update(state, queue_cells, now_us, tables, params=None,
                hist_c=None, slot=0):
    params = params or CongParams()
    return _cong.cong_update(state, queue_cells, now_us, tables, params,
                             hist_c, slot)


_COUNTED = {"cong_update": _cong.cong_update,
            "lcmp_decide": _decide.lcmp_decide,
            "monitor_tick": monitor_tick, "route_arrivals": route_arrivals,
            "decide": decide, "switch_route": switch_route,
            "qsr_int8": qsr_int8, "qsr_dequant": qsr_dequant}


def counts() -> dict:
    """Kernel launches since the last reset."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


def add_counts(launches: dict) -> None:
    """Add another process's ``counts()`` (a sweep worker's) to this one's,
    so ``counts()`` reads what a call launched wherever it ran."""
    for name, n in launches.items():
        _COUNTED[name].launches += n
