"""The LCMP DCI-switch state machine (paper Fig. 2 runtime workflow);
counterpart of ``repro/core/switchd.py``.

Composes the bootstrap tables, the path-quality table, the congestion
registers, the flow cache and the two-stage selection into two entry
points:

- ``monitor_tick``: the monitor pass (refresh Q/T/D), one
  ``kernels.ops.switch_monitor`` call: on the card one launch of the
  ``cong_update`` kernel;
- ``route_batch``: a batch of arrivals: established flows take the
  cached egress (stickiness), new flows (and flows whose egress died,
  lazy failover) take the LCMP decision and are inserted into the
  cache, one ``kernels.ops.switch_route`` call: on the card one call of
  two kernels (probe and decide, then commit).

On the card ``make_switch`` builds the switch's two launchers once
(``SwitchState.monitor``, a ``kernels.ops.SwitchMonitor``, and
``SwitchState.route``, a ``kernels.ops.SwitchRoute``), each with every
pointer that is fixed for the switch; on the CPU they are None and the
plain versions (``kernels.ref.switch_monitor_ref``,
``switch_route_ref``) run. The netsim engines do not run this object
(they wire the same cores per step through the fused ``monitor_tick`` and
``route_arrivals``, with flow stickiness in the per-flow state).

Differences from the reference, by design:
- ``SwitchState.c_cong`` keeps the per-port ``C_cong`` that the monitor
  pass returns with the registers (initially the score of zeroed
  registers), which ``route_batch`` reads; ``candidate_costs``
  recomputes it from the registers, as the reference does;
- on the card the switch is updated in place: ``monitor_tick`` writes the
  registers and ``c_cong``, ``route_batch`` the cache, ``gc_tick`` the
  cache's valid bits and ``set_port_liveness`` the port liveness, so an
  earlier ``SwitchState`` shares them; a batch is two launches;
- a switch with more than 8 candidates is refused on the card (by
  ``make_switch``), as the kernel takes at most 8;
- flow ids are int64 tensors holding uint32 values;
- batch collisions in the cache follow ``core.flowcache``'s rule.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as devmod
from repro_torch.core import cong as congmod
from repro_torch.core import flowcache as fc
from repro_torch.core.cong import CongParams, CongState
from repro_torch.core.pathq import PathQParams, calc_path_quality
from repro_torch.core.select import SelectParams
from repro_torch.core.tables import SwitchTables
from repro_torch.kernels import ops


@dataclasses.dataclass
class SwitchState:
    tables: SwitchTables
    c_path: torch.Tensor         # (P,) int32: installed per-candidate quality
    cand_port: torch.Tensor      # (P,) int32: egress port of each candidate
    cand_valid: torch.Tensor     # (P,) bool: candidate installed
    cong: CongState              # per-port congestion registers
    c_cong: torch.Tensor         # (num_ports,) int32: C_cong of the registers
    cache: fc.FlowCache
    port_alive: torch.Tensor     # (num_ports,) bool
    monitor: object = None       # on the card: its ops.SwitchMonitor
    route: object = None         # on the card: its ops.SwitchRoute


@dataclasses.dataclass(frozen=True)
class SwitchParams:
    pathq: PathQParams = PathQParams()
    cong: CongParams = CongParams()
    select: SelectParams = SelectParams()
    idle_timeout_us: int = 1_000_000  # flow-cache GC idle timeout


def make_switch(tables: SwitchTables, path_delay_us, path_cap_gbps,
                cand_port, num_ports: int, cache_capacity: int = 4096,
                params: SwitchParams = SwitchParams(),
                device=devmod.DEFAULT) -> SwitchState:
    """Bootstrap on ``device``: the control plane installs the tables and
    the per-path C_path scores (``tables`` must be on the same device).
    On the card this also builds the switch's two launchers, bound to
    its tensors and to ``params``' congestion and selection parameters;
    more than 8 candidates raise there."""
    dev = devmod.resolve(device)

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)
    cand_port = i32(cand_port)
    c_path = calc_path_quality(i32(path_delay_us), i32(path_cap_gbps),
                               tables.cap_thresh, params.pathq)
    cong = CongState.init(num_ports, device=dev)
    sw = SwitchState(
        tables=tables, c_path=c_path, cand_port=cand_port,
        cand_valid=torch.ones(cand_port.shape, dtype=torch.bool, device=dev),
        cong=cong, c_cong=congmod.calc_cong_cost(cong, tables, params.cong),
        cache=fc.FlowCache.init(cache_capacity, device=dev),
        port_alive=torch.ones((num_ports,), dtype=torch.bool, device=dev))
    if dev.type == "cpu":
        return sw
    return dataclasses.replace(
        sw, monitor=ops.SwitchMonitor(sw.cong, sw.c_cong, tables, params.cong),
        route=ops.SwitchRoute(sw, params.select))


def monitor_tick(sw: SwitchState, queue_cells: torch.Tensor, now_us: int,
                 params: SwitchParams = SwitchParams()) -> SwitchState:
    """Monitor pass: sample the per-port queues (cells), update the Q/T/D
    registers and C_cong (one ``switch_monitor``: on the card one
    ``cong_update`` launch, in place)."""
    cong, c_cong = ops.switch_monitor(
        sw, queue_cells.to(torch.int32).contiguous(), int(now_us), params.cong)
    return dataclasses.replace(sw, cong=cong, c_cong=c_cong)


def candidate_costs(sw: SwitchState, params: SwitchParams = SwitchParams()):
    """Per-candidate ``(C_path, C_cong, valid)`` (ports -> candidates).
    ``C_cong`` is recomputed from the registers (``cong.calc_cong_cost``)
    with plain torch ops on the switch's device, as the reference does,
    so it also checks the ``c_cong`` that the monitor pass keeps; it is
    not on ``route_batch``'s path."""
    c_cong = congmod.calc_cong_cost(sw.cong, sw.tables, params.cong)
    valid = sw.cand_valid & sw.port_alive[sw.cand_port]
    return sw.c_path, c_cong[sw.cand_port], valid


def route_batch(sw: SwitchState, flow_ids: torch.Tensor, now_us: int,
                params: SwitchParams = SwitchParams()):
    """Process a batch of arrivals; returns ``(sw', candidate_idx,
    is_new)``. Established flows (cache hit, live egress) keep their
    path; every other flow takes the fresh LCMP decision and is inserted
    (one ``switch_route`` call: on the card two launches, the cache
    written in place). The index is into the switch's candidate table."""
    cache, choice, is_new = ops.switch_route(
        sw, flow_ids.to(torch.int64).contiguous(), int(now_us), params.select)
    return dataclasses.replace(sw, cache=cache), choice, is_new


def gc_tick(sw: SwitchState, now_us: int,
            params: SwitchParams = SwitchParams()) -> SwitchState:
    cache = fc.garbage_collect(sw.cache, now_us, params.idle_timeout_us)
    if sw.route is None:
        return dataclasses.replace(sw, cache=cache)
    sw.cache.valid.copy_(cache.valid)   # on the card: in place
    return sw


def set_port_liveness(sw: SwitchState, port_alive) -> SwitchState:
    """Data-plane port liveness update (fast-failover input)."""
    alive = torch.as_tensor(port_alive, dtype=torch.bool,
                            device=sw.port_alive.device)
    if sw.route is None:
        return dataclasses.replace(sw, port_alive=alive)
    sw.port_alive.copy_(alive)          # on the card: in place
    return sw
