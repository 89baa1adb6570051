"""The LCMP DCI-switch state machine (paper Fig. 2 runtime workflow);
counterpart of ``repro/core/switchd.py``.

Composes the bootstrap tables, the path-quality table, the congestion
registers, the flow cache and the two-stage selection into two entry
points:

- ``monitor_tick``: the monitor pass (refresh Q/T/D), one
  ``kernels.ops.cong_update`` call;
- ``route_batch``: a batch of arrivals: established flows take the
  cached egress (stickiness), new flows (and flows whose egress died,
  lazy failover) run the full decision, one ``kernels.ops.lcmp_decide``
  call, and are inserted into the cache.

This is the one path of the port that launches those two standalone
kernel entries: on the card the CUDA kernels of
``kernels/csrc/cong_update.cu`` and ``kernels/csrc/lcmp_decide.cu``, on
the CPU their plain versions. The netsim engines do not run this object
(they wire the same cores per step through the fused ``monitor_tick`` and
``route_arrivals``, with flow stickiness in the per-flow state).

Differences from the reference, by design:
- ``SwitchState.c_cong`` keeps the per-port ``C_cong`` that
  ``cong_update`` returns with the registers (initially the score of
  zeroed registers), where the reference recomputes it from the
  registers in ``candidate_costs``;
- on the card ``monitor_tick`` updates the registers in place (the
  kernel's contract), so the previous ``SwitchState`` shares them;
- a switch with more than 8 candidates raises on the card, as the
  kernel does;
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
    the per-path C_path scores (``tables`` must be on the same device)."""
    dev = devmod.resolve(device)

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)
    cand_port = i32(cand_port)
    c_path = calc_path_quality(i32(path_delay_us), i32(path_cap_gbps),
                               tables.cap_thresh, params.pathq)
    cong = CongState.init(num_ports, device=dev)
    return SwitchState(
        tables=tables, c_path=c_path, cand_port=cand_port,
        cand_valid=torch.ones(cand_port.shape, dtype=torch.bool, device=dev),
        cong=cong, c_cong=congmod.calc_cong_cost(cong, tables, params.cong),
        cache=fc.FlowCache.init(cache_capacity, device=dev),
        port_alive=torch.ones((num_ports,), dtype=torch.bool, device=dev))


def monitor_tick(sw: SwitchState, queue_cells: torch.Tensor, now_us: int,
                 params: SwitchParams = SwitchParams()) -> SwitchState:
    """Monitor pass: sample the per-port queues (cells), update the Q/T/D
    registers and C_cong (one ``cong_update``)."""
    cong, c_cong = ops.cong_update(
        sw.cong, queue_cells.to(torch.int32).contiguous(), int(now_us),
        sw.tables, params.cong)
    return dataclasses.replace(sw, cong=cong, c_cong=c_cong)


def candidate_costs(sw: SwitchState, params: SwitchParams = SwitchParams()):
    """Per-candidate ``(C_path, C_cong, valid)`` (ports -> candidates)."""
    c_cong = sw.c_cong[sw.cand_port]
    valid = sw.cand_valid & sw.port_alive[sw.cand_port]
    return sw.c_path, c_cong, valid


def route_batch(sw: SwitchState, flow_ids: torch.Tensor, now_us: int,
                params: SwitchParams = SwitchParams()):
    """Process a batch of arrivals; returns ``(sw', candidate_idx,
    is_new)``. Established flows (cache hit, live egress) keep their
    path; every other flow takes the fresh LCMP decision (one
    ``lcmp_decide`` over the batch). The index is into the switch's
    candidate table."""
    flow_ids = flow_ids.to(torch.int64).contiguous()
    # the cache stores candidate indices: a candidate is "alive" iff its
    # port is
    cand_alive = sw.port_alive[sw.cand_port] & sw.cand_valid
    hit, cached_idx, slot = fc.lookup(sw.cache, flow_ids, cand_alive)
    cache = fc.refresh(sw.cache, slot, hit, now_us)

    c_path, c_cong, valid = candidate_costs(sw, params)
    F, P = flow_ids.shape[0], c_path.shape[0]
    fresh_idx = ops.lcmp_decide(
        flow_ids, c_path.expand(F, P).contiguous(),
        c_cong.expand(F, P).contiguous(), valid.expand(F, P).contiguous(),
        params.select)
    choice = torch.where(hit, cached_idx, fresh_idx)
    cache = fc.insert(cache, flow_ids, fresh_idx, now_us, ~hit)
    return dataclasses.replace(sw, cache=cache), choice, ~hit


def gc_tick(sw: SwitchState, now_us: int,
            params: SwitchParams = SwitchParams()) -> SwitchState:
    return dataclasses.replace(
        sw, cache=fc.garbage_collect(sw.cache, now_us, params.idle_timeout_us))


def set_port_liveness(sw: SwitchState, port_alive) -> SwitchState:
    """Data-plane port liveness update (fast-failover input)."""
    return dataclasses.replace(sw, port_alive=torch.as_tensor(
        port_alive, dtype=torch.bool, device=sw.port_alive.device))
