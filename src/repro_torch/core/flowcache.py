"""Bounded flow cache: per-flow path stickiness, GC and lazy fast-failover
(paper §3.1.2 (4)/(5) and §3.4); counterpart of ``repro/core/flowcache.py``.

- entry = (flowId, outDevIdx, lastSeen); only the first packet of a flow
  runs the full cost computation, later packets hit the cache and refresh
  lastSeen (in-order delivery for RDMA);
- periodic GC evicts entries idle past a timeout;
- fast-failover is lazy: a hit whose egress is dead is a miss, and the
  entry is overwritten by a fresh decision on the packet path.

A direct-mapped hash cache (slot = fmix32(flow) % capacity) as a
struct of tensors. Flow ids are int64 tensors holding uint32 values, as
in the kernels (``core.select``).

Collisions inside one batch follow one deterministic rule, where the
reference's scatter leaves the winner to XLA's order (and CUDA's
``index_put_`` with repeated indices is nondeterministic): in
``insert`` the last lane with ``do_insert`` set wins its slot and masked
lanes write nothing; in ``refresh`` a slot is refreshed when any hit
lane maps to it. On batches whose slots are distinct both rules are the
reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as devmod
from repro_torch.core.select import fmix32

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class FlowCache:
    flow_id: torch.Tensor    # (C,) int64 holding uint32: the key
    out_idx: torch.Tensor    # (C,) int32: chosen egress/candidate index
    last_seen: torch.Tensor  # (C,) int32: microseconds
    valid: torch.Tensor      # (C,) bool

    @classmethod
    def init(cls, capacity: int, device=devmod.DEFAULT) -> "FlowCache":
        dev = devmod.resolve(device)
        return cls(
            flow_id=torch.zeros((capacity,), dtype=torch.int64, device=dev),
            out_idx=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
            last_seen=torch.zeros((capacity,), dtype=torch.int32, device=dev),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=dev))

    @property
    def capacity(self) -> int:
        return self.flow_id.shape[0]


def _key(flow_ids: torch.Tensor) -> torch.Tensor:
    return flow_ids.to(torch.int64) & _M32


def _slot(cache: FlowCache, flow_ids: torch.Tensor) -> torch.Tensor:
    return (fmix32(flow_ids) % cache.capacity).to(torch.int32)


def lookup(cache: FlowCache, flow_ids: torch.Tensor,
           port_alive: torch.Tensor):
    """Vectorized lookup. Returns ``(hit, out_idx, slot)``. A hit needs a
    valid slot, a key match and a live recorded egress: a dead egress is
    a miss (lazy failover re-decision)."""
    flow_ids = _key(flow_ids)
    slot = _slot(cache, flow_ids)
    key_ok = cache.valid[slot] & (cache.flow_id[slot] == flow_ids)
    out = cache.out_idx[slot]
    alive = port_alive.to(torch.bool)[torch.clamp_min(out, 0)]
    hit = key_ok & alive
    return hit, torch.where(hit, out, -1), slot


def refresh(cache: FlowCache, slot: torch.Tensor, hit: torch.Tensor,
            now_us: int) -> FlowCache:
    """Refresh lastSeen of every slot a hit lane maps to."""
    hits = torch.zeros((cache.capacity,), dtype=torch.int32,
                       device=slot.device).index_add_(0, slot,
                                                      hit.to(torch.int32))
    return dataclasses.replace(cache, last_seen=torch.where(
        hits > 0, int(now_us), cache.last_seen))


def insert(cache: FlowCache, flow_ids: torch.Tensor, out_idx: torch.Tensor,
           now_us: int, do_insert: torch.Tensor) -> FlowCache:
    """Record fresh decisions (the first packet of each flow). Vectorized:
    of the lanes with ``do_insert`` set (and a decision >= 0) that map to
    one slot, the last writes it; the other lanes write nothing."""
    flow_ids = _key(flow_ids)
    n = flow_ids.shape[0]
    if n == 0:
        return cache
    slot = _slot(cache, flow_ids)
    do = do_insert.to(torch.bool) & (out_idx >= 0)
    lane = torch.arange(n, dtype=torch.int64, device=flow_ids.device)
    # each slot's winner: the largest lane index writing it (max is
    # order-free, so the device's reduction order does not show)
    win = torch.full((cache.capacity,), -1, dtype=torch.int64,
                     device=flow_ids.device).scatter_reduce_(
        0, slot.to(torch.int64), torch.where(do, lane, -1), "amax")
    won, w = win >= 0, torch.clamp_min(win, 0)
    return FlowCache(
        flow_id=torch.where(won, flow_ids[w], cache.flow_id),
        out_idx=torch.where(won, out_idx.to(torch.int32)[w], cache.out_idx),
        last_seen=torch.where(won, int(now_us), cache.last_seen),
        valid=cache.valid | won)


def garbage_collect(cache: FlowCache, now_us: int,
                    idle_timeout_us: int) -> FlowCache:
    """Periodic GC: evict entries idle past the timeout (paper workflow 4)."""
    fresh = (int(now_us) - cache.last_seen) <= int(idle_timeout_us)
    return dataclasses.replace(cache, valid=cache.valid & fresh)


def invalidate_ports(cache: FlowCache, port_alive: torch.Tensor) -> FlowCache:
    """Eager failover (control-plane batch invalidation). The production
    path is the lazy one inside ``lookup``; this serves tests and
    operators who prefer eager sweeps."""
    alive = port_alive.to(torch.bool)[torch.clamp_min(cache.out_idx, 0)]
    return dataclasses.replace(cache, valid=cache.valid & alive)
