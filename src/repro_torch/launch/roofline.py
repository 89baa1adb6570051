"""Roofline arithmetic for the dry run (counterpart of
``repro/launch/roofline.py``, which it equals bit for bit).

Three terms per (arch x shape x mesh) cell, for one chip of the mesh:
  t_comp = FLOPs per device / peak dense bf16 FLOP/s
  t_mem  = HBM bytes per device / HBM bytes/s
  t_coll = wire bytes per chip / link bytes/s (one link each way)

The constants come in sets (``Chip``). ``V5E`` is the reference's TPU
v5e set (197e12 FLOP/s, 819e9 B/s HBM, 50e9 B/s ICI), kept under the
reference's names ``PEAK_FLOPS``, ``HBM_BW`` and ``ICI_BW``; ``roofline``
uses it unless it is handed another. ``H100`` is NVIDIA's data sheet for
the H100 SXM part at its 700 W limit: 989e12 dense bf16 FLOP/s, 3.35e12
B/s HBM, and 450e9 B/s of NVLink each way (900 GB/s both ways, to every
card of an NVLink domain; a (16, 16) mesh of 256 cards is taken as one
domain, so every collective runs at that rate). The dry run passes
``H100``.

Collective bytes: ``parse_collectives`` reads the post-SPMD HLO text the
reference compiles (``compiled.as_text()``) and sums the result-shape
bytes of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute; the port's dry run counts the collectives DTensor
issues from their tensors instead. Both turn result bytes into per-chip
wire bytes with the ring factors of ``wire_bytes``, g the group size:
  all-reduce      2 (g-1)/g x result bytes
  all-gather      (g-1)/g x result bytes (result = gathered)
  reduce-scatter  (g-1)/g x input bytes  (= result x g)
  all-to-all      (g-1)/g x bytes
  collective-permute  1 x bytes
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Chip:
    """One chip's peak rates: dense bf16 FLOP/s, HBM bytes/s, and the
    bytes/s of the link a collective's wire bytes cross."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


V5E = Chip("tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
H100 = Chip("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)

PEAK_FLOPS = V5E.peak_flops        # bf16 / chip
HBM_BW = V5E.hbm_bw                # B/s / chip
ICI_BW = V5E.link_bw               # B/s / link

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[\w\[\],{}\s]+?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(", re.M)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(sig: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(sig):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def wire_bytes(kind: str, nbytes, g: int) -> float:
    """Per-chip wire bytes of one collective of ``kind`` (an HLO name)
    whose result holds ``nbytes``, over a group of ``g`` chips."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * nbytes
    if kind == "all-gather":
        return (g - 1) / g * nbytes
    if kind == "reduce-scatter":
        return (g - 1) / g * nbytes * g       # input bytes = result x g
    if kind == "all-to-all":
        return (g - 1) / g * nbytes
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    per_kind_bytes: Dict[str, float]
    wire_bytes_per_chip: float
    num_ops: int

    def row(self) -> str:
        return ";".join(f"{k}={v:.3e}" for k, v in
                        sorted(self.per_kind_bytes.items()))


def parse_collectives(hlo_text: str) -> CollectiveStats:
    per_kind: Dict[str, float] = {}
    wire = 0.0
    n_ops = 0
    for line in hlo_text.splitlines():
        m = _COLL_RE.match(line)
        if not m or "-done(" in line:
            continue
        sig, kind = m.group(1), m.group(2)
        nbytes = _shape_bytes(sig)
        if nbytes == 0:
            continue
        per_kind[kind] = per_kind.get(kind, 0.0) + nbytes
        wire += wire_bytes(kind, nbytes, _group_size(line))
        n_ops += 1
    return CollectiveStats(per_kind, wire, n_ops)


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return max(len(m.group(1).split(",")), 1)
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return max(int(m.group(2)), 1)
    return 2


def _scan_trip_count(hlo_text: str) -> int:
    """Collectives inside the depth scan execute trip_count times but the
    HLO lists them once; cost_analysis already multiplies FLOPs by trip
    count, so we scale collective bytes by the scan trip count too (the
    dominant while loop)."""
    trips = [int(t) for t in re.findall(r"trip_count=(\d+)", hlo_text)]
    return max(trips, default=1)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_wire_bytes: float
    chips: int
    t_comp: float
    t_mem: float
    t_coll: float
    bottleneck: str
    model_flops: float
    useful_ratio: float

    def derived(self) -> str:
        return (f"t_comp={self.t_comp:.3e}s;t_mem={self.t_mem:.3e}s;"
                f"t_coll={self.t_coll:.3e}s;bound={self.bottleneck};"
                f"useful={self.useful_ratio:.2f}")


def roofline(cost: dict, coll: CollectiveStats, chips: int,
             model_flops: float, scan_trips: int = 1, *,
             chip: Chip = V5E) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    wire = coll.wire_bytes_per_chip * scan_trips
    t_comp = flops / chip.peak_flops
    t_mem = nbytes / chip.hbm_bw
    t_coll = wire / chip.link_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bound = max(terms, key=terms.get)
    useful = model_flops / (flops * chips) if flops else 0.0
    return Roofline(flops=flops, hbm_bytes=nbytes, coll_wire_bytes=wire,
                    chips=chips, t_comp=t_comp, t_mem=t_mem, t_coll=t_coll,
                    bottleneck=bound, model_flops=model_flops,
                    useful_ratio=useful)


def model_flops_train(n_active: int, tokens: int) -> float:
    return 6.0 * n_active * tokens


def model_flops_decode(n_active: int, tokens: int) -> float:
    return 2.0 * n_active * tokens
