"""Collective-traffic generation: a training job as netsim flows
(counterpart of ``repro/cosim/workload.py``).

``build_plan`` resolves a ``configs/`` architecture (smoke config — the
CPU-tractable same-family reduction) and a ``launch/shapes.py`` cell
into the exact bucket structure ``dist.lcmp_collectives`` would put on
the wire: the flat gradient chopped into ``BUCKET_ELEMS`` buckets, each
bucket's wire bytes under the optional int8+scales compression, one
reduce-scatter and one all-gather burst per bucket per training
iteration across ``pods`` pods. Arrival phases are fully deterministic
(no rng): reduce-scatter buckets stagger over the first quarter of the
iteration period (backward-pass readiness order), all-gather bursts
follow half a period later on the reverse pair — so the co-simulated
rows layer onto the existing Poisson background without touching its
draw sequence (see ``overlay``).

``overlay`` appends the plan's rows to a generated ``FlowSet`` AFTER
every background rng draw is complete and re-sorts by arrival with a
stable sort, so background rows keep their exact legacy values and
relative order (pinned by ``tests/test_torch_cosim.py``). The
appended rows are identified by ``FlowSet.cosim_of`` (row -> plan
index, -1 for background), which is how ``cosim.iterate`` maps
simulation results back to iterations and buckets.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch import configs
from repro_torch.dist.lcmp_collectives import BUCKET_ELEMS, _fmix32_host
from repro_torch.dist.mesh_rules import Rules
from repro_torch.kernels.qsr_int8 import BLOCK
from repro_torch.launch import shapes as shapesmod
from repro_torch.traffic.gen import FlowSet

# pods in the geo-distributed job: one per WAN endpoint of the measured
# pair (the repo's dist layer replicates parameters across pods and
# sends gradients over the long haul, mesh_rules.py)
PODS = 2
# fraction of the iteration period the backward pass spreads its
# reduce-scatter bucket bursts over (readiness order), and the offset at
# which the optimizer's all-gather burst follows
RS_SPREAD = 0.25
AG_OFFSET = 0.5

GRAD_BYTES_PER_PARAM = 4          # f32 gradients on the wire pre-compression


@dataclasses.dataclass(frozen=True)
class CosimPlan:
    """Deterministic per-bucket flow schedule for one training run."""
    model: str                 # configs arch id (alias form)
    cell: str                  # launch/shapes cell name
    n_iters: int
    n_buckets: int
    pods: int
    period_us: int             # iteration period (duration / n_iters)
    tokens_per_iter: int       # global batch x seq (cell metadata)
    param_count: int
    compressed: bool
    # flat per-flow arrays, one row per (iteration, phase, bucket)
    arrival_us: np.ndarray     # (R,) int64
    size_bytes: np.ndarray     # (R,) float64 wire bytes on the haul
    pair_id: np.ndarray        # (R,) int32
    flow_id: np.ndarray        # (R,) uint32 nonzero hash keys
    iter_of: np.ndarray        # (R,) int32
    bucket_of: np.ndarray      # (R,) int32
    phase_of: np.ndarray       # (R,) int8  0 = reduce-scatter, 1 = all-gather

    @property
    def num_rows(self) -> int:
        return len(self.arrival_us)

    def iter_start_us(self, i) -> np.ndarray:
        return np.asarray(i, np.int64) * self.period_us


@functools.lru_cache(maxsize=16)
def _smoke_param_count(model: str) -> int:
    """Parameter count of the arch's smoke config, from its shapes (no
    weight allocation)."""
    return int(configs.get(model, smoke=True).param_count())


def bucket_wire_bytes(param_count: int, compressed: bool) -> np.ndarray:
    """(n_buckets,) wire bytes per gradient bucket, exactly the
    ``lcmp_collectives.lcmp_pod_reduce`` accounting: int8 + one f32
    scale per ``BLOCK`` elems when compressed, 4 B/elem otherwise."""
    total = int(param_count)
    nb = -(-total // BUCKET_ELEMS)
    lens = np.minimum((np.arange(nb, dtype=np.int64) + 1) * BUCKET_ELEMS,
                      total) - np.arange(nb, dtype=np.int64) * BUCKET_ELEMS
    if compressed:
        return lens + 4 * (-(-lens // BLOCK))
    return 4 * lens


def _reverse_pair(scen, table) -> int:
    """Pair id carrying the all-gather leg: the measured pair's reverse
    direction when advertised with candidates, else the forward pair
    (single-direction scenario tables)."""
    pidx = table.pair_index()
    fwd = pidx[scen.main_pair]
    rev = pidx.get((scen.main_pair[1], scen.main_pair[0]))
    if rev is not None and table.pair_ncand[rev] > 0:
        return int(rev)
    return int(fwd)


def build_plan(spec, scen, table) -> "CosimPlan":
    """Resolve ``spec.cosim_*`` knobs into a ``CosimPlan``.

    Pure function of the spec and world (no rng, no global state): the
    same spec always produces the same rows, which is what lets the
    sweep engine treat the cosim knobs as dynamic axes.
    """
    model = spec.cosim_model
    cell = shapesmod.SHAPES[spec.cosim_cell]
    if cell.kind != "train":
        raise ValueError(f"cosim needs a train cell, got {spec.cosim_cell!r}"
                         f" ({cell.kind})")
    n_iters = int(spec.cosim_iters)
    if n_iters < 1:
        raise ValueError(f"cosim_iters must be >= 1, got {n_iters}")
    period = spec.duration_us // n_iters
    if period < 1:
        raise ValueError(f"duration_us={spec.duration_us} too short for "
                         f"{n_iters} iterations")
    # the pod axis must actually shard the cell's global batch — the same
    # placement rule the training stack enforces (mesh_rules)
    cfg = configs.get(model, smoke=True)
    rules = Rules(cfg, {"pod": PODS, "data": 1, "model": 1})
    if rules.train_batch_specs(cell.batch, cell.seq)["tokens"][0] is None:
        raise ValueError(
            f"cell {cell.name!r} batch {cell.batch} does not shard across "
            f"{PODS} pods (mesh_rules placement)")

    params = _smoke_param_count(model)
    nb = -(-params // BUCKET_ELEMS)
    wire = bucket_wire_bytes(params, bool(spec.cosim_compress))
    # each leg moves (pods-1)/pods of the bucket across the haul (the
    # all_to_all reduce-scatter leg and the all_gather leg carry the
    # same bytes, lcmp_collectives._reduce_flat_*)
    leg_bytes = wire.astype(np.float64) * (PODS - 1) / PODS

    pidx = table.pair_index()
    rs_pair = int(pidx[scen.main_pair])
    ag_pair = _reverse_pair(scen, table)

    b = np.arange(nb, dtype=np.int64)
    # deterministic intra-burst stagger: bucket b of the backward pass
    # becomes ready at b/nb of the RS spread window
    rs_off = (b * int(period * RS_SPREAD)) // max(nb, 1)
    ag_off = int(period * AG_OFFSET) + rs_off
    bucket_ids = _fmix32_host(np.arange(nb, dtype=np.uint32) + np.uint32(1))

    arrs, sizes, pairs, fids, its, bks, phs = [], [], [], [], [], [], []
    for i in range(n_iters):
        start = i * period
        for phase, (off, pid) in enumerate(((rs_off, rs_pair),
                                            (ag_off, ag_pair))):
            arrs.append(start + off)
            sizes.append(leg_bytes)
            pairs.append(np.full(nb, pid, np.int32))
            salt = np.uint32(((2 * i + phase + 1) * 0x9E3779B9)
                             & 0xFFFFFFFF)
            fid = _fmix32_host(bucket_ids ^ salt)
            fids.append(np.where(fid == 0, np.uint32(1), fid))
            its.append(np.full(nb, i, np.int32))
            bks.append(b.astype(np.int32))
            phs.append(np.full(nb, phase, np.int8))

    return CosimPlan(
        model=model, cell=cell.name, n_iters=n_iters, n_buckets=nb,
        pods=PODS, period_us=int(period),
        tokens_per_iter=cell.batch * cell.seq, param_count=params,
        compressed=bool(spec.cosim_compress),
        arrival_us=np.concatenate(arrs).astype(np.int64),
        size_bytes=np.concatenate(sizes),
        pair_id=np.concatenate(pairs),
        flow_id=np.concatenate(fids),
        iter_of=np.concatenate(its),
        bucket_of=np.concatenate(bks),
        phase_of=np.concatenate(phs))


def overlay(fs: FlowSet, plan: CosimPlan) -> FlowSet:
    """Layer the plan's collective rows onto a generated background set.

    Runs AFTER every rng draw of ``traffic.gen.generate`` (the plan is
    rng-free), and merges with a *stable* sort on arrival time — so the
    background rows keep their exact legacy values and relative order
    bit-for-bit, and the combined set stays arrival-sorted as the
    engines require. Collective rows are foreground (they are the
    measured workload) and carry ``cosim_of`` back-references; with an
    ``amp`` subflow set they join as singleton parents so parent-level
    metrics stay well-defined.
    """
    F, R = fs.num_flows, plan.num_rows
    arrival = np.concatenate([fs.arrival_us,
                              plan.arrival_us]).astype(np.int64)
    size = np.concatenate([fs.size_bytes, plan.size_bytes])
    pair = np.concatenate([fs.pair_id,
                           plan.pair_id]).astype(np.int32)
    fid = np.concatenate([fs.flow_id, plan.flow_id]).astype(np.uint32)
    fg = np.concatenate([fs.foreground, np.ones(R, bool)])
    cosim_of = np.concatenate([np.full(F, -1, np.int32),
                               np.arange(R, dtype=np.int32)])
    subflow_of = None
    if fs.subflow_of is not None:
        base = int(fs.subflow_of.max()) + 1 if F else 0
        subflow_of = np.concatenate([
            fs.subflow_of, base + np.arange(R, dtype=np.int32)])

    order = np.argsort(arrival, kind="stable")
    pick = lambda a: a[order]
    return FlowSet(arrival_us=pick(arrival), size_bytes=pick(size),
                   pair_id=pick(pair), flow_id=pick(fid),
                   fg_mask=pick(fg),
                   subflow_of=(pick(subflow_of) if subflow_of is not None
                               else None),
                   cosim_of=pick(cosim_of),
                   dose_pair=fs.dose_pair, dose_target=fs.dose_target,
                   dose_real=fs.dose_real)
