"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``): run every
(arch x shape x mesh) cell on the production meshes ((16, 16) single-pod
and (2, 16, 16) multi-pod) without a cluster, and price what one chip of
the mesh does with the H100 roofline (``launch/roofline``).

Where the reference lowers a cell onto 512 fake host devices and reads
XLA's analyses, the port runs the cell's step once on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage) as rank 0 of
a fake process group as large as the mesh, with parameters, optimizer
state, inputs and caches placed as DTensors by ``dist.mesh_rules``.
DTensor's sharding propagation inserts the collectives as it would on
the cluster, and ``StepCounter`` counts what rank 0 runs:

- FLOPs: the matmul-class ops on local tensors (torch's FLOP formulas).
  Ops on DTensors are not counted: each runs again as a local op on the
  rank's shards, which is counted, and the shape propagation DTensor
  runs on global shapes is skipped;
- HBM bytes: the input and output bytes of every local op that is not a
  view, an unfused upper bound (XLA's "bytes accessed" is counted after
  fusion);
- collectives: the collective ops DTensor issues (``_c10d_functional``,
  and ``_dtensor.shard_dim_alltoall``: on the CPU DTensor gathers and
  chunks where it exchanges with an all-to-all on the card, so a CPU dry
  run's collectives and memory differ from the card's), their result
  bytes and group size, turned into wire bytes by the roofline's ring
  factors;
- memory: ``args`` the local bytes of parameters, optimizer state and
  inputs (the train step takes the global batch on every rank and keeps
  its rows), ``out`` those of the outputs, ``temp`` the peak of live local
  bytes during the step less ``args``.

Eager execution runs every layer, so nothing is counted once per loop as
in the reference; ``_depth_points`` and ``_extrapolate`` still serve, to
count two cut depths and extrapolate to the full one, which is exact
where a layer's counts do not depend on its depth, and cheaper than
running every layer. The CLI does that unless ``--no-depth-correction``.

Usage (the fake tensors lie on the card by default, which needs one;
``--device cpu`` runs without):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.dist.lcmp_collectives import tree_flatten
from repro_torch.dist.mesh_rules import (is_dtensor, make_rules, map_with_path,
                                         placements)
from repro_torch.launch import roofline as rl
from repro_torch.launch.shapes import (SHAPES, ShapeCell, input_specs,
                                      skip_reason)

# collective op (``_c10d_functional``, and the all-to-all DTensor issues
# on the card, ``_dtensor.shard_dim_alltoall``) -> its HLO name; another
# op of these namespaces but ``wait_tensor`` raises
_COLLECTIVE_NS = ("_c10d_functional", "_dtensor")
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_NO_WORK = ("empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "wait_tensor")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of ``tree`` (a DTensor as its local shard)."""
    return [x.to_local() if is_dtensor(x) else x
            for x in torch.utils._pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _in_sharding_propagation() -> bool:
    """Whether the current op comes from DTensor's sharding propagation,
    which runs each new op once on stand-ins of the global shapes."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _aliases(func, args, outs) -> bool:
    """Whether ``func`` only views its inputs (a view, a split, a chunk):
    no mutation, and every output on an input's storage."""
    if func.is_view:
        return True
    if func._schema.is_mutable:
        return False
    ins = {id(a.untyped_storage())
           for a in torch.utils._pytree.tree_leaves(args)
           if isinstance(a, torch.Tensor)}
    return all(id(t.untyped_storage()) in ins for t in outs)


def _group_size(func, args, kwargs) -> int:
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(named["group_name"]).size()


class StepCounter(TorchDispatchMode):
    """Counts the local work of rank 0 while active (module docstring):
    ``flops`` and ``hbm_bytes`` (ints), ``collectives`` (a list of
    ``(kind, result bytes, group size)``), and the live local bytes
    (``live``, ``peak``) of the storages that ``hold`` registered and
    that local ops made. Works on fake and on real tensors alike."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.collectives: List[Tuple[str, int, int]] = []
        self.live = 0
        self.peak = 0
        self._seen = torch.utils.weak.WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def _add(self, st, n: int) -> None:
        if st in self._seen:
            return
        self._seen[st] = weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold(self, tree) -> int:
        """Registers ``tree``'s local tensors as live (each storage once,
        at its tensor's bytes: a local shard may view a larger stand-in)
        and returns the bytes added."""
        before = self.live
        for t in _tensors(tree):
            self._add(t.untyped_storage(), _nbytes(t))
        return self.live - before

    def wire_bytes(self) -> float:
        return sum(rl.wire_bytes(k, n, g) for k, n, g in self.collectives)

    def per_kind_bytes(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, n, _ in self.collectives:
            out[k] = out.get(k, 0.0) + n
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = sys.modules.get("torch.distributed.tensor")
        if dtensor is not None and any(issubclass(t, dtensor.DTensor)
                                       for t in types):
            return NotImplemented       # DTensor runs it as local ops
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        outs = [t for t in (out if isinstance(out, (list, tuple)) else [out])
                if isinstance(t, torch.Tensor)]
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NS and name != "wait_tensor":
            if name not in _COLLECTIVES:
                raise NotImplementedError(f"the dry run counts no {func}")
            g = _group_size(func, args, kwargs)
            self.collectives.append((_COLLECTIVES[name],
                                     sum(map(_nbytes, outs)), g))
        elif outs and name not in _NO_WORK and not _aliases(func, args,
                                                            outs):
            from torch.utils.flop_counter import flop_registry
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
            self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if name == "wait_tensor":
            # returns its input; a fake one returns a new stand-in, which
            # takes over the input's bytes
            src = args[0].untyped_storage()
            if src in self._seen and outs[0].untyped_storage() is not src:
                self._seen[src]()
        for t in outs:
            st = t.untyped_storage()
            self._add(st, st.nbytes())
        return out


@dataclasses.dataclass
class StepTrace:
    """What ``lower_cell`` counted for one cell (the port's stand-in for
    the reference's compiled executable)."""
    flops: int
    hbm_bytes: int
    collectives: list
    per_kind_bytes: dict
    wire_bytes: float
    mem: dict


def trace_step(fn, state) -> StepTrace:
    """Runs ``fn()`` once under a ``StepCounter`` with ``state`` (the
    step's parameters, optimizer state and inputs) held as live, and
    returns the counts; ``fn``'s result is the step's output."""
    c = StepCounter()
    with c:
        args = c.hold(state)
        out = fn()
        out_bytes = sum(map(_nbytes, _tensors(out)))
    return StepTrace(flops=c.flops, hbm_bytes=c.hbm_bytes,
                     collectives=list(c.collectives),
                     per_kind_bytes=c.per_kind_bytes(),
                     wire_bytes=c.wire_bytes(),
                     mem=dict(args=args, out=out_bytes,
                              temp=c.peak - args))


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0:
    collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group needs no process group to be set up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _empty_tree(shapes: dict, device) -> dict:
    return {k: _empty_tree(v, device) if isinstance(v, dict)
            else torch.empty(v, dtype=torch.float32, device=device)
            for k, v in sorted(shapes.items())}


def _cell(shape) -> ShapeCell:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _meta(cfg, cell: ShapeCell, chips: int) -> dict:
    if cell.kind == "train":
        mflops = rl.model_flops_train(cfg.active_param_count(),
                                      cell.batch * cell.seq)
    elif cell.kind == "prefill":
        mflops = rl.model_flops_train(cfg.active_param_count(),
                                      cell.batch * cell.seq) / 3
    else:
        mflops = rl.model_flops_decode(cfg.active_param_count(), cell.batch)
    return dict(arch=cfg.name, shape=cell.name, chips=chips,
                model_flops=mflops)


def build_cell(cfg, shape, mesh, *, microbatches: int = 1, params=None,
               inputs=None):
    """``(fn, state)`` of one cell on ``mesh``: ``fn()`` runs the cell's
    step once and ``state`` holds what the step reads (placed
    parameters, optimizer state, inputs). Parameters are stand-ins
    (``torch.empty``, fake under a ``FakeTensorMode``) unless ``params``
    are given, and the inputs ``input_specs``'s unless ``inputs`` are
    (a real step's: its batch, or its tokens, pos and cache).

    - train: ``ShardedStep`` (forward, backward, AdamW);
    - prefill: ``forward`` without gradients, logits to the batch rows'
      placements (the reference's output sharding);
    - decode: ``decode_step`` on a cache placed by ``Rules.cache_specs``
      and tokens by ``decode_token_spec``, logits replicated."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.arch import forward, param_shapes
    from repro_torch.serve.decode import decode_step
    from repro_torch.train.optim import AdamWState
    from repro_torch.train.step import ShardedStep, TrainConfig
    cell = _cell(shape)
    dev = mesh.device_type
    rules = make_rules(cfg, mesh)
    if params is None:
        params = _empty_tree(param_shapes(cfg), dev)

    def put(t, spec):
        return distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                                 src_data_rank=None)

    if cell.kind == "train":
        step = ShardedStep(cfg, TrainConfig(microbatches=microbatches), mesh)
        leaves, rebuild = tree_flatten(params)
        zeros = lambda: rebuild([torch.zeros_like(p, requires_grad=False)
                                 for p in leaves])
        opt = AdamWState(count=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=zeros(), nu=zeros())
        p, o = step.place(params, opt)
        batch = inputs or input_specs(cfg, cell, device=dev)
        del params, opt, leaves
        return (lambda: step(p, o, batch)), (p, o, batch)

    placed = map_with_path(params, lambda path, t: put(
        t, rules._leaf_spec(path, tuple(t.shape))))
    del params
    ins = dict(inputs or input_specs(cfg, cell, device=dev))
    if cell.kind == "prefill":
        ins.pop("labels", None)
        bspecs = rules.train_batch_specs(cell.batch, cell.seq)
        batch = {k: put(v, bspecs[k]) for k, v in ins.items()}
        out_pl = placements((bspecs["tokens"][0], None, None), mesh)

        @torch.no_grad()
        def prefill():
            with implicit_replication():
                logits = forward(placed, cfg, batch["tokens"],
                                 extra=batch.get("extra"))
            return logits.redistribute(mesh, out_pl)
        return prefill, (placed, batch)

    cache = map_with_path(ins["cache"], lambda path, t: put(
        t, rules._cache_leaf_spec(path, tuple(t.shape))))
    tokens = put(ins["tokens"], rules.decode_token_spec(cell.batch))
    pos = ins["pos"]
    replicated = [Replicate()] * mesh.ndim

    def serve():
        with implicit_replication():
            logits, new = decode_step(placed, cfg, cache, tokens, pos)
        return logits.redistribute(mesh, replicated), new
    return serve, (placed, cache, tokens, pos)


def lower_cell(cfg, shape_name, mesh, *, microbatches: int = 1):
    """Run one cell's step once on fake tensors on ``mesh`` (a mesh over
    a fake process group as large as it: ``fake_group``). Returns
    ``(trace, meta)``; ``shape_name`` may also be a ``ShapeCell``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cell = _cell(shape_name)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, state = build_cell(cfg, cell, mesh, microbatches=microbatches)
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        trace = trace_step(fn, state)
    t_run = time.perf_counter() - t0
    meta = _meta(cfg, cell, mesh.size())
    meta.update(t_lower_s=round(t_lower, 1), t_compile_s=round(t_run, 1))
    return trace, meta


def _raw_measurements(trace: StepTrace) -> dict:
    return dict(
        flops=trace.flops,
        hbm_bytes=trace.hbm_bytes,
        coll_wire=trace.wire_bytes,
        coll_ops=len(trace.collectives),
        coll_by_kind=trace.per_kind_bytes,
        mem=dict(trace.mem),
    )


def _depth_points(cfg):
    """Reduced-depth variants for the depth extrapolation.

    The reference needs them because XLA's cost_analysis counts a
    while-loop body once; the port runs every layer, so its counts are
    exactly affine in depth and two (three for enc-dec) cut depths give
    the full depth's without running it. Calibrate on L = 2*step and
    3*step, as the reference does."""
    import dataclasses as dc
    if cfg.family == "encdec":
        return [dc.replace(cfg, n_layers=2, n_enc_layers=2),
                dc.replace(cfg, n_layers=3, n_enc_layers=2),
                dc.replace(cfg, n_layers=2, n_enc_layers=3)]
    step = 2 if cfg.alt_local_global else 1
    return [dc.replace(cfg, n_layers=2 * step),
            dc.replace(cfg, n_layers=3 * step)]


def _extrapolate(cfg, pts, key):
    """Affine extrapolation of measurement ``key`` to the full depth."""
    if cfg.family == "encdec":
        a1, a2, a3 = [p[key] for p in pts]     # (2,2), (3,2), (2,3)
        b_dec, c_enc = a2 - a1, a3 - a1
        base = a1 - 2 * b_dec - 2 * c_enc
        return base + b_dec * cfg.n_layers + c_enc * cfg.n_enc_layers
    step = 2 if cfg.alt_local_global else 1
    a1, a2 = [p[key] for p in pts]             # L = 2*step, 3*step
    b = (a2 - a1) / step
    base = a1 - b * 2 * step
    return base + b * cfg.n_layers


def analyze(trace: StepTrace, meta: dict, depth_pts=None, cfg=None) -> dict:
    """The reference's record for one cell, priced with the H100's
    constants (named under ``constants``). With ``depth_pts`` (the
    ``_raw_measurements`` of ``_depth_points(cfg)``) every count,
    memory included, is extrapolated to ``cfg``'s depth; ``trace`` is
    then one of the cut depths' and stands under ``raw_once_counted``.
    FLOPs, bytes, wire bytes and ``args`` are affine in depth; ``temp``
    is where the step's peak falls at the same point at every depth."""
    raw = _raw_measurements(trace)
    flops, nbytes, wire = raw["flops"], raw["hbm_bytes"], raw["coll_wire"]
    mem = dict(raw["mem"])
    corrected = False
    if depth_pts is not None and cfg is not None:
        flops = _extrapolate(cfg, depth_pts, "flops")
        nbytes = _extrapolate(cfg, depth_pts, "hbm_bytes")
        wire = _extrapolate(cfg, depth_pts, "coll_wire")
        mems = [p["mem"] for p in depth_pts]
        mem = {k: int(round(_extrapolate(cfg, mems, k))) for k in mem}
        corrected = True
    coll = rl.CollectiveStats(raw["coll_by_kind"], wire, raw["coll_ops"])
    roof = rl.roofline({"flops": flops, "bytes accessed": nbytes}, coll,
                       meta["chips"], meta["model_flops"], chip=rl.H100)
    out = dict(meta)
    out.update(
        bytes_per_device=dict(mem, peak=mem["args"] + mem["temp"]),
        flops_per_device=flops,
        hbm_bytes_per_device=nbytes,
        coll_wire_bytes_per_chip=wire,
        raw_once_counted=dict(flops=raw["flops"], hbm_bytes=raw["hbm_bytes"],
                              coll_wire=raw["coll_wire"]),
        depth_corrected=corrected,
        coll_ops=raw["coll_ops"],
        coll_by_kind=raw["coll_by_kind"],
        t_comp=roof.t_comp, t_mem=roof.t_mem, t_coll=roof.t_coll,
        bottleneck=roof.bottleneck, useful_ratio=roof.useful_ratio,
        constants=rl.H100.name,
    )
    return out


def run_cell(cfg, shape, mesh, *, microbatches: int = 1,
             depth_correction: bool = True) -> dict:
    """One cell's record: the full depth, or (``depth_correction``) two
    or three cut depths extrapolated to it."""
    if not depth_correction:
        trace, meta = lower_cell(cfg, shape, mesh, microbatches=microbatches)
        return analyze(trace, meta)
    pts, t_lower, t_run = [], 0.0, 0.0
    for cfg_v in _depth_points(cfg):
        trace, meta_v = lower_cell(cfg_v, shape, mesh,
                                   microbatches=microbatches)
        pts.append(_raw_measurements(trace))
        t_lower += meta_v["t_lower_s"]
        t_run += meta_v["t_compile_s"]
    meta = _meta(cfg, _cell(shape), mesh.size())
    meta.update(t_lower_s=round(t_lower, 1), t_compile_s=round(t_run, 1))
    return analyze(trace, meta, pts, cfg)


def skip_record(arch: str, shape: str, mesh_name: str) -> Optional[dict]:
    """The record of a cell the shape rules skip, else None."""
    reason = skip_reason(configs.get(arch), shape)
    if not reason:
        return None
    return dict(arch=arch, shape=shape, mesh=mesh_name, status="skip",
                reason=reason)


def _fail_record(arch: str, shape: str, mesh_name: str, error: str,
                 trace: str) -> dict:
    return dict(arch=arch, shape=shape, mesh=mesh_name, status="fail",
                error=error, trace=trace[-2000:])


def _in_process(cells: list, device: str, flags: dict) -> list:
    from repro_torch.launch.mesh import make_production_mesh
    records = [None] * len(cells)
    for mesh_name in dict.fromkeys(m for _, _, m in cells):
        multi_pod = mesh_name == "multi"
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=device)
            for i, (arch, shape, m) in enumerate(cells):
                if m != mesh_name:
                    continue
                try:
                    rec = run_cell(configs.get(arch), shape, mesh, **flags)
                    rec.update(mesh=mesh_name, status="ok")
                except Exception as e:  # a failure here is a sharding bug
                    rec = _fail_record(arch, shape, mesh_name,
                                       f"{type(e).__name__}: {e}",
                                       traceback.format_exc())
                records[i] = rec
    return records


def _start_order(cell: tuple) -> tuple:
    """The order in which parallel cells start: the ssm family's train and
    prefill cells first (its mamba-1 scan runs each position as ops of
    its own, minutes a cell where every other cell takes seconds), then
    the multi-pod mesh's."""
    arch, shape, mesh_name = cell
    slow = (configs.get(arch).family == "ssm"
            and SHAPES[shape].kind != "decode")
    return (not slow, mesh_name != "multi")


def _in_subprocesses(cells: list, device: str, flags: dict, jobs: int,
                     timeout: Optional[float]) -> list:
    import repro_torch
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(repro_torch.__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    extra = ["--microbatches", str(flags["microbatches"])]
    if not flags["depth_correction"]:
        extra.append("--no-depth-correction")
    records = [None] * len(cells)
    pending = sorted(range(len(cells)), key=lambda i: _start_order(cells[i]))
    running = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            while pending or running:
                while pending and len(running) < jobs:
                    i = pending.pop(0)
                    arch, shape, mesh_name = cells[i]
                    out = open(os.path.join(tmp, f"{i}.out"), "w+")
                    err = open(os.path.join(tmp, f"{i}.err"), "w+")
                    p = subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", arch, "--shape", shape, "--mesh",
                         mesh_name, "--device", device] + extra,
                        stdout=out, stderr=err, env=env)
                    running[i] = (p, time.monotonic(), out, err)
                time.sleep(0.1)
                for i, (p, t0, out, err) in list(running.items()):
                    late = (timeout is not None
                            and time.monotonic() - t0 > timeout)
                    if p.poll() is None:
                        if not late:
                            continue
                        p.kill()
                        p.wait()
                    del running[i]
                    out.seek(0)
                    err.seek(0)
                    lines = [ln for ln in out.read().splitlines()
                             if ln.startswith("{")]
                    tail = err.read()
                    out.close()
                    err.close()
                    if lines:
                        records[i] = json.loads(lines[-1])
                    else:
                        records[i] = _fail_record(
                            *cells[i], f"timed out after {timeout} s" if late
                            else f"exit code {p.returncode}, no record", tail)
        finally:
            for p, _, out, err in running.values():
                p.kill()
                p.wait()
                out.close()
                err.close()
    return records


def run_cells(cells, *, device: str, jobs: int = 1, microbatches: int = 1,
              depth_correction: bool = True,
              timeout: Optional[float] = None) -> List[dict]:
    """The records of ``cells`` ((arch, shape, mesh name) triples, mesh
    ``single`` or ``multi``) in their order: a skip record where the
    shape rules skip the cell, else ``run_cell``'s (``status`` ``ok``) or
    a ``fail`` record with the error. With ``jobs`` > 1 each cell runs in
    a process of the CLI of its own, ``jobs`` at a time, one that runs
    past ``timeout`` seconds killed and failed; else all run in this
    process, one fake group a mesh."""
    cells = [tuple(c) for c in cells]
    flags = dict(microbatches=microbatches,
                 depth_correction=depth_correction)
    skips = [skip_record(*c) for c in cells]
    todo = [c for c, r in zip(cells, skips) if r is None]
    if jobs > 1:
        done = iter(_in_subprocesses(todo, device, flags, jobs, timeout))
    else:
        done = iter(_in_process(todo, device, flags))
    return [r if r is not None else next(done) for r in skips]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--out", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-depth-correction", action="store_true",
                    help="run every layer instead of two cut depths "
                         "extrapolated to the full one")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run each cell in a process of its own, this "
                         "many at a time")
    ap.add_argument("--device", default=devmod.DEFAULT,
                    help="device of the fake tensors (cuda needs a card)")
    args = ap.parse_args(argv)
    device = devmod.resolve(args.device).type

    meshes = [m for m in ("single", "multi") if args.mesh in (m, "both")]
    pairs = ([(a, s) for a in configs.ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    records = run_cells([(a, s, m) for m in meshes for a, s in pairs],
                        device=device, jobs=args.jobs,
                        microbatches=args.microbatches,
                        depth_correction=not args.no_depth_correction)
    lines = [json.dumps(rec) for rec in records]
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    failures = sum(rec["status"] == "fail" for rec in records)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
