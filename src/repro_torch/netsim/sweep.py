"""Batched scenario sweep: a figure's whole grid as one world per static
group (counterpart of ``repro/netsim/sweep.py``).

The paper's evaluation is a grid of experiment cells (topologies x
workloads x loads x policies x seeds, §6). ``run_sweep``:

1. groups the cells by their *static* key (``static_key``), as the
   reference does: the scenario string and the configuration with the
   policy replaced by the ``sweep`` meta-policy, so every cell of a
   group has the same world, engine, schedules, CC law, horizon and
   parameters, and the policy is a per-cell law code (fluid and packet
   cells form separate groups);
2. builds each cell of a group with its own policy and traffic and joins
   them into one block-diagonal world (``engine.merge_cells``): cell c's
   links, paths, pairs and flows follow the earlier cells', a step's
   arrival row is the cells' rows side by side, and each pair carries
   its cell's law code (``SimArrays.pair_policy``), which the route and
   decide kernels read per arrival;
3. runs that world through the group's engine once (one
   ``monitor_tick`` and one ``route_arrivals`` launch a step on the card
   for the whole group) and slices each cell's final state back out
   (``engine.slice_cell``) for its metrics.

The cells share no link, so no float sum mixes two cells: on the CPU
each cell's result equals the sequential loop's bit for bit (the packet
step's parked 0.0 contributions may land on another cell's links, which
leaves its sums as they were). On the card both steps sum per link in
float64, where the order of the atomics does not show, so a cell's sums
are its sequential run's. With ``checks`` the merged run is sanitized
and raises after it, as the reference's group runner does.

With ``use_mesh`` each group's cells split over ``ndev`` devices
(``mesh_devices``: ``min(devices or visible, visible)``, one visible on
the CPU, as the reference's one host device), each shard its own merged
world, run by one worker process per device (``run_sharded``). The
reference pads a chunk's cell axis to the mesh and runs ``shard_map``;
here cells share no link, so any split leaves every cell's numbers as
they were, and nothing is padded. The worker processes are what spread
the host's work: the engine step is host-bound, so one thread driving
several cards would be slower than one merged world on one card.

Not carried over from the reference, since nothing is padded: the
per-cell padding of the flow tables (``_pad_cell``, the reference
engine's ``STATE_PAD``), the chunking of a group by flow
count (``_chunk_by_flows``, ``max_pad_frac``) and the 512-flow
vmap/map crossover (``_VMAP_MAX_FLOWS``, a measurement of XLA's
batched-scatter lowering on a CPU), with the reference's
``batch_mode`` option: every group runs merged, and ``sequential=True``
is the cell-by-cell loop.
"""
from __future__ import annotations

import dataclasses
import queue
import time
import traceback
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.kernels import ops
from repro_torch.netsim import engine, metrics
from repro_torch.netsim.experiment import (ExpSpec, build_world, make_flows,
                                           run_experiment, spec_to_cfg)
from repro_torch.netsim.sanitize import InvariantError

@dataclasses.dataclass
class CellResult:
    """One cell's outputs, sliced back out of its group (numpy)."""
    spec: ExpSpec
    stats: metrics.FCTStats
    util: np.ndarray           # (L,) effective-capacity utilization
    # done / fct_us / flow_path / serv_bytes / c_path / route_nonce
    final: SimpleNamespace
    flows: object              # the cell's FlowSet
    # foreground/background split when the cell doses cross-traffic
    # (spec.bg_load > 0); stats_fg is stats and stats_bg None otherwise
    stats_fg: metrics.FCTStats = None
    stats_bg: metrics.FCTStats = None


@dataclasses.dataclass
class SweepReport:
    results: List[CellResult]  # in the order of the input specs
    num_cells: int
    num_groups: int            # static groups (one world each)
    wall_s: float
    group_cells: List[int]     # cells per group
    # per worker process of a sharded run (``run_sharded``): its device,
    # start-up seconds, launches and peak device bytes; None in process
    workers: Optional[List[dict]] = None

    def __iter__(self):
        return iter(self.results)


@dataclasses.dataclass
class Group:
    """One static group, built and merged: ``arrs``/``state`` the merged
    world, ``cfg`` its sweep configuration, and per cell (in the order of
    ``specs``) its slice, flows and own arrays."""
    specs: List[ExpSpec]
    table: object
    cfg: engine.SimConfig
    arrs: engine.SimArrays
    state: engine.SimState
    slices: List[engine.CellSlice]
    flows: list
    cell_arrs: list


def static_key(spec: ExpSpec):
    """Everything that makes a separate world: the scenario string and
    the configuration with the policy replaced by ``sweep``. Load, seed,
    workload, pairs, bg_load and load_sched only change the traffic, and
    the policy is a per-cell law code."""
    scen, _ = build_world(spec.topology)
    return (spec.topology,
            dataclasses.replace(spec_to_cfg(spec, scen), policy="sweep"))


def group_config(specs: Sequence[ExpSpec], key=None):
    """``(topology, cfg)`` of one static group: its ``static_key`` (the
    one ``key`` given, else computed and checked for every spec), with the
    sweep narrowed to the policies present (in ``engine.POLICIES``
    order), so a law no cell takes costs nothing in the step."""
    if key is None:
        keys = {static_key(s) for s in specs}
        if len(keys) != 1:
            raise ValueError(f"the specs span {len(keys)} static groups, "
                             "not one")
        key, = keys
    topology, cfg = key
    present = {s.policy for s in specs}
    return topology, dataclasses.replace(cfg, sweep_policies=tuple(
        p for p in engine.POLICIES if p in present))


def build_group(specs: Sequence[ExpSpec], device=devmod.DEFAULT,
                key=None) -> Group:
    """Build the cells of one static group on ``device``, each with its
    own policy, and merge them into one world (``group_config``)."""
    dev = devmod.resolve(device)
    topology, cfg = group_config(specs, key)
    scen, table = build_world(topology)
    eng = engine.get_engine(cfg.engine)
    built, flows = [], []
    for spec in specs:
        fl = make_flows(spec, scen, table)
        built.append(eng.build(table, fl, dataclasses.replace(
            cfg, policy=spec.policy), device=dev))
        flows.append(fl)
    arrs, state, slices = engine.merge_cells(built)
    return Group(list(specs), table, cfg, arrs, state, slices, flows,
                 [a for a, _ in built])


def _view(st) -> SimpleNamespace:
    return SimpleNamespace(**{n: getattr(st, n).cpu().numpy() for n in (
        "done", "fct_us", "flow_path", "serv_bytes", "c_path",
        "route_nonce")})


def run_group(group: Group) -> List[CellResult]:
    """Run a merged group over its horizon and score each cell. The
    group's state is consumed (updated in place)."""
    final = engine.get_engine(group.cfg.engine).run(group.arrs, group.state,
                                                    group.cfg)
    out, cfg, table = [], group.cfg, group.table
    for spec, sl, flows, arrs in zip(group.specs, group.slices, group.flows,
                                     group.cell_arrs):
        cell = engine.slice_cell(final, sl)
        stats = metrics.fct_stats(cell, table, flows, cfg)
        fg, bg = metrics.fg_bg_stats(cell, table, flows, cfg, overall=stats)
        out.append(CellResult(
            spec=spec, stats=stats,
            util=metrics.link_utilization(cell, arrs, cfg),
            final=_view(cell), flows=flows, stats_fg=fg, stats_bg=bg))
    return out


def _static_groups(specs: Sequence[ExpSpec]) -> dict:
    """static key -> the indices of its cells, both in input order."""
    groups: dict = {}
    for i, spec in enumerate(specs):
        groups.setdefault(static_key(spec), []).append(i)
    return groups


def mesh_devices(device, devices: Optional[int] = None) -> List[torch.device]:
    """The devices a ``use_mesh`` sweep on ``device`` spreads over:
    ``min(devices or visible, visible)`` cards, ``visible`` being
    ``torch.cuda.device_count()`` on the card and 1 on the CPU (the
    reference's one host device), so a CPU sweep stays in process."""
    dev = devmod.resolve(device)
    if devices is not None and devices < 0:
        raise ValueError(f"devices must be >= 0, got {devices}")
    if dev.type != "cuda":
        return [dev]
    visible = torch.cuda.device_count()
    return [torch.device("cuda", i)
            for i in range(min(devices or visible, visible))]


def run_sweep(specs: Sequence[ExpSpec], sequential: bool = False,
              use_mesh: bool = False, devices: Optional[int] = None,
              device=devmod.DEFAULT) -> SweepReport:
    """Run a grid of experiment cells on ``device``, one merged world per
    static group.

    Args:
      specs: the grid, any mix of scenarios, loads, policies, seeds, ...
      sequential: run ``run_experiment`` cell by cell instead (the
        baseline the batched run must equal).
      use_mesh: split each group's cells over ``mesh_devices(device,
        devices)``, one worker process per card (``run_sharded``); with
        one device (always on the CPU) the merged run in this process.
      devices: cap on the cards ``use_mesh`` takes (None: all visible).
      device: ``"cuda"`` (default; raises without a card) or ``"cpu"``.
    """
    dev = devmod.resolve(device)
    if use_mesh and not sequential:
        devs = mesh_devices(dev, devices)
        if len(devs) > 1:
            return run_sharded(specs, devs)
    t0 = time.perf_counter()
    if sequential:
        results = []
        for spec in specs:
            stats, util, (_, table, flows, cfg, final) = run_experiment(
                spec, device=dev)
            fg, bg = metrics.fg_bg_stats(final, table, flows, cfg,
                                         overall=stats)
            results.append(CellResult(spec=spec, stats=stats, util=util,
                                      final=_view(final), flows=flows,
                                      stats_fg=fg, stats_bg=bg))
        return SweepReport(results, len(results), len(results),
                           time.perf_counter() - t0, [1] * len(results))

    groups = _static_groups(specs)
    results: List[Optional[CellResult]] = [None] * len(specs)
    for key, idxs in groups.items():
        group = build_group([specs[i] for i in idxs], device=dev, key=key)
        for i, res in zip(idxs, run_group(group)):
            results[i] = res
        del group             # the world's memory, before the next is built
    return SweepReport(results, len(specs), len(groups),
                       time.perf_counter() - t0,
                       [len(idxs) for idxs in groups.values()])


# ------------------------------------------------------- sharded sweeps
_POLL_S = 0.25          # how often a wait for workers checks they live
_JOIN_S = 30.0          # grace for a worker to exit after its last task


def _serve(wid: int, device: str, threads: int, initializer, tasks,
           replies) -> None:
    """One worker process of ``SweepWorkers``: set up on ``device``, say
    ``ready``, then build and run each group shard it is sent
    (``build_group`` + ``run_group``) and reply with its ``CellResult``s,
    its launches and its peak device bytes, until it is sent None. A
    failure is replied, not raised: an ``InvariantError`` as itself (the
    parent ranks the shards'), anything else as its traceback text."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(threads)
        if initializer is not None:
            fn, args = initializer
            fn(*args)
    except Exception:
        replies.put((wid, "error", traceback.format_exc(), {}))
        return
    replies.put((wid, "ready", None, {"ready_at": time.time()}))
    while True:
        task = tasks.get()
        if task is None:
            return
        specs, key = task
        ops.reset_counts()
        try:
            reply = ("ok", run_group(build_group(specs, device=dev, key=key)))
        except InvariantError as e:
            reply = ("invariant", e)
        except Exception:       # reported; the parent stops every worker
            reply = ("error", traceback.format_exc())
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        replies.put((wid, *reply, {"launches": ops.counts(),
                                   "peak_bytes": peak}))


class SweepWorkers:
    """One worker process per entry of ``devices`` (spawned: CUDA cannot
    fork), started together, each set up on its device (``cuda:k`` made
    current; a CPU worker takes this process's intra-op thread count)
    and then running ``initializer = (fn, args)``, importable by name, if
    given. Starting does not wait: the first ``run`` waits until every
    worker is set up, so a caller may start them before other work
    (``startup_s`` is each one's time from start to set up, on the
    host's clock). ``run_sharded`` starts its own for one call, or takes
    one that serves several. ``close`` (or leaving the ``with``) stops
    every worker: the graceful way after a clean call, killed at once
    after a failure; none outlives it."""

    def __init__(self, devices: Sequence, initializer=None):
        ctx = torch.multiprocessing.get_context("spawn")
        self.devices = [torch.device(d) for d in devices]
        self.tasks = [ctx.Queue() for _ in self.devices]
        self.replies = ctx.Queue()
        self.procs = [ctx.Process(
            target=_serve, daemon=True,
            args=(w, str(d), torch.get_num_threads(), initializer,
                  self.tasks[w], self.replies))
            for w, d in enumerate(self.devices)]
        self.stats = [{"device": str(d), "startup_s": None, "peak_bytes": None,
                       "launches": {}} for d in self.devices]
        self.closed = self.ready = False
        self.started_at = time.time()
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.close(failed=True)
            raise

    def __enter__(self) -> "SweepWorkers":
        return self

    def __exit__(self, exc_type, *_) -> None:
        self.close(failed=exc_type is not None)

    def _get(self, waiting: set):
        """The next reply, checking every ``_POLL_S`` that the workers it
        waits for still live (a worker that died cannot reply)."""
        while True:
            try:
                return self.replies.get(timeout=_POLL_S)
            except queue.Empty:
                dead = [w for w in sorted(waiting)
                        if not self.procs[w].is_alive()]
                if dead:
                    try:    # what it put just before it died
                        return self.replies.get(timeout=_POLL_S)
                    except queue.Empty:
                        w = dead[0]
                        raise RuntimeError(
                            f"sweep worker {w} on {self.devices[w]} died "
                            f"(exit code {self.procs[w].exitcode})") from None

    def _gather(self, wids) -> list:
        """``(wid, value)`` replies of workers ``wids``, in worker order;
        a worker's error raises, with its traceback text, and its launches
        are added to ``ops.counts()`` whatever the reply."""
        waiting, out = set(wids), {}
        while waiting:
            wid, kind, value, info = self._get(waiting)
            waiting.discard(wid)
            if "ready_at" in info:
                self.stats[wid]["startup_s"] = (info["ready_at"]
                                                - self.started_at)
            if info.get("launches"):
                ops.add_counts(info["launches"])
                st = self.stats[wid]
                for name, n in info["launches"].items():
                    st["launches"][name] = st["launches"].get(name, 0) + n
                if info["peak_bytes"] is not None:
                    st["peak_bytes"] = max(st["peak_bytes"] or 0,
                                           info["peak_bytes"])
            if kind == "error":
                raise RuntimeError(f"sweep worker {wid} on "
                                   f"{self.devices[wid]} failed:\n{value}")
            out[wid] = value
        return sorted(out.items())

    def run(self, shards: list) -> list:
        """Send shard ``w`` (``(specs, key)``) to worker ``w`` and return
        the workers' results in shard order (``CellResult`` lists, or the
        shard's ``InvariantError``)."""
        if not self.ready:
            self._gather(range(len(self.procs)))
            self.ready = True
        for w, shard in enumerate(shards):
            self.tasks[w].put(shard)
        return [v for _, v in self._gather(range(len(shards)))]

    def close(self, failed: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive() and not failed:
                q.put(None)
        for p in self.procs:
            if p.pid is None:           # never started
                continue
            p.join(timeout=0 if failed else _JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
        for q in (*self.tasks, self.replies):
            q.cancel_join_thread()
            q.close()


def run_sharded(specs: Sequence[ExpSpec], devices: Sequence = (),
                workers: Optional[SweepWorkers] = None,
                initializer=None) -> SweepReport:
    """``run_sweep(use_mesh=True)`` over an explicit device list (a
    device may repeat: ``[cpu, cpu]`` and ``[cuda:0, cuda:0]`` check the
    split on one device). Groups run in ``run_sweep``'s order; each
    group's cells (in input order) split into ``len(devices)``
    contiguous near-equal shards (``np.array_split``; empty ones are
    skipped), shard k a merged world of its own on worker k, all of a
    group's shards at once, gathered before the next group is sent.
    Results come back in input order, with ``num_groups`` and
    ``group_cells`` as unsharded, and the workers' launches added to
    ``ops.counts()``. With checks, the merged run's ``InvariantError``
    is raised: the least ``(step, slot)`` over the group's shards.

    ``workers`` reuses running workers (their devices are the list; a
    failure other than an invariant's stops them); else one per device
    is started for this call with ``initializer``, after the CUDA
    kernels are built here once (``build.build_all``), so that no
    worker runs ``nvcc``."""
    if workers is None and not devices:
        raise ValueError("run_sharded needs devices or workers")
    t0 = time.perf_counter()
    groups = _static_groups(specs)
    own = workers is None
    if own:
        devices = [torch.device(d) for d in devices]
        if any(d.type == "cuda" for d in devices):
            from repro_torch.kernels import build
            build.build_all()
        workers = SweepWorkers(devices, initializer)
    ndev = len(workers.devices)
    results: List[Optional[CellResult]] = [None] * len(specs)
    try:
        for key, idxs in groups.items():
            shards = [s.tolist() for s in np.array_split(np.asarray(idxs), ndev)
                      if len(s)]
            got = workers.run([([specs[i] for i in shard], key)
                               for shard in shards])
            errors = [e for e in got if isinstance(e, InvariantError)]
            if errors:
                raise min(errors, key=lambda e: (e.step, e.slot))
            for shard, res in zip(shards, got):
                for i, r in zip(shard, res):
                    results[i] = r
    except BaseException as e:
        # after an invariant every shard has replied, so lent workers
        # serve on; after anything else replies may be outstanding
        if own or not isinstance(e, InvariantError):
            workers.close(failed=True)
        raise
    if own:
        workers.close()
    return SweepReport(results, len(specs), len(groups),
                       time.perf_counter() - t0,
                       [len(idxs) for idxs in groups.values()],
                       workers=[{**st, "launches": dict(st["launches"])}
                                for st in workers.stats])
