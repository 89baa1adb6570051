"""A pool of ranks joined in one Gloo process group, for the port's tests
of the dist layer across processes (``test_torch_dist_group.py``,
``test_torch_sharded_step.py``).

``GlooPool(world)`` spawns ``world`` processes once (a test module holds
one pool for all its tests); ``pool.run(fn, *args)`` calls ``fn(*args)``
on every rank and returns the ranks' results in rank order, or raises
with every failed rank's traceback. ``fn`` must be importable by name:
a module-level function of this module or of the port. Each rank runs
one intra-op thread on the CPU. This module imports neither jax nor the
JAX package.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import shutil
import tempfile
import traceback

TIMEOUT_S = 120


def _serve(rank: int, world: int, store: str, tasks, results) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(*args)))
        except Exception:           # reported to the test; the rank serves on
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class GlooPool:
    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        # the ranks meet through a file store: no port to pick, so pools
        # of parallel test workers cannot collide
        self.dir = tempfile.mkdtemp(prefix="gloo_pool_")
        store = os.path.join(self.dir, "store")
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, store, self.tasks[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = TIMEOUT_S) -> list:
        for q in self.tasks:
            q.put((fn, args))
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            rank, ok, value = self.results.get(timeout=timeout)
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        shutil.rmtree(self.dir, ignore_errors=True)


# ------------------------------------------------------- rank-side cases
_GROUPS: dict = {}


def pod_group(n: int):
    """A ``PodGroup`` over the first ``n`` ranks of the pool (every rank
    of the pool must call this: making a group is collective), or None on
    the ranks outside it."""
    import torch.distributed as dist
    from repro_torch.dist import lcmp_collectives as lc
    if n not in _GROUPS:
        world = dist.get_world_size()
        _GROUPS[n] = None if n == world else dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    return lc.PodGroup(group=_GROUPS[n])


def pod_rows(n: int, m: int, seed: int):
    """The n pods' float32 gradients (n, m), each 1024-block scaled by
    1e-3, 1 or 10, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)) * rng.choice([1e-3, 1.0, 10.0], (n, m))
    return x.astype(np.float32)


def reduce_flat(n: int, m: int, compress: bool, seed: int, alive=None):
    """This rank's ``pod_reduce_flat`` over the group of the first ``n``
    ranks of its own row of ``pod_rows``: the result, the route bytes,
    the bucket binding and the legs timed (None outside the group)."""
    import torch
    from repro_torch.dist import lcmp_collectives as lc
    g = pod_group(n)
    if g is None:
        return None
    x = torch.from_numpy(pod_rows(g.size, m, seed)[g.rank])
    lc._TELEMETRY.reset()
    if alive is not None:
        lc.set_route_liveness(alive)
    out = lc.pod_reduce_flat(x, g, compress)
    res = (out.numpy(), lc._TELEMETRY.route_bytes.copy(),
           lc._TELEMETRY.bucket_routes.copy(), sorted(lc._TELEMETRY.leg_s))
    lc._TELEMETRY.reset()
    return res


def reduce_tree(seed: int, compress: bool):
    """``lcmp_pod_reduce`` of this rank's own (unstacked) tree over the
    whole pool."""
    import torch
    from repro_torch.dist import lcmp_collectives as lc
    g = lc.PodGroup()
    rows = pod_rows(g.size, 70_000 + 300 * 300 + 7, seed)[g.rank]
    tree = {"b": torch.from_numpy(rows[:70_000].copy()),
            "a": {"w": torch.from_numpy(rows[70_000:160_000].reshape(300, 300)),
                  "s": torch.from_numpy(rows[160_000:].copy())}}
    out = lc.lcmp_pod_reduce(tree, g, compress)
    lc._TELEMETRY.reset()
    return {"b": out["b"].numpy(), "w": out["a"]["w"].numpy(),
            "s": out["a"]["s"].numpy()}


def numpy_state(params, opt) -> list:
    """The parameters, then ``mu``, then ``nu``, as whole arrays in leaf
    order (DTensor leaves are gathered: every rank of the mesh calls
    this)."""
    from repro_torch.dist.lcmp_collectives import tree_flatten
    from repro_torch.dist.mesh_rules import is_dtensor
    return [(x.full_tensor() if is_dtensor(x) else x).detach().numpy().copy()
            for t in (params, opt.mu, opt.nu) for x in tree_flatten(t)[0]]


def pod_group_step(n: int, mode: str, batch: int, seq: int):
    """One qwen3 smoke train step from seed 0 with this rank as one pod
    of the first ``n`` ranks: the state after it, the pods' losses, the
    norm and the reduced gradient (None outside the group)."""
    from repro_torch import configs
    from repro_torch.data.synth import batch_at
    from repro_torch.dist import lcmp_collectives as lc
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step)
    g = pod_group(n)
    if g is None:
        return None
    cfg = configs.get("qwen3_4b", smoke=True)
    params, opt = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, TrainConfig(pod_reduce=mode, pod_axis=g))
    params, opt, m = step(params, opt, batch_at(cfg, 0, batch=batch, seq=seq,
                                                device="cpu"))
    lc._TELEMETRY.reset()
    return (numpy_state(params, opt), m["loss"].numpy(),
            m["grad_norm"].numpy(), step.reduced.numpy(), step.grads.shape)


def sharded_step(data: int, model: int, ckpt_dir: str):
    """The FSDP x TP step on a (data, model) mesh of the default group:
    one qwen3 smoke step from seed 0 on a 4 x 32 batch; its loss and
    norm, the whole state after it (rank 0), each parameter's local and
    global numel with its placements; then the state saved with its
    specs, restored on a (world, 1) mesh and gathered again (rank 0);
    and the errors that placing and restoring tensors of another device
    type than the mesh's raise."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data.synth import batch_at
    from repro_torch.dist.lcmp_collectives import tree_flatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import (ShardedStep, TrainConfig,
                                        init_train_state)
    cfg = configs.get("qwen3_4b", smoke=True)
    mesh = make_host_mesh(data, model, device_type="cpu")
    params, opt = init_train_state(cfg, 0, device="cpu")
    meta = [tree_flatten(t)[1]([x.to("meta") for x in tree_flatten(t)[0]])
            for t in (params, opt.mu, opt.nu)]
    step = ShardedStep(cfg, TrainConfig(), mesh)
    specs = step.specs(params)
    refused = {}
    try:
        step.place(meta[0], opt._replace(mu=meta[1], nu=meta[2]))
    except ValueError as e:
        refused["place"] = str(e)
    params, opt = step.place(params, opt)
    params, opt, m = step(params, opt, batch_at(cfg, 0, batch=4, seq=32,
                                                device="cpu"))
    rank0 = dist.get_rank() == 0
    shards = [(p.to_local().numel(), p.numel(), str(tuple(p.placements)))
              for p in tree_flatten(params)[0]]
    whole = numpy_state(params, opt)
    path = ckpt.save(ckpt_dir, 1, {"params": params, "opt": opt},
                     specs=specs)
    world = dist.get_world_size()
    other = make_host_mesh(world, 1, device_type="cpu")
    ospecs = ShardedStep(cfg, TrainConfig(), other).specs(params)
    try:
        ckpt.restore(path, {"params": meta[0], "opt": opt._replace(
            count=torch.zeros((), dtype=torch.int32), mu=meta[1],
            nu=meta[2])}, mesh=other, specs=ospecs)
    except ValueError as e:
        refused["restore"] = str(e)
    back = ckpt.restore(path, {"params": params, "opt": opt}, mesh=other,
                        specs=ospecs)
    restored = numpy_state(back["params"], back["opt"])
    back_shards = [(p.to_local().numel(), str(tuple(p.placements)))
                   for p in tree_flatten(back["params"])[0]]
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                count=int(back["opt"].count), path=path, shards=shards,
                back_shards=back_shards, refused=refused,
                whole=whole if rank0 else None,
                restored=restored if rank0 else None)


def launch(argv: list):
    """``launch.train.main(argv)`` on this rank: what it printed, the
    error it raised (None when it ran), the logged losses and the whole
    state it ended with (on rank 0)."""
    import contextlib
    import io
    import torch.distributed as dist
    from repro_torch.launch import train as ltrain
    buf = io.StringIO()
    err = losses = state = None
    try:
        with contextlib.redirect_stdout(buf):
            run = ltrain.main(argv)
        losses = [r["loss"] for r in run.log]
        state = numpy_state(run.params, run.opt)
    except (Exception, SystemExit) as e:    # returned to the test, which checks it
        err = f"{type(e).__name__}: {e}"
    return (buf.getvalue(), err, losses,
            state if dist.get_rank() == 0 else None)


def f32_smoke(arch: str):
    """``arch``'s smoke configuration with float32 activations: the
    mesh's step and the one-device step then differ only by summation
    order, far below bf16's rounding (which leaves a zamba2 step's
    gradient norm 0.3% apart on either side)."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(arch, smoke=True),
                               act_dtype="float32")


def family_step(arch: str, data: int, model: int, batch: int, seq: int):
    """One ``f32_smoke`` train step of ``arch`` from seed 0 through the
    dry run's train cell (``ShardedStep`` on a (data, model) mesh of the
    default group) on real tensors: its loss and norm, and on rank 0 the
    whole state after it."""
    import torch.distributed as dist
    from repro_torch.data.synth import batch_at
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models.arch import init_params
    cfg = f32_smoke(arch)
    mesh = make_host_mesh(data, model, device_type="cpu")
    fn, _ = dryrun.build_cell(
        cfg, ShapeCell("step", "train", seq, batch), mesh,
        params=init_params(cfg, 0, device="cpu"),
        inputs=batch_at(cfg, 0, batch=batch, seq=seq, device="cpu"))
    params, opt, m = fn()
    whole = numpy_state(params, opt)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                whole=whole if dist.get_rank() == 0 else None)


def decode_inputs(cfg, batch: int, max_seq: int, seed: int) -> dict:
    """Decode inputs on the CPU from ``seed``: tokens (batch, 1), pos =
    max_seq // 2 and the family's cache filled with normal values."""
    import numpy as np
    import torch
    from repro_torch.dist.mesh_rules import map_with_path
    from repro_torch.serve.decode import init_cache
    rng = np.random.default_rng(seed)
    cache = map_with_path(
        init_cache(cfg, batch, max_seq, device="cpu"),
        lambda path, t: torch.from_numpy(rng.standard_normal(
            tuple(t.shape)).astype(np.float32)).to(t.dtype))
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, 1)).astype(np.int32))
    return dict(tokens=tokens, pos=torch.tensor(max_seq // 2,
                                                dtype=torch.int32),
                cache=cache)


def sharded_decode(arch: str, data: int, model: int, batch: int,
                   max_seq: int, seed: int):
    """One ``decode_step`` of ``arch`` (``f32_smoke``, parameters from
    seed 0) through the dry run's decode cell on a (data, model) mesh of
    the default group, on ``decode_inputs``: on rank 0 the logits and
    the cache after it, whole, in leaf order."""
    import torch.distributed as dist
    from repro_torch.dist.lcmp_collectives import tree_flatten
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models.arch import init_params
    cfg = f32_smoke(arch)
    mesh = make_host_mesh(data, model, device_type="cpu")
    fn, _ = dryrun.build_cell(
        cfg, ShapeCell("step", "decode", max_seq, batch), mesh,
        params=init_params(cfg, 0, device="cpu"),
        inputs=decode_inputs(cfg, batch, max_seq, seed))
    logits, cache = fn()
    out = [logits.full_tensor()] + [x.full_tensor()
                                    for x in tree_flatten(cache)[0]]
    out = [x.numpy() for x in out]
    return out if dist.get_rank() == 0 else None
