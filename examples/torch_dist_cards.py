"""The port's dist layer across processes on cards: one rank per card
over NCCL, or, with ``--probe``, ranks sharing one card over Gloo.

Two checks with one rank per card, each against the one-process path
it must equal:

1. reduce: each rank holds one pod's gradient of qwen3-4b at 4 layers
   (1,181,638,144 f32 elements, ``chip_smoke.pod_vector``) and reduces
   it over the group (``PodGroup``) with the int8 and the f32 wire.
   Every rank's result must equal the one-process ``PodAxis`` reduce of
   the same vectors on card 0 bit for bit (exact digests), and its
   route bytes the reference's accounting loop. Prints each leg's wall
   time.
2. sharded: the FSDP x TP step (``ShardedStep``) on a 2 x 2 (data,
   model) mesh, qwen3-4b at full width and 4 layers, 4 rows of 512
   tokens, against the one-device step that rank 0 then runs from the
   same weights and batch: loss and norm within rtol 2e-3 and every
   parameter within 5e-3 (tests/test_dist.py's contract); ``mu``,
   ``nu`` and the parameters' update within the relative L2 gaps that
   tests/test_torch_sharded_step.py holds on 4 CPU ranks (a first AdamW
   step moves every parameter by about its learning rate, so the
   parameters alone cannot tell a right step from a wrong one); each
   rank holding only its shards.

Run on a machine with 4 cards: ``python examples/torch_dist_cards.py``.
``--device cpu --backend gloo --small`` runs the same checks on 4 CPU
processes at the smoke size (the reduce at 2^18 + 123 elements). Prints
one JSON line per check and exits non-zero if one fails.

``--probe gloo`` (2 ranks) and ``--probe dtensor`` (4 ranks) need one
card, which every rank shares over Gloo (NCCL refuses two ranks on one
device): ``gloo`` times the pod reduce's collectives on CUDA tensors,
small and large; ``dtensor`` places a 2 x 2 ``DeviceMesh`` and runs a
DTensor matmul with its backward. Each rank prints as it goes, so a
rank that dies shows where. Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

from chip_smoke import digest, pod_vector, reference_route_bytes  # noqa: E402

WORLD = 4
BATCH, SEQ = 4, 512             # the sharded step's global batch
MOMENT_GAP, UPDATE_GAP = 0.05, 0.3      # tests/test_torch_sharded_step.py
MODES = ("lcmp_int8", "lcmp")


def say(rank: int, *what) -> None:
    print(f"[rank {rank}]", *what, file=sys.stderr, flush=True)


def config(small: bool):
    from repro_torch import configs
    if small:
        return configs.get("qwen3_4b", smoke=True)
    return dataclasses.replace(configs.get("qwen3_4b"), n_layers=4)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reduce_check(rank: int, dev, m: int) -> dict:
    """This rank's int8 and f32 reduce of its own pod vector over the
    group, and the one-process reduce of every pod's vector (rank 0)."""
    import torch.distributed as dist
    from repro_torch.dist import lcmp_collectives as lc
    from repro_torch.kernels import ops
    out = {}
    ops.reset_counts()
    for mode in MODES:
        x = pod_vector(dev, m, rank)
        lc._TELEMETRY.reset()
        dist.barrier()
        t0 = time.perf_counter()
        got = lc.pod_reduce_flat(x, lc.PodGroup(), mode == "lcmp_int8")
        sync(dev)
        out[mode] = {"wall_s": time.perf_counter() - t0,
                     "leg_s": dict(lc._TELEMETRY.leg_s),
                     "route_bytes": lc._TELEMETRY.route_bytes.tolist(),
                     "digest": digest(got)}
        del x, got
    out["launches"] = {n: ops.counts()[n] for n in ("qsr_int8", "qsr_dequant")}
    if rank == 0:                           # the one-process reduce
        for mode in MODES:
            flat = torch.stack([pod_vector(dev, m, p) for p in range(WORLD)])
            got = lc.pod_reduce_flat(flat, lc.PodAxis("pod", WORLD),
                                     mode == "lcmp_int8")
            out[mode]["want"] = digest(got)
            del flat, got
    lc._TELEMETRY.reset()
    return out


def sharded_check(rank: int, dev, cfg) -> dict:
    """The 2 x 2 step, then (rank 0) the one-device step from the same
    weights and batch, compared leaf by leaf as each sharded leaf is
    gathered."""
    import torch.distributed as dist
    from repro_torch.data.synth import batch_at
    from repro_torch.dist.lcmp_collectives import tree_flatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.step import (ShardedStep, TrainConfig,
                                        init_train_state, make_train_step)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(2, 2, device_type=dev.type)
    params, opt = init_train_state(cfg, 0, device=dev)
    step = ShardedStep(cfg, TrainConfig(), mesh)
    params, opt = step.place(params, opt)
    batch = batch_at(cfg, 0, batch=BATCH, seq=SEQ, device=dev)
    dist.barrier()
    t0 = time.perf_counter()
    params, opt, met = step(params, opt, batch)
    sync(dev)
    leaves = [tree_flatten(t)[0] for t in (params, opt.mu, opt.nu)]
    out = {"wall_s": time.perf_counter() - t0, "loss": float(met["loss"]),
           "grad_norm": float(met["grad_norm"]),
           "local_numel": sum(p.to_local().numel() for p in leaves[0]),
           "numel": sum(p.numel() for p in leaves[0]),
           "peak_bytes": torch.cuda.max_memory_allocated()
           if dev.type == "cuda" else None}
    if rank == 0:
        p1, o1 = init_train_state(cfg, 0, device=dev)
        before = [p.detach().clone() for p in tree_flatten(p1)[0]]
        t0 = time.perf_counter()
        p1, o1, m1 = make_train_step(cfg)(p1, o1, batch)
        sync(dev)
        out["one_device"] = {"wall_s": time.perf_counter() - t0,
                             "loss": float(m1["loss"]),
                             "grad_norm": float(m1["grad_norm"])}
        want = [tree_flatten(t)[0] for t in (p1, o1.mu, o1.nu)]
        step_sq = sum(float((a.detach() - b).double().square().sum())
                      for a, b in zip(want[0], before))
        del before
    dist.barrier()
    sq = [[0.0, 0.0] for _ in range(3)]     # params, mu, nu: diff, want
    worst = 0.0
    for k, group in enumerate(leaves):
        for i, x in enumerate(group):
            whole = x.full_tensor().detach()
            if rank == 0:
                d = (whole - want[k][i].detach()).double()
                sq[k][0] += float(d.square().sum())
                sq[k][1] += float(want[k][i].detach().double().square().sum())
                if k == 0:
                    worst = max(worst, float(d.abs().max()))
            del whole
    if rank == 0:
        out["params_max_diff"] = worst
        out["mu_gap"] = float(np.sqrt(sq[1][0] / sq[1][1]))
        out["nu_gap"] = float(np.sqrt(sq[2][0] / sq[2][1]))
        # the updates differ by what the parameters differ by
        out["update_gap"] = float(np.sqrt(sq[0][0] / step_sq))
    return out


def rank_main(rank: int, args, port: int, q) -> None:
    try:
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank) if args.device == "cuda" \
            else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(args.backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=WORLD, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        cfg = config(args.small)
        m = (1 << 18) + 123 if args.small else cfg.param_count()
        out = {"rank": rank, "reduce": reduce_check(rank, dev, m),
               "sharded": sharded_check(rank, dev, cfg)}
        dist.barrier()
        dist.destroy_process_group()
        q.put(out)
    except BaseException:
        q.put({"rank": rank, "error": traceback.format_exc()})
        raise


# ------------------------------------------------ ranks sharing one card
def probe_gloo(rank: int, world: int) -> None:
    import torch.distributed as dist
    dev = torch.device("cuda", 0)

    def timed(name: str, fn) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        say(rank, f"{name}: {time.perf_counter() - t0:.4f} s", out)

    def a2a(dtype, n):
        x = torch.full((world * n,), rank, dtype=dtype, device=dev)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y[:: n].tolist() if n < 64 else None

    def gather(dtype, n):
        x = torch.full((n,), rank, dtype=dtype, device=dev)
        y = torch.empty((world * n,), dtype=dtype, device=dev)
        dist.all_gather_into_tensor(y, x)
        return y[:: n].tolist() if n < 64 else None

    timed("all_to_all_single int8", lambda: a2a(torch.int8, 4))
    timed("all_to_all_single f32", lambda: a2a(torch.float32, 4))
    timed("all_gather_into_tensor int8", lambda: gather(torch.int8, 3))
    timed("all_gather_into_tensor f32", lambda: gather(torch.float32, 3))
    timed("all_to_all_single 512 MB int8",
          lambda: a2a(torch.int8, (1 << 29) // world))
    timed("all_gather_into_tensor 1 GB f32 a rank",
          lambda: gather(torch.float32, 1 << 28))


def probe_dtensor(rank: int, world: int) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    dev = torch.device("cuda", 0)
    mesh = init_device_mesh("cuda", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    say(rank, "mesh", mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(8, 16, generator=gen, device=dev)
    w = torch.randn(16, 12, generator=gen, device=dev)
    da = distribute_tensor(a, mesh, [Shard(0), Replicate()])
    dw = distribute_tensor(w, mesh, [Shard(0), Shard(1)]).requires_grad_()
    say(rank, "placed")
    with implicit_replication():
        loss = torch.relu(da @ dw).sum()
    say(rank, "forward")
    loss.backward()
    want = w.clone().requires_grad_()
    torch.relu(a @ want).sum().backward()
    say(rank, "backward, gradient error",
        float((dw.grad.full_tensor() - want.grad).abs().max()))


def probe_main(rank: int, world: int, port: int, kind: str) -> None:
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    (probe_dtensor if kind == "dtensor" else probe_gloo)(rank, world)
    dist.barrier()
    dist.destroy_process_group()
    say(rank, "done")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def probe(kind: str) -> int:
    if not torch.cuda.is_available():
        print("--probe needs a card", file=sys.stderr)
        return 2
    world = 4 if kind == "dtensor" else 2
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=probe_main, args=(r, world, port, kind))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    print("exit codes", codes, flush=True)
    return 0 if all(c == 0 for c in codes) else 1


# ----------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--probe", choices=("gloo", "dtensor"))
    args = ap.parse_args()
    if args.probe:
        return probe(args.probe)
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    port = free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, args, port, q))
             for r in range(WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        ranks = sorted((q.get(timeout=900) for _ in procs),
                       key=lambda r: r["rank"])
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    names = [torch.cuda.get_device_name(i) for i in range(WORLD)] \
        if args.device == "cuda" else ["cpu"] * WORLD
    cfg = config(args.small)
    m = (1 << 18) + 123 if args.small else cfg.param_count()
    want_bytes = reference_route_bytes(m)
    red0 = ranks[0]["reduce"]
    ok_reduce = all(r["reduce"][mode]["digest"] == red0[mode]["want"]
                    and r["reduce"][mode]["route_bytes"]
                    == want_bytes[mode].tolist()
                    for r in ranks for mode in MODES)
    print(json.dumps({"check": "reduce", "ranks": WORLD, "backend": args.backend,
                      "devices": names, "elements": m,
                      "bit_for_bit": ok_reduce,
                      "per_rank": [{"rank": r["rank"],
                                    "launches": r["reduce"]["launches"],
                                    **{mode: {k: r["reduce"][mode][k]
                                              for k in ("wall_s", "leg_s")}
                                       for mode in MODES}}
                                   for r in ranks]}), flush=True)
    sh = [r["sharded"] for r in ranks]
    one = sh[0]["one_device"]
    ok_sharded = (
        all(np.isclose(s["loss"], one["loss"], rtol=2e-3, atol=0)
            and np.isclose(s["grad_norm"], one["grad_norm"], rtol=2e-3, atol=0)
            and s["local_numel"] < s["numel"] for s in sh)
        and sh[0]["params_max_diff"] < 5e-3
        and sh[0]["mu_gap"] < MOMENT_GAP and sh[0]["nu_gap"] < MOMENT_GAP
        and sh[0]["update_gap"] < UPDATE_GAP)
    print(json.dumps({"check": "sharded", "mesh": {"data": 2, "model": 2},
                      "config": cfg.name, "batch": [BATCH, SEQ],
                      "loss": [s["loss"] for s in sh],
                      "grad_norm": [s["grad_norm"] for s in sh],
                      "one_device": one,
                      **{k: sh[0][k] for k in ("params_max_diff", "mu_gap",
                                               "nu_gap", "update_gap")},
                      "ok": bool(ok_sharded),
                      "local_numel": [s["local_numel"] for s in sh],
                      "numel": sh[0]["numel"],
                      "wall_s": [s["wall_s"] for s in sh],
                      "peak_bytes": [s["peak_bytes"] for s in sh],
                      "ranks_s": wall}), flush=True)
    ok = ok_reduce and ok_sharded
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
