"""LCMP as the cross-pod collective scheduler, on the card: gradient
buckets are LCMP-routed over candidate route programs and mean-reduced
across pods, then a route fails and the binding re-hashes over the live
ones (fast failover). The port's counterpart of
``examples/multipod_grad_routes.py``.

Two pods, one on each rank of a 2-rank ``torch.distributed`` Gloo group
(``dist.lcmp_collectives.PodGroup``), each rank's tensors on its device
(with one card both ranks share it; Gloo carries CUDA tensors). The
reference runs 8 simulated devices, 2 pods x 2 data x 2 model, under
``shard_map``; its data and model axes add nothing to the pod reduce,
which reduces each bucket over the pod axis alone, so the port runs the
pod axis only.

  PYTHONPATH=src python examples/torch_multipod_grad_routes.py            # the card
  PYTHONPATH=src python examples/torch_multipod_grad_routes.py --device cpu
"""
import argparse
import multiprocessing as mp
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as devmod
from repro_torch.dist import lcmp_collectives as lc

PODS = 2
BUCKETS = 6
BUCKET_ELEMS = 256
TIMEOUT_S = 300


def bucket_ids() -> np.ndarray:
    """The six buckets' ids, as the reference hashes them."""
    return lc._fmix32_host(np.arange(1, BUCKETS + 1, dtype=np.uint32))


def pod_buckets(pod: int, device, seed=None) -> dict:
    """Pod ``pod``'s six gradient buckets: the reference's (bucket i all
    i + 1 on every pod), or with ``seed`` each pod's own seeded normal
    values, so that the mean is no pod's."""
    if seed is None:
        return {f"bucket{i}": torch.full((BUCKET_ELEMS,), float(i + 1),
                                         device=device)
                for i in range(BUCKETS)}
    rng = np.random.default_rng([seed, pod])
    return {f"bucket{i}": torch.tensor(
        rng.standard_normal(BUCKET_ELEMS, dtype=np.float32), device=device)
        for i in range(BUCKETS)}


def _gather(x: torch.Tensor, group) -> list:
    every = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, x, group=group)
    return every


def rank_main(device, seed=None, group=None, say=lambda *a: None) -> dict:
    """One pod's part, on a rank of ``group`` (None: the default group):
    the binding with every route alive, the pod reduce of its buckets,
    the binding with route 0 dead. Returns the bindings, the reduced
    buckets (numpy) and ``reduced_ok``: every pod holds the same buckets,
    equal to the f32 mean of the pods' buckets."""
    dev = devmod.resolve(device)
    pods = lc.PodGroup(group)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", pods.rank % torch.cuda.device_count())
    lc._TELEMETRY.reset()                   # every route alive
    ids = bucket_ids()
    alive = lc.schedule_buckets(ids)
    say("route binding (all alive):", alive)

    grads = pod_buckets(pods.rank, dev, seed)
    out = lc.lcmp_pod_reduce(grads, pods)
    keys = sorted(out)
    mine = torch.cat([out[k] for k in keys])
    inputs = _gather(torch.cat([grads[k] for k in keys]), group)
    mean = torch.stack(inputs).sum(0) / pods.size   # exact for 2 pods
    ok = all(torch.equal(o, mean) for o in _gather(mine, group))
    say("reduced ok:", ok)

    # kill route 0 (telemetry marks the direct all-reduce path dead)
    lc.set_route_liveness([False, True, True])
    dead = lc.schedule_buckets(ids)
    say("route binding (route0 dead):", dead)
    return {"alive": alive, "dead": dead, "reduced_ok": ok,
            "reduced": {k: out[k].cpu().numpy() for k in keys}}


def _rank(rank: int, world: int, port: int, device: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        rank_main(device, say=(lambda *a: print(*a, flush=True))
                  if rank == 0 else (lambda *a: None))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=devmod.DEFAULT)
    device = str(devmod.resolve(ap.parse_args(argv).device))
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(r, PODS, port, device))
             for r in range(PODS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        print("ranks exited with", [p.exitcode for p in procs],
              file=sys.stderr)
        return 1
    print("multipod_grad_routes OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
