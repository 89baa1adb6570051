"""End-to-end training launcher.

Counterpart of ``repro/launch/train.py``:
- the FSDP x TP step on a (data, model) host mesh for ``--data``/``--model``
  > 1 (``train.step.ShardedStep``), one rank per device of the
  mesh under ``torchrun``; one device otherwise;
- deterministic restart-safe data (step == cursor, ``data.synth``);
- atomic checkpoints of params + optimizer (``train.checkpoint``, the
  reference's format) and auto-resume (``--resume``);
- an emergency checkpoint on SIGTERM;
- route telemetry: the wall time per step of each log block (after the
  first, which holds the warm-up) feeds the LCMP route registers
  (``dist.lcmp_collectives._TELEMETRY``), as the reference does.

The port's AdamW updates parameters in place, so a SIGTERM that arrives
inside a train step is handled when the step returns, and the emergency
checkpoint holds that step; one that arrives between steps saves at
once. ``train`` runs the loop for any ``ArchConfig``; a vlm or encdec
batch's ``extra`` (patch or frame embeddings, ``data.synth.batch_at``)
reaches the step with its tokens.

On a mesh every rank builds the same global batch and the same initial
state, keeps its shards (``dist.mesh_rules``), and takes part in each
checkpoint (DTensor leaves are gathered; rank 0 writes, with the specs
in the manifest); rank 0 prints the log lines. ``--data x --model`` must
equal the world size. The backend is ``--backend``: NCCL by default on
the card, Gloo on the CPU; Gloo also carries CUDA tensors, and is what
runs ranks that share one card (NCCL refuses two ranks on one device).

Usage (the card by default; ``--device cpu`` on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt /tmp/ck --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3_4b --smoke --data 2 --model 2 --device cpu
"""
from __future__ import annotations

import argparse
import os
import signal
import time
from typing import NamedTuple

import numpy as np
import torch.distributed as dist

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.data.synth import batch_at
from repro_torch.dist import lcmp_collectives as lc
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.arch import ArchConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamWConfig, AdamWState
from repro_torch.train.step import (ShardedStep, TrainConfig,
                                    init_train_state, make_train_step)


class TrainRun(NamedTuple):
    params: dict
    opt: AdamWState
    log: list        # one dict per printed step line


def train(cfg: ArchConfig, *, steps: int = 50, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, microbatches: int = 1, ckpt_dir: str = "",
          ckpt_every: int = 25, resume: bool = False, log_every: int = 10,
          device=devmod.DEFAULT, mesh=None) -> TrainRun:
    """The launcher's loop: steps ``start..steps-1`` (``start`` from the
    latest checkpoint under ``resume``), printing the reference's lines;
    on ``mesh`` (a ``DeviceMesh`` with dims data and model) the sharded
    step, whose state is DTensors."""
    dev = devmod.resolve(device)
    tcfg = TrainConfig(optim=AdamWConfig(lr=lr, total_steps=steps),
                       microbatches=microbatches)
    params, opt = init_train_state(cfg, 0, device=dev)
    specs = None
    if mesh is not None:
        step_fn = ShardedStep(cfg, tcfg, mesh)
        specs = step_fn.specs(params)
        params, opt = step_fn.place(params, opt)
    else:
        step_fn = make_train_step(cfg, tcfg)
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a: None)
    start = 0
    if resume and ckpt_dir:
        found = ckpt.latest(ckpt_dir)
        if found:
            start, path = found
            restored = ckpt.restore(path, {"params": params, "opt": opt},
                                    mesh=mesh, specs=specs)
            params, opt = restored["params"], restored["opt"]
            say(f"[resume] step {start} from {path}")

    state = {"params": params, "opt": opt, "step": start, "busy": False,
             "term": False}

    def emergency():
        if ckpt_dir:
            ckpt.save(ckpt_dir, state["step"],
                      {"params": state["params"], "opt": state["opt"]}, specs)
            say(f"[sigterm] emergency checkpoint at step {state['step']}")
        raise SystemExit(1)

    def on_term(signum, frame):
        if state["busy"]:            # parameters are mid-update in place
            state["term"] = True
            return
        emergency()

    previous = signal.signal(signal.SIGTERM, on_term)
    log = []
    try:
        t_last = time.perf_counter()
        last_log = start
        for step in range(start, steps):
            b = batch_at(cfg, step, batch=batch, seq=seq, device=dev)
            state["busy"] = True
            params, opt, metrics = step_fn(params, opt, b)
            state.update(params=params, opt=opt, step=step + 1, busy=False)
            if state["term"]:
                emergency()

            if (step + 1) % log_every == 0 or step == start:
                loss = float(metrics["loss"])          # waits for the step
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                nsteps = max(step + 1 - last_log, 1)
                last_log = step + 1
                # per-step wall time (ms) -> route trend registers; the
                # first block holds the warm-up, not route time
                if step != start:
                    lc._TELEMETRY.observe(
                        np.full(lc.NUM_ROUTES, int(dt * 1e3 / nsteps)),
                        int(step))
                gnorm = float(metrics["grad_norm"])
                log.append(dict(step=step + 1, loss=loss, grad_norm=gnorm,
                                seconds=dt, steps=nsteps))
                say(f"step {step+1}: loss={loss:.4f} gnorm={gnorm:.3f} "
                    f"({dt:.2f}s/{nsteps}steps)")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                ckpt.save(ckpt_dir, step + 1, {"params": params, "opt": opt},
                          specs)
    finally:
        signal.signal(signal.SIGTERM, previous)
    say("done")
    return TrainRun(params, opt, log)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=devmod.DEFAULT)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend on a mesh (default: "
                    "nccl on the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    mesh = None
    if args.data > 1 or args.model > 1:
        mesh = host_mesh(args.data, args.model, args.device, args.backend)
    cfg = configs.get(args.arch, smoke=args.smoke)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, microbatches=args.microbatches,
                 ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                 resume=args.resume, log_every=args.log_every,
                 device=args.device, mesh=mesh)


def host_mesh(data: int, model: int, device, backend=None):
    """The (data, model) mesh over the ranks ``torchrun`` started (or of
    a process group already set up): raises unless the world size is
    ``data * model``, or when an existing group's backend is not
    ``backend``."""
    dev = devmod.resolve(device)
    world = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", "1"))
    if world != data * model:
        raise ValueError(f"--data {data} x --model {model} needs WORLD_SIZE = "
                         f"{data * model} ranks (torchrun --nproc-per-node "
                         f"{data * model}), got {world}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend)        # torchrun's env:// address
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not --backend {backend}")
    return make_host_mesh(data, model, device_type=dev.type)


if __name__ == "__main__":
    main()
