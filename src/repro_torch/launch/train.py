"""End-to-end training launcher.

Counterpart of ``repro/launch/train.py``, on one device:
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
once. The host mesh (``--data``/``--model`` > 1) is not ported
(ROADMAP.md, queue A item 9). ``train`` runs the loop for any
``ArchConfig``; a vlm or encdec batch's ``extra`` (patch or frame
embeddings, ``data.synth.batch_at``) reaches the step with its tokens.

Usage (the card by default; ``--device cpu`` on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b --smoke \\
      --steps 50 --batch 8 --seq 128 --ckpt /tmp/ck --device cpu
"""
from __future__ import annotations

import argparse
import signal
import time
from typing import NamedTuple

import numpy as np

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.data.synth import batch_at
from repro_torch.dist import lcmp_collectives as lc
from repro_torch.models.arch import ArchConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamWConfig, AdamWState
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_train_step)


class TrainRun(NamedTuple):
    params: dict
    opt: AdamWState
    log: list        # one dict per printed step line


def train(cfg: ArchConfig, *, steps: int = 50, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, microbatches: int = 1, ckpt_dir: str = "",
          ckpt_every: int = 25, resume: bool = False, log_every: int = 10,
          device=devmod.DEFAULT) -> TrainRun:
    """The launcher's loop: steps ``start..steps-1`` (``start`` from the
    latest checkpoint under ``resume``), printing the reference's lines."""
    dev = devmod.resolve(device)
    tcfg = TrainConfig(optim=AdamWConfig(lr=lr, total_steps=steps),
                       microbatches=microbatches)
    params, opt = init_train_state(cfg, 0, device=dev)
    start = 0
    if resume and ckpt_dir:
        found = ckpt.latest(ckpt_dir)
        if found:
            start, path = found
            restored = ckpt.restore(path, {"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
            print(f"[resume] step {start} from {path}")
    step_fn = make_train_step(cfg, tcfg)

    state = {"params": params, "opt": opt, "step": start, "busy": False,
             "term": False}

    def emergency():
        if ckpt_dir:
            ckpt.save(ckpt_dir, state["step"],
                      {"params": state["params"], "opt": state["opt"]})
            print(f"[sigterm] emergency checkpoint at step {state['step']}")
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
                print(f"step {step+1}: loss={loss:.4f} gnorm={gnorm:.3f} "
                      f"({dt:.2f}s/{nsteps}steps)")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                ckpt.save(ckpt_dir, step + 1, {"params": params, "opt": opt})
    finally:
        signal.signal(signal.SIGTERM, previous)
    print("done")
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
    args = ap.parse_args(argv)
    if args.data > 1 or args.model > 1:
        raise NotImplementedError(
            "the host mesh (--data/--model > 1) is not ported yet (ROADMAP.md, "
            "queue A item 9); the port trains on one device")
    cfg = configs.get(args.arch, smoke=args.smoke)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, microbatches=args.microbatches,
                 ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                 resume=args.resume, log_every=args.log_every,
                 device=args.device)


if __name__ == "__main__":
    main()
