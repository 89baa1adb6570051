"""Batched serving launcher: prefill + decode loop with KV caches.

Counterpart of ``repro/launch/serve.py``. As there, the encdec family
is refused with the reference's message (the example it names is not in
the repo; an encdec decode runs through ``serve.decode`` with a cross
cache from ``prefill_cross_cache``), and a vlm decodes without its
patch prefix.

Usage (the card by default; ``--device cpu`` on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b --smoke \\
      --batch 4 --prompt-len 32 --gen 32 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.models.arch import init_params
from repro_torch.serve.decode import init_cache
from repro_torch.train.step import make_serve_step


def prefill_then_decode(cfg, params, prompt: torch.Tensor,
                        gen_len: int) -> torch.Tensor:
    """Prefill teacher-forced through decode steps, then ``gen_len``
    greedy steps -> generated tokens (B, gen_len), on ``prompt``'s
    device. Positions are device scalars: no step reads back to the
    host."""
    B, S = prompt.shape
    cache = init_cache(cfg, B, S + gen_len, device=prompt.device)
    step = make_serve_step(cfg)
    positions = torch.arange(S + gen_len, device=prompt.device)
    logits = None
    for i in range(S):
        logits, cache = step(params, cache, prompt[:, i:i + 1], positions[i])
    toks = []
    cur = torch.argmax(logits[:, -1], -1)[:, None]
    for i in range(gen_len):
        toks.append(cur)
        logits, cache = step(params, cache, cur, positions[S + i])
        cur = torch.argmax(logits[:, -1], -1)[:, None]
    return torch.cat(toks, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=devmod.DEFAULT)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        raise SystemExit("use examples/whisper_serve.py for enc-dec serving")
    dev = devmod.resolve(args.device)
    params = init_params(cfg, 0, device=dev)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen).to(dev)
    t0 = time.perf_counter()
    out = prefill_then_decode(cfg, params, prompt, args.gen)
    out = out.cpu()
    dt = time.perf_counter() - t0
    tok = args.batch * (args.prompt_len + args.gen)
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({tok/dt:.1f} tok/s)")
    print(out[0, :16])


if __name__ == "__main__":
    main()
