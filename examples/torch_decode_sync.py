"""Hold a checkout's ``decode_step`` against the card's sync detector.

Runs ``repro_torch.serve.decode.decode_step`` of qwen3-4b (4 layers) and
falcon-mamba-7b (2 layers) at full width in bf16, batch 4: a first step,
then steps 1-8 under ``torch.cuda.set_sync_debug_mode("error")``, each
feeding back its argmax on the card. A step that synchronizes is
reported with its frames inside the checkout, so the line can be held
against what ``python -m repro_torch.analysis`` names (DEV001-DEV004).
Give it the root of any checkout of the port, this one or an older one
unpacked with ``git archive``, to compare two versions in one call::

    python3 examples/torch_decode_sync.py <checkout> [<checkout> ...]

Needs one CUDA card; prints one JSON line per checkout.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

CONFIGS = (("qwen3_4b", 4), ("falcon_mamba_7b", 2))   # (arch, layers)
BATCH = 4
STEPS = 8


def check(root: str) -> dict:
    """The two configurations' decode steps 1..``STEPS`` from the
    checkout at ``root``, in this process (its ``repro_torch`` is the
    one imported: call once per process)."""
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import configs
    from repro_torch.models.arch import init_params
    from repro_torch.serve.decode import decode_step, init_cache
    dev = torch.device("cuda", 0)
    out = {"root": root, "runs": []}
    for arch, layers in CONFIGS:
        cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
        params = init_params(cfg, 0, device=dev)
        cache = init_cache(cfg, BATCH, STEPS + 1, device=dev)
        gen = torch.Generator().manual_seed(23)
        tok = torch.randint(0, cfg.vocab, (BATCH, 1), generator=gen).to(dev)
        pos = torch.arange(STEPS + 1, device=dev)
        rec = {"config": cfg.name, "layers": layers, "batch": BATCH,
               "dtype": str(cfg.adt), "steps": STEPS, "synced": None}
        with torch.inference_mode():
            logits, cache = decode_step(params, cfg, cache, tok, pos[0])
            torch.cuda.synchronize()
            done, t0 = 0, time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for i in range(1, STEPS + 1):
                    tok = logits[:, -1].argmax(-1, keepdim=True)
                    logits, cache = decode_step(params, cfg, cache, tok,
                                                pos[i])
                    done += 1
            except RuntimeError as e:
                rec["synced"] = {
                    "step": i, "error": str(e).splitlines()[0],
                    "frames": [[os.path.relpath(f.filename, root)
                                .replace(os.sep, "/"), f.lineno, f.line]
                               for f in traceback.extract_tb(e.__traceback__)
                               if f.filename.startswith(root)]}
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            rec["ms_per_step"] = (1e3 * (time.perf_counter() - t0) / done
                                  if done else None)
            rec["finite"] = bool(torch.isfinite(logits).all())
            rec["shape"] = list(logits.shape)
        out["runs"].append(rec)
        del params, cache
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_decode_sync: needs a CUDA card", file=sys.stderr)
        return 2
    if len(argv) == 1:
        print(json.dumps(check(os.path.abspath(argv[0]))), flush=True)
        return 0
    # one process per checkout: each imports its own repro_torch
    rc = 0
    for root in argv or ["."]:
        rc |= subprocess.run([sys.executable, __file__, root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
