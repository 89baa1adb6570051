"""Time a checkout's switch on the card: ``chip_smoke.py``'s phase switch.

Runs the checkout's own ``chip_smoke.phase_switch`` (the switch object
model, ``core.switchd``: 48 ports, 8 candidates, a 65,536-slot cache,
200 ticks of 4,096 arrivals, bit for bit against the plain versions) and
prints its synchronized ``route_batch`` median and mean, its launch
counts and whether its checks held; then the device ms of the launch
floor (a one-element ``fill_`` replayed from a CUDA graph, as the
kernels are timed), of the standalone ``cong_update`` and
``lcmp_decide`` entries at the switch's shapes, and, where the checkout
has them, of the switch's launchers (``check_switch_monitor``,
``check_switch_route``). Give it the roots of checkouts of
the port, this one or an older one unpacked with ``git archive``, to
compare versions in one call on one card, in turns::

    python3 examples/torch_switch_batch.py <old> . . <old>

Needs one CUDA card; prints the card's name and power limit, then one
JSON line per run.
"""
import json
import os
import subprocess
import sys

import torch

KEYS = ("route_batch_us_median", "route_batch_us_mean", "launches",
        "plain_calls", "equal")


def check(root: str) -> dict:
    """Phase switch of the checkout at ``root``, in this process (its
    ``chip_smoke`` and ``repro_torch`` are the ones imported: call once
    per process); the phase prints its own line first."""
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke
    from repro_torch.kernels import build
    build.build_all()
    dev = torch.device("cuda", 0)
    rec = {"root": root}
    try:
        out = chip_smoke.phase_switch(dev)
        rec.update({k: out[k] for k in KEYS}, ok=True)
    except RuntimeError as e:          # a failed check of the phase
        rec.update(ok=False, error=str(e))
    x = torch.zeros(1, device=dev)
    rec["floor_ms"] = chip_smoke.graph_ms(lambda: x.fill_(1.0), 200)
    sw = chip_smoke.SWITCH
    rec["cong_update_ms"] = chip_smoke.check_cong_update(
        dev, chip_smoke.switch_inputs(dev)[0], "switch", 200)["ms"]
    rec["lcmp_decide_ms"] = chip_smoke.check_lcmp_decide(
        dev, sw["batch"], sw["cands"], "switch", 200)["ms"]
    for name in ("check_switch_monitor", "check_switch_route"):
        if hasattr(chip_smoke, name):
            row = getattr(chip_smoke, name)(dev, 200)
            rec[name[len("check_"):]] = {k: row[k] for k in (
                "ms", "plain_ms", "call_ms", "host_us", "bound_ms")
                if k in row}
    return rec


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_switch_batch: needs a CUDA card", file=sys.stderr)
        return 2
    if len(argv) == 1:
        print(json.dumps(check(os.path.abspath(argv[0]))), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    # one process per run: each imports its checkout's own modules
    rc = 0
    for root in argv or ["."]:
        rc |= subprocess.run([sys.executable, __file__, root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
