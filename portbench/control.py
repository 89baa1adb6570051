"""The control of the comparison, at a cell's own size on the card.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--sum-dtypes float32 [bfloat16]]

For each seed, in one process: the program's grid of the cell through
``run_sweep`` (the timed path), the reference in the configuration's
stated precision (per-link sums in float64), and the reference again
with its per-link sums one precision below (the control). Prints one
JSON line per seed with the worst of each compared number over the
checked cells: the program's (the lower reading) and each control's
(the upper reading). The benchmark's own runs do not run this; PERF.md
gives its readings and the limits set from them.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def worst(per_cell: dict) -> dict:
    out = {}
    for nums in per_cell.values():
        for k, v in nums.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def readings(cell, seed: int, device: str, sum_dtypes) -> dict:
    """One seed's lower and upper readings of ``cell`` on ``device``."""
    import torch

    from portbench import compare
    from portbench.reference import grid as refgrid
    from repro_torch.netsim import sweep
    from repro_torch.netsim.experiment import ExpSpec
    fields = cell.grid(seed)
    checked = cell.checked(seed, len(fields))
    t0 = time.perf_counter()
    rep = sweep.run_sweep([ExpSpec(**f) for f in fields], device=device)
    prog = {i: compare.cell_view(rep.results[i]) for i in checked}
    del rep
    if device == "cuda":
        torch.cuda.empty_cache()
    out = {"workload": cell.name, "seed": seed,
           "program_s": time.perf_counter() - t0}
    ref = refgrid.run_grid(fields, device, "float64", checked)
    out["program"] = worst({i: compare.numbers(prog[i], ref[i])
                            for i in checked})
    out["control"] = {}
    for dt in sum_dtypes:
        ctl = refgrid.run_grid(fields, device, dt, checked)
        out["control"][dt] = worst({i: compare.numbers(ctl[i], ref[i])
                                    for i in checked})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sum-dtypes", nargs="+", default=["float32"])
    args = p.parse_args(argv)
    import torch

    from portbench import cells
    if not torch.cuda.is_available():
        sys.exit("the control runs on the card")
    cell = cells.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, "cuda", args.sum_dtypes)),
              flush=True)


if __name__ == "__main__":
    main()
