"""Benchmark of the port's simulation grids (``repro_torch``) on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run: set-up (CUDA, the kernels from ``build/kernels/``, and the
window's grid once with its steps after the first ``WARM_STEPS`` left
out, so every shape is met before the window), then whole
grids through ``repro_torch.netsim.sweep.run_sweep`` back to back for
``--seconds``, then the reference's run of the checked cells and the
comparison. With ``--trace 1`` the window's grids are timed per layer
and one more grid runs a profiled slice of engine steps; the line then
carries the per-layer metrics. The last line of standard output is the
result, as JSON; the numbers compared, each beside its limit, are the
last lines of standard error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache stays inside the checkout, at a fixed path
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_START = 300
PROFILE_STEPS = {"fluid": 100, "packet": 40}
# the warm-up grid runs its steps up to this one, past the first
# arrivals, a control refresh and the scenarios' degrade, and skips the
# rest; build and scoring run whole
WARM_STEPS = 800
ENGINES = ("fluid", "packet")


def process_age_s() -> float:
    """Seconds since this process started (its start in /proc), or since
    this module's first line where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr)
    sys.exit(code)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, check_device: bool = True) -> dict:
    args = parse(argv)
    import torch

    from portbench import cells as cellsmod
    cell = cellsmod.load_cell(args.workload)
    if check_device and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        fail(f"{args.workload} needs {cell.chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = "cuda" if check_device else "cpu"
    result, checks = run_cell(cell, args, dev)
    # after the window, the trace and the reference: whatever the port
    # loaded in this process by then is in sys.modules
    bad = forbidden_modules()
    if bad:
        fail(f"modules loaded that the benchmark forbids: {bad}", 3)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} <= {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return result


def run_cell(cell, args, dev: str):
    """Set-up, window, optional trace and the comparison of one run.
    Returns ``(result line, checks)``."""
    import torch

    from portbench import compare, spans, trace, window
    from portbench import cells as cellsmod
    from repro_torch.netsim import sweep
    from repro_torch.netsim.experiment import ExpSpec

    on_card = dev == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    fields = cell.grid(args.seed)
    specs = [ExpSpec(**f) for f in fields]
    steps = cellsmod.engine_steps(fields[0])
    checked = cell.checked(args.seed, len(fields))

    def grid():
        rep = sweep.run_sweep(specs, device=dev)
        sync()
        return rep

    # set-up: CUDA, the kernels, and the window's grid once (its steps
    # past WARM_STEPS skipped), so the caching allocator and every
    # host-side cache meet each shape here
    with spans.patched(_step_patches(trace.warm_hook(WARM_STEPS))):
        grid()
    setup_s = process_age_s()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    rec = spans.Recorder(sync)
    kept = []                       # per grid: its checked cells' views
    per_grid = []                   # per grid: span totals (traced run)

    def one_grid():
        rec.clear()
        rep = grid()
        kept.append({i: compare.cell_view(rep.results[i]) for i in checked})
        per_grid.append(rec.totals())

    if args.trace:
        with spans.patched(spans.span_patches(rec)):
            runs = window.run_window(one_grid, args.seconds)
    else:
        runs = window.run_window(one_grid, args.seconds)
    rate = window.cell_steps_per_s(runs, len(specs), steps)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    ctx = None
    if args.trace:
        # a steady slice, past the first arrivals' routing and CC
        k = min(PROFILE_STEPS[cell.traffic["engine"]], steps // 8)
        sl = trace.Slice(min(PROFILE_START, steps // 4), k, on_card)
        with spans.patched(_step_patches(sl.hook)):
            try:
                grid()
            except trace.SliceDone:
                pass
        ctx = _context(cell, per_grid, steps, sl if sl.prof else None)

    # the program's state is gone; the reference runs the checked cells
    if on_card:
        torch.cuda.empty_cache()
    from portbench.reference import grid as refgrid
    ref = refgrid.run_grid(fields, dev, "float64", checked)
    verdict = compare.judge(kept, ref, cell.limits)
    failed_grids = [r for r in runs if r.error]
    for r in failed_grids:
        print(f"grid failed: {r.error}", file=sys.stderr)
    print(f"grid walls (s): {[round(r.wall_s, 3) for r in runs]}; setup "
          f"{setup_s:.2f} s", file=sys.stderr)

    result = {
        "correct": verdict["correct"] and not failed_grids,
        "attempted": len(runs) * len(specs),
        "failed": verdict["failed"] + len(failed_grids) * len(specs),
        "metrics": {},
        "device": _device(cell, on_card, peak),
    }
    if args.trace:
        result["metrics"] = _per_layer(cell, ctx)
        if ctx.kernels:
            result["device"].update(busy_s=ctx.busy_s, window_s=ctx.window_s)
            result["breakdown"] = {
                "device_ops": trace.device_ops(ctx.kernels),
                "idle_gaps": trace.idle_gaps(ctx.labelled_kernels,
                                             ctx.cpu_ops, "engine step")}
    else:
        e2e = {"cell_steps_per_s": rate, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["checks"] = verdict["checks"]
    return result, verdict["checks"]


def _step_patches(hook) -> list:
    """Each engine's ``make_step`` wrapped by ``hook``."""
    import importlib
    return [(f"repro_torch.netsim.{e}", "make_step", hook(getattr(
        importlib.import_module(f"repro_torch.netsim.{e}"), "make_step")))
        for e in ENGINES]


def _device(cell, on_card: bool, peak: int) -> dict:
    import torch
    return {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell.chips, "memory_peak_bytes": peak}


def _context(cell, per_grid, steps: int, sl):
    """What the per-layer readers read: the window's span totals per
    grid; the profiled slice's kernels, traced with CUDA activity alone;
    the kernels and host ops of the labelled slice after it, which only
    names the idle gaps; the world it ran and the table of peaks."""
    from types import SimpleNamespace

    from portbench import cells as cellsmod
    from portbench import trace
    with open(os.path.join(cellsmod.DATA, "peaks.json")) as f:
        peaks = json.load(f)
    ctx = SimpleNamespace(cell=cell, grids=[g for g in per_grid if g],
                          steps=steps, peaks=peaks, slice=sl, kernels=[],
                          labelled_kernels=[], cpu_ops=[], busy_s=None,
                          window_s=None)
    if sl is not None:
        ctx.kernels, ctx.labelled_kernels, ctx.cpu_ops = sl.events()
        ctx.busy_s = trace.busy_us(ctx.kernels) * 1e-6
        ctx.window_s = sl.window_s
    return ctx


def _per_layer(cell, ctx) -> dict:
    from portbench import cells as cellsmod
    out = {}
    for m in cell.metrics:
        v = cellsmod.metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


if __name__ == "__main__":
    main()
