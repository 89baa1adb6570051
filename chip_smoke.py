#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit: ``python3 chip_smoke.py``. It prints one JSON object per phase
and, last, ``{"ok": true, "device": {...}}``. Any failed check raises, so
the script exits non-zero and prints no result line. Phases:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: both CUDA kernels compiled for sm_90a from ``src/repro_torch/
   kernels/csrc`` (one nvcc each, in parallel), with ptxas registers and
   spills;
3. kernel_check: each kernel against its plain PyTorch version on the
   card, bit for bit, at the main path's shapes (testbed8 and wan2000)
   and at bulk shapes, with CUDA-event times and byte bounds; a
   ``lcmp_decide`` call with 9 candidates must raise on the card;
4. run: the main path through ``run_experiment`` (testbed8 and wan2000,
   lcmp and ecmp): FCT slowdown, completion, wall time, peak memory and
   the kernels' launch counts, which must show the path went through the
   kernels; the reference's policy orderings must hold;
5. profile: where a testbed8 lcmp step's time goes (torch.profiler):
   wall and device-busy time per step, idle share, kernels per step;
6. device_vs_cpu: testbed8 lcmp run on the card and on the CPU (plain
   versions) must route the same flows the same way;
then the ``kernels`` summary line and the result line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM HBM rate (NVIDIA data sheet). Both kernels do a few integer
# operations per byte they move, far below the card's balance of
# operations to bytes, so their bound is the bytes they must move.
PEAK_BYTES_PER_S = 3.35e12

TESTBED8 = dict(topology="testbed8", load=0.5, duration_us=400_000)
WAN2000 = dict(topology="wan2000:dcs=24,segs=2,chords=12", pairs="main",
               load=0.5, bg_load=0.25, cap_scale=0.0625, duration_us=400_000)
WORLDS = {"testbed8": TESTBED8, "wan2000": WAN2000}
# the JAX package's results on the same specs (p50, p99, completed,
# offered), computed on the CPU; the port must land within the bands
REFERENCE = {("testbed8", "lcmp"): (13.27, 87.80, 3124, 3134),
             ("testbed8", "ecmp"): (5.89, 112.58, 3134, 3134),
             ("wan2000", "lcmp"): (2.115, 17.44, 16743, 16745),
             ("wan2000", "ecmp"): (3.491, 52.41, 16737, 16745)}
P50_BAND, P99_BAND, COMPLETED_BAND = 0.03, 0.10, 0.01
BULK = 1 << 20
HASH_EDGES = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def within(got: float, want: float, band: float) -> bool:
    return abs(got - want) <= band * abs(want)


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` from CUDA events over ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in one
    CUDA graph, one replay timed with CUDA events (no host launch cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def timings(kernel, plain, iters: int) -> dict:
    """``ms``/``plain_ms``: device time per call (graph replay);
    ``call_ms``/``plain_call_ms``: time per eager call from the host, as
    the eager engine step pays it."""
    return {"ms": graph_ms(kernel, iters), "plain_ms": graph_ms(plain, iters),
            "call_ms": cuda_ms(kernel, iters), "plain_call_ms": cuda_ms(plain, iters)}


def bound(nbytes: int) -> dict:
    return {"bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


# ------------------------------------------------------------------ phases
def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0))}
    emit(info)
    return info


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    kernels = build.build_all(force=True)     # from this checkout's sources
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "arch": "sm_90a", "kernels": kernels}
    emit(out)
    return out


def main_path_shapes(dev) -> dict:
    """(ports L, arrivals per step A, candidates K) and the switch tables
    of each main-path world, from the port's own build."""
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import fluid
    out = {}
    for name, kw in WORLDS.items():
        _, table, flows, cfg = pexp.build_experiment(pexp.ExpSpec(**kw))
        arrs, _ = fluid.build(table, flows, cfg, device=dev)
        out[name] = dict(L=arrs.link_cap.shape[0], A=arrs.arrivals.shape[1],
                         K=arrs.pair_cand.shape[1], tables=arrs.tables)
    return out


def check_cong_update(dev, tables, label: str, iters: int) -> dict:
    from repro_torch.core.cong import CongState
    from repro_torch.kernels import ops, ref
    n = tables.trend_thresh.shape[0]
    rng = np.random.default_rng(n)
    ring = 8
    st_k, st_p = CongState.init(n, dev), CongState.init(n, dev)
    hist_k = torch.zeros((n, ring), dtype=torch.int32, device=dev)
    hist_p = torch.zeros_like(hist_k)
    err = 0
    for tick in range(6):
        hi = 2_000_000 if tick % 3 < 2 else 100      # drains: negative trends
        q = torch.from_numpy(rng.integers(0, hi, n).astype(np.int32)).to(dev)
        st_k, cc_k = ops.cong_update(st_k, q, tick * 200, tables,
                                     hist_c=hist_k, slot=tick % ring)
        st_p, cc_p = ref.cong_update_ref(st_p, q, tick * 200, tables,
                                         hist_c=hist_p, slot=tick % ring)
        torch.cuda.synchronize()
        pairs = [(cc_k, cc_p), (hist_k, hist_p)] + [
            (getattr(st_k, f), getattr(st_p, f)) for f in
            ("queue_cur", "queue_prev", "trend", "dur_cnt", "last_sample")]
        err = max(err, max(int((a.long() - b.long()).abs().max()) for a, b in pairs))
    require(bool((st_p.trend < 0).any()), f"cong_update {label}: negative trends")
    require(err == 0, f"cong_update {label}: kernel equals plain (err {err})")
    tm = timings(lambda: ops.cong_update(st_k, q, 0, tables, hist_c=hist_k,
                                         slot=0),
                 lambda: ref.cong_update_ref(st_p, q, 0, tables,
                                             hist_c=hist_p, slot=0), iters)
    # per port: reads queue_cur, trend, dur_cnt, queue cells and a 15-int
    # trend_thresh row; writes 5 registers, c_cong and one ring slot; the
    # shared q_thresh and level_score once
    b = bound(n * (4 + 15 + 7) * 4 + (15 + 16) * 4)
    return dict(shape=label, N=n, max_abs_err=err, **tm, **b)


def check_lcmp_decide(dev, F: int, P: int, label: str, iters: int) -> dict:
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(F * 8 + P)
    fids = rng.integers(0, 1 << 32, F).astype(np.int64)
    fids[:min(F, len(HASH_EDGES))] = HASH_EDGES[:F]
    c_path = rng.integers(0, 256, (F, P)).astype(np.int32)
    c_cong = rng.integers(0, 256, (F, P)).astype(np.int32)
    valid = rng.random((F, P)) < 0.8
    valid[F // 2] = False                              # no valid candidate
    c_cong[F - 1] = rng.integers(230, 256, P)          # congestion fallback
    inp = [torch.from_numpy(x).to(dev) for x in (fids, c_path, c_cong, valid)]
    got = ops.lcmp_decide(*inp)
    want = ref.lcmp_decide_ref(*inp)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    require(err == 0, f"lcmp_decide {label}: kernel equals plain (err {err})")
    require(int(got[F // 2]) == -1, f"lcmp_decide {label}: -1 without candidates")
    tm = timings(lambda: ops.lcmp_decide(*inp),
                 lambda: ref.lcmp_decide_ref(*inp), iters)
    # per flow: a 32-bit id (the function hashes uint32 ids), P x (4 + 4
    # + 1) candidate bytes, a 4-byte result
    b = bound(F * (4 + 9 * P + 4))
    return dict(shape=label, F=F, P=P, max_abs_err=err, **tm, **b)


def bulk_tables(dev, n: int):
    """Switch tables for ``n`` ports: the five link rates of the worlds,
    each port's trend row gathered from its rate's row."""
    import dataclasses

    from repro_torch.core.tables import bootstrap_tables
    rates = [25, 40, 100, 200, 400]
    small = bootstrap_tables(rates, buffer_bytes=10**9, sample_interval_us=200,
                             device=dev)
    pick = torch.from_numpy(np.random.default_rng(0).integers(0, 5, n)).to(dev)
    return dataclasses.replace(small,
                               trend_thresh=small.trend_thresh[pick].contiguous())


def refuses_wide_sets(dev) -> bool:
    """The card has no route for candidate sets wider than the kernel's
    8 slots: the wrapper must raise, not fall back."""
    from repro_torch.kernels import ops
    F, P = 4, 9
    inp = (torch.zeros(F, dtype=torch.int64, device=dev),
           torch.zeros((F, P), dtype=torch.int32, device=dev),
           torch.zeros((F, P), dtype=torch.int32, device=dev),
           torch.ones((F, P), dtype=torch.bool, device=dev))
    try:
        ops.lcmp_decide(*inp)
    except ValueError:
        return True
    return False


def phase_kernel_check(dev, shapes) -> dict:
    cong, decide = [], []
    for name, s in shapes.items():
        cong.append(check_cong_update(dev, s["tables"], f"{name} N={s['L']}", 200))
        decide.append(check_lcmp_decide(dev, s["A"], s["K"],
                                         f"{name} F={s['A']} P={s['K']}", 200))
    cong.append(check_cong_update(dev, bulk_tables(dev, BULK), f"bulk N={BULK}", 20))
    for P in range(2, 9):
        decide.append(check_lcmp_decide(dev, BULK, P, f"bulk F={BULK} P={P}", 20))
    out = {"phase": "kernel_check", "library_ms": None,
           "cong_update": cong, "lcmp_decide": decide,
           "lcmp_decide_refuses_p9": refuses_wide_sets(dev)}
    emit(out)
    require(out["lcmp_decide_refuses_p9"], "lcmp_decide raises on P > 8")
    return out


def run_main_path(dev, world: str, policy: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.netsim import experiment as pexp
    spec = pexp.ExpSpec(**WORLDS[world], policy=policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    stats, util, (_, _, flows, cfg, final) = pexp.run_experiment(spec, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.counts()
    out = {"phase": "run", "world": world, "policy": policy,
           "p50": stats.p50, "p99": stats.p99, "completed": stats.completed,
           "offered": stats.offered, "steps": cfg.num_steps, "wall_s": wall,
           "steps_per_s": cfg.num_steps / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts, "reference": REFERENCE[(world, policy)]}
    emit(out)
    require(counts["cong_update"] == cfg.num_steps,
            f"{world}/{policy}: one cong_update launch per step")
    if policy == "lcmp":
        require(counts["lcmp_decide"] > 0, f"{world}/lcmp: lcmp_decide launched")
    require(np.isfinite(stats.slowdown).all() and (stats.slowdown >= 1).all(),
            f"{world}/{policy}: finite slowdowns")
    require(np.isfinite(util).all(), f"{world}/{policy}: finite utilization")
    require(bool(torch.isfinite(final.q_bytes).all()), f"{world}/{policy}: finite queues")
    r50, r99, rdone, roffered = REFERENCE[(world, policy)]
    require(stats.offered == roffered == flows.num_flows,
            f"{world}/{policy}: offered flows equal the reference's")
    require(within(stats.p50, r50, P50_BAND), f"{world}/{policy}: p50 in band")
    require(within(stats.p99, r99, P99_BAND), f"{world}/{policy}: p99 in band")
    require(abs(stats.completed - rdone) <= COMPLETED_BAND * roffered,
            f"{world}/{policy}: completed in band")
    return out


def phase_runs(dev) -> dict:
    runs = {(w, p): run_main_path(dev, w, p)
            for w in WORLDS for p in ("lcmp", "ecmp")}
    tb = runs[("testbed8", "lcmp")], runs[("testbed8", "ecmp")]
    require(tb[0]["p99"] < tb[1]["p99"], "testbed8: p99 lcmp < ecmp")
    wan = runs[("wan2000", "lcmp")], runs[("wan2000", "ecmp")]
    require(wan[0]["p50"] < wan[1]["p50"], "wan2000: p50 lcmp < ecmp")
    require(wan[0]["p99"] < wan[1]["p99"], "wan2000: p99 lcmp < ecmp")
    return runs


def phase_profile(dev, steps: int = 200) -> dict:
    """Where a step's time goes, on testbed8 lcmp after 300 warm-up
    steps: the wall time of ``steps`` plain steps, then ``steps`` more
    under ``torch.profiler`` for the device-busy time, the idle share,
    kernels per step, the two hand-written kernels' device time and the
    kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import fluid
    _, table, flows, cfg = pexp.build_experiment(
        pexp.ExpSpec(**TESTBED8, policy="lcmp"))
    arrs, st = fluid.build(table, flows, cfg, device=dev)
    step = fluid.make_step(arrs, cfg)
    for t in range(300):
        st = step(st, t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(300, 300 + steps):
        st = step(st, t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(300 + steps, 300 + 2 * steps):
            st = step(st, t)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kern)
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    own = {k: sum(v for n, v in by_name.items() if f"{k}_kernel" in n) / steps
           for k in ("cong_update", "lcmp_decide")}
    out = {"phase": "profile", "spec": "testbed8 lcmp load 0.5, from step 300",
           "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
           "wall_ms_per_step_profiled": wall_prof / steps * 1e3,
           "device_busy_ms_per_step": busy_us / steps / 1e3,
           # busy time from the profiled steps over the unprofiled wall
           "device_idle_share": 1.0 - busy_us / 1e6 / wall,
           "kernels_per_step": len(kern) / steps,
           "own_kernels_device_us_per_step": own,
           "top_device_us_per_step": {n[:90]: v / steps for n, v in top}}
    emit(out)
    require(len(kern) > 0, "profile: the step ran kernels on the device")
    require(all(v > 0 for v in own.values()),
            "profile: both hand-written kernels ran in the step")
    return out


def phase_device_vs_cpu(dev) -> dict:
    from repro_torch.netsim import experiment as pexp
    spec = pexp.ExpSpec(**dict(TESTBED8, duration_us=100_000), policy="lcmp")
    res = {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        stats, _, (_, _, flows, cfg, final) = pexp.run_experiment(spec, device=d)
        if d.type == "cuda":
            torch.cuda.synchronize()
        res[d.type] = (stats, final.flow_path.cpu().numpy(),
                       time.perf_counter() - t0)
    (sg, fg, wg), (sc, fc, wc) = res["cuda"], res["cpu"]
    step = np.minimum(flows.arrival_us // cfg.dt_us, cfg.num_steps - 1)
    early = step < 500
    differ = early & (fg != fc)
    out = {"phase": "device_vs_cpu", "spec": "testbed8 lcmp load 0.5 100 ms",
           "same_path_share": float((fg[early] == fc[early]).mean()),
           "flows_first_500_steps": int(early.sum()),
           "first_differing_step": int(step[differ].min()) if differ.any() else None,
           "gpu": {"p50": sg.p50, "p99": sg.p99, "completed": sg.completed,
                   "wall_s": wg},
           "cpu": {"p50": sc.p50, "p99": sc.p99, "completed": sc.completed,
                   "wall_s": wc},
           "offered": sg.offered}
    emit(out)
    require(out["same_path_share"] >= 0.99, "device vs cpu: same paths")
    require(within(sg.p50, sc.p50, P50_BAND), "device vs cpu: p50 in band")
    require(within(sg.p99, sc.p99, P99_BAND), "device vs cpu: p99 in band")
    require(abs(sg.completed - sc.completed) <= COMPLETED_BAND * sg.offered,
            "device vs cpu: completed in band")
    return out


def kernel_summary(checks: dict, runs: dict) -> dict:
    """The ``kernels`` line: each kernel at testbed8's main-path shape,
    with its launches summed over the four main-path runs."""
    meta = {"cong_update": ("src/repro_torch/kernels/csrc/cong_update.cu",
                            "src/repro/kernels/cong_update.py:74"),
            "lcmp_decide": ("src/repro_torch/kernels/csrc/lcmp_decide.cu",
                            "src/repro/kernels/lcmp_decide.py:93")}
    out = []
    for name, (source, replaces) in meta.items():
        rows = checks[name]
        main = rows[0]                  # testbed8, the fig5 world
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"][name] for r in runs.values()),
            "launches_by_run": {f"{w}/{p}": r["launches"][name]
                                for (w, p), r in runs.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shape": main["shape"],
            "call_ms": main["call_ms"], "plain_call_ms": main["plain_call_ms"],
            "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "call_ms",
                                          "bound_ms", "bound_by")}
                       for r in rows]})
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    info = phase_device()
    phase_build()
    checks = phase_kernel_check(dev, main_path_shapes(dev))
    runs = phase_runs(dev)
    phase_profile(dev)
    phase_device_vs_cpu(dev)
    emit(kernel_summary(checks, runs))
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
