"""The harness's arithmetic on made-up numbers: the window's whole-grid
accounting, the trace reductions, the byte counts and the per-layer
readers; the forbidden-module check; a cell, mix, configuration and
metric added as files alone. CPU only, no simulation."""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import bytecount, cells, trace, window

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def test_window_runs_whole_grids():
    now = [0.0]

    def clock():
        return now[0]

    def grid():                 # each grid takes 4 s
        now[0] += 4.0
        return "ok"
    runs = window.run_window(grid, 10.0, clock)
    # starts at 0, 4, 8 (still inside the window), then 12 >= 10 stops
    assert [r.wall_s for r in runs] == [4.0, 4.0, 4.0]
    assert window.cell_steps_per_s(runs, cells=15, steps=4000) == 3 * 15 * 4000 / 12.0
    now[0] = 0.0
    runs = window.run_window(lambda: grid() and (_ for _ in ()).throw(
        RuntimeError("boom")), 10.0, clock)
    assert len(runs) == 1 and runs[0].error.startswith("RuntimeError")
    assert window.cell_steps_per_s(runs, 15, 4000) == 0.0
    now[0] = 0.0
    slow = window.run_window(lambda: now.__setitem__(0, now[0] + 30.0), 10.0,
                             clock)
    assert len(slow) == 1        # one grid even when it outlasts the window


def test_trace_reductions():
    kern = [(0.0, 10.0, "a"), (5.0, 12.0, "b"), (20.0, 30.0, "a"),
            (40.0, 41.0, "c")]
    assert trace.busy_us(kern) == 12.0 + 10.0 + 1.0
    ops = trace.device_ops(kern)
    assert ops[0] == ["a", pytest.approx(20e-6)] and len(ops) == 3
    cpu = [(11.0, 25.0, "aten::outer"), (14.0, 18.0, "aten::inner")]
    gaps = trace.idle_gaps(kern, cpu, "step")
    # 12-20 (mid 16: inner), 30-40 (mid 35: no op)
    assert dict((k, v) for k, v in gaps) == {
        "step: aten::inner": pytest.approx(8e-6),
        "step: python": pytest.approx(10e-6)}


def test_byte_counts():
    assert bytecount.monitor_tick_bytes(24) == 24 * 26 * 4 + 31 * 4
    # 2 pairs x 2 candidates, 3 paths of 2 hops over 4 links, ring of 8
    w = {"pair_cand": np.array([[0, 1], [2, -1]]),
         "path_links": np.array([[0, 1], [2, -1], [3, 1]]),
         "path_sig_delay": np.array([[0, 1], [0, 0], [0, 1]]),
         "f_pair": np.array([0, 0, 1]),
         "arrivals": np.array([[0, 2, -1], [1, -1, -1]]),
         "pair_policy": np.array([2, 0])}
    ecmp = bytecount.candidate_bytes(w, np.array([0]), "ecmp", 0, 8)
    # cand row 8 B; paths 0, 1: 2 x 2 hops x 4 B; links 0, 1, 2 liveness
    assert ecmp == 8 + 16 + 3
    lcmp = bytecount.candidate_bytes(w, np.array([0]), "lcmp", 0, 8)
    assert lcmp == ecmp + 16 + 4 * 3 + 4 * 2
    sweep = bytecount.candidate_bytes(w, np.array([0, 1]), "sweep", 0, 8)
    assert sweep == 8 + ecmp + bytecount.candidate_bytes(
        w, np.array([1]), "lcmp", 0, 8)
    path = np.array([1, -1, 2])
    got = bytecount.route_arrivals_bytes(w, 0, "ecmp", 8, path)
    # row 12 B, 2 flows x 16 B, their 2 pairs' candidates, flows 0 and 2
    # routed on paths 1, 2: links 1, 2, 3 (8 B each), 2 paths (8 B each)
    want = (12 + 32 + bytecount.candidate_bytes(w, np.array([0, 1]), "ecmp", 0, 8)
            + 24 + 16 + 2 * 29)
    assert got == want


def _ctx(**kw):
    sl = SimpleNamespace(steps=10, start=0, num_links=24, ring=8,
                         policy="ecmp", flow_path=np.array([0]),
                         world={"arrivals": np.full((10, 1), -1),
                                "f_pair": np.zeros(1, int),
                                "pair_cand": np.zeros((1, 1), int),
                                "path_links": np.zeros((1, 1), int)})
    base = dict(cell=None, steps=4000, slice=sl, busy_s=0.002, window_s=0.01,
                peaks={"hbm_bytes_per_s": 3.35e12},
                grids=[{"build": 1.0, "group": 5.0, "engine": 4.0,
                        "engine.n": 1},
                       {"build": 3.0, "group": 7.0, "engine": 6.0,
                        "engine.n": 2}],
                kernels=[(0.0, 2.0, "void monitor_tick_kernel<1>"),
                         (3.0, 5.0, "void route_arrivals_kernel"),
                         (6.0, 7.0, "elementwise")], cpu_ops=[])
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers():
    ctx = _ctx()
    r = {m: cells.metric_reader(m)(ctx) for m in (
        "build_s", "score_s", "step_ms", "kernels_per_step",
        "device_idle_pct", "monitor_tick_roofline",
        "route_arrivals_roofline")}
    assert r["build_s"] == 2.0 and r["score_s"] == 1.0
    assert r["step_ms"] == pytest.approx((4.0 / 4000 + 6.0 / 8000) / 2 * 1e3)
    assert r["kernels_per_step"] == 0.3
    assert r["device_idle_pct"] == pytest.approx(80.0)
    mon = 10 * bytecount.monitor_tick_bytes(24) / 3.35e12 / 2e-6 * 100
    assert r["monitor_tick_roofline"] == pytest.approx(mon)
    assert 0 < r["route_arrivals_roofline"] < 100
    # nothing to read: no value, never 0
    empty = _ctx(slice=None, grids=[], kernels=[])
    for m in r:
        assert cells.metric_reader(m)(empty) is None


def test_forbidden_check_compares_whole_names():
    code = ("import sys; sys.argv = ['x']; import portbench.run as r; "
            "import portbench.reference.grid, portbench.compare, "
            "portbench.trace, portbench.spans, portbench.window; "
            "import repro_torch.netsim.sweep; "
            "print(r.forbidden_modules()); "
            "sys.modules['repro.x'] = sys; print(r.forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(
        ROOT, "src")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "['repro']"]


def test_new_cell_from_files_alone(tmp_path, monkeypatch):
    """A configuration, a mix, a metric and a cell added as files plus
    manifest entries, with no edit to any harness file."""
    data = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(BENCH, sub), data / sub)
    conf = json.loads((data / "configs" / "testbed8.json").read_text())
    conf["name"] = "testbed8_jitter"
    conf["spec"]["topology"] = "jitter:base=testbed8,frac=0.2"
    (data / "configs" / "testbed8_jitter.json").write_text(json.dumps(conf))
    (data / "traffic" / "load-sweep.json").write_text(json.dumps(
        {"engine": "fluid", "loads": [0.2, 0.4], "policies": ["lcmp"],
         "seeds": 2, "spec": {"redecide_period_us": 10_000},
         "policy_spec": {"amp": {"n_subflows": 4}}}))
    (data / "limits" / "testbed8_jitter.load-sweep.json").write_text(
        json.dumps({"limits": {"flows_differ": 0, "fct_gap": 0}}))
    (data / "metrics" / "grids_seen.py").write_text(
        "def read(ctx):\n    return len(ctx.grids) or None\n")
    man = cells.load_manifest()
    man["configs"].append({"name": "testbed8_jitter", "source": "x",
                           "file": "portbench/configs/testbed8_jitter.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "testbed8_jitter.load-sweep",
                             "config": "testbed8_jitter",
                             "traffic": "load-sweep", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "grids_seen", "unit": "grids",
                             "better": "higher", "source": "program_span",
                             "layer": "grid build", "moves": "cell_steps_per_s",
                             "workloads": ["testbed8_jitter.load-sweep"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(man))
    monkeypatch.setattr(cells, "DATA", str(data))
    monkeypatch.setattr(cells, "MANIFEST", str(path))
    cell = cells.load_cell("testbed8_jitter.load-sweep")
    grid = cell.grid(5)
    assert [(f["seed"], f["load"]) for f in grid] == [
        (10, 0.2), (10, 0.4), (11, 0.2), (11, 0.4)]
    assert grid[0]["topology"] == "jitter:base=testbed8,frac=0.2"
    assert grid[0]["redecide_period_us"] == 10_000
    assert "n_subflows" not in grid[0]
    assert "grids_seen" in [m["name"] for m in cell.metrics]
    assert cells.metric_reader("grids_seen")(SimpleNamespace(grids=[1, 2])) == 2
    # the existing cells do not report the new metric
    old = cells.load_cell("testbed8.fig5-fluid")
    assert "grids_seen" not in [m["name"] for m in old.metrics]
