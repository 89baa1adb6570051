"""The port's reprolint (``repro_torch.analysis``): parity with the
reference linter (``repro.analysis``) on the families they share, the
port's own fixture corpus for the DEV family and the in-place INV001,
the whole port tree clean, seeded violations on the real engine found at
their lines, the CLI contract, the wire freeze, and no JAX anywhere in
it. CPU only; the whole-tree analyses run once per module."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import repro.analysis as ref_lint
from repro_torch import analysis as lint
from repro_torch.analysis.runner import default_files
from repro_torch.analysis.wire import MANIFEST_REL, build_manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIX = os.path.join(REPO, "tests", "fixtures", "analysis")
FIX = os.path.join(REPO, "tests", "fixtures", "torch_analysis")
PORT = os.path.join(REPO, "src", "repro_torch")

# the reference's fixtures of the families both linters share
SHARED_BAD = ("axs001_missing.py", "axs002_dynamic_read.py",
              "axs003_static_unread.py", "rng001_ring.py", "rng002_guard.py",
              "uni001_mix.py", "uni002_scale.py", "uni003_compound.py",
              "uni004_suffix.py", "inv002_rot.py")
SHARED_GOOD = ("clean_scan.py", "clean_units_invariants.py")
# the port's bad fixture -> the exact code it must raise (and nothing else)
BAD_EXPECT = {
    "dev001_item.py": "DEV001",
    "dev002_branch.py": "DEV002",
    "dev003_scatter.py": "DEV003",
    "dev004_mask.py": "DEV004",
    "inv001_inplace.py": "INV001",
}
# the shared surfaces of the two wire freezes
WIRE_SHARED = ("policy_codes", "redecide_policies", "scenario_names",
               "sched_families")


def _key(findings):
    """Comparable findings: messages with ``repro.`` read as
    ``repro_torch.``."""
    return sorted((f.code, f.path, f.line,
                   re.sub(r"\brepro\.", "repro_torch.", f.message))
                  for f in findings)


@pytest.fixture(scope="module")
def port_report():
    return lint.run_checks(REPO)


# ------------------------------------------------ parity with reference
@pytest.mark.parametrize("sub,fname",
                         [("bad", f) for f in SHARED_BAD]
                         + [("good", f) for f in SHARED_GOOD])
def test_shared_families_match_reference_on_its_fixtures(sub, fname):
    top = os.path.join(REF_FIX, sub)
    path = os.path.join(top, fname)
    want = ref_lint.run_checks(top, files=[path])
    got = lint.run_checks(top, files=[path])
    assert _key(got.findings) == _key(want.findings)
    assert bool(got.findings) == (sub == "bad")


def test_shared_families_match_reference_over_the_port():
    checks = ["axes", "rings", "units"]
    files = default_files(REPO)
    want = ref_lint.run_checks(REPO, checks=checks, files=files)
    got = lint.run_checks(REPO, checks=checks)
    assert got.num_files == want.num_files
    assert _key(got.findings) == _key(want.findings)
    assert _key(got.suppressed) == _key(want.suppressed)


def test_catalog_keeps_the_shared_codes_and_appends_dev():
    shared = {c for c in ref_lint.CODES if not c.startswith("TRC")}
    assert set(lint.CODES) == shared | {"DEV001", "DEV002", "DEV003",
                                        "DEV004"}
    assert set(lint.CHECKS) == {"syncs", "axes", "wire", "rings", "units",
                                "invariants"}
    with pytest.raises(ValueError, match="unknown check"):
        lint.run_checks(REPO, checks=["tracing"], files=[])


# -------------------------------------------------- the port's corpus
@pytest.mark.parametrize("fname,code", sorted(BAD_EXPECT.items()))
def test_bad_fixture_raises_exactly_its_code(fname, code):
    path = os.path.join(FIX, "bad", fname)
    rep = lint.run_checks(os.path.join(FIX, "bad"), files=[path])
    assert [f.code for f in rep.findings] == [code], rep.findings


def test_good_fixtures_clean():
    good = os.path.join(FIX, "good")
    files = [os.path.join(good, f) for f in sorted(os.listdir(good))
             if f.endswith(".py")]
    assert len(files) >= 3
    rep = lint.run_checks(good, files=files)
    assert rep.ok, rep.findings


def test_corpus_covers_every_step_code():
    covered = set(BAD_EXPECT.values())
    assert {c for c in lint.CODES if c.startswith("DEV")} | {"INV001"} \
        == covered


# --------------------------------------------------- the whole port tree
def test_port_tree_clean(port_report):
    rep = port_report
    assert rep.ok, "\n".join(f.format() for f in rep.findings)
    assert rep.num_files > 80
    paths = {f.path for f in rep.suppressed}
    assert not any("fixtures" in p for p in paths)
    assert all(p.startswith(("src/repro_torch/", "tests/")) for p in paths)
    # the launchers' set-up reads are the only exempted DEV findings
    dev = sorted((f.path, f.code) for f in rep.suppressed
                 if f.code.startswith("DEV"))
    assert dev == [("src/repro_torch/kernels/lcmp_decide.py", "DEV001")] * 2 \
        + [("src/repro_torch/kernels/lcmp_decide.py", "DEV004")]


def test_step_reachability_follows_the_launchers():
    """The card's path: `step_phases`' tuple-unpacked closures, the
    bound methods of `StepLaunchers`, the launcher objects they build and
    call (`RouteArrivals.decide` is reached only through
    `self._router(st).decide`), and the CPU's plain path beside it."""
    from repro_torch.analysis.astutil import RepoIndex
    index = RepoIndex(REPO, default_files(REPO))
    reach = index.step_reachable()
    for key in ("netsim/engine.py::StepLaunchers.monitor",
                "netsim/engine.py::StepLaunchers.decide",
                "netsim/engine.py::StepLaunchers._router",
                "netsim/engine.py::step_phases.tick",
                "kernels/cong_update.py::MonitorTick.__init__",
                "kernels/cong_update.py::MonitorTick.__call__",
                "kernels/lcmp_decide.py::RouteArrivals.__init__",
                "kernels/lcmp_decide.py::RouteArrivals.__call__",
                "kernels/lcmp_decide.py::RouteArrivals.decide",
                "kernels/ref.py::route_arrivals_ref",
                "models/layers.py::rope",
                "serve/decode.py::_mamba1_decode.update"):
        assert f"src/repro_torch/{key}" in reach, key


# (engine, the step statement a `.item()` is seeded before): before the
# monitor tick, and at the end, past every call that returns the state anew
SEEDS = (("fluid", "st = tick(t, st)"),
         ("fluid", "st = redte_tick(t, st, ar, cfg)"),
         ("packet", "st = redte_tick(t, st, ar, cfg)"))
LAUNCHERS = "src/repro_torch/kernels/lcmp_decide.py"


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """One lint run over a copy of the port with a `.item()` seeded at
    each of ``SEEDS`` and the launchers' exemption comments blanked (the
    line numbers stay): ``(findings, {seed: (path, line)})``."""
    root = tmp_path_factory.mktemp("seeded")
    dst = root / "src" / "repro_torch"
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns("__pycache__"))
    for i, (engine, anchor) in enumerate(SEEDS):
        path = dst / "netsim" / f"{engine}.py"
        lines = path.read_text().splitlines()
        at = next(j for j, ln in enumerate(lines) if ln.strip() == anchor)
        lines.insert(at, f"        _ = st.q_bytes.sum().item()  # seed {i}")
        path.write_text("\n".join(lines) + "\n")
    where = {}
    for i, (engine, _) in enumerate(SEEDS):
        rel = f"src/repro_torch/netsim/{engine}.py"
        lines = (root / rel).read_text().splitlines()
        where[SEEDS[i]] = (rel, next(j + 1 for j, ln in enumerate(lines)
                                     if ln.endswith(f"# seed {i}")))
    path = root / LAUNCHERS
    path.write_text(re.sub(r"(?m)^ *# reprolint: ignore\[DEV[^\n]*$", "",
                           path.read_text()))
    rep = lint.run_checks(str(root), checks=["syncs"])
    return {(f.code, f.path, f.line) for f in rep.findings}, where


@pytest.mark.parametrize("engine,anchor", SEEDS)
def test_seeded_item_in_engine_step_found_at_its_line(seeded, engine,
                                                      anchor):
    found, where = seeded
    assert ("DEV001", *where[(engine, anchor)]) in found


def test_unexempted_launcher_setup_reads_found_at_their_lines(
        seeded, port_report):
    """With their comments gone, the launchers' set-up reads are found
    at exactly the lines they were exempted at, and nothing else is
    found beside the seeds."""
    found, where = seeded
    exempted = {(f.code, f.path, f.line) for f in port_report.suppressed
                if f.path == LAUNCHERS and f.code.startswith("DEV")}
    assert sorted(c for c, _, _ in exempted) == ["DEV001", "DEV001",
                                                 "DEV004"]
    assert found == exempted | {("DEV001", *w) for w in where.values()}


# ------------------------------------------------------------------ CLI
def _cli(args, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis"]
                          + args, capture_output=True, text=True, env=env,
                          cwd=cwd)


def test_cli_exit_codes_and_formats(tmp_path):
    bad = tmp_path / "bad"
    bad.mkdir()
    shutil.copy(os.path.join(FIX, "bad", "dev001_item.py"), bad)
    p = _cli(["--root", str(bad), "--format", "github"])
    assert p.returncode == 1, p.stdout + p.stderr
    assert "::error file=dev001_item.py,line=8" in p.stdout
    assert "reprolint DEV001" in p.stdout
    p = _cli(["--root", str(bad), "--format", "json"])
    data = json.loads(p.stdout)
    assert p.returncode == 1 and data["ok"] is False
    assert [f["code"] for f in data["findings"]] == ["DEV001"]
    p = _cli(["--root", str(bad), "--checks", "rings,axes"])
    assert p.returncode == 0, p.stdout        # syncs not selected -> clean

    shutil.copytree(os.path.join(FIX, "good"), tmp_path / "good")
    p = _cli(["--root", str(tmp_path / "good"), "--format", "json"])
    assert p.returncode == 0, p.stdout + p.stderr
    data = json.loads(p.stdout)
    assert data["ok"] is True and data["findings"] == []
    assert data["files"] == 3


def test_cli_changed_reports_only_changed_files(tmp_path):
    tree = tmp_path / "tree"
    tree.mkdir()
    shutil.copy(os.path.join(FIX, "bad", "dev001_item.py"), tree)
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t",
           "-c", "commit.gpgsign=false"]
    for cmd in (["init", "-q"], ["add", "-A"], ["commit", "-qm", "base"]):
        subprocess.run(git + cmd, cwd=tree, check=True, capture_output=True)
    shutil.copy(os.path.join(FIX, "bad", "dev002_branch.py"), tree)
    p = _cli(["--root", str(tree), "--format", "json"])
    assert sorted(f["code"] for f in json.loads(p.stdout)["findings"]) \
        == ["DEV001", "DEV002"]
    p = _cli(["--root", str(tree), "--changed", "--format", "json"])
    assert p.returncode == 1
    assert [f["path"] for f in json.loads(p.stdout)["findings"]] \
        == ["dev002_branch.py"]


# ----------------------------------------------------- wire-format freeze
def test_wire_manifest_is_current():
    with open(os.path.join(REPO, MANIFEST_REL), encoding="utf-8") as f:
        frozen = json.load(f)
    assert frozen == build_manifest(REPO), (
        "wire-format manifest is stale — regenerate with "
        "`python -m repro_torch.analysis --write-manifest`")
    assert "csv_schemas" not in frozen and "bench_keys" not in frozen
    assert frozen["checker_codes"] == sorted(lint.CODES)


def test_wire_shared_surfaces_equal_the_references():
    with open(os.path.join(REPO, "src", "repro", "analysis",
                           "manifest.json"), encoding="utf-8") as f:
        ref = json.load(f)
    with open(os.path.join(REPO, MANIFEST_REL), encoding="utf-8") as f:
        port = json.load(f)
    for section in WIRE_SHARED:
        assert port[section] == ref[section], section


def test_wire_drift_and_missing_manifest(tmp_path):
    man = build_manifest(REPO)
    tampered = dict(man)
    tampered["sched_families"] = list(man["sched_families"]) + ["bogus"]
    mp = tmp_path / "manifest.json"
    mp.write_text(json.dumps(tampered))
    rep = lint.run_checks(REPO, checks=["wire"], files=[], manifest=str(mp))
    assert [f.code for f in rep.findings] == ["WIR001"]
    assert "sched_families" in rep.findings[0].message
    assert "repro_torch.analysis --write-manifest" in rep.findings[0].message
    rep = lint.run_checks(REPO, checks=["wire"], files=[],
                          manifest=str(tmp_path / "missing.json"))
    assert [f.code for f in rep.findings] == ["WIR002"]


# ------------------------------------------------------------- no JAX
def test_cli_runs_and_writes_its_manifest_without_jax(tmp_path):
    """The CLI over the whole port (exit 0, json) and ``--write-manifest``
    in one process: the manifest it writes is the committed one, and
    neither loads a module of JAX or of the reference."""
    out = tmp_path / "manifest.json"
    code = ("import contextlib, io, json, sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "buf = io.StringIO()\n"
            "with contextlib.redirect_stdout(buf):\n"
            f"    rc = main(['--root', {REPO!r}, '--format', 'json'])\n"
            "    rc_w = main(['--root', "
            f"{REPO!r}, '--write-manifest', '--manifest', {str(out)!r}])\n"
            "report = json.loads(buf.getvalue().split('reprolint: wrote')[0])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(json.dumps([rc, rc_w, report['ok'], report['files'], "
            "bad]))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env)
    assert p.returncode == 0, p.stderr
    rc, rc_w, ok, files, bad = json.loads(p.stdout)
    assert (rc, rc_w, ok, bad) == (0, 0, True, []), p.stdout
    assert files > 80
    with open(os.path.join(REPO, MANIFEST_REL), encoding="utf-8") as f:
        assert json.loads(out.read_text()) == json.load(f)


# ------------------------------- the fixed host builds, bit for bit
def test_filled_scalars_equal_the_host_built_ones():
    """rope's theta, gemma's embedding scale and decode's int position are
    filled on the card now (torch.full) where they were copied from the
    host (torch.tensor / as_tensor): the same bits for every
    configuration's value."""
    from repro_torch import configs
    vals = set()
    for smoke in (False, True):
        for c in configs.all_configs(smoke).values():
            vals |= {(float(c.rope_theta), torch.float32),
                     (c.d_model ** 0.5, c.adt),
                     (c.d_model ** 0.5, torch.bfloat16)}
    for v, dt in sorted(vals, key=str):
        a, b = torch.tensor(v, dtype=dt), torch.full((), v, dtype=dt)
        assert a.dtype == b.dtype and \
            a.reshape(1).view(torch.uint8).tolist() == \
            b.reshape(1).view(torch.uint8).tolist(), (v, dt)
    assert torch.equal(torch.as_tensor(7).long(),
                       torch.full((), 7, dtype=torch.long))


def test_decode_step_int_and_tensor_positions_agree():
    from repro_torch import configs
    from repro_torch.models.arch import init_params
    from repro_torch.serve.decode import decode_step, init_cache
    cfg = configs.get("qwen3_4b", smoke=True)
    params = init_params(cfg, 0, device="cpu")
    tok = torch.tensor([[3], [5]])
    outs = []
    for pos in (2, torch.tensor(2)):
        cache = init_cache(cfg, 2, 8, device="cpu")
        logits, cache = decode_step(params, cfg, cache, tok, pos)
        outs.append((logits, cache["attn"]["k"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
