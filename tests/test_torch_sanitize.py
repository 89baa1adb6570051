"""The port's physics-invariant sanitizer (``repro_torch.netsim.sanitize``)
on the CPU, with the contracts of ``tests/test_sanitize.py``:

1. every seeded physics bug of the torch corpus (``torch_mutations``,
   the keys of the reference's ``tests/mutations``) is reported by the
   invariant that owns it, on both engines, which pins the order in
   which the first failure is chosen (the earliest step, then the
   inline ``pfc_lossless`` check, then ``INVARIANTS`` in order);
   ``signal_causality`` through a negated ``path_sig_delay`` and
   ``pfc_lossless`` through a patched ``pfc_gate``;
2. a checked run only observes: its final state equals a checks-off
   run's bit for bit, on both engines and in a batched ``run_sweep``;
   with checks off the engines never call into ``sanitize``;
3. the knobs (``ExpSpec.checks``, ``REPRO_CHECKS``) and the host checks
   of ``metrics.fct_stats`` and ``cosim.iteration_stats``; the
   registries equal the reference's.

test_sanitize.py's spec: testbed8, load 0.7, 40 ms of arrivals (396
flows, 400 steps); about half a minute on one worker.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from mutations import MUTATIONS as REF_MUTATIONS
from torch_mutations import MUTATIONS

from repro.netsim import sanitize as rsanitize
from repro_torch.cosim import iteration_stats
from repro_torch.cosim.workload import CosimPlan
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import fluid, metrics, packet, sanitize, sweep

SPEC = dict(topology="testbed8", load=0.7, duration_us=40_000)
ENGINES = {"fluid": fluid, "packet": packet}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The worlds here are small: torch's intra-op threads would only
    contend with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(engine_name, checks=True, **cfg_over):
    spec = pexp.ExpSpec(engine=engine_name, checks=int(checks), **SPEC)
    _, table, flows, cfg = pexp.build_experiment(spec)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    mod = ENGINES[engine_name]
    arrs, st = mod.build(table, flows, cfg, device="cpu")
    return mod, arrs, st, cfg


def _fields(st):
    """Every tensor of a state by name (the registers flattened in)."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        else:
            out.update({f"{f.name}.{g.name}": getattr(v, g.name)
                        for g in dataclasses.fields(v)})
    return out


# ------------------------------------------------------ mutation corpus
def test_mutation_corpus_covers_every_invariant():
    assert set(MUTATIONS) == set(REF_MUTATIONS)
    assert (set(MUTATIONS) | {"signal_causality", "pfc_lossless"}
            == set(sanitize.INVARIANTS))


@pytest.mark.parametrize("engine_name", sorted(ENGINES))
@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_seeded_bug_is_caught(engine_name, name, monkeypatch):
    mod, arrs, st, cfg = _build(engine_name)
    monkeypatch.setattr(sanitize, "_MUTATION", MUTATIONS[name])
    with pytest.raises(sanitize.InvariantError, match=name) as err:
        mod.run(arrs, st, cfg)
    assert err.value.invariant == name and err.value.step >= 0


@pytest.mark.parametrize("engine_name", sorted(ENGINES))
def test_signal_causality_caught(engine_name):
    mod, arrs, st, cfg = _build(engine_name)
    bad = dataclasses.replace(arrs, path_sig_delay=-(arrs.path_sig_delay + 1))
    with pytest.raises(sanitize.InvariantError, match="signal_causality") \
            as err:
        mod.run(bad, st, cfg)
    assert err.value.step == 0


def test_pfc_gate_break_is_caught(monkeypatch):
    # all-pairs traffic into a buffer small enough that PFC pauses
    # actually fire on downstream hops at this load
    spec = pexp.ExpSpec(engine="packet", pairs="all", checks=1, **SPEC)
    _, table, flows, cfg = pexp.build_experiment(spec)
    cfg = dataclasses.replace(cfg, buffer_bytes=2e5)
    arrs, st = packet.build(table, flows, cfg, device="cpu")
    # honored gate: pauses occur, nothing is forwarded into them
    final = packet.run(arrs, st, cfg)
    assert bool(final.hist_pause.any())
    # broken gate (ignores the pause signal): check_pfc must fire
    monkeypatch.setattr(sanitize, "pfc_gate", lambda okh, paused: okh)
    arrs, st = packet.build(table, flows, cfg, device="cpu")
    with pytest.raises(sanitize.InvariantError, match="pfc_lossless"):
        packet.run(arrs, st, cfg)


def test_first_failure_order_within_a_step():
    """Two checks failing at one step report the earlier one; an earlier
    step beats any order."""
    chk = sanitize.Checker()
    yes, no = torch.tensor(True), torch.tensor(False)
    for t, oks in ((0, (yes, yes, yes)), (1, (yes, no, no)),
                   (2, (no, no, no))):
        for ok, msg in zip(oks, ("a: x", "b: y", "c: z")):
            chk.check(ok, msg)
        chk.end_step(t)
    with pytest.raises(sanitize.InvariantError, match="b: y") as err:
        chk.throw()
    assert (err.value.invariant, err.value.step) == ("b", 1)
    assert chk.first.tolist() == [2, 1, 1]


# ------------------------------------------------- observation-only runs
@pytest.mark.parametrize("engine_name", sorted(ENGINES))
def test_checked_run_is_bit_identical(engine_name):
    """The sanitizer only observes: the checks-on final state equals the
    checks-off final state bit for bit (two fresh builds: a run consumes
    its state)."""
    mod, arrs, st, cfg_on = _build(engine_name, checks=True)
    cfg_off = dataclasses.replace(cfg_on, checks=False)
    b = mod.run(arrs, st, cfg_on)
    mod, arrs, st, _ = _build(engine_name, checks=False)
    a = mod.run(arrs, st, cfg_off)
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        assert fa[name].dtype == fb[name].dtype, name
        assert torch.equal(fa[name], fb[name]), \
            f"sanitizer perturbed simulation state: {name}"


def test_checked_sweep_is_bit_identical():
    """A checked merged group equals its unchecked twin, cell by cell."""
    specs = [pexp.ExpSpec(policy=p, **SPEC) for p in ("lcmp", "ecmp")]
    on = sweep.run_sweep([dataclasses.replace(s, checks=1) for s in specs],
                         device="cpu")
    off = sweep.run_sweep(specs, device="cpu")
    assert on.num_groups == off.num_groups == 1
    for a, b in zip(off.results, on.results):
        for name in ("done", "fct_us", "flow_path", "serv_bytes", "c_path"):
            np.testing.assert_array_equal(getattr(a.final, name),
                                          getattr(b.final, name))


def test_checked_sweep_raises(monkeypatch):
    monkeypatch.setattr(sanitize, "_MUTATION", MUTATIONS["cong_quantized"])
    specs = [pexp.ExpSpec(policy=p, checks=1, **SPEC)
             for p in ("lcmp", "ecmp")]
    with pytest.raises(sanitize.InvariantError, match="cong_quantized"):
        sweep.run_sweep(specs, device="cpu")


@pytest.mark.parametrize("engine_name", sorted(ENGINES))
def test_checks_off_never_enter_sanitize(engine_name, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("sanitize entered with checks off")
    for name in ("enabled", "step_check", "pfc_gate", "check_pfc", "Checker"):
        monkeypatch.setattr(sanitize, name, boom)
    mod, arrs, st, cfg = _build(engine_name, checks=False,
                                horizon_us=20_000)
    step = mod.make_step(arrs, cfg)
    assert step.checker is None
    mod.run(arrs, st, cfg)


# ---------------------------------------------------------------- knobs
def test_spec_checks_flag_reaches_cfg(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKS", raising=False)
    spec = pexp.ExpSpec(**SPEC)
    _, _, _, cfg = pexp.build_experiment(spec)
    assert cfg.checks is False and not sanitize.enabled(cfg)
    _, _, _, cfg = pexp.build_experiment(dataclasses.replace(spec, checks=1))
    assert cfg.checks is True and sanitize.enabled(cfg)


def test_env_override_forces_checks_on(monkeypatch):
    monkeypatch.setenv("REPRO_CHECKS", "1")
    _, _, _, cfg = pexp.build_experiment(pexp.ExpSpec(**SPEC))
    assert cfg.checks is True
    assert sanitize.host_checks_enabled()


def test_host_checks_catch_broken_completion_accounting(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKS", raising=False)
    mod, arrs, st, cfg = _build("fluid", checks=False)
    _, table, flows, _ = pexp.build_experiment(pexp.ExpSpec(**SPEC))
    final = mod.run(arrs, st, cfg)
    # a "completed" flow with FCT 0: the accounting identity is broken
    broken = dataclasses.replace(final, done=torch.ones_like(final.done),
                                 fct_us=torch.zeros_like(final.fct_us))
    metrics.fct_stats(broken, table, flows, cfg)     # silent without the knob
    monkeypatch.setenv("REPRO_CHECKS", "1")
    with pytest.raises(AssertionError, match="completion_identity"):
        metrics.fct_stats(broken, table, flows, cfg)
    metrics.fct_stats(final, table, flows, cfg)      # intact state passes


def test_host_checks_catch_iteration_before_its_start(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKS", raising=False)
    R = 4
    plan = CosimPlan(
        model="m", cell="train_4k", n_iters=2, n_buckets=2, pods=2,
        period_us=1000, tokens_per_iter=1, param_count=1, compressed=True,
        arrival_us=np.array([0, 100, 1000, 1100], np.int64),
        size_bytes=np.full(R, 1e3), pair_id=np.zeros(R, np.int32),
        flow_id=np.arange(1, R + 1, dtype=np.uint32),
        iter_of=np.array([0, 0, 1, 1], np.int32),
        bucket_of=np.array([0, 1, 0, 1], np.int32),
        phase_of=np.zeros(R, np.int8))
    flows = SimpleNamespace(arrival_us=plan.arrival_us,
                            cosim_of=np.arange(R, dtype=np.int32))
    # iteration 1's buckets "complete" 2 ms before they arrive
    final = SimpleNamespace(done=np.ones(R, bool),
                            fct_us=np.array([50.0, 60.0, -2000.0, -2000.0]))
    iteration_stats(plan, flows, final)
    monkeypatch.setenv("REPRO_CHECKS", "1")
    with pytest.raises(AssertionError, match="cosim barrier"):
        iteration_stats(plan, flows, final)


# ------------------------------------------------------------ registries
def test_registries_equal_the_reference():
    assert list(sanitize.INVARIANTS) == list(rsanitize.INVARIANTS)
    assert sanitize.INVARIANT_COVERAGE == rsanitize.INVARIANT_COVERAGE
    assert sanitize.COVERAGE_EXEMPT == rsanitize.COVERAGE_EXEMPT
    assert sanitize._REL_EPS == rsanitize._REL_EPS
    # every field of the port's states is covered or exempt
    fields = {f.name for f in dataclasses.fields(packet.PacketState)}
    assert fields <= (set(sanitize.INVARIANT_COVERAGE)
                      | set(sanitize.COVERAGE_EXEMPT))
