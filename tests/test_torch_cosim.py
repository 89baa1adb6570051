"""The port's training co-simulation (``repro_torch.cosim``) on the CPU,
held to the JAX package's (``tests/test_cosim.py``'s contracts):

- ``build_plan`` and ``overlay`` give the reference's arrays exactly, for
  both of fig_training's models and both wire formats, and the overlay
  keeps the background rows bit for bit (amp's subflows included);
- ``iteration_stats``, ``straggler_routes`` and ``feed_route_telemetry``
  give the reference's results on a reference run's final state carried
  over, and hold its barrier, survivorship and feedback contracts;
- a short co-simulated run (80 ms, 2 iterations) of the port on both
  engines lands within the FCT bands of ``tests/test_torch_fluid_runs.py``
  of the reference's, with the same iterations done;
- batched equals sequential with the cosim knobs as sweep axes, and the
  default knobs are inert.

About 40 s on one worker.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import cosim as rcosim
from repro.dist import lcmp_collectives as rlc
from repro.netsim import experiment as rexp
from repro_torch import cosim
from repro_torch.cosim import workload
from repro_torch.dist import lcmp_collectives as lc
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import sweep

TOP = "wan2000:dcs=8,segs=2,chords=4"
P50_BAND, P99_BAND, COMPLETED_BAND = 0.03, 0.10, 0.01
FINAL = ("done", "fct_us", "flow_path")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The worlds here are small: torch's intra-op threads would only
    contend with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**over):
    kw = dict(topology=TOP, load=0.3, duration_us=60_000, seed=3,
              cap_scale=0.0625, cosim_model="qwen3-4b", cosim_iters=4)
    kw.update(over)
    return kw


def _worlds():
    return rexp.build_world(TOP), pexp.build_world(TOP)


# ----------------------------------------------------- plans and overlays
@pytest.mark.parametrize("compress", [0, 1])
@pytest.mark.parametrize("model", ["qwen3-4b", "gemma2-9b"])
def test_plan_and_overlay_equal_the_reference(model, compress):
    (rs, rt), (ps, pt) = _worlds()
    kw = _kw(cosim_model=model, cosim_compress=compress, bg_load=0.1)
    a = rcosim.build_plan(rexp.ExpSpec(**kw), rs, rt)
    b = cosim.build_plan(pexp.ExpSpec(**kw), ps, pt)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name
    fr = rexp.make_flows(rexp.ExpSpec(**kw), rs, rt)
    fp = pexp.make_flows(pexp.ExpSpec(**kw), ps, pt)
    for f in ("arrival_us", "size_bytes", "pair_id", "flow_id", "fg_mask",
              "cosim_of", "dose_pair", "dose_target", "dose_real"):
        x, y = getattr(fr, f), getattr(fp, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_plan_accounting_and_validation():
    """Bucket count and wire bytes are ``lcmp_pod_reduce``'s accounting,
    the plan is rng-free, and bad knobs raise as in the reference."""
    _, (scen, table) = _worlds()
    spec = pexp.ExpSpec(**_kw())
    plan = cosim.build_plan(spec, scen, table)
    params = plan.param_count
    nb = -(-params // lc.BUCKET_ELEMS)
    assert lc.BUCKET_ELEMS == rlc.BUCKET_ELEMS
    assert plan.n_buckets == nb and plan.num_rows == 4 * 2 * nb
    assert workload.bucket_wire_bytes(params, False).sum() \
        == workload.GRAD_BYTES_PER_PARAM * params
    again = cosim.build_plan(spec, scen, table)
    np.testing.assert_array_equal(plan.flow_id, again.flow_id)
    assert (plan.flow_id != 0).all()
    with pytest.raises(ValueError, match="train cell"):
        cosim.build_plan(dataclasses.replace(spec, cosim_cell="prefill_32k"),
                         scen, table)
    with pytest.raises(ValueError, match="cosim_iters"):
        cosim.build_plan(dataclasses.replace(spec, cosim_iters=0), scen, table)


@pytest.mark.parametrize("seed,load,bg", [(0, 0.15, 0.0), (5, 0.5, 0.1)])
def test_overlay_keeps_background_bit_for_bit(seed, load, bg):
    _, (scen, table) = _worlds()
    legacy = pexp.make_flows(pexp.ExpSpec(**_kw(seed=seed, load=load,
                                                bg_load=bg, cosim_model="")),
                             scen, table)
    cos = pexp.make_flows(pexp.ExpSpec(**_kw(seed=seed, load=load,
                                             bg_load=bg)), scen, table)
    bgm = cos.cosim_of < 0
    for f in ("arrival_us", "size_bytes", "pair_id", "flow_id", "foreground"):
        np.testing.assert_array_equal(getattr(cos, f)[bgm],
                                      getattr(legacy, f), err_msg=f)
    assert (np.diff(cos.arrival_us) >= 0).all()
    assert cos.foreground[~bgm].all()


def test_overlay_with_subflows_equals_the_reference():
    (rs, rt), (ps, pt) = _worlds()
    kw = _kw(n_subflows=2)
    fr = rexp.make_flows(rexp.ExpSpec(**kw), rs, rt)
    fp = pexp.make_flows(pexp.ExpSpec(**kw), ps, pt)
    np.testing.assert_array_equal(fr.subflow_of, fp.subflow_of)
    cs = fp.subflow_of[fp.cosim_of >= 0]
    assert len(np.unique(cs)) == len(cs)             # singleton parents


def test_default_knobs_are_inert():
    _, (scen, table) = _worlds()
    base = pexp.make_flows(pexp.ExpSpec(**_kw(cosim_model="")), scen, table)
    assert base.cosim_of is None
    for kw in (dict(cosim_iters=11), dict(cosim_compress=0),
               dict(cosim_cell="prefill_32k")):
        other = pexp.make_flows(pexp.ExpSpec(**_kw(cosim_model="", **kw)),
                                scen, table)
        for f in ("arrival_us", "flow_id", "size_bytes"):
            np.testing.assert_array_equal(getattr(base, f), getattr(other, f))
    # the knobs stay out of the static key: one world for the figure
    keys = {sweep.static_key(pexp.ExpSpec(**_kw(cosim_model=m, cosim_iters=i)))
            for m in ("", "qwen3-4b", "gemma2-9b") for i in (3, 6)}
    assert len(keys) == 1


# ------------------------------------------------- runs against the JAX one
SHORT = dict(topology=TOP, load=0.7, bg_load=0.15, seed=9, cap_scale=0.0625,
             duration_us=80_000, cosim_model="qwen3-4b", cosim_iters=2,
             policy="lcmp")


@pytest.fixture(scope="module")
def short_runs():
    out = {}
    for engine in ("fluid", "packet"):
        kw = dict(SHORT, engine=engine)
        rstats, _, (_, rtable, rflows, _, rfinal) = rexp.run_experiment(
            rexp.ExpSpec(**kw))
        pstats, _, (_, ptable, pflows, _, pfinal) = pexp.run_experiment(
            pexp.ExpSpec(**kw), device="cpu")
        rplan = rcosim.build_plan(rexp.ExpSpec(**kw), *rexp.build_world(TOP))
        pplan = cosim.build_plan(pexp.ExpSpec(**kw), *pexp.build_world(TOP))
        out[engine] = SimpleNamespace(
            rstats=rstats, rflows=rflows, rplan=rplan, rtable=rtable,
            rfinal=SimpleNamespace(**{n: np.asarray(getattr(rfinal, n))
                                      for n in FINAL}),
            pstats=pstats, pflows=pflows, pplan=pplan, pfinal=pfinal)
    return out


@pytest.mark.parametrize("engine", ["fluid", "packet"])
def test_short_cosim_run_within_bands(short_runs, engine):
    r = short_runs[engine]
    p, q = r.pstats, r.rstats
    assert p.offered == q.offered == r.pflows.num_flows
    assert abs(p.p50 - q.p50) <= P50_BAND * q.p50, (p.p50, q.p50)
    assert abs(p.p99 - q.p99) <= P99_BAND * q.p99, (p.p99, q.p99)
    assert abs(p.completed - q.completed) <= COMPLETED_BAND * q.offered
    pit = cosim.iteration_stats(r.pplan, r.pflows, r.pfinal)
    rit = rcosim.iteration_stats(r.rplan, r.rflows, r.rfinal)
    print(engine, pit.makespan_ms, rit.makespan_ms)
    assert pit.iters_done == rit.iters_done == 2


@pytest.mark.parametrize("engine", ["fluid", "packet"])
def test_stats_equal_the_reference_on_a_carried_state(short_runs, engine):
    """The port's metrics over the reference's own final state (numpy
    arrays, and the same as CPU tensors) give the reference's results."""
    r = short_runs[engine]
    tensors = SimpleNamespace(**{n: torch.tensor(getattr(r.rfinal, n))
                                 for n in FINAL})
    want = rcosim.iteration_stats(r.rplan, r.rflows, r.rfinal)
    for final in (r.rfinal, tensors):
        got = cosim.iteration_stats(r.pplan, r.rflows, final)
        np.testing.assert_array_equal(got.makespan_ms, want.makespan_ms)
        for q in (1, 50, 99):
            assert got.pct_strict(q) == want.pct_strict(q)
        assert got.iters_done == want.iters_done
        assert (cosim.straggler_routes(r.pplan, r.rflows, final)
                == rcosim.straggler_routes(r.rplan, r.rflows, r.rfinal))
    assert (cosim.pair_path_slots(r.rtable, int(r.rplan.pair_id[0]))
            == rcosim.pair_path_slots(r.rtable, int(r.rplan.pair_id[0])))
    tp, tr = lc.RouteTelemetry(), rlc.RouteTelemetry()
    cosim.feed_route_telemetry(r.pplan, r.rflows, tensors, tp, table=r.rtable)
    rcosim.feed_route_telemetry(r.rplan, r.rflows, r.rfinal, tr,
                                table=r.rtable)
    for f in ("cur", "trend", "dur"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(tr, f))
    np.testing.assert_array_equal(tp.cong_scores(), tr.cong_scores())


# ------------------------------------------------ iteration metrics (unit)
def _tiny_plan(n_iters=2, nb=2, period=1000):
    R = n_iters * nb
    return workload.CosimPlan(
        model="m", cell="train_4k", n_iters=n_iters, n_buckets=nb,
        pods=2, period_us=period, tokens_per_iter=1, param_count=1,
        compressed=True,
        arrival_us=np.array([i * period + 100 * b for i in range(n_iters)
                             for b in range(nb)], np.int64),
        size_bytes=np.full(R, 1e3), pair_id=np.zeros(R, np.int32),
        flow_id=np.arange(1, R + 1, dtype=np.uint32),
        iter_of=np.repeat(np.arange(n_iters, dtype=np.int32), nb),
        bucket_of=np.tile(np.arange(nb, dtype=np.int32), n_iters),
        phase_of=np.zeros(R, np.int8))


def _fake_run(plan, done, fct_us, paths=None):
    R = plan.num_rows
    flows = SimpleNamespace(arrival_us=plan.arrival_us,
                            cosim_of=np.arange(R, dtype=np.int32))
    final = SimpleNamespace(
        done=torch.tensor(np.asarray(done, bool)),
        fct_us=torch.tensor(np.asarray(fct_us, np.float32)),
        flow_path=torch.tensor(np.asarray(
            paths if paths is not None else np.zeros(R), np.int32)))
    return flows, final


def test_iteration_stats_barrier_and_strict_percentiles():
    plan = _tiny_plan()
    flows, final = _fake_run(plan, done=[True, True, True, False],
                             fct_us=[50.0, 200.0, 60.0, 1.0], paths=[7, 9, 7, 9])
    it = cosim.iteration_stats(plan, flows, final)
    np.testing.assert_allclose(it.makespan_ms[0], 0.3)   # 100 + 200 us
    assert np.isnan(it.makespan_ms[1])
    assert (it.iters_done, it.iters_total, it.completion_rate) == (1, 2, 0.5)
    assert it.pct_strict(99) == np.inf and np.isfinite(it.pct_strict(1))
    routes = cosim.straggler_routes(plan, flows, final)
    assert routes[9]["stragglers"] == 2 and routes[7]["stragglers"] == 0
    assert routes[9]["max_ms"] == np.inf and routes[7]["buckets"] == 2
    flows, final = _fake_run(plan, [False] * 4, [0.0] * 4)
    assert cosim.iteration_stats(plan, flows, final).pct_strict(50) == np.inf


def test_feed_route_telemetry_demotes_slow_route(monkeypatch):
    """The closed loop: a persistently slow simulated route is demoted by
    the collective layer's scheduler (C_PATH flattened so congestion
    decides, as in the reference's test)."""
    tm = lc._TELEMETRY
    tm.reset()
    monkeypatch.setattr(lc, "C_PATH", np.zeros_like(lc.C_PATH))
    try:
        plan = _tiny_plan(n_iters=12, nb=3, period=2000)
        paths = np.tile(np.array([40, 41, 42]), 12)
        flows, final = _fake_run(plan, done=np.ones(plan.num_rows, bool),
                                 fct_us=np.where(paths == 41, 900e3, 50e3),
                                 paths=paths)
        before = tm.cong_scores().copy()
        cosim.feed_route_telemetry(plan, flows, final, tm,
                                   path_slot={40: 0, 41: 1, 42: 2})
        after = tm.cong_scores()
        assert after[1] > before[1] and after[1] > max(after[0], after[2])
        ids = lc._fmix32_host(np.arange(64, dtype=np.uint32))
        assert 1 not in set(lc.schedule_buckets(ids).tolist())
    finally:
        tm.reset()


# ------------------------------------------------------- sweep axes, inert
@pytest.mark.parametrize("engine", ["fluid", "packet"])
def test_cosim_axes_batched_equal_sequential(engine):
    specs = [pexp.ExpSpec(**_kw(duration_us=40_000, engine=engine, policy=pol,
                                cosim_model=m, cosim_iters=it,
                                cosim_compress=cp))
             for pol, m, it, cp in (("lcmp", "", 4, 1),
                                    ("matchrdma", "qwen3-4b", 3, 0),
                                    ("lcmp", "gemma2-9b", 4, 1))]
    seq = sweep.run_sweep(specs, sequential=True, device="cpu")
    bat = sweep.run_sweep(specs, device="cpu")
    assert bat.num_groups == 1
    for a, b in zip(seq.results, bat.results):
        assert (a.flows.cosim_of is None) == (b.spec.cosim_model == "")
        for n in FINAL:
            np.testing.assert_array_equal(getattr(a.final, n),
                                          getattr(b.final, n),
                                          err_msg=f"{b.spec} {n}")


def test_default_knobs_engine_run_bit_identical():
    specs = [pexp.ExpSpec(topology="testbed8", load=0.3, duration_us=30_000,
                          seed=1, engine=engine, cosim_iters=it)
             for engine in ("fluid", "packet") for it in (6, 3)]
    rep = sweep.run_sweep(specs, sequential=True, device="cpu")
    for a, b in (rep.results[:2], rep.results[2:]):
        for n in FINAL:
            np.testing.assert_array_equal(getattr(a.final, n),
                                          getattr(b.final, n))
