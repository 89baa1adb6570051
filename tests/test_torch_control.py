"""Port parity of the fluid engine's control paths: one whole step from
a state the reference's own scanned step carried, for the dctcp, timely
and hpcc CC laws, a control-plane refresh after a degrade, a RedTE
re-weighting, a failover at a trip step, a re-decision epoch (fatpaths,
lcmp_r) and amp's subflows; then short whole runs (failover lcmp and
ecmp, lcmp_r re-deciding under a degrade, amp, ucmp, hpcc) within
slice 1's bands of the reference.

One step: integer and bool fields equal, float fields within rtol 1e-5
(the port sums the same float32 terms in possibly another order). Runs:
``flow_path`` equal for >= 99% of the flows routed in the first
``EARLY`` steps, FCT-slowdown p50 within 3%, p99 within 10%,
completions within 1% of offered.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim import experiment as rexp
from repro.netsim import fluid as rfluid
from repro_torch.netsim import carry
from repro_torch.netsim import engine as pengine
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import fluid as pfluid

FLOAT_RTOL = 1e-5
FIG10 = dict(topology="testbed8", load=0.3, duration_us=400_000)


def flat(obj, prefix=""):
    """A reference dataclass -> flat dict of numpy arrays (dotted keys)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flat(v, prefix + f.name + "."))
        elif v is not None:
            out[prefix + f.name] = np.asarray(v)
    return out


def _assert_state(got, want, what):
    for k, w in want.items():
        if k == "tables.high_water_level":
            continue
        g = got[k]
        if w.dtype == np.uint32:
            w = w.astype(np.int64)
        assert g.shape == w.shape, (what, k)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=1e-6,
                                       err_msg=f"{what} {k}")
        else:
            assert g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def _carried(kw, k):
    """The reference's arrays, its state before step ``k`` (carried by
    its own scanned step) and after it, and the port's config."""
    _, rt, rf, rcfg = rexp.build_experiment(rexp.ExpSpec(**kw))
    r_arr, st = rfluid.build(rt, rf, rcfg)
    step = rfluid.make_step(r_arr, rcfg)
    st = jax.jit(lambda s: jax.lax.scan(step, s, jnp.arange(k))[0])(st)
    after = jax.jit(step)(st, k)[0]
    _, _, _, pcfg = pexp.build_experiment(pexp.ExpSpec(**kw))
    return flat(r_arr), flat(st), flat(after), pcfg


# each case: (spec, step k, what the step must show)
STEP_CASES = {
    "dctcp": (dict(FIG10, cc="dctcp"), 900, "cc_alpha"),
    "timely": (dict(FIG10, cc="timely"), 900, "prev_delay"),
    "hpcc": (dict(FIG10, cc="hpcc"), 900, None),
    # degrade at step 400, refresh at step 500: C_path re-priced
    "ctrl_refresh": (dict(topology="staleness:deg_ms=80", load=0.4,
                          duration_us=200_000), 500, "c_path"),
    # link 12 trips with active flows on it (failover, and a refresh at
    # step 250)
    "failover": (dict(topology="testbed8_failover:fail_ms=50", load=0.3,
                      duration_us=200_000), 250, "flow_path"),
    "failover_ecmp": (dict(topology="testbed8_failover:fail_ms=60",
                           load=0.5, policy="ecmp", duration_us=200_000),
                      300, "flow_path"),
    # RedTE's 100 ms period: new weights at step 500
    "redte": (dict(FIG10, policy="redte", duration_us=200_000), 500,
              "redte_w"),
    # a 10 ms re-decision epoch at step 600
    "redecide_fatpaths": (dict(topology="staleness:deg_ms=60", load=0.4,
                               seed=1, policy="fatpaths",
                               redecide_period_us=10_000,
                               duration_us=200_000), 600, "route_nonce"),
    "redecide_lcmp_r": (dict(topology="staleness:deg_ms=60", load=0.4,
                             seed=1, policy="lcmp_r",
                             redecide_period_us=10_000,
                             duration_us=200_000), 600, "route_nonce"),
    "amp": (dict(FIG10, policy="amp", n_subflows=4, duration_us=200_000),
            700, None),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_from_carried_state(case):
    kw, k, moved = STEP_CASES[case]
    r_arr, before, want, cfg = _carried(kw, k)
    assert before["active"].any() and before["q_bytes"].any()
    if moved is not None:       # the step really exercises its path
        assert not np.array_equal(before[moved], want[moved]), moved
    p_arr, p_st = carry.from_reference(r_arr, before, device="cpu")
    got = carry.to_numpy(pfluid.make_step(p_arr, cfg)(p_st, k))
    _assert_state(got, want, case)


def test_control_ticks_alone_match_reference():
    # ctrl_refresh after a degrade, redte_tick's weights, _reroute_dead at
    # a trip step and redecide_tick, each called alone from one carried
    # state (the failover world at its trip step, with active flows on
    # the link that trips), against the reference's functions
    from repro.netsim import engine as rengine
    kw = dict(topology="testbed8_failover:fail_ms=50", load=0.3,
              duration_us=200_000)
    r_flat, before, _, cfg = _carried(kw, 250)
    _, rt, rf, rcfg = rexp.build_experiment(rexp.ExpSpec(**kw))
    r_arr, r_st = rfluid.build(rt, rf, rcfg)
    cong = dataclasses.replace(r_st.cong, **{
        f.name: jnp.asarray(before["cong." + f.name])
        for f in dataclasses.fields(r_st.cong)})
    r_st = dataclasses.replace(r_st, cong=cong, **{
        f.name: jnp.asarray(before[f.name]) for f in dataclasses.fields(r_st)
        if f.name != "cong"})
    t = 250
    r_st = dataclasses.replace(r_st, link_alive=t < r_arr.link_fail_step)
    before = dict(before, link_alive=np.asarray(r_st.link_alive))
    for name, rfn, pfn, pcfg in (
            ("ctrl_refresh", lambda s, c: rengine.ctrl_refresh(t, s, r_arr, c),
             lambda s, a, c: pengine.ctrl_refresh(t, s, a, c), cfg),
            ("reroute", lambda s, c: flat(rengine._reroute_dead(t, s, r_arr, c)),
             lambda s, a, c: carry.to_numpy(pengine._reroute_dead(t, s, a, c)),
             cfg),
            ("redte", lambda s, c: np.asarray(rengine.redte_tick(
                t, s, r_arr, c).redte_w),
             lambda s, a, c: pengine.redte_tick(t, s, a, c).redte_w,
             dataclasses.replace(cfg, policy="redte", redte_period_us=50_000)),
            ("redecide", lambda s, c: flat(rengine.redecide_tick(
                t, s, r_arr, c, jnp.ones_like(s.active))),
             lambda s, a, c: carry.to_numpy(pengine.redecide_tick(
                 t, s, a, c, torch.ones_like(s.active))),
             dataclasses.replace(cfg, policy="lcmp_r",
                                 redecide_period_us=10_000))):
        rc = dataclasses.replace(rcfg, policy=pcfg.policy,
                                 redecide_period_us=pcfg.redecide_period_us,
                                 redte_period_us=pcfg.redte_period_us)
        p_arr, p_st = carry.from_reference(r_flat, before, device="cpu")
        want, got = rfn(r_st, rc), pfn(p_st, p_arr, pcfg)
        if isinstance(want, dict):
            _assert_state(got, want, name)
            if name == "reroute":       # flows really moved off the dead link
                assert (got["flow_path"] != before["flow_path"]).any()
            if name == "redecide":
                assert (got["route_nonce"] != before["route_nonce"]).any()
        else:
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
            assert not np.array_equal(got, before["redte_w" if name == "redte"
                                                  else "c_path"]), name
    # the refreshed C_path differs from the installed one (a link is dead)
    assert not np.array_equal(np.asarray(rengine.ctrl_refresh(
        t, r_st, r_arr, rcfg)), before["c_path"])


# ------------------------------------------------------- short whole runs
EARLY = 500
RUNS = {
    "failover_lcmp": dict(topology="testbed8_failover:fail_ms=50", load=0.3,
                          policy="lcmp", duration_us=100_000),
    "failover_ecmp": dict(topology="testbed8_failover:fail_ms=50", load=0.3,
                          policy="ecmp", duration_us=100_000),
    "staleness_lcmp_r": dict(topology="staleness:deg_ms=60", load=0.4,
                             seed=1, sig_delay_scale=2.0, policy="lcmp_r",
                             redecide_period_us=10_000, duration_us=100_000),
    "amp": dict(topology="testbed8", load=0.3, policy="amp", n_subflows=4,
                duration_us=100_000),
    "ucmp": dict(topology="testbed8", load=0.5, policy="ucmp",
                 duration_us=100_000),
    # at load 0.5 hpcc's decreases move the tail (at 0.3 no law bites)
    "hpcc": dict(topology="testbed8", load=0.5, cc="hpcc",
                 duration_us=100_000),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_short_run_within_bands(run):
    kw = RUNS[run]
    r_stats, _, (_, _, flows, cfg, r_fin) = rexp.run_experiment(rexp.ExpSpec(**kw))
    p_stats, p_util, (_, _, _, _, p_fin) = pexp.run_experiment(
        pexp.ExpSpec(**kw), device="cpu")
    step = np.minimum(flows.arrival_us // cfg.dt_us, cfg.num_steps - 1)
    early = step < EARLY
    r_path, p_path = np.asarray(r_fin.flow_path), p_fin.flow_path.numpy()
    same = float((r_path[early] == p_path[early]).mean())
    print(f"{run}: same path {same:.4f} of {int(early.sum())}; p50 "
          f"{p_stats.p50:.4f} vs {r_stats.p50:.4f}; p99 {p_stats.p99:.4f} vs "
          f"{r_stats.p99:.4f}; completed {p_stats.completed} vs "
          f"{r_stats.completed} of {r_stats.offered}")
    assert same >= 0.99
    assert p_stats.offered == r_stats.offered
    assert abs(p_stats.p50 - r_stats.p50) <= 0.03 * r_stats.p50
    assert abs(p_stats.p99 - r_stats.p99) <= 0.10 * r_stats.p99
    assert abs(p_stats.completed - r_stats.completed) <= 0.01 * r_stats.offered
    assert p_stats.completion_rate == p_stats.completed / p_stats.offered
    assert np.isfinite(p_util).all()
    if run == "staleness_lcmp_r":       # the re-decision epochs ran
        assert (p_fin.route_nonce.numpy() > 0).any()
        np.testing.assert_array_equal(p_fin.route_nonce.numpy(),
                                      np.asarray(r_fin.route_nonce))
    if run.startswith("failover"):      # the trip took the link down
        assert not p_fin.link_alive.numpy().all()
