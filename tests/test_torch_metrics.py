"""Port parity of the load schedules and the metrics: ``repro_torch.traffic.
sched`` builds the reference's arrays and ``make_flows`` with a
``load_sched`` the reference's flow tables, NumPy-exact; every metric of
``repro_torch.netsim.metrics`` (``fct_stats`` with and without ``mask``,
amp's subflow collapse, ``completion_rate``, ``by_size_bucket``,
``completion_wall_us``, ``fg_bg_stats``, ``phase_stats``,
``per_pair_stats``) equals the reference's on the same final state.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.netsim import experiment as rexp
from repro.netsim import metrics as rmetrics
from repro.traffic import sched as rsched
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import metrics as pmetrics
from repro_torch.traffic import sched as psched

SCHEDS = ["const", "const:segs=8", "diurnal", "diurnal:amp=0.5,segs=12",
          "diurnal:flash_at_ms=30,flash_dur_ms=20,flash_mult=3,flash_src=1",
          "diurnal:shift_ms=50,weighted=0,peak_h=6",
          "flash:at_ms=20,dur_ms=10,mult=4", "flash:at_ms=10,dur_ms=30,src=2"]
WORLDS = {"geo": dict(topology="geo", pairs="all"),
          "testbed8": dict(topology="testbed8", bg_load=0.2),
          "wan2000": dict(topology="wan2000:dcs=24,segs=2,chords=12",
                          bg_load=0.15, cap_scale=0.0625)}


def _flows_equal(got, want):
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if w is None:
            assert g is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f.name)


@pytest.mark.parametrize("spec", SCHEDS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_sched_build_and_flows_exact(world, spec):
    kw = dict(WORLDS[world], load=0.4, duration_us=100_000, load_sched=spec)
    r_scen, r_table = rexp.build_world(kw["topology"])
    p_scen, p_table = pexp.build_world(kw["topology"])
    r_spec, p_spec = rexp.ExpSpec(**kw), pexp.ExpSpec(**kw)
    fg = rexp.traffic_pair_ids(r_spec, r_scen, r_table)
    bg = rexp.background_pair_ids(r_table, fg) if r_spec.bg_load else []
    want = rsched.build(spec, kw["duration_us"], r_table, r_scen, fg, bg)
    got = psched.build(spec, kw["duration_us"], p_table, p_scen, fg, bg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    _flows_equal(pexp.make_flows(p_spec, p_scen, p_table),
                 rexp.make_flows(r_spec, r_scen, r_table))


@pytest.mark.parametrize("spec", ["nope", "diurnal:amp=1.5", "flash:dur_ms=0",
                                  "const:bogus=1"])
def test_sched_errors_match(spec):
    scen, table = pexp.build_world("testbed8")
    r_scen, r_table = rexp.build_world("testbed8")
    with pytest.raises(ValueError) as r_err:
        rsched.build(spec, 100_000, r_table, r_scen, [0], [])
    with pytest.raises(ValueError) as p_err:
        psched.build(spec, 100_000, table, scen, [0], [])
    assert str(p_err.value) == str(r_err.value)


def _final_pair(flows, seed: int):
    """A random final state over ``flows`` (done flags, FCTs): the
    reference's (numpy) and the port's (torch) view of it."""
    rng = np.random.default_rng(seed)
    F = flows.num_flows
    done = rng.random(F) < 0.9
    fct = (rng.random(F) * 1e5 + 50).astype(np.float32)
    return (types.SimpleNamespace(done=done, fct_us=fct),
            types.SimpleNamespace(done=torch.from_numpy(done),
                                  fct_us=torch.from_numpy(fct)))


def _stats_equal(got, want, what=""):
    if want is None:
        assert got is None, what
        return
    np.testing.assert_array_equal(got.slowdown, want.slowdown, err_msg=what)
    np.testing.assert_array_equal(got.sizes, want.sizes, err_msg=what)
    assert (got.completed, got.offered) == (want.completed, want.offered), what
    np.testing.assert_equal(got.completion_rate, want.completion_rate)
    np.testing.assert_equal(got.p50, want.p50)
    np.testing.assert_equal(got.p99, want.p99)
    edges = [0, 10_000, 100_000, 1_000_000, 1e12]
    assert got.by_size_bucket(edges) == want.by_size_bucket(edges), what


@pytest.mark.parametrize("case", ["testbed8", "wan2000_bg", "amp", "geo_sched"])
def test_metrics_exact(case):
    kw = {"testbed8": dict(topology="testbed8", load=0.5),
          "wan2000_bg": dict(WORLDS["wan2000"], load=0.5),
          "amp": dict(topology="testbed8", load=0.3, policy="amp",
                      n_subflows=4, bg_load=0.1),
          "geo_sched": dict(topology="geo", pairs="all", load=0.4,
                            load_sched="diurnal:segs=6")}[case]
    kw["duration_us"] = 100_000
    _, r_table, r_flows, r_cfg = rexp.build_experiment(rexp.ExpSpec(**kw))
    _, p_table, p_flows, p_cfg = pexp.build_experiment(pexp.ExpSpec(**kw))
    _flows_equal(p_flows, r_flows)
    r_fin, p_fin = _final_pair(r_flows, len(case))
    args_r, args_p = (r_table, r_flows, r_cfg), (p_table, p_flows, p_cfg)
    overall = rmetrics.fct_stats(r_fin, *args_r)
    _stats_equal(pmetrics.fct_stats(p_fin, *args_p), overall, "all")
    fg = r_flows.foreground
    _stats_equal(pmetrics.fct_stats(p_fin, *args_p, mask=fg),
                 rmetrics.fct_stats(r_fin, *args_r, mask=fg), "mask")
    for g, w in zip(pmetrics.fg_bg_stats(p_fin, *args_p),
                    rmetrics.fg_bg_stats(r_fin, *args_r)):
        _stats_equal(g, w, "fg_bg")
    got_pp = pmetrics.per_pair_stats(p_fin, *args_p)
    want_pp = rmetrics.per_pair_stats(r_fin, *args_r)
    assert sorted(got_pp) == sorted(want_pp)
    for pid in want_pp:
        _stats_equal(got_pp[pid], want_pp[pid], f"pair {pid}")
    np.testing.assert_array_equal(pmetrics.completion_wall_us(p_fin, p_flows),
                                  rmetrics.completion_wall_us(r_fin, r_flows))
    sched_t = np.array([0, 30_000, 60_000, 90_000])
    labels = ["peak", "off", "peak", "cross"]
    got_ph = pmetrics.phase_stats(p_fin, *args_p, sched_t, labels, mask=fg)
    want_ph = rmetrics.phase_stats(r_fin, *args_r, sched_t, labels, mask=fg)
    assert list(got_ph) == list(want_ph) == ["peak", "off", "cross"]
    for ph in want_ph:
        _stats_equal(got_ph[ph], want_ph[ph], ph)
    with pytest.raises(ValueError, match="seg_phase must label"):
        pmetrics.phase_stats(p_fin, *args_p, sched_t, labels[:2])
    if case == "amp":       # parents scored at their last subflow
        assert overall.offered * 4 == p_flows.num_flows
