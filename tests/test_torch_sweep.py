"""The port's batched sweep (``repro_torch.netsim.sweep``) on the CPU.

The contracts of ``tests/test_sweep.py`` held by the port: a group run as
one merged world equals the sequential per-cell loop bit for bit (``done``,
``fct_us``, ``flow_path``, served bytes, ``C_path``, re-decision nonces,
slowdowns, utilization); the policy x seed plane is one group;
``static_key`` separates CC laws and parameter overrides but not loads; mixed scenarios make one group each; the legacy
single-link trip equals the scenario trip; a silent degrade shifts
bytes. Then the port against the JAX package: its ``run_sweep`` on a
mixed grid (lcmp, ecmp, redte and fatpaths with a 10 ms re-decision
epoch) within the bands of ``tests/test_torch_fluid_runs.py``, and the
plain per-pair-law decisions against the reference's sweep-mode
``decide`` and ``_route_arrivals`` from carried state, integers exact.

The reference's shard_map test has its counterpart in
``tests/test_torch_sweep_mesh.py`` (the cells split over worker
processes). 60 ms horizons (600 steps) as in the reference's file; about
a minute on one worker.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim import engine as rengine
from repro.netsim import experiment as rexp
from repro.netsim import fluid as rfluid
from repro.netsim import sweep as rsweep
from repro_torch.core.tables import bootstrap_tables
from repro_torch.kernels import ref
from repro_torch.netsim import carry
from repro_torch.netsim import engine as pengine
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import fluid as pfluid
from repro_torch.netsim import sweep

_DUR = 60_000
FINAL = ("done", "fct_us", "flow_path", "serv_bytes", "c_path", "route_nonce")
P50_BAND, P99_BAND, COMPLETED_BAND = 0.03, 0.10, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The worlds here are small: torch's intra-op threads would only
    contend with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid():
    return [pexp.ExpSpec(topology="testbed8", load=load, policy=pol,
                         duration_us=_DUR, seed=seed)
            for load in (0.3, 0.5)
            for pol in ("lcmp", "ecmp", "redte")
            for seed in (0, 1)]


@pytest.fixture(scope="module")
def grid_seq():
    return sweep.run_sweep(_grid(), sequential=True, device="cpu")


def _same(a, b):
    for n in FINAL:
        np.testing.assert_array_equal(getattr(a.final, n), getattr(b.final, n),
                                      err_msg=f"{b.spec} {n}")
    np.testing.assert_array_equal(a.stats.slowdown, b.stats.slowdown)
    np.testing.assert_array_equal(a.util, b.util)
    assert a.stats.completed == b.stats.completed


def test_batched_sweep_matches_sequential_bit_for_bit(grid_seq):
    # one merged world for 2 loads x 3 policies x 2 seeds
    bat = sweep.run_sweep(_grid(), device="cpu")
    assert (bat.num_cells, bat.num_groups, bat.group_cells) == (12, 1, [12])
    for a, b in zip(grid_seq.results, bat.results):
        assert a.spec == b.spec
        _same(a, b)
    assert all(r.stats.completed > 0 for r in bat)


def test_policy_and_seed_axes_share_one_group():
    specs = [pexp.ExpSpec(topology="testbed8", load=0.3, policy=pol,
                          duration_us=_DUR, seed=seed)
             for pol in ("lcmp", "ecmp", "ucmp", "wcmp") for seed in (0, 1)]
    rep = sweep.run_sweep(specs, device="cpu")
    assert rep.num_groups == 1 and rep.group_cells == [8]
    assert all(r.stats.completed > 0 for r in rep)


def test_sweep_groups_by_static_axes():
    from repro_torch.core.select import SelectParams
    kw = dict(topology="testbed8", duration_us=_DUR)
    specs = [pexp.ExpSpec(load=0.3, cc="dcqcn", **kw),
             pexp.ExpSpec(load=0.5, cc="dcqcn", policy="ecmp", **kw),
             pexp.ExpSpec(load=0.3, cc="dctcp", **kw),
             pexp.ExpSpec(load=0.3, cc="dcqcn", select=SelectParams(alpha=1,
                                                                    beta=1),
                          **kw)]
    keys = [sweep.static_key(s) for s in specs]
    assert keys[0] == keys[1]
    assert keys[0] != keys[2]
    assert keys[0] != keys[3]


def test_sweep_mixed_scenarios_and_workloads():
    # use_mesh is a no-op with one device
    specs = [pexp.ExpSpec(topology="testbed8", workload=wl, load=0.3,
                          policy="lcmp", duration_us=_DUR)
             for wl in ("websearch", "fbhdp")]
    specs += [pexp.ExpSpec(topology="parallel:n=3,cap=40", load=0.3,
                           policy="ecmp", duration_us=_DUR)]
    rep = sweep.run_sweep(specs, use_mesh=True, device="cpu")
    assert rep.num_groups == 2 and rep.num_cells == 3
    assert rep.group_cells == [2, 1]
    for res in rep.results:
        assert res.stats.completed > 0
        assert np.isfinite(res.stats.p50)


def test_sweep_staleness_axes_bit_for_bit():
    # sig_delay_scale is static: one group per value, the live C_path
    # table (ctrl refresh over a degrade) per cell included
    specs = [pexp.ExpSpec(topology="staleness:deg_ms=20", load=0.3,
                          policy=pol, duration_us=_DUR, sig_delay_scale=sds,
                          ctrl_period_us=25_000)
             for sds in (0.0, 2.0) for pol in ("lcmp", "ecmp")]
    seq = sweep.run_sweep(specs, sequential=True, device="cpu")
    bat = sweep.run_sweep(specs, device="cpu")
    assert bat.num_groups == 2
    for a, b in zip(seq.results, bat.results):
        _same(a, b)


def test_entry_point_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_sweep(_grid()[:2])


def test_merged_world_is_the_cells_side_by_side():
    # the merged tables equal a bootstrap of the replicated capacities,
    # the index tables are offset per cell, each pair has its cell's law
    specs = [pexp.ExpSpec(topology="testbed8", load=0.3, policy=p,
                          duration_us=_DUR) for p in ("redte", "lcmp", "ecmp")]
    g = sweep.build_group(specs, device="cpu")
    assert g.cfg.policy == "sweep"
    assert g.cfg.sweep_policies == ("lcmp", "ecmp", "redte")
    one = g.cell_arrs[0]
    L, NP, NPAIR = one.link_cap.shape[0], one.path_links.shape[0], \
        one.pair_cand.shape[0]
    caps = [max(int(c * g.cfg.cap_scale), 1)
            for c in np.tile(pengine._infer_link_caps(g.table), 3)]
    tb = bootstrap_tables(caps, buffer_bytes=max(int(
        g.cfg.buffer_bytes * g.cfg.cap_scale), 1 << 20),
        sample_interval_us=g.cfg.dt_us, device="cpu")
    for n in ("cap_thresh", "level_score", "q_thresh", "trend_thresh"):
        assert torch.equal(getattr(g.arrs.tables, n), getattr(tb, n)), n
        assert torch.equal(getattr(one.tables, n),
                           getattr(tb, n)[:L] if n == "trend_thresh"
                           else getattr(tb, n)), n
    assert g.arrs.tables.high_water_level == tb.high_water_level
    codes = [pengine.POLICY_CODES[p] for p in ("redte", "lcmp", "ecmp")]
    assert g.arrs.pair_policy.tolist() == np.repeat(codes, NPAIR).tolist()
    for c, (sl, ar) in enumerate(zip(g.slices, g.cell_arrs)):
        assert (sl.link0, sl.path0, sl.pair0) == (c * L, c * NP, c * NPAIR)
        pl = g.arrs.path_links[sl.rows("paths")]
        assert torch.equal(torch.where(pl >= 0, pl - c * L, pl), ar.path_links)
        assert torch.equal(g.arrs.f_pair[sl.rows("flows")] - c * NPAIR,
                           ar.f_pair)
        assert torch.equal(g.arrs.link_cap[sl.rows("links")], ar.link_cap)
    assert g.arrs.arrivals.shape[1] == sum(a.arrivals.shape[1]
                                           for a in g.cell_arrs)
    # a step over rings whose flat index would overflow int32 is refused
    # (an expanded view: the rings' size without their memory)
    rows = (1 << 31) // pengine.HIST + 1
    big = dataclasses.replace(g.state, hist_q=torch.zeros(()).expand(
        rows, pengine.HIST))
    with pytest.raises(ValueError, match="int32"):
        pengine._cc_update(0, big, g.arrs, g.cfg, None, None, None)


def test_one_cell_under_sweep_takes_law_0():
    # as in the reference, a cell run under the meta-policy alone has
    # law code 0 (lcmp)
    kw = dict(topology="testbed8", load=0.5, duration_us=20_000)
    a, _, (_, _, _, _, fa) = pexp.run_experiment(
        pexp.ExpSpec(policy="sweep", **kw), device="cpu")
    b, _, (_, _, _, _, fb) = pexp.run_experiment(
        pexp.ExpSpec(policy="lcmp", **kw), device="cpu")
    assert torch.equal(fa.flow_path, fb.flow_path)
    assert torch.equal(fa.fct_us, fb.fct_us)


def test_failover_scenario_matches_legacy_fail_link():
    # the legacy single-event trip folds into the schedule: it equals the
    # scenario trip exactly in the port, its trip array is the
    # reference's, and its run lands within the bands of the reference's
    legacy_spec = pexp.ExpSpec(topology="testbed8", load=0.3, policy="lcmp",
                               duration_us=120_000, seed=5)
    _, table, flows, cfg = pexp.build_experiment(legacy_spec)
    cfg = dataclasses.replace(cfg, fail_link=12, fail_at_us=40_000)
    assert cfg.has_failures
    arrs, st = pfluid.build(table, flows, cfg, device="cpu")
    legacy_arrs_fail = arrs.link_fail_step.clone()
    legacy = pfluid.run(arrs, st, cfg)

    scen_spec = dataclasses.replace(
        legacy_spec, topology="testbed8_failover:fail_ms=40,link=12")
    _, table2, flows2, cfg2 = pexp.build_experiment(scen_spec)
    assert flows2.num_flows == flows.num_flows
    arrs2, st2 = pfluid.build(table2, flows2, cfg2, device="cpu")
    assert torch.equal(arrs2.link_fail_step, legacy_arrs_fail)
    final = pfluid.run(arrs2, st2, cfg2)
    for n in ("done", "fct_us", "flow_path", "link_alive", "route_step"):
        assert torch.equal(getattr(legacy, n), getattr(final, n)), n
    assert not bool(final.link_alive[12])

    _, rtable, rflows, rcfg = rexp.build_experiment(rexp.ExpSpec(
        **dataclasses.asdict(legacy_spec)))
    rcfg = dataclasses.replace(rcfg, fail_link=12, fail_at_us=40_000)
    r_arrs, r_st = rfluid.build(rtable, rflows, rcfg)
    np.testing.assert_array_equal(np.asarray(r_arrs.link_fail_step),
                                  legacy_arrs_fail.numpy())
    r_fin = rfluid.run(r_arrs, r_st, rcfg)
    step = np.minimum(flows.arrival_us // cfg.dt_us, cfg.num_steps - 1)
    early = step < 300
    assert (np.asarray(r_fin.flow_path)[early]
            == legacy.flow_path.numpy()[early]).mean() >= 0.99
    from repro.netsim import metrics as rmetrics
    from repro_torch.netsim import metrics as pmetrics
    r = rmetrics.fct_stats(r_fin, rtable, rflows, rcfg)
    p = pmetrics.fct_stats(legacy, table, flows, cfg)
    _within_bands(p, r, "legacy trip")


def test_degradation_shifts_new_placements():
    spec = pexp.ExpSpec(topology="parallel:n=2,cap=100", load=0.5,
                        policy="ecmp", duration_us=150_000, seed=3)
    _, table, flows, cfg = pexp.build_experiment(spec)
    arrs, st = pfluid.build(table, flows, cfg, device="cpu")
    healthy = pfluid.run(arrs, st, cfg)

    first = int(table.path_first[0])
    cfg_d = dataclasses.replace(cfg, degrade_sched=((first, 30_000, 0.2),))
    arrs_d, st_d = pfluid.build(table, flows, cfg_d, device="cpu")
    degraded = pfluid.run(arrs_d, st_d, cfg_d)

    assert degraded.done.double().mean() > 0.9
    assert (float(degraded.serv_bytes[first])
            < 0.8 * float(healthy.serv_bytes[first]))
    done = healthy.done
    assert torch.equal(healthy.flow_path[done], degraded.flow_path[done])


def _within_bands(p, r, what):
    assert p.offered == r.offered, what
    assert abs(p.p50 - r.p50) <= P50_BAND * r.p50, (what, p.p50, r.p50)
    assert abs(p.p99 - r.p99) <= P99_BAND * r.p99, (what, p.p99, r.p99)
    assert abs(p.completed - r.completed) <= COMPLETED_BAND * r.offered, what


def test_sweep_within_bands_of_the_reference_sweep():
    # one mixed group with a re-decision epoch: lcmp, ecmp and redte stay
    # pinned (nonce 0) while fatpaths re-decides
    kw = dict(topology="testbed8", load=0.5, duration_us=_DUR,
              redecide_period_us=10_000)
    pols = ("lcmp", "ecmp", "redte", "fatpaths")
    mine = sweep.run_sweep([pexp.ExpSpec(policy=p, **kw) for p in pols],
                           device="cpu")
    theirs = rsweep.run_sweep([rexp.ExpSpec(policy=p, **kw) for p in pols])
    assert mine.num_groups == 1
    for p, m, r in zip(pols, mine.results, theirs.results):
        flows = m.flows
        early = flows.arrival_us < _DUR // 4
        same = (m.final.flow_path[early]
                == np.asarray(r.final.flow_path)[early]).mean()
        assert same >= 0.99, (p, same)
        _within_bands(m.stats, r.stats, p)
        moved = int(m.final.route_nonce.max())
        assert (moved > 0) == (p == "fatpaths"), (p, moved)


@pytest.fixture(scope="module")
def carried():
    """A testbed8 world with traffic on every pair, its state carried 600
    steps by the reference's scanned lcmp step, a quarter of the links
    then down and random RedTE weights; a random law per pair."""
    spec = rexp.ExpSpec(topology="testbed8", load=0.5, pairs="all",
                        duration_us=400_000)
    _, rt, rf, rcfg = rexp.build_experiment(spec)
    r_arr, r_st = rfluid.build(rt, rf, rcfg)
    step = rfluid.make_step(r_arr, rcfg)
    r_st = jax.jit(lambda s: jax.lax.scan(step, s, jnp.arange(600))[0])(r_st)
    rng = np.random.default_rng(7)
    state = _flat(r_st)
    state["link_alive"] = rng.random(state["link_alive"].shape[0]) >= 0.25
    state["redte_w"] = rng.integers(0, 300, state["redte_w"].shape).astype(np.int32)
    r_st = _to_reference(r_st, state)
    p_arr, p_st = carry.from_reference(_flat(r_arr), state, device="cpu")
    codes = rng.integers(0, len(ref.LAWS), p_arr.pair_cand.shape[0])
    p_arr = dataclasses.replace(p_arr, pair_policy=torch.from_numpy(
        codes.astype(np.int32)))
    rcfg = dataclasses.replace(rcfg, policy="sweep")
    return rcfg, r_arr, r_st, p_arr, p_st, codes


def _flat(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, prefix + f.name + "."))
        elif v is not None:
            out[prefix + f.name] = np.asarray(v)
    return out


def _to_reference(r_st, state):
    kw = {f.name: jnp.asarray(state[f.name]) for f in dataclasses.fields(r_st)
          if f.name in state}
    return dataclasses.replace(r_st, **kw)


def test_plain_per_pair_law_matches_reference_sweep(carried):
    # every law the reference's sweep-mode decide gives a cell of that
    # code, the port's plain versions give each pair of that code
    rcfg, r_arr, r_st, p_arr, p_st, codes = carried
    pcfg = pengine.SimConfig(policy="sweep", cap_scale=rcfg.cap_scale,
                             horizon_us=rcfg.horizon_us)
    pair = p_arr.f_pair.numpy()
    law = codes[pair]
    assert len(np.unique(law)) == len(ref.LAWS)
    r_decide = jax.jit(rengine.decide, static_argnums=(5,))
    r_route = jax.jit(rengine._route_arrivals, static_argnums=(3,))
    for t, sig in ((0, -1), (600, 599), (600, 600)):
        pk, pc = pengine.decide(t, p_arr.f_id, p_arr.f_pair, p_st, p_arr,
                                pcfg, sig_step=sig)
        for c in range(len(ref.LAWS)):
            rk, rc = r_decide(
                t, r_arr.f_id, r_arr.f_pair, r_st,
                dataclasses.replace(r_arr, policy_code=jnp.int32(c)), rcfg,
                sig)
            m = law == c
            np.testing.assert_array_equal(pk.numpy()[m], np.asarray(rk)[m])
            np.testing.assert_array_equal(pc.numpy()[m], np.asarray(rc)[m])
    routed = 0
    for t in (600, 601, 602, 603):
        got = pengine._route_arrivals(t, p_st, p_arr, pcfg)
        row = p_arr.arrivals[t].numpy()
        row = row[row >= 0]
        for c in np.unique(law[row]):
            want = r_route(t, r_st, dataclasses.replace(
                r_arr, policy_code=jnp.int32(c)), rcfg)
            f = row[law[row] == c]
            for n in ("flow_path", "rtt_steps", "route_step", "active"):
                np.testing.assert_array_equal(getattr(got, n).numpy()[f],
                                              np.asarray(getattr(want, n))[f])
            np.testing.assert_allclose(got.extra_wait.numpy()[f],
                                       np.asarray(want.extra_wait)[f],
                                       rtol=1e-6, atol=0)
            routed += int(got.active.numpy()[f].sum())
    assert routed > 0
