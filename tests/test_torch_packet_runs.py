"""Whole packet-engine runs of the port on the CPU, held to the JAX
package: the counterparts of ``tests/test_engines.py`` (the closed-form
single-flow FCT, lossless and buffer-bounded queues under PFC, the
degenerate candidate sets routed alike by both engines, packet failover
with go-back-N, the engine as a sweep axis with batched equal to
sequential bit for bit) and ``lcmp_r`` with both re-decision knobs off
equal to ``lcmp``. Short worlds; about a minute on one worker.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.netsim import experiment as rexp
from repro.netsim import packet as rpacket
from repro.netsim import paths as rpaths
from repro.netsim import scenarios as rscen
from repro.netsim import topo as rtopo
from repro.netsim.engine import SimConfig as RSimConfig
from repro.netsim.engine import attach_link_caps as rattach
from repro.traffic.gen import FlowSet as RFlowSet
from repro_torch.netsim import engine as pengine
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import packet as ppacket
from repro_torch.netsim import paths as ppaths
from repro_torch.netsim import scenarios as pscen
from repro_torch.netsim import sweep
from repro_torch.netsim import topo as ptopo
from repro_torch.traffic.gen import FlowSet as PFlowSet

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


def _within_bands(p, r, what):
    assert p.offered == r.offered, what
    assert abs(p.p50 - r.p50) <= P50_BAND * r.p50, (what, p.p50, r.p50)
    assert abs(p.p99 - r.p99) <= P99_BAND * r.p99, (what, p.p99, r.p99)
    assert abs(p.completed - r.completed) <= COMPLETED_BAND * r.offered, what


# --------------------------------------------- closed-form single flow
def _single_flow(pkg_topo, pkg_paths, attach, flowset, size):
    t = pkg_topo.parallel_paths(caps=(100,), delays_us=(5000,))
    table = pkg_paths.build_path_table(t, [(0, 2)])
    attach(table, t)
    flows = flowset(arrival_us=np.array([1000], np.int64),
                    size_bytes=np.array([float(size)]),
                    pair_id=np.array([0], np.int32),
                    flow_id=np.array([42], np.uint32))
    return table, flows


@pytest.mark.parametrize("policy", ["lcmp", "ecmp"])
@pytest.mark.parametrize("size", [5e6, 1e5])
def test_packet_single_flow_matches_closed_form(policy, size):
    """A flow alone: FCT = prop + size / bottleneck within one slot, every
    byte delivered once, and the reference's FCT to float32 rounding."""
    table, flows = _single_flow(ptopo, ppaths, pengine.attach_link_caps,
                                 PFlowSet, size)
    cfg = pengine.SimConfig(engine="packet", policy=policy,
                            horizon_us=200_000, cap_scale=1.0)
    arrs, st = ppacket.build(table, flows, cfg, device="cpu")
    final = ppacket.run(arrs, st, cfg)
    assert bool(final.done[0])
    ideal = 6000.0 + size / (100 * 125.0)
    got = float(final.fct_us[0])
    assert abs(got - ideal) <= cfg.dt_us + 1e-3, (got, ideal)
    assert abs(float(final.delivered[0]) - size) < 1.0

    r_table, r_flows = _single_flow(rtopo, rpaths, rattach, RFlowSet,
                                      size)
    rcfg = RSimConfig(engine="packet", policy=policy, horizon_us=200_000,
                      cap_scale=1.0)
    r_final = rpacket.run(*rpacket.build(r_table, r_flows, rcfg), rcfg)
    np.testing.assert_allclose(got, float(r_final.fct_us[0]), rtol=1e-6)


# ------------------------------------------------ lossless, buffer-bounded
def test_packet_queues_lossless_and_buffer_bounded():
    """A 99% silent degrade with tightened PFC thresholds: XOFF engages on
    the degraded link, queues stay inside the scaled buffer and near the
    XOFF line, hop queues stay non-negative; the queue peak is the
    reference's to float32 rounding."""
    kw = dict(topology="parallel:n=1,cap=100", load=0.5, policy="ecmp",
              engine="packet", duration_us=100_000, seed=3)
    peaks = []
    for exp, pkt in ((pexp, ppacket), (rexp, rpacket)):
        _, table, flows, cfg = exp.build_experiment(exp.ExpSpec(**kw))
        first = int(table.path_first[0])
        cfg = dataclasses.replace(cfg, degrade_sched=((first, 20_000, 0.01),),
                                  pfc_xoff_frac=0.02, pfc_xon_frac=0.01)
        build = (lambda: pkt.build(table, flows, cfg, device="cpu")) \
            if pkt is ppacket else (lambda: pkt.build(table, flows, cfg))
        final = pkt.run(*build(), cfg)
        hist_q, hist_pause = np.asarray(final.hist_q), np.asarray(final.hist_pause)
        buf = cfg.buffer_bytes * cfg.cap_scale
        assert hist_q.max() <= buf + 1e-3
        assert float(np.asarray(final.fq).min()) >= -1e-3
        # reprolint: ignore[RNG001] link-axis index over the whole ring
        assert hist_pause[first].any()
        # reprolint: ignore[RNG001] link-axis index over the whole ring
        peak = hist_q[first].max()
        assert peak < 0.5 * buf
        peaks.append(peak)
    np.testing.assert_allclose(peaks[0], peaks[1], rtol=1e-5)


# ------------------------------------- degenerate candidates, both engines
def _burst_world(topology, n_flows=64, size=2e4):
    """A same-slot burst against a named scenario world, every decision at
    t = 0 on all-zero congestion state."""
    scen = pscen.get(topology)
    t = scen.topology
    table = ppaths.build_path_table(t, ppaths.all_pairs(t))
    pengine.attach_link_caps(table, t)
    pidx = table.pair_index()[scen.main_pair]
    rng = np.random.default_rng(0)
    flows = PFlowSet(
        arrival_us=np.zeros(n_flows, np.int64),
        size_bytes=np.full(n_flows, float(size)),
        pair_id=np.full(n_flows, pidx, np.int32),
        flow_id=rng.integers(1, 1 << 32, n_flows, dtype=np.uint32))
    return table, flows, pidx


def _both_engines(table, flows, horizon_us=100_000, **cfg_kw):
    out = {}
    for name in ("fluid", "packet"):
        eng = pengine.get_engine(name)
        cfg = pengine.SimConfig(engine=name, horizon_us=horizon_us, **cfg_kw)
        arrs, st = eng.build(table, flows, cfg, device="cpu")
        final = eng.run(arrs, st, cfg)
        out[name] = (final.flow_path.numpy(), final)
    return out


def test_single_valid_candidate_identical():
    table, flows, _ = _burst_world("parallel:n=1")
    res = _both_engines(table, flows, policy="lcmp")
    for fp, _ in res.values():
        assert (fp == fp[0]).all() and fp[0] >= 0
    assert np.array_equal(res["fluid"][0], res["packet"][0])


def test_all_candidates_invalid_identical():
    table, flows, _ = _burst_world("parallel:n=2")
    firsts = sorted({int(f) for f in table.path_first})
    res = _both_engines(table, flows, horizon_us=50_000, policy="lcmp",
                        fail_sched=tuple((li, 0) for li in firsts))
    for fp, final in res.values():
        assert (fp == -1).all()
        assert not final.done.any()
    assert np.array_equal(res["fluid"][0], res["packet"][0])


def test_weighted_hash_bounds_identical():
    table, flows, pidx = _burst_world(
        "longhaul_mesh:routes=4,segs=1,caps=200+100+40,hi_ms=5")
    res = _both_engines(table, flows, policy="lcmp_w")
    cands = set(table.pair_cand[pidx][:table.pair_ncand[pidx]].tolist())
    for fp, _ in res.values():
        assert set(fp.tolist()) <= cands and (fp >= 0).all()
        assert len(set(fp.tolist())) >= 2
    assert np.array_equal(res["fluid"][0], res["packet"][0])
    # the reference's packet engine places the herd the same way
    scen = rscen.get("longhaul_mesh:routes=4,segs=1,caps=200+100+40,hi_ms=5")
    r_table = rpaths.build_path_table(scen.topology,
                                      rpaths.all_pairs(scen.topology))
    rattach(r_table, scen.topology)
    r_flows = RFlowSet(arrival_us=flows.arrival_us, size_bytes=flows.size_bytes,
                       pair_id=flows.pair_id, flow_id=flows.flow_id)
    rcfg = RSimConfig(engine="packet", horizon_us=100_000, policy="lcmp_w")
    r_final = rpacket.run(*rpacket.build(r_table, r_flows, rcfg), rcfg)
    assert np.array_equal(np.asarray(r_final.flow_path), res["packet"][0])


# ------------------------------------------------------- packet failover
def test_packet_failover_completes_and_avoids_dead_link():
    """Go-back-N at a trip: flows re-hash onto live candidates and still
    complete, nothing later lands on the dead link, and the run is within
    the bands of the reference's."""
    kw = dict(topology="testbed8_failover:fail_ms=60,link=12", load=0.3,
              policy="lcmp", engine="packet", duration_us=180_000, seed=5)
    stats, _, (_, table, flows, cfg, final) = pexp.run_experiment(
        pexp.ExpSpec(**kw), device="cpu")
    done = final.done.numpy()
    assert done.mean() > 0.95
    uses12 = (np.asarray(table.path_links) == 12).any(-1)[
        np.maximum(final.flow_path.numpy(), 0)]
    late = done & (flows.arrival_us > 60_000)
    assert not uses12[late].any()
    r_stats, _, _ = rexp.run_experiment(rexp.ExpSpec(**kw))
    _within_bands(stats, r_stats, "failover")


# -------------------------------------------------- the engine sweep axis
def test_sweep_engine_axis_groups_and_matches_sequential():
    """engine is a static axis: a mixed fluid and packet grid forms one
    group per engine, and every cell equals its sequential run bit for
    bit."""
    specs = [pexp.ExpSpec(topology="testbed8", load=0.3, policy=pol,
                          engine=eng, duration_us=60_000, seed=1)
             for eng in ("fluid", "packet") for pol in ("lcmp", "ecmp")]
    seq = sweep.run_sweep(specs, sequential=True, device="cpu")
    bat = sweep.run_sweep(specs, device="cpu")
    assert bat.num_groups == 2 and bat.group_cells == [2, 2]
    for a, b in zip(seq.results, bat.results):
        for f in FINAL:
            assert np.array_equal(getattr(a.final, f), getattr(b.final, f)), \
                (b.spec, f)
        assert np.array_equal(a.util, b.util), b.spec
        assert (a.stats.p50, a.stats.p99) == (b.stats.p50, b.stats.p99)
    g = sweep.build_group(specs[2:], device="cpu")
    assert isinstance(g.state, ppacket.PacketState)
    cell = pengine.slice_cell(g.state, g.slices[1])
    assert isinstance(cell, ppacket.PacketState)
    assert cell.fq.shape[0] == cell.flow_path.shape[0] == g.slices[1].F
    assert cell.hist_pause.shape[0] == g.slices[1].L


def test_lcmp_r_knobs_off_is_lcmp_bit_for_bit():
    kw = dict(topology="testbed8", load=0.3, duration_us=60_000, seed=1,
              engine="packet")
    _, _, (_, _, _, _, fa) = pexp.run_experiment(
        pexp.ExpSpec(policy="lcmp", **kw), device="cpu")
    _, _, (_, _, _, _, fb) = pexp.run_experiment(
        pexp.ExpSpec(policy="lcmp_r", **kw), device="cpu")
    for f in ("fct_us", "flow_path", "done", "route_nonce", "delivered"):
        assert torch.equal(getattr(fa, f), getattr(fb, f)), f
