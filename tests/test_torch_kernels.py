"""Port parity of the kernel modules.

On the CPU, ``repro_torch.kernels.ops`` runs the plain versions; they
must equal the JAX package's Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and its ``ref`` oracles bit for bit.
The tests marked ``cuda`` hold the hand-written CUDA kernels against the
plain versions on the card; they skip themselves without one. The JAX
package is imported by the ``jref`` fixture only, so the card tests also
run on a GPU machine without JAX (``pytest -m cuda``).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core.cong import CongParams, CongState
from repro_torch.core.select import SelectParams
from repro_torch.core.tables import bootstrap_tables
from repro_torch.kernels import ops, ref

REG_FIELDS = ("queue_cur", "queue_prev", "trend", "dur_cnt", "last_sample")
HASH_EDGES = [0, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 1]


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernel entry points and core types."""
    import jax.numpy as jnp

    from repro.core import cong, select, tables
    from repro.kernels import ops as rops
    from repro.kernels import ref as rref
    return types.SimpleNamespace(jnp=jnp, cong=cong, select=select,
                                 tables=tables, ops=rops, ref=rref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eq(got, want, what=""):
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(want).astype(got.dtype),
                                  err_msg=what)


# ---------------------------------------------------------------- cong_update
def _cong_world(n_ports, seed, buffer_bytes=10**9):
    rng = np.random.default_rng(seed)
    rates = rng.choice([25, 40, 100, 200, 400], n_ports).tolist()
    return rng, rates, dict(buffer_bytes=buffer_bytes, sample_interval_us=200)


@pytest.mark.parametrize("params", [{}, dict(w_ql=1, w_tl=2, w_dp=1,
                                             ewma_k=2, dur_shift=1)])
@pytest.mark.parametrize("n_ports", [1, 5, 24, 152, 400])
def test_cong_update_matches_pallas_and_ref(jref, n_ports, params):
    jnp = jref.jnp
    rng, rates, kw = _cong_world(n_ports, n_ports)
    r_tb = jref.tables.bootstrap_tables(rates, **kw)
    p_tb = bootstrap_tables(rates, device="cpu", **kw)
    rp, pp = jref.cong.CongParams(**params), CongParams(**params)
    r_st, p_st = (jref.cong.CongState.init(n_ports),
                  CongState.init(n_ports, device="cpu"))
    ring = torch.full((n_ports, 16), -7, dtype=torch.int32)   # a short hist_c
    launches = ops.counts()["cong_update"]
    for tick in range(6):
        hi = 1_000_000 if tick % 3 < 2 else 100    # drains: negative trends
        q = rng.integers(0, hi, n_ports).astype(np.int32)
        k_st, k_cc = jref.ops.cong_update(r_st, jnp.asarray(q), tick * 200,
                                          r_tb, rp)
        o_st, o_cc = jref.ref.cong_update_ref(r_st, jnp.asarray(q), tick * 200,
                                              r_tb, rp)
        p_st, p_cc = ops.cong_update(p_st, torch.from_numpy(q), tick * 200,
                                     p_tb, pp, hist_c=ring, slot=tick)
        _eq(p_cc, k_cc, "c_cong vs pallas")
        _eq(p_cc, o_cc, "c_cong vs ref")
        _eq(ring[:, tick], k_cc, "hist_c slot")
        for f in REG_FIELDS[:4]:
            _eq(getattr(p_st, f), getattr(k_st, f), f)
        _eq(p_st.last_sample, o_st.last_sample, "last_sample")
        r_st = o_st
    assert (ring[:, 6:] == -7).all()        # other slots untouched
    assert ops.counts()["cong_update"] == launches   # plain version: no launch


# ---------------------------------------------------------------- lcmp_decide
def _decide_inputs(seed, F, P):
    rng = np.random.default_rng(seed)
    fids = rng.integers(0, 1 << 32, F).astype(np.uint32)
    fids[:min(F, len(HASH_EDGES))] = HASH_EDGES[:F]
    c_path = rng.integers(0, 256, (F, P)).astype(np.int32)
    c_cong = rng.integers(0, 256, (F, P)).astype(np.int32)
    valid = rng.random((F, P)) < 0.8
    if F > 2:
        valid[F // 2] = False                               # none valid
        c_cong[F - 1] = rng.integers(230, 256, P)           # fallback
    return fids, c_path, c_cong, valid


def _torch(fids, c_path, c_cong, valid, dev="cpu"):
    return (torch.from_numpy(fids.astype(np.int64)).to(dev),
            torch.from_numpy(c_path).to(dev), torch.from_numpy(c_cong).to(dev),
            torch.from_numpy(valid).to(dev))


@pytest.mark.parametrize("F", [1, 9, 24, 300])
@pytest.mark.parametrize("P", [2, 3, 5, 8])
def test_lcmp_decide_matches_pallas_and_ref(jref, F, P):
    inp = _decide_inputs(F * 31 + P, F, P)
    want = jref.ops.lcmp_decide(*[jref.jnp.asarray(x) for x in inp])
    np.testing.assert_array_equal(np.asarray(want),
                                  np.asarray(jref.ref.lcmp_decide_ref(*inp)))
    got = ops.lcmp_decide(*_torch(*inp))
    assert got.dtype == torch.int32
    _eq(got, want)
    _eq(ref.lcmp_decide_ref(*_torch(*inp)), want)


@pytest.mark.parametrize("seed", range(4))
def test_lcmp_decide_param_sweep(jref, seed):
    kw = [dict(alpha=1, beta=1), dict(alpha=1, beta=3),
          dict(alpha=3, beta=1, cong_fallback=100),
          dict(alpha=2, beta=2, keep_num=3)][seed]
    inp = _decide_inputs(seed, 256, 6)
    want = jref.ops.lcmp_decide(*[jref.jnp.asarray(x) for x in inp],
                                jref.select.SelectParams(**kw))
    _eq(ops.lcmp_decide(*_torch(*inp), SelectParams(**kw)), want)


def test_lcmp_decide_wide_sets_run_the_plain_version_on_cpu(jref):
    ops.reset_counts()
    inp = _decide_inputs(7, 64, 10)
    want = jref.ref.lcmp_decide_ref(*inp)
    _eq(ops.lcmp_decide(*_torch(*inp)), want)
    assert ops.counts() == {"cong_update": 0, "lcmp_decide": 0,
                            "monitor_tick": 0, "route_arrivals": 0,
                            "decide": 0, "switch_route": 0,
                            "qsr_int8": 0, "qsr_dequant": 0}


def test_wrappers_refuse_other_devices():
    inp = [x.to("meta") for x in _torch(*_decide_inputs(0, 4, 4))]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.lcmp_decide(*inp)
    tb = bootstrap_tables([100] * 3, device="cpu")
    st = CongState.init(3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.cong_update(st, torch.zeros(3, dtype=torch.int32, device="meta"),
                        0, tb)


def test_decide_wrapper_is_the_plain_version_only():
    # off the CPU only a run's launcher decides (RouteArrivals.decide), so
    # a decision never builds and checks a launcher of its own
    ar = types.SimpleNamespace(
        pair_cand=torch.zeros((1, 2), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match=r"RouteArrivals\.decide"):
        ops.decide(0, None, None, None, ar, "lcmp")


# ------------------------------------------------------- on the card (cuda)
@pytest.mark.cuda
@pytest.mark.parametrize("n_ports", [24, 152, 1 << 20])
def test_cuda_cong_update_matches_plain(cuda, n_ports):
    rng, rates, kw = _cong_world(n_ports, 1)
    tb = bootstrap_tables(rates, device=cuda, **kw)
    st_k, st_p = CongState.init(n_ports, cuda), CongState.init(n_ports, cuda)
    hist = torch.zeros((n_ports, 8), dtype=torch.int32, device=cuda)
    before = ops.counts()["cong_update"]
    for tick in range(5):
        hi = 1_000_000 if tick % 3 < 2 else 100
        q = torch.from_numpy(rng.integers(0, hi, n_ports).astype(np.int32)).to(cuda)
        st_k, cc_k = ops.cong_update(st_k, q, tick * 200, tb, hist_c=hist,
                                     slot=tick)
        st_p, cc_p = ref.cong_update_ref(st_p, q, tick * 200, tb)
        torch.cuda.synchronize()
        assert torch.equal(cc_k, cc_p)
        assert torch.equal(hist[:, tick], cc_p)
        for f in dataclasses.fields(CongState):
            assert torch.equal(getattr(st_k, f.name), getattr(st_p, f.name)), f.name
    assert ops.counts()["cong_update"] == before + 5


@pytest.mark.cuda
@pytest.mark.parametrize("F,P", [(9, 8), (24, 8)] + [(1 << 20, p) for p in range(2, 9)])
def test_cuda_lcmp_decide_matches_plain(cuda, F, P):
    inp = _torch(*_decide_inputs(F + P, F, P), dev=cuda)
    before = ops.counts()["lcmp_decide"]
    got = ops.lcmp_decide(*inp)
    want = ref.lcmp_decide_ref(*inp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ops.counts()["lcmp_decide"] == before + 1


@pytest.mark.cuda
def test_cuda_wrappers_check_inputs(cuda):
    fid, cp, cc, vd = _torch(*_decide_inputs(0, 16, 4), dev=cuda)
    with pytest.raises(ValueError, match="c_cong"):
        ops.lcmp_decide(fid, cp, cc.to(torch.int64), vd)
    with pytest.raises(ValueError, match="valid"):
        ops.lcmp_decide(fid, cp, cc, vd.t().contiguous().t())
    tb = bootstrap_tables([100] * 4, device=cuda, num_levels=8)
    with pytest.raises(ValueError, match="num_levels"):
        ops.cong_update(CongState.init(4, cuda),
                        torch.zeros(4, dtype=torch.int32, device=cuda), 0, tb)


@pytest.mark.cuda
def test_cuda_lcmp_decide_refuses_wide_sets(cuda):
    inp = _torch(*_decide_inputs(3, 16, 9), dev=cuda)
    with pytest.raises(ValueError, match="P <= 8"):
        ops.lcmp_decide(*inp)


@pytest.mark.cuda
def test_cuda_empty_inputs_launch_nothing(cuda):
    before = ops.counts()
    got = ops.lcmp_decide(*_torch(*_decide_inputs(0, 0, 8), dev=cuda))
    assert got.shape == (0,)
    tb = bootstrap_tables([], device=cuda)
    st, cc = ops.cong_update(CongState.init(0, cuda),
                             torch.zeros(0, dtype=torch.int32, device=cuda), 0, tb)
    assert cc.shape == (0,)
    assert ops.counts() == before


# ------------------------------------------------- qsr_int8 on the card (cuda)
def _qsr_case(n, dev, seed=0):
    from repro_torch.dist import compress
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 100.0], n)).astype(np.float32)
    x[:1024] = 0.0                                   # a zero block
    if n > 2048:
        x[1024 + 5] = -np.abs(x[1024:2048]).max() * 2  # an element at -amax
        x[1024 + 9] = -x[1024 + 5]                     # and one at +amax
    return (torch.from_numpy(x).to(dev),
            compress.rand_bits(n, seed + 11, salt=1, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1 << 16, 3 * 1024 * 1000, 1 << 24])
def test_cuda_qsr_int8_and_dequant_bit_exact(cuda, n):
    x, bits = _qsr_case(n, cuda, n % 7)
    before = ops.counts()
    q, s = ops.qsr_int8(x, bits)
    qp, sp = ref.qsr_int8_ref(x, bits)
    y = ops.qsr_dequant(q, s)
    yp = ref.qsr_dequant_ref(qp, sp)
    torch.cuda.synchronize()
    assert torch.equal(q, qp) and torch.equal(s, sp)
    assert torch.equal(y, yp)
    assert (q[:1024] == 0).all() and s[0] == 0
    if n > 2048:        # at -amax and +amax: the clip edge (or one step in)
        assert int(q[1024 + 5]) in (-127, -126) and int(q[1024 + 9]) in (126, 127)
    after = ops.counts()
    assert after["qsr_int8"] == before["qsr_int8"] + 1
    assert after["qsr_dequant"] == before["qsr_dequant"] + 1


@pytest.mark.cuda
def test_cuda_qsr_unbiased(cuda):
    from repro_torch.dist import compress
    n = 2048
    x = torch.zeros(n, device=cuda)
    x[1024:] = 0.3
    acc = torch.zeros(n, dtype=torch.float64, device=cuda)
    for seed in range(64):
        q, s = ops.qsr_int8(x, compress.rand_bits(n, seed, device=cuda))
        acc += ops.qsr_dequant(q, s).double()
    acc /= 64
    assert (acc[:1024] == 0).all()
    assert float((acc[1024:] - 0.3).abs().max()) <= 2e-3


@pytest.mark.cuda
def test_cuda_qsr_checks_inputs(cuda):
    x = torch.zeros(2048, device=cuda)
    bits = torch.zeros(2048, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rand_bits"):
        ops.qsr_int8(x, bits.to(torch.int64))
    with pytest.raises(ValueError, match="multiple of 1024"):
        ops.qsr_int8(x[:1000], bits[:1000])
    with pytest.raises(ValueError, match="misaligned"):
        ops.qsr_int8(torch.zeros(1025, device=cuda)[1:], bits[:1024])
    with pytest.raises(ValueError, match="not contiguous"):
        ops.qsr_int8(torch.zeros(4096, device=cuda)[::2], bits)
    with pytest.raises(ValueError, match="scales"):
        ops.qsr_dequant(torch.zeros(2048, dtype=torch.int8, device=cuda),
                        torch.zeros(3, device=cuda))


@pytest.mark.cuda
def test_cuda_pod_reduce_int8_equals_cpu(cuda):
    """The whole int8 pod reduce is exact arithmetic around the kernels
    (the same bits, bit-exact kernels, a mean of two), so the card gives
    the CPU's result bit for bit, through the kernels."""
    from repro_torch.dist import lcmp_collectives as plc
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3 * 65_536 + 123)).astype(np.float32))
    ax = plc.PodAxis("pod", 2)
    want = plc.lcmp_pod_reduce({"g": g}, ax, compress=True)["g"]
    before = ops.counts()
    got = plc.lcmp_pod_reduce({"g": g.to(cuda)}, ax, compress=True)["g"]
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    after = ops.counts()
    assert after["qsr_int8"] - before["qsr_int8"] == 4        # 2 pods x 2 legs
    assert after["qsr_dequant"] - before["qsr_dequant"] == 3  # 2 partials + gather
    plc._TELEMETRY.reset()


# -------------------------------- the fluid engine's fused phases (cuda)
def _chip_smoke():
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py's route and monitor checks (torch and numpy only)."""
    return _chip_smoke()


@pytest.mark.cuda
@pytest.mark.parametrize("n_ports", [24, 152, 166, 1 << 20])
def test_cuda_monitor_tick_matches_plain(cuda, cs, n_ports):
    rng, rates, kw = _cong_world(n_ports, 2)
    tb = bootstrap_tables(rates, device=cuda, **kw)
    r = cs.check_monitor(cuda, tb, f"N={n_ports}", 0)
    assert r["max_abs_err"] == 0


LAWS = ref.LAWS


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["testbed8", "wan2000", "geo"])
@pytest.mark.parametrize("kind", ["live", "dead", "cut", "fallback"])
@pytest.mark.parametrize("policy", LAWS)
def test_cuda_route_arrivals_matches_plain(cuda, cs, world, kind, policy):
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import fluid
    _, table, flows, cfg = pexp.build_experiment(
        pexp.ExpSpec(**cs.CHECK_WORLDS[world], policy=policy))
    arrs, st = fluid.build(table, flows, cfg, device=cuda)
    w = dict(arrs=arrs, state=st)
    ar, st = cs.world_state(cuda, w, kind, seed=3)
    rows = cs.check_rows(arrs.arrivals.cpu().numpy(),
                         int(arrs.path_sig_delay.max()))
    rows = sorted(set(rows) | {cs.stranded_row(ar, st)} - {-1})
    r = cs.check_route(cuda, ar, st, policy, f"{world} {policy} {kind}", 0,
                       cfg.select, cfg.dt_us, rows)
    assert r["max_abs_err"] == 0
    assert (r["routed"] == 0) == (kind == "cut")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", LAWS)
def test_cuda_route_arrivals_bulk_matches_plain(cuda, cs, policy):
    from repro_torch.core.select import SelectParams
    ar, st = cs.bulk_route_world(cuda)
    r = cs.check_route(cuda, ar, st, policy, f"bulk {policy}", 0,
                       SelectParams(), 200, [0, 1, 2, 3])
    assert r["max_abs_err"] == 0 and r["no_candidate"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["testbed8", "wan2000", "geo"])
@pytest.mark.parametrize("kind", ["dead", "fallback"])
@pytest.mark.parametrize("policy", LAWS)
def test_cuda_decide_matches_plain(cuda, cs, world, kind, policy):
    # every flow's decision: the failover's read (ring step -1), a
    # mid-run step, salted keys
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import fluid
    _, table, flows, cfg = pexp.build_experiment(
        pexp.ExpSpec(**cs.CHECK_WORLDS[world], policy=policy))
    arrs, st = fluid.build(table, flows, cfg, device=cuda)
    ar, st = cs.world_state(cuda, dict(arrs=arrs, state=st), kind, seed=5)
    r = cs.check_decide(cuda, ar, st, policy, f"{world} {policy} {kind}", 0,
                        cfg.select, [(0, -1, False), (900, 899, False),
                                     (900, 900, True)])
    assert r["max_abs_err"] == 0 and r["decided"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", LAWS)
def test_cuda_decide_bulk_matches_plain(cuda, cs, policy):
    from repro_torch.core.select import SelectParams
    ar, st = cs.bulk_route_world(cuda)
    r = cs.check_decide(cuda, ar, st, policy, f"bulk {policy}", 0,
                        SelectParams(), [(2, 1, False), (0, -1, False),
                                         (3, 3, True)])
    assert r["max_abs_err"] == 0 and r["no_candidate"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["lcmp", "ecmp"])
def test_cuda_step_launches_each_fused_kernel_once(cuda, policy):
    # the card's step: one monitor_tick and one route_arrivals launch a
    # step, all-pad rows included, and the same routes as the CPU's
    # plain step over the first steps
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import fluid
    spec = pexp.ExpSpec(topology="testbed8", load=0.5, duration_us=20_000,
                        policy=policy)
    _, table, flows, cfg = pexp.build_experiment(spec)
    paths = {}
    for dev in (cuda, torch.device("cpu")):
        arrs, st = fluid.build(table, flows, cfg, device=dev)
        step = fluid.make_step(arrs, cfg)
        before = ops.counts()
        for t in range(40):
            st = step(st, t)
        after = ops.counts()
        launched = {n: after[n] - before[n] for n in after}
        want = 40 if dev.type == "cuda" else 0
        assert launched["monitor_tick"] == launched["route_arrivals"] == want
        assert launched["cong_update"] == launched["lcmp_decide"] == 0
        paths[dev.type] = st.flow_path.cpu()
    assert torch.equal(paths["cuda"], paths["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("kw,decides", [
    (dict(topology="testbed8_failover:fail_ms=50", load=0.3), 1),
    (dict(topology="staleness:deg_ms=40", load=0.4, seed=1, policy="lcmp_r",
          redecide_period_us=10_000), 6),
    (dict(topology="testbed8", load=0.3, policy="redte", cc="hpcc"), 0)])
def test_cuda_schedule_steps_launch_decide(cuda, kw, decides):
    # 300 steps of a schedule run: one decide launch per trip step and
    # epoch, and the same routes and link state as the CPU's plain steps
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import fluid
    _, table, flows, cfg = pexp.build_experiment(
        pexp.ExpSpec(**kw, duration_us=100_000))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        arrs, st = fluid.build(table, flows, cfg, device=dev)
        step = fluid.make_step(arrs, cfg)
        before = ops.counts()
        for t in range(300):
            st = step(st, t)
        after = ops.counts()
        launched = {n: after[n] - before[n] for n in after}
        want = 1 if dev.type == "cuda" else 0
        assert launched["decide"] == decides * want
        assert launched["route_arrivals"] == 300 * want
        out[dev.type] = [getattr(st, n).cpu() for n in
                         ("flow_path", "route_nonce", "link_alive", "c_path",
                          "redte_w")]
    for g, c in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, c)


@pytest.mark.cuda
def test_cuda_fused_launchers_check_inputs(cuda, cs):
    from repro_torch.core.select import SelectParams
    ar, st = cs.bulk_route_world(cuda)
    with pytest.raises(ValueError, match="routes"):
        ops.RouteArrivals(ar, st, "sweep", SelectParams(), 200)
    launch = ops.RouteArrivals(ar, st, "lcmp", SelectParams(), 200)
    with pytest.raises(ValueError, match="decide fid"):
        launch.decide(0, ar.f_id.int(), ar.f_pair, 0)
    with pytest.raises(ValueError, match="decide pair"):
        launch.decide(0, ar.f_id, ar.f_pair.clone().fill_(1 << 20), 0)
    with pytest.raises(ValueError, match="int32"):
        launch.decide(1 << 31, ar.f_id, ar.f_pair, 0)
    bad = dataclasses.replace(st, rate=st.rate.double())
    with pytest.raises(ValueError, match="rate"):
        launch(0, bad)
    with pytest.raises(ValueError, match="step"):
        launch(ar.arrivals.shape[0], st)
    shared = dataclasses.replace(st, cc_target=st.rate)
    with pytest.raises(ValueError, match="share memory"):
        launch(0, shared)
    wide = dataclasses.replace(ar, pair_cand=torch.zeros(
        (4, 9), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="K <= 8"):
        ops.RouteArrivals(wide, st, "lcmp", SelectParams(), 200)
    tb = bootstrap_tables([100] * 4, device=cuda)
    cong = CongState.init(4, cuda)
    cc = torch.zeros(4, dtype=torch.int32, device=cuda)
    hist = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    tick = ops.MonitorTick(cong, cc, hist, tb, CongParams(), 1000)
    with pytest.raises(ValueError, match="q_bytes"):
        tick(torch.zeros(4, dtype=torch.int32, device=cuda), 0, 0)
    with pytest.raises(ValueError, match="outside the run"):
        tick(torch.zeros(4, device=cuda), 2000, 0)
    with pytest.raises(ValueError, match="overflows int32"):
        ops.MonitorTick(cong, cc, hist, tb, CongParams(), 1 << 31)


# ------------------------------------------ a law per pair: the sweep (cuda)
@pytest.fixture(scope="module")
def merged(cs):
    """The merged world of chip_smoke's fig5 group (15 cells), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return cs.merged_shape(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["live", "dead", "cut", "fallback"])
def test_cuda_route_arrivals_a_law_per_pair_matches_plain(cuda, cs, merged,
                                                          kind):
    ar, st = cs.world_state(cuda, merged, kind, seed=11)
    ar = cs.mixed_laws(ar, 2)
    rows = cs.check_rows(ar.arrivals.cpu().numpy(),
                         int(ar.path_sig_delay.max()))
    rows = sorted(set(rows) | {cs.stranded_row(ar, st)} - {-1})
    r = cs.check_route(cuda, ar, st, "sweep", f"fig5 merged {kind}", 0,
                       merged["cfg"].select, merged["cfg"].dt_us, rows)
    assert r["max_abs_err"] == 0
    assert (r["routed"] == 0) == (kind == "cut")
    assert kind == "cut" or r["laws"] >= 5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dead", "fallback"])
def test_cuda_decide_a_law_per_pair_matches_plain(cuda, cs, merged, kind):
    ar, st = cs.world_state(cuda, merged, kind, seed=12)
    r = cs.check_decide(cuda, cs.mixed_laws(ar, 4), st, "sweep",
                        f"fig5 merged {kind}", 0, merged["cfg"].select,
                        [(0, -1, False), (900, 899, False), (900, 900, True)])
    assert r["max_abs_err"] == 0 and r["laws"] >= 5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["wan2000", "bulk", "fig5 merged"])
def test_cuda_decide_records_match_plain(cuda, cs, request, shape):
    # decide's first kernel: the per-pair table, unpacked on the host,
    # equals decide_records_ref field for field (a law per pair on the
    # merged world), at the failover's read, a mid-run step, salted keys
    from repro_torch.core.select import SelectParams
    cases = [(0, -1, False), (900, 899, False), (900, 900, True)]
    if shape == "bulk":
        ar, st = cs.bulk_route_world(cuda)
        policy, select, cases = "lcmp_w", SelectParams(), [(2, 1, False),
                                                           (0, -1, False),
                                                           (3, 3, True)]
    elif shape == "wan2000":
        from repro_torch.netsim import experiment as pexp
        from repro_torch.netsim import fluid
        _, table, flows, cfg = pexp.build_experiment(
            pexp.ExpSpec(**cs.CHECK_WORLDS["wan2000"], policy="redte"))
        arrs, st = fluid.build(table, flows, cfg, device=cuda)
        ar, st = cs.world_state(cuda, dict(arrs=arrs, state=st), "dead", seed=7)
        policy, select = "redte", cfg.select
    else:
        merged = request.getfixturevalue("merged")
        ar, st = cs.world_state(cuda, merged, "dead", seed=13)
        ar, policy, select = cs.mixed_laws(ar, 5), "sweep", merged["cfg"].select
    r = cs.check_decide(cuda, ar, st, policy, f"{shape} records", 0, select,
                        cases)
    assert r["table_err"] == 0 and r["max_abs_err"] == 0 and r["decided"] > 0


@pytest.mark.cuda
def test_cuda_a_law_per_pair_bulk_matches_plain(cuda, cs):
    from repro_torch.core.select import SelectParams
    ar, st = cs.bulk_route_world(cuda)
    ar = cs.mixed_laws(ar, 6)
    r = cs.check_route(cuda, ar, st, "sweep", "bulk sweep", 0, SelectParams(),
                       200, [0, 1, 2, 3])
    assert r["max_abs_err"] == 0 and r["laws"] == len(LAWS)
    r = cs.check_decide(cuda, ar, st, "sweep", "bulk sweep", 0, SelectParams(),
                        [(2, 1, False), (0, -1, False), (3, 3, True)])
    assert r["max_abs_err"] == 0 and r["laws"] == len(LAWS)


@pytest.mark.cuda
def test_cuda_sweep_launcher_checks_its_laws(cuda, cs, merged):
    ar = cs.mixed_laws(merged["arrs"], 1)
    with pytest.raises(ValueError, match="outside the swept"):
        ops.RouteArrivals(ar, merged["state"], "sweep", SelectParams(), 200,
                          ("lcmp", "ecmp"))
    bad = dataclasses.replace(ar, pair_policy=ar.pair_policy.long())
    with pytest.raises(ValueError, match="per-pair law codes"):
        ops.RouteArrivals(bad, merged["state"], "sweep", SelectParams(), 200)


@pytest.mark.cuda
def test_cuda_merged_fig5_steps_equal_the_cpu(cuda, cs):
    # 300 steps of the merged fig5 group: one launch of each fused kernel
    # a step for all 15 cells, and the state the CPU's plain steps reach
    # (integers exact, floats within 1e-5 of the field's largest value:
    # the card sums the link loads in another order)
    from repro_torch.netsim import experiment as pexp
    from repro_torch.netsim import fluid, sweep
    specs = [pexp.ExpSpec(**kw) for kw in cs.SWEEPS["fig5"]]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        g = sweep.build_group(specs, device=dev)
        step = fluid.make_step(g.arrs, g.cfg)
        st = g.state
        before = ops.counts()
        for t in range(300):
            st = step(st, t)
        after = ops.counts()
        want = 300 if dev.type == "cuda" else 0
        assert after["monitor_tick"] - before["monitor_tick"] == want
        assert after["route_arrivals"] - before["route_arrivals"] == want
        out[dev.type] = {f.name: getattr(st, f.name).cpu()
                         for f in dataclasses.fields(st) if f.name != "cong"}
        out[dev.type].update({f"cong.{f.name}": getattr(st.cong, f.name).cpu()
                              for f in dataclasses.fields(st.cong)})
    assert bool(out["cpu"]["active"].any())
    for n, g in out["cuda"].items():
        c = out["cpu"][n]
        if g.is_floating_point():
            torch.testing.assert_close(g, c, rtol=1e-5,
                                       atol=1e-5 * float(c.abs().max()), msg=n)
        else:
            assert torch.equal(g, c), n
