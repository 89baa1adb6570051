"""Port parity of the fluid engine's two fused phases: the plain versions
of ``kernels.route_arrivals`` and ``kernels.monitor_tick`` (what the
port's engine runs on the CPU) against the JAX package's
``engine._route_arrivals`` and ``engine.monitor_tick``.

States are the reference's own (carried through its scanned step on
testbed8) or random ones made with numpy from a seed
(``chip_smoke.random_state``: dead links, the congestion fallback, rows
below the largest signal delay, all-pad rows, flow 0 among pads) on
testbed8, wan2000 and geo (8-hop paths). Integer and bool fields must be
equal; ``extra_wait`` within rtol 1e-6, since the reference's ``.sum``
and the port's hop-by-hop sum may round differently in the last bit.
The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_kernels.py``, marked ``cuda``, and ``chip_smoke.py``).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim import engine as rengine
from repro.netsim import experiment as rexp
from repro.netsim import fluid as rfluid
from repro_torch.kernels import ops, ref
from repro_torch.netsim import carry
from repro_torch.netsim import engine as pengine
from repro_torch.netsim import experiment as pexp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRA_WAIT_RTOL = 1e-6


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


CS = _chip_smoke()
FLOW_FIELDS = CS.FLOW_FIELDS        # the eight fields the route writes


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


def to_reference_state(r_st, state):
    """The reference's ``SimState`` ``r_st`` with every field replaced
    from the flat numpy dict ``state``."""
    cong = dataclasses.replace(r_st.cong, **{
        f.name: jnp.asarray(state["cong." + f.name])
        for f in dataclasses.fields(r_st.cong)})
    return dataclasses.replace(r_st, cong=cong, **{
        f.name: jnp.asarray(state[f.name]) for f in dataclasses.fields(r_st)
        if f.name != "cong"})


@pytest.fixture(scope="module", params=["testbed8", "wan2000", "geo"])
def world(request):
    """The reference's arrays, initial state and config of a world, for
    lcmp and ecmp, and the rows a route check runs."""
    kw = CS.CHECK_WORLDS[request.param]
    cfgs = {}
    for policy in ("lcmp", "ecmp"):
        _, rt, rf, rcfg = rexp.build_experiment(rexp.ExpSpec(**kw, policy=policy))
        _, _, _, pcfg = pexp.build_experiment(pexp.ExpSpec(**kw, policy=policy))
        cfgs[policy] = (rcfg, pcfg)
    r_arr, r_st = rfluid.build(rt, rf, cfgs["lcmp"][0])
    arr = flat(r_arr)
    rows = CS.check_rows(arr["arrivals"], int(arr["path_sig_delay"].max()))
    return request.param, r_arr, r_st, arr, cfgs, rows


def _assert_route_equal(got, want, what):
    for n in FLOW_FIELDS:
        if n == "extra_wait":
            np.testing.assert_allclose(got[n], want[n], rtol=EXTRA_WAIT_RTOL,
                                       atol=0, err_msg=f"{what} {n}")
        else:
            assert got[n].dtype == want[n].dtype, (what, n)
            np.testing.assert_array_equal(got[n], want[n], err_msg=f"{what} {n}")


@pytest.mark.parametrize("policy", ["lcmp", "ecmp"])
@pytest.mark.parametrize("kind", ["live", "dead", "cut", "fallback"])
def test_plain_route_matches_reference_on_random_states(world, policy, kind):
    name, r_arr, r_st, arr, cfgs, rows = world
    rcfg, pcfg = cfgs[policy]
    state = CS.random_state(flat(r_st), np.random.default_rng(len(name) + 3),
                            kind)
    r_state = to_reference_state(r_st, state)
    p_arr, p_st = carry.from_reference(arr, state, device="cpu")
    assert min(rows) < int(arr["path_sig_delay"].max())   # negative offsets
    assert (arr["arrivals"][rows] < 0).any()              # pads among them
    if kind == "dead":          # and a flow whose candidates all are dead
        rows = sorted(set(rows) | {CS.stranded_row(p_arr, p_st)} - {-1})
    launches = ops.counts()["route_arrivals"]
    no_candidate = routed = dead = 0
    for t in rows:
        want = flat(rengine._route_arrivals(t, r_state, r_arr, rcfg))
        got = carry.to_numpy(pengine._route_arrivals(t, p_st, p_arr, pcfg))
        _assert_route_equal(got, want, f"{name} {policy} {kind} t={t}")
        # everything else in the state is untouched
        for n in ("q_bytes", "hist_c", "link_alive", "c_path", "done"):
            np.testing.assert_array_equal(got[n], state[n])
        row = p_arr.arrivals[t]
        cand, _, valid = ref.candidate_view(
            p_arr.f_pair[row[row >= 0].long()], p_st, p_arr)
        routed += int(valid.any(1).sum())
        no_candidate += int((~valid.any(1)).sum())
        dead += int((~valid & (cand >= 0)).sum())
    if kind == "cut":           # nothing routed, nothing written
        assert routed == 0 and no_candidate > 0
        for n in FLOW_FIELDS:
            np.testing.assert_array_equal(got[n], state[n])
    else:
        assert routed > 0
    if kind == "dead":
        assert dead > 0
    assert ops.counts()["route_arrivals"] == launches   # plain: no launch


def test_fallback_state_falls_back(world):
    # every candidate's congestion view is >= 230, so every lcmp choice
    # is the least fused cost (rank 0)
    name, r_arr, r_st, arr, cfgs, rows = world
    state = CS.random_state(flat(r_st), np.random.default_rng(5), "fallback")
    p_arr, p_st = carry.from_reference(arr, state, device="cpu")
    t = rows[-1] if (arr["arrivals"][rows[-1]] >= 0).any() else rows[0]
    row = p_arr.arrivals[t]
    fidx = row[row >= 0].long()
    cand, hop, valid = ref.candidate_view(p_arr.f_pair[fidx], p_st, p_arr)
    c_path, c_cong = ref.lcmp_scores(t, cand, hop, p_st, p_arr)
    assert (c_cong[valid] >= 230).all()
    k = ref.lcmp_decide_ref(p_arr.f_id[fidx], c_path, c_cong, valid)
    cost = torch.where(valid, 3 * c_path + c_cong, 1 << 24)
    best = (cost * 8 + torch.arange(cand.shape[1])).argmin(1).to(torch.int32)
    assert torch.equal(k, torch.where(valid.any(1), best, -1))


def test_route_writes_nothing_for_pads_and_flow_zero_survives(world):
    name, r_arr, r_st, arr, cfgs, rows = world
    _, pcfg = cfgs["lcmp"]
    p_arr, p_st = carry.from_reference(arr, flat(r_st), device="cpu")
    t = int(np.nonzero((arr["arrivals"] == 0).any(1))[0][0])
    out = pengine._route_arrivals(t, p_st, p_arr, pcfg)
    assert int(out.route_step[0]) == t and int(out.flow_path[0]) >= 0
    pad_rows = np.nonzero(~(arr["arrivals"] >= 0).any(1))[0]
    if pad_rows.size:
        same = pengine._route_arrivals(int(pad_rows[0]), out, p_arr, pcfg)
        for n in FLOW_FIELDS:
            assert torch.equal(getattr(same, n), getattr(out, n)), n


# ------------------------------------------------ carried reference states
CARRY_STEPS = (1, 500, 1200)


@pytest.fixture(scope="module", params=["lcmp", "ecmp"])
def carried(request):
    """testbed8 reference states after k steps of its own scanned step."""
    kw = dict(CS.TESTBED8, policy=request.param)
    _, rt, rf, rcfg = rexp.build_experiment(rexp.ExpSpec(**kw))
    _, _, _, pcfg = pexp.build_experiment(pexp.ExpSpec(**kw))
    r_arr, st = rfluid.build(rt, rf, rcfg)
    step = rfluid.make_step(r_arr, rcfg)
    scan = jax.jit(lambda s, ts: jax.lax.scan(step, s, ts)[0])
    out, t = {}, 0
    for k in CARRY_STEPS:
        st = scan(st, jnp.arange(t, k))
        t = k
        out[k] = st
    return request.param, r_arr, rcfg, pcfg, out


@pytest.mark.parametrize("k", CARRY_STEPS)
def test_plain_route_matches_reference_from_carried_state(carried, k):
    policy, r_arr, rcfg, pcfg, states = carried
    r_st = states[k]
    p_arr, p_st = carry.from_reference(flat(r_arr), flat(r_st), device="cpu")
    for t in range(k, k + 4):           # this step's row and the next ones
        want = flat(rengine._route_arrivals(t, r_st, r_arr, rcfg))
        got = carry.to_numpy(pengine._route_arrivals(t, p_st, p_arr, pcfg))
        _assert_route_equal(got, want, f"testbed8 {policy} k={k} t={t}")


@pytest.mark.parametrize("k", CARRY_STEPS)
def test_plain_monitor_tick_matches_reference_from_carried_state(carried, k):
    policy, r_arr, rcfg, pcfg, states = carried
    r_st = states[k]
    p_arr, p_st = carry.from_reference(flat(r_arr), flat(r_st), device="cpu")
    want = flat(rengine.monitor_tick(k, r_st, r_arr, rcfg))
    got = carry.to_numpy(pengine.monitor_tick(k, p_st, p_arr, pcfg))
    for n in ["c_cong", "hist_c"] + [n for n in want if n.startswith("cong.")]:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


# -------------------------------------------------------------- monitor tick
@pytest.mark.parametrize("seed", range(3))
def test_plain_monitor_tick_matches_reference(world, seed):
    # random registers and queues (exact cell multiples and just below);
    # several ticks in a row, the ring slot wrapping at t % HIST
    name, r_arr, r_st, arr, cfgs, rows = world
    rcfg, pcfg = cfgs["lcmp"]
    state = CS.random_state(flat(r_st), np.random.default_rng(seed), "live")
    r_state = to_reference_state(r_st, state)
    p_arr, p_st = carry.from_reference(arr, state, device="cpu")
    rng = np.random.default_rng(100 + seed)
    launches = ops.counts()["monitor_tick"]
    for t in (0, 1, rengine.HIST - 1, rengine.HIST, 3 * rengine.HIST + 5):
        q = (rng.integers(0, 1 << 16, state["q_bytes"].shape) * 1024.0
             + rng.choice([0.0, 1023.75, 0.5], state["q_bytes"].shape))
        q = q.astype(np.float32)
        r_state = dataclasses.replace(r_state, q_bytes=jnp.asarray(q))
        p_st = dataclasses.replace(p_st, q_bytes=torch.from_numpy(q))
        r_state = rengine.monitor_tick(t, r_state, r_arr, rcfg)
        p_st = pengine.monitor_tick(t, p_st, p_arr, pcfg)
        want, got = flat(r_state), carry.to_numpy(p_st)
        for n in ["c_cong", "hist_c"] + [n for n in want if n.startswith("cong.")]:
            np.testing.assert_array_equal(got[n], want[n], err_msg=f"{n} t={t}")
    assert (got["cong.trend"] < 0).any()
    assert ops.counts()["monitor_tick"] == launches     # plain: no launch


# ------------------------------------------------- the launchers' device rule
def test_launchers_take_only_cuda_tensors(world):
    name, r_arr, r_st, arr, cfgs, rows = world
    _, pcfg = cfgs["lcmp"]
    p_arr, p_st = carry.from_reference(arr, flat(r_st), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.RouteArrivals(p_arr, p_st, "lcmp", pcfg.select, pcfg.dt_us)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.MonitorTick(p_st.cong, p_st.c_cong, p_st.hist_c, p_arr.tables,
                        pcfg.congp, 0)
    meta = dataclasses.replace(p_arr, arrivals=p_arr.arrivals.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.route_arrivals(0, p_st, meta, "lcmp")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.monitor_tick(p_st.cong, p_st.q_bytes.to("meta"), 0, p_arr.tables,
                         pcfg.congp, p_st.hist_c, 0, p_st.c_cong)


# ------------------------------- chip_smoke.py's checks of the fused kernels
def _route_fault(fault):
    """A stand-in for the route kernel on the CPU: the plain version with
    ``fault`` planted, writing ``st`` in place as the kernel does."""
    plain = ops.route_arrivals

    def kernel(t, st, ar, policy, select, dt_us):
        row = ar.arrivals[t]
        if fault == "ecmp_as_lcmp" and policy == "ecmp":
            policy = "lcmp"
        new = ref.route_arrivals_ref(t, st, ar, policy, select, dt_us)
        flows = row[row >= 0].long()
        _, _, valid = ref.candidate_view(ar.f_pair[flows], st, ar)
        if fault == "pad_writes_flow0" and (row < 0).any():
            new.route_step[0] = t + 1
        if fault == "stranded_written":
            new.route_step[flows[~valid.any(1)]] = t
        for n in FLOW_FIELDS:
            getattr(st, n).copy_(getattr(new, n))
        plain.launches += 1
        return st
    return kernel


@pytest.mark.parametrize("fault", [None, "pad_writes_flow0",
                                   "stranded_written", "ecmp_as_lcmp"])
def test_chip_smoke_route_check_catches_a_broken_kernel(monkeypatch, fault):
    _, table, flows, cfg = pexp.build_experiment(pexp.ExpSpec(**CS.WAN2000))
    w = dict(zip(("arrs", "state"), pengine.build(table, flows, cfg,
                                                  device="cpu")))
    kind = "dead" if fault == "stranded_written" else "live"
    ar, st = CS.world_state("cpu", w, kind, seed=1)
    rows = CS.check_rows(ar.arrivals.numpy(), int(ar.path_sig_delay.max()))
    rows = sorted(set(rows) | {CS.stranded_row(ar, st)} - {-1})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(ops, "route_arrivals", _route_fault(fault))

    def check():
        return CS.check_route("cpu", ar, st, "ecmp", f"wan2000 ecmp {kind}",
                              0, cfg.select, cfg.dt_us, rows)
    if fault is None:
        assert check()["max_abs_err"] == 0
    else:
        with pytest.raises(RuntimeError, match="kernel equals plain"):
            check()


@pytest.mark.parametrize("fault", [None, "rounded_cells"])
def test_chip_smoke_monitor_check_catches_a_broken_kernel(monkeypatch, fault):
    plain = ops.monitor_tick

    def kernel(cong, q, now_us, tables, params, hist_c, slot, c_cong):
        if fault == "rounded_cells":       # cells rounded, not truncated
            q = torch.round(q / 1024) * 1024
        plain.launches += 1
        return ref.monitor_tick_ref(cong, q, now_us, tables, params, hist_c,
                                    slot)
    tb = pengine.bootstrap_tables([25, 100, 400] * 8, buffer_bytes=10**9,
                                  sample_interval_us=200, device="cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(ops, "monitor_tick", kernel)
    if fault is None:
        assert CS.check_monitor("cpu", tb, "N=24", 0)["max_abs_err"] == 0
    else:
        with pytest.raises(RuntimeError, match="kernel equals plain"):
            CS.check_monitor("cpu", tb, "N=24", 0)
