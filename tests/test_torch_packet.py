"""Port parity of the packet engine (repro_torch.netsim.packet): the
engine registry and knobs, ``build()``, one slot from carried reference
state (a busy testbed8 slot, PFC XOFF engaged, a slot at which a remote
hop's pause reaches the hop before it, a trip with go-back-N, a degraded
slot, an armed flowlet slot), the parked per-link sums, and the
fluid engine left as it was. Whole runs are in test_torch_packet_runs.py
and test_torch_packet_bands.py.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.select import ecmp_select
from repro.netsim import experiment as rexp
from repro.netsim import packet as rpacket
from repro.netsim import paths as rpaths
from repro.netsim import topo as rtopo
from repro.netsim.engine import SimConfig as RSimConfig
from repro.netsim.engine import attach_link_caps as rattach
from repro.traffic.gen import FlowSet as RFlowSet
from repro_torch.core.cong import CongParams
from repro_torch.core.pathq import PathQParams
from repro_torch.core.select import SelectParams
from repro_torch.netsim import carry
from repro_torch.netsim import engine as pengine
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import packet as ppacket

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float fields of one slot from identical state: the port adds the same
# float32 terms as XLA on the CPU, in possibly another order (index_add_
# for segment_sum), so they agree to float32 rounding
FLOAT_RTOL = 1e-5
TESTBED8 = dict(topology="testbed8", load=0.3, seed=1, duration_us=400_000,
                engine="packet")


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


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def port_cfg(rcfg) -> pengine.SimConfig:
    """The port's ``SimConfig`` of a reference configuration."""
    kw = {f.name: getattr(rcfg, f.name)
          for f in dataclasses.fields(pengine.SimConfig)}
    for name, cls in (("select", SelectParams), ("pathq", PathQParams),
                      ("congp", CongParams)):
        kw[name] = cls(**dataclasses.asdict(kw[name]))
    return pengine.SimConfig(**kw)


def assert_flat_equal(got, want, rtol=0.0):
    assert sorted(got) == sorted(want)
    hw = "tables.high_water_level"      # a Python int in the port
    if hw in want:
        assert got[hw] == want[hw]
        got = {k: v for k, v in got.items() if k != hw}
        want = {k: v for k, v in want.items() if k != hw}
    for k in want:
        g, w = got[k], want[k]
        if w.dtype == np.uint32:
            w = w.astype(np.int64)
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating) and rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6, err_msg=k)
        else:
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


def assert_slot_equal(got, want):
    """Integers and bools exact, floats within FLOAT_RTOL."""
    ints = {n for n, v in want.items() if not np.issubdtype(v.dtype, np.floating)}
    assert_flat_equal({n: got[n] for n in ints}, {n: want[n] for n in ints})
    assert_flat_equal({n: got[n] for n in want if n not in ints},
                      {n: want[n] for n in want if n not in ints},
                      rtol=FLOAT_RTOL)


# ---------------------------------------------------- registry and knobs
def test_engine_registry_and_packet_knobs():
    assert pengine.get_engine("packet") is ppacket
    assert pengine.get_engine("fluid").name == "fluid"
    with pytest.raises(ValueError, match="fluid"):
        pengine.get_engine("ns3")
    p, r = pengine.SimConfig(), RSimConfig()
    for k in ("mtu_bytes", "pfc_xoff_frac", "pfc_xon_frac"):
        assert getattr(p, k) == getattr(r, k), k
    scen = pexp.build_world("testbed8")[0]
    assert pexp.spec_to_cfg(pexp.ExpSpec(engine="packet"), scen).engine == "packet"


@pytest.mark.parametrize("engine,gap,period,armed", [
    ("packet", 1000, 0, True), ("packet", 0, 10_000, False),
    ("fluid", 1000, 0, False), ("fluid", 0, 10_000, True),
    ("packet", 1000, 10_000, True), ("fluid", 1000, 10_000, True)])
def test_wants_redecide_reads_the_engines_own_knob(engine, gap, period, armed):
    for policy, redecides in (("fatpaths", True), ("lcmp_r", True),
                              ("lcmp", False)):
        kw = dict(engine=engine, policy=policy, flowlet_gap_us=gap,
                  redecide_period_us=period)
        got = pengine.wants_redecide(pengine.SimConfig(**kw))
        assert got == (armed and redecides) == rpacket.wants_redecide(
            RSimConfig(**kw)), (kw, got)


def test_packet_checks_still_raise_naming_item_7():
    # item 7 (the sanitizer) is ported: a checked packet run completes and
    # scores as the unchecked one (tests/test_torch_sanitize.py holds the
    # invariants themselves)
    spec = pexp.ExpSpec(**dict(TESTBED8, duration_us=20_000, checks=1))
    on, _, _ = pexp.run_experiment(spec, device="cpu")
    off, _, _ = pexp.run_experiment(dataclasses.replace(spec, checks=0),
                                    device="cpu")
    np.testing.assert_array_equal(on.slowdown, off.slowdown)
    assert on.completed == off.completed > 0


def test_packet_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = pexp.ExpSpec(**dict(TESTBED8, duration_us=10_000))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pexp.run_experiment(spec)
    _, table, flows, cfg = pexp.build_experiment(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppacket.build(table, flows, cfg)
    stats, _, (_, _, _, _, final) = pexp.run_experiment(spec, device="cpu")
    assert isinstance(final, ppacket.PacketState) and stats.completed > 0


def test_build_state_exact():
    _, rt, rf, rcfg = rexp.build_experiment(rexp.ExpSpec(**TESTBED8))
    _, pt, pf, pcfg = pexp.build_experiment(pexp.ExpSpec(**TESTBED8))
    r_arr, r_st = rpacket.build(rt, rf, rcfg)
    p_arr, p_st = ppacket.build(pt, pf, pcfg, device="cpu")
    assert isinstance(p_st, ppacket.PacketState)
    assert_flat_equal(carry.to_numpy(p_arr), flat(r_arr))
    assert_flat_equal(carry.to_numpy(p_st), flat(r_st))
    # and back through carry, as a PacketState
    _, c_st = carry.from_reference(flat(r_arr), flat(r_st), device="cpu")
    assert isinstance(c_st, ppacket.PacketState)
    assert c_st.last_tx.dtype == torch.int32 and int(c_st.last_tx[0]) == 1 << 20


# ------------------------------------------------ one slot from carried state
def _spec_world(kw, **cfg_kw):
    _, table, flows, cfg = rexp.build_experiment(rexp.ExpSpec(**kw))
    return table, flows, dataclasses.replace(cfg, **cfg_kw)


def _flowlet_world():
    """tests/test_redecision.py's flowlet world: 12 flows hash-pinned to
    path 0 of two 1G paths, a mild degrade at 5 ms, a 800 us gap."""
    t = rtopo.parallel_paths(caps=(1, 1), delays_us=(200, 200))
    table = rpaths.build_path_table(t, [(0, 3)])
    rattach(table, t)
    fids = np.arange(1, 4000, dtype=np.uint32)
    k = np.asarray(ecmp_select(jnp.asarray(fids),
                               jnp.ones((len(fids), 2), bool)))
    on0 = fids[k == 0][:12]
    flows = RFlowSet(arrival_us=np.full(12, 1000, np.int64),
                     size_bytes=np.full(12, 2e5),
                     pair_id=np.zeros(12, np.int32),
                     flow_id=np.array(on0, np.uint32))
    cfg = RSimConfig(engine="packet", policy="fatpaths", horizon_us=1_000_000,
                     flowlet_gap_us=800, ecn_kmin_bytes=2e4,
                     degrade_sched=((int(table.path_first[0]), 5000, 0.5),))
    return table, flows, cfg


def _pfc_world():
    """tests/test_engines.py's lossless world: one 100G route degraded to
    1% at 20 ms with the PFC thresholds tightened."""
    table, flows, cfg = _spec_world(dict(
        topology="parallel:n=1,cap=100", load=0.5, policy="ecmp",
        engine="packet", duration_us=100_000, seed=3))
    first = int(table.path_first[0])
    return table, flows, dataclasses.replace(
        cfg, degrade_sched=((first, 20_000, 0.01),), pfc_xoff_frac=0.02,
        pfc_xon_frac=0.01)


def _pfc_hop_world():
    """The staleness world with PFC thresholds at 0.1% of the buffer, so that
    a remote hop's pause reaches the hop before it."""
    return _spec_world(dict(topology="staleness:deg_ms=20", load=0.4, seed=1,
                            policy="ecmp", engine="packet",
                            duration_us=200_000),
                       pfc_xoff_frac=0.001, pfc_xon_frac=0.0005)


def _pause_edge(arr, st, k) -> bool:
    """Whether a flow with bytes queued at hop h reads its next link's
    pause (one backward propagation of hop h's link late) differently at
    slot k than at slot k + 1."""
    fp = st["flow_path"]
    links = arr["path_links"][np.maximum(fp, 0)]
    ring = st["hist_pause"]
    for h in range(links.shape[1] - 1):
        nxt = np.maximum(links[:, h + 1], 0)
        pd = arr["link_delay_us"][np.maximum(links[:, h], 0)] // 200
        live = (fp >= 0) & (links[:, h + 1] >= 0) & (st["fq"][:, h] > 0)
        now = ring[nxt, (k - pd) % ring.shape[1]]
        later = ring[nxt, (k + 1 - pd) % ring.shape[1]]
        if (live & (now != later)).any():
            return True
    return False


# case -> (world, slot k); each slot is checked below to be what it names
CASES = {
    "busy": (lambda: _spec_world(dict(TESTBED8, policy="lcmp", load=0.5,
                                      seed=0)), 1500),
    "pfc_xoff": (_pfc_world, 450),
    "pfc_hop": (_pfc_hop_world, 339),
    "trip": (lambda: _spec_world(dict(TESTBED8, policy="lcmp", topology=
                                      "testbed8_failover:fail_ms=60")), 300),
    "degraded": (lambda: _spec_world(dict(TESTBED8, policy="ecmp", topology=
                                          "staleness:deg_ms=20", load=0.4,
                                          sig_delay_scale=2.0)), 400),
    "flowlet": (_flowlet_world, None),
}


def _first_flowlet_slot(step, st, horizon):
    """The first slot at which a flow re-decides (its nonce moves)."""
    for t in range(horizon):
        nxt = step(st, t)[0]
        if bool((nxt.route_nonce != st.route_nonce).any()):
            return t, st
        st = nxt
    raise AssertionError("the flowlet plane never fired")


@pytest.fixture(scope="module", params=sorted(CASES))
def carried(request):
    """(case, reference arrays, state before slot k, the reference's own
    slot k from it, config, k)."""
    world, k = CASES[request.param]
    table, flows, rcfg = world()
    r_arr, st = rpacket.build(table, flows, rcfg)
    step = jax.jit(rpacket.make_step(r_arr, rcfg))
    if k is None:
        k, st = _first_flowlet_slot(step, st, rcfg.num_steps)
    else:
        scan = jax.jit(lambda s, ts: jax.lax.scan(rpacket.make_step(r_arr, rcfg),
                                                  s, ts)[0])
        st = scan(st, jnp.arange(k))
    return (request.param, flat(r_arr), flat(st), flat(step(st, k)[0]), rcfg, k)


def test_one_slot_from_carried_state(carried):
    case, r_arr, before, want, rcfg, k = carried
    p_arr, p_st = carry.from_reference(r_arr, before, device="cpu")
    got = carry.to_numpy(ppacket.make_step(p_arr, port_cfg(rcfg))(p_st, k))
    assert_slot_equal(got, want)
    # the slot is what the case names: bytes queued (none at a flowlet
    # slot, whose re-deciding flows have drained)
    assert before["active"].any() and before["fq"].any() != (case == "flowlet")
    if case == "pfc_xoff":
        assert want["pfc_pause"].any()
    elif case == "pfc_hop":       # an upstream hop's pause reading flips
        assert _pause_edge(r_arr, want, k)
    elif case == "trip":
        dead = r_arr["link_fail_step"] == k
        assert dead.any()
        hops = r_arr["path_links"][np.maximum(before["flow_path"], 0)]
        on_dead = before["active"] & dead[np.maximum(hops, 0)].any(-1)
        assert (on_dead & (before["fq"].sum(-1) > 0)).any()  # go-back-N bytes
        assert (want["flow_path"] != before["flow_path"])[on_dead].any()
    elif case == "degraded":
        assert (r_arr["link_deg_step"] <= k).any()
    elif case == "flowlet":
        assert (want["route_nonce"] > before["route_nonce"]).any()


@pytest.mark.parametrize("kw", [
    dict(topology="testbed8_failover:fail_ms=5", load=0.3, policy="lcmp"),
    dict(topology="staleness:deg_ms=5", load=0.4, policy="fatpaths",
         flowlet_gap_us=1000, redecide_period_us=10_000),
], ids=["failover", "flowlet"])
def test_chip_smoke_plain_calls_see_the_packet_slots_plain_versions(kw):
    # on the CPU every phase runs its plain version: one monitor tick and
    # one route a slot, and the failover's and the flowlet plane's
    # decisions number what chip_smoke expects of `decide` on the card
    chip_smoke = _chip_smoke()
    spec = pexp.ExpSpec(engine="packet", duration_us=10_000, **kw)
    with chip_smoke.PlainCalls() as plain:
        _, _, (_, _, _, cfg, _) = pexp.run_experiment(spec, device="cpu")
    assert plain.called["monitor_tick_ref"] == cfg.num_steps
    assert plain.called["route_arrivals_ref"] == cfg.num_steps
    assert plain.called["decide_ref"] == chip_smoke.expected_decides(cfg) > 0


# ------------------------------------------ parked sums, the fluid engine
def test_parked_sums_equal_link_0_sums_bit_for_bit(monkeypatch):
    """The per-link sums with masked contributions parked on f % L equal
    the reference's layout (masked ones on clamp(link, 0)) bit for bit on
    the CPU: every contribution is a non-negative byte count."""
    spec = pexp.ExpSpec(**dict(TESTBED8, policy="ecmp", load=0.5,
                               duration_us=30_000,
                               topology="testbed8_failover:fail_ms=10"))
    _, table, flows, cfg = pexp.build_experiment(spec)
    runs = []
    for parked in (True, False):
        if not parked:
            monkeypatch.setattr(ppacket, "_seg_index", lambda idx, ok, park: idx)
        arrs, st = ppacket.build(table, flows, cfg, device="cpu")
        runs.append(carry.to_numpy(ppacket.run(arrs, st, cfg)))
    a, b = runs
    assert a["done"].any() and a["hist_q"].any()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("policy", ["lcmp", "fatpaths"])
def test_fluid_ignores_the_packet_knobs_bit_for_bit(policy):
    base = pexp.ExpSpec(topology="testbed8", load=0.3, policy=policy,
                        duration_us=30_000, seed=1)
    _, _, (_, _, _, cfg, fa) = pexp.run_experiment(base, device="cpu")
    armed = dataclasses.replace(base, flowlet_gap_us=800)
    _, _, (_, _, _, cfg_b, fb) = pexp.run_experiment(armed, device="cpu")
    _, table, flows, _ = pexp.build_experiment(base)
    knobs = dataclasses.replace(cfg, mtu_bytes=512, pfc_xoff_frac=0.1,
                                pfc_xon_frac=0.05, flowlet_gap_us=400)
    arrs, st = pengine.get_engine("fluid").build(table, flows, knobs,
                                                 device="cpu")
    fc = pengine.get_engine("fluid").run(arrs, st, knobs)
    assert not pengine.wants_redecide(cfg_b)
    for other in (fb, fc):
        for k, v in carry.to_numpy(fa).items():
            np.testing.assert_array_equal(carry.to_numpy(other)[k], v, err_msg=k)
