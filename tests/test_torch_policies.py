"""Port parity of every routing law: ``repro_torch.core.baselines`` and
``select_egress(weights=)`` bit-exact against ``repro.core.baselines`` and
``repro.core.select`` on seeded random and hand-made cases (pads, ties,
rows with no valid candidate, all candidates congested, zero weights);
then the engine's plain decisions, ``ref.route_arrivals_ref`` (through
``engine._route_arrivals``) and ``ref.decide_ref`` (through
``engine.decide``), for each of the ten policies against the reference's
``_route_arrivals`` and ``decide``, from states its own scanned step
carried on testbed8, wan2000 and geo, with dead links, a degrade schedule
and random RedTE weights. Integer fields must be equal; ``extra_wait``
within rtol 1e-6 (the port adds the per-hop waits hop by hop, the
reference with ``.sum``).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as rbl
from repro.core import pathq as rpathq
from repro.core import select as rselect
from repro.netsim import engine as rengine
from repro.netsim import experiment as rexp
from repro.netsim import fluid as rfluid
from repro_torch.core import baselines as pbl
from repro_torch.core import pathq as ppathq
from repro_torch.core import select as pselect
from repro_torch.kernels import ops, ref
from repro_torch.netsim import carry
from repro_torch.netsim import engine as pengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASH_EDGES = [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
              0xFFFFFFFF, 0x85EBCA6B, 0xC2B2AE35]
EXTRA_WAIT_RTOL = 1e-6
LAWS = ref.LAWS


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


CS = _chip_smoke()


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x)


def _eq(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


def _law_inputs(seed: int, F: int, P: int):
    """Hash keys (edges first), valid masks with some empty rows, and
    per-candidate integers with ties: capacities (some 0), hop counts,
    congestion (some rows all >= 230), matched rates, weights (zeros)."""
    rng = np.random.default_rng(seed)
    fids = rng.integers(0, 1 << 32, F, dtype=np.uint64).astype(np.uint32)
    fids[:len(HASH_EDGES)] = HASH_EDGES
    valid = rng.random((F, P)) < 0.7
    valid[::11] = False                      # no valid candidate
    valid[1::13] = True
    cap = rng.choice([0, 10, 40, 100, 200, 400], (F, P)).astype(np.int32)
    plen = rng.integers(1, 4, (F, P)).astype(np.int32)
    cong = rng.integers(0, 256, (F, P)).astype(np.int32)
    cong[::5] = rng.integers(230, 256, (F // 5 + (F % 5 > 0), P))
    avail = rng.choice([0, 5, 1000, 10**9], (F, P)).astype(np.int32)
    weights = rng.integers(0, 4, (F, P)).astype(np.int32) * 50
    return fids, valid, cap, plen, cong, avail, weights


@pytest.mark.parametrize("P", range(1, 9))
@pytest.mark.parametrize("seed", range(2))
def test_baseline_laws_bit_exact(seed, P):
    fids, valid, cap, plen, cong, avail, weights = _law_inputs(seed, 300, P)
    ft, vt = _t(fids), _t(valid)
    delay = np.zeros((300, P), np.int32)
    cases = {
        "ecmp": (rbl.ecmp(fids, delay, cap, valid),
                 pbl.ecmp(ft, None, _t(cap), vt)),
        "wcmp": (rbl.wcmp(fids, delay, cap, valid),
                 pbl.wcmp(ft, None, _t(cap), vt)),
        "ucmp": (rbl.ucmp(fids, delay, cap, valid),
                 pbl.ucmp(ft, None, _t(cap), vt)),
        "ucmp_wait": (rbl.ucmp(fids, delay, cap, valid, wait_cost_us=7),
                      pbl.ucmp(ft, None, _t(cap), vt, wait_cost_us=7)),
        "weighted_hash": (rbl._weighted_hash(fids, weights, valid),
                          pbl._weighted_hash(ft, _t(weights), vt)),
        "fatpaths": (rbl.fatpaths(fids, plen, valid, cong),
                     pbl.fatpaths(ft, _t(plen), vt, _t(cong))),
        "fatpaths_100": (rbl.fatpaths(fids, plen, valid, cong, cong_thresh=100),
                         pbl.fatpaths(ft, _t(plen), vt, _t(cong),
                                      cong_thresh=100)),
        "matchrdma": (rbl.matchrdma(fids, avail, valid),
                      pbl.matchrdma(ft, _t(avail), vt)),
    }
    for name, (want, got) in cases.items():
        assert got.dtype == torch.int32, name
        _eq(got, want, name)
        assert (got.numpy()[~valid.any(1)] == -1).all(), name


@pytest.mark.parametrize("P", range(1, 9))
@pytest.mark.parametrize("params", [dict(), dict(keep_num=3),
                                    dict(alpha=1, beta=3, cong_fallback=100)])
def test_select_egress_weighted_bit_exact(params, P):
    fids, valid, cap, _, cong, _, weights = _law_inputs(P, 300, P)
    c_path = np.random.default_rng(P).integers(0, 256, (300, P)).astype(np.int32)
    for w in (cap, weights):
        r_idx, r_cost = rselect.select_egress(
            fids, c_path, cong, valid, rselect.SelectParams(**params),
            weights=w)
        p_idx, p_cost = pselect.select_egress(
            _t(fids), _t(c_path), _t(cong), _t(valid),
            pselect.SelectParams(**params), weights=_t(w))
        _eq(p_idx, r_idx, "choice")
        _eq(p_cost, r_cost, "cost")


def test_laws_on_hand_made_rows():
    # ties everywhere, pads in the middle, zero weights, every candidate
    # congested, no candidate at all; each row under many hash keys
    fids = np.array(HASH_EDGES + list(range(40)), np.uint32)
    F = len(fids)
    rows = {
        "ties": ([1, 1, 1, 1], [100, 100, 100, 100], [2, 2, 2, 2], [9] * 4),
        "pads": ([1, 0, 1, 0], [0, 400, 40, 400], [3, 1, 2, 1], [240] * 4),
        "zero_w": ([1, 1, 0, 1], [0, 0, 0, 400], [1, 1, 1, 2], [0, 250, 0, 0]),
        "congested": ([1, 1, 1, 0], [40, 400, 100, 1], [1, 1, 2, 1],
                      [230, 255, 231, 0]),
        "none": ([0, 0, 0, 0], [400] * 4, [1] * 4, [0] * 4),
    }
    for name, (v, cap, plen, cong) in rows.items():
        v = np.array(v, bool)
        cap, plen, cong = (np.array(x, np.int32) for x in (cap, plen, cong))
        pairs = [
            (rbl.ucmp(fids, None, cap, v), pbl.ucmp(_t(fids), None, _t(cap), _t(v))),
            (rbl.wcmp(fids, None, cap, v), pbl.wcmp(_t(fids), None, _t(cap), _t(v))),
            (rbl.fatpaths(fids, plen, v, cong),
             pbl.fatpaths(_t(fids), _t(plen), _t(v), _t(cong))),
            (rbl.matchrdma(fids, cap * 3, v),
             pbl.matchrdma(_t(fids), _t(cap * 3), _t(v))),
            (rselect.select_egress(fids, plen, cong, v, weights=cap)[0],
             pselect.select_egress(_t(fids), _t(plen), _t(cong), _t(v),
                                   weights=_t(cap))[0]),
        ]
        for i, (want, got) in enumerate(pairs):
            assert got.shape == (F,)
            _eq(got, want, f"{name} law {i}")
        if name == "none":
            assert all((g.numpy() == -1).all() for _, g in pairs)


def test_redte_update_and_choice_bit_exact():
    # the port's RedTE law (redte_tick's headroom weights, the choice by
    # _weighted_hash as law_choice makes it) against the reference's
    # redte_update and redte at each re-optimization
    rng = np.random.default_rng(3)
    r_st = rbl.RedTEState.init(6)
    fids = (np.arange(200, dtype=np.uint64) * 2654435761
            % (1 << 32)).astype(np.uint32)
    valid = rng.random((200, 6)) < 0.8
    valid[:4] = False
    for now in (0, 100_000, 200_000, 350_000):
        util = rng.integers(0, 300, 6).astype(np.int32)
        r_st = rbl.redte_update(r_st, now, util)
        w = pbl.redte_weights(_t(util))
        _eq(w, r_st.weights, f"weights at {now}")
        _eq(pbl._weighted_hash(_t(fids), w, _t(valid)),
            rbl.redte(fids, None, None, valid, r_st), f"choice at {now}")


@pytest.mark.parametrize("seed", range(3))
def test_path_bottleneck_stats_bit_exact(seed):
    rng = np.random.default_rng(seed)
    L, NP, H = 40, 200, 8
    delay = rng.integers(1, 30_000, L).astype(np.int32)
    cap = rng.choice([0, 25, 40, 100, 400], L).astype(np.int32)
    plen = rng.integers(1, H + 1, NP).astype(np.int32)
    links = rng.integers(0, L, (NP, H)).astype(np.int32)
    links[np.arange(H)[None, :] >= plen[:, None]] = -1
    want = rpathq.path_bottleneck_stats(jnp.asarray(delay), jnp.asarray(cap),
                                        jnp.asarray(links), jnp.asarray(plen))
    got = ppathq.path_bottleneck_stats(_t(delay), _t(cap), _t(links), _t(plen))
    for g, w, n in zip(got, want, ("delay", "cap")):
        assert g.dtype == torch.int32
        _eq(g, w, n)


# ------------------------------------- the engine's decisions, every law
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


def to_reference(r_obj, state):
    """The reference dataclass ``r_obj`` with every field replaced from
    the flat numpy dict ``state`` (nested ones dotted)."""
    kw = {}
    for f in dataclasses.fields(r_obj):
        v = getattr(r_obj, f.name)
        if dataclasses.is_dataclass(v):
            if f.name in ("cong",):
                kw[f.name] = to_reference(v, {k[len(f.name) + 1:]: x
                                              for k, x in state.items()
                                              if k.startswith(f.name + ".")})
        elif v is not None and f.name in state:
            kw[f.name] = jnp.asarray(state[f.name])
    return dataclasses.replace(r_obj, **kw)


CARRY = {"testbed8": 600, "wan2000": 400, "geo": 250}


@pytest.fixture(scope="module", params=["testbed8", "wan2000", "geo"])
def world(request):
    """A world's reference arrays and a state its scanned lcmp step
    carried ``CARRY`` steps, then with about a quarter of the links down,
    random RedTE weights and a degrade schedule; the port's copies; the
    rows to route (around the carried step and below the largest signal
    delay, the congestion fallback's row set as ``fallback``)."""
    name = request.param
    kw = CS.CHECK_WORLDS[name]
    _, rt, rf, rcfg = rexp.build_experiment(rexp.ExpSpec(**kw))
    r_arr, r_st = rfluid.build(rt, rf, rcfg)
    step = rfluid.make_step(r_arr, rcfg)
    k = CARRY[name]
    r_st = jax.jit(lambda s: jax.lax.scan(step, s, jnp.arange(k))[0])(r_st)
    rng = np.random.default_rng(len(name))
    state = flat(r_st)
    assert state["active"].any()
    L = state["link_alive"].shape[0]
    state["link_alive"] = rng.random(L) >= 0.25
    state["redte_w"] = rng.integers(0, 300, state["redte_w"].shape).astype(np.int32)
    arrays = CS.random_degrade(flat(r_arr), rng)
    r_arr = to_reference(r_arr, arrays)
    rows = CS.check_rows(arrays["arrivals"], int(arrays["path_sig_delay"].max()))
    rows = sorted(set(rows) | {k, k + 1, k + 2})
    return name, rcfg, arrays, state, r_arr, r_st, rows


def _pair(world, policy, kind):
    """Reference and port configs, states and arrays of ``world`` for
    ``policy``; ``fallback`` fills the ring with 230-255."""
    name, rcfg, arrays, state, r_arr, r_st, rows = world
    state = dict(state)
    if kind == "fallback":
        state["hist_c"] = np.random.default_rng(9).integers(
            230, 256, state["hist_c"].shape).astype(np.int32)
    rcfg = dataclasses.replace(rcfg, policy=policy)
    pcfg = pengine.SimConfig(policy=policy, cap_scale=rcfg.cap_scale,
                             horizon_us=rcfg.horizon_us)
    p_arr, p_st = carry.from_reference(arrays, state, device="cpu")
    return rcfg, pcfg, r_arr, to_reference(r_st, state), p_arr, p_st, rows


@pytest.mark.parametrize("kind", ["dead", "fallback"])
@pytest.mark.parametrize("policy", LAWS)
def test_plain_decide_matches_reference(world, policy, kind):
    rcfg, pcfg, r_arr, r_st, p_arr, p_st, rows = _pair(world, policy, kind)
    F = p_st.flow_path.shape[0]
    nonce = np.random.default_rng(1).integers(0, 5, F).astype(np.uint32)
    salted = (np.asarray(r_arr.f_id) ^ np.asarray(rselect.fmix32(nonce)))
    k = CARRY[world[0]]
    launches = ops.counts()["decide"]
    # the failover's read (t - 1, at t = 0 a negative ring step), the
    # re-decision's (salted keys), and a late step past the degrades
    for t, sig, fid in ((0, -1, None), (k, k - 1, None), (k, k, salted),
                        (2500, 2500, salted)):
        r_fid = r_arr.f_id if fid is None else jnp.asarray(fid)
        p_fid = p_arr.f_id if fid is None else torch.from_numpy(
            fid.astype(np.int64))
        rk, rc = rengine.decide(t, r_fid, r_arr.f_pair, r_st, r_arr, rcfg,
                                sig_step=sig)
        pk, pc = pengine.decide(t, p_fid, p_arr.f_pair, p_st, p_arr, pcfg,
                                sig_step=sig)
        assert pk.dtype == pc.dtype == torch.int32
        _eq(pk, rk, f"{policy} k_idx t={t}")
        _eq(pc, rc, f"{policy} chosen t={t}")
    assert (pk.numpy() >= 0).any()
    assert ops.counts()["decide"] == launches            # plain: no launch


@pytest.mark.parametrize("kind", ["dead", "fallback"])
@pytest.mark.parametrize("policy", LAWS)
def test_plain_route_matches_reference(world, policy, kind):
    rcfg, pcfg, r_arr, r_st, p_arr, p_st, rows = _pair(world, policy, kind)
    routed = 0
    for t in rows:
        want = flat(rengine._route_arrivals(t, r_st, r_arr, rcfg))
        got = carry.to_numpy(pengine._route_arrivals(t, p_st, p_arr, pcfg))
        for n in CS.FLOW_FIELDS:
            if n == "extra_wait":
                np.testing.assert_allclose(got[n], want[n],
                                           rtol=EXTRA_WAIT_RTOL, atol=0,
                                           err_msg=f"{policy} t={t} {n}")
            else:
                assert got[n].dtype == want[n].dtype, n
                np.testing.assert_array_equal(got[n], want[n],
                                              err_msg=f"{policy} t={t} {n}")
        routed += int((got["route_step"] == t).sum())
    assert routed > 0
