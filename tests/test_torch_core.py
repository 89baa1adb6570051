"""Port parity: repro_torch.core (tables, pathq, cong, select) is bit-exact
with repro.core on seeded random integers, hash edge values, negative
trends, P from 2 to 8, rows with no valid candidate and the congestion
fallback, over the parameter sweeps of tests/test_kernels.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cong as rcong
from repro.core import pathq as rpathq
from repro.core import select as rselect
from repro.core import tables as rtables
from repro_torch.core import cong as pcong
from repro_torch.core import pathq as ppathq
from repro_torch.core import select as pselect
from repro_torch.core import tables as ptables

HASH_EDGES = [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
              0xFFFFFFFF, 0x85EBCA6B, 0xC2B2AE35]

SELECT_SWEEP = [dict(), dict(alpha=1, beta=1), dict(alpha=1, beta=3),
                dict(alpha=3, beta=1, cong_fallback=100),
                dict(alpha=2, beta=2, keep_num=3)]
CONG_SWEEP = [dict(), dict(w_ql=1, w_tl=2, w_dp=1, ewma_k=2, dur_shift=1)]


def _eq(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


def _tables_pair(rates, **kw):
    return (rtables.bootstrap_tables(rates, **kw),
            ptables.bootstrap_tables(rates, device="cpu", **kw))


# ---------------------------------------------------------------- tables
@pytest.mark.parametrize("rates,kw", [
    ([100] * 5, {}),
    ([25, 40, 100, 200, 400], dict(buffer_bytes=10**9, sample_interval_us=200)),
    ([3, 12, 50], dict(buffer_bytes=1 << 20, sample_interval_us=200,
                       num_classes=6, num_levels=8, high_water_frac=0.5)),
])
def test_bootstrap_tables_bit_exact(rates, kw):
    r, p = _tables_pair(rates, **kw)
    for f in ("cap_thresh", "level_score", "q_thresh", "trend_thresh"):
        assert getattr(p, f).dtype == torch.int32
        _eq(getattr(p, f), getattr(r, f), f)
    assert p.high_water_level == int(r.high_water_level)
    assert p.num_levels == r.num_levels


# ----------------------------------------------------------------- pathq
@pytest.mark.parametrize("seed", range(3))
def test_path_quality_bit_exact(seed):
    rng = np.random.default_rng(seed)
    n = 500
    delay = rng.integers(0, 200_000, n).astype(np.int32)
    thr = np.array(rtables.capacity_class_thresholds(400))
    cap = np.concatenate([rng.integers(0, 800, n - 2 * len(thr)),
                          thr, thr - 1]).astype(np.int32)   # on boundaries
    params = [dict(), dict(w_dl=1, w_lc=3, d_shift=6),
              dict(w_dl=2, w_lc=2, d_shift=10)][seed]
    rp, pp = rpathq.PathQParams(**params), ppathq.PathQParams(**params)
    cap_thresh = torch.from_numpy(thr)
    _eq(ppathq.calc_delay_cost(torch.from_numpy(delay), pp),
        rpathq.calc_delay_cost(delay, rp))
    _eq(ppathq.calc_linkcap_cost(torch.from_numpy(cap), cap_thresh),
        rpathq.calc_linkcap_cost(cap, jnp.asarray(thr)))
    _eq(ppathq.calc_path_quality(torch.from_numpy(delay), torch.from_numpy(cap),
                                 cap_thresh, pp),
        rpathq.calc_path_quality(delay, cap, jnp.asarray(thr), rp))


# ------------------------------------------------------------------ cong
@pytest.mark.parametrize("params", CONG_SWEEP)
@pytest.mark.parametrize("n_ports", [1, 24, 152])
def test_cong_pipeline_bit_exact(n_ports, params):
    rng = np.random.default_rng(n_ports)
    rates = rng.choice([25, 40, 100, 200, 400], n_ports).tolist()
    r_tb, p_tb = _tables_pair(rates, buffer_bytes=10**9, sample_interval_us=200)
    rp, pp = rcong.CongParams(**params), pcong.CongParams(**params)
    r_st = rcong.CongState.init(n_ports)
    p_st = pcong.CongState.init(n_ports, device="cpu")
    saw_negative = False
    for tick in range(12):
        # bursts then drains, so the trend swings negative
        hi = 1_000_000 if tick % 4 < 2 else 2_000
        q = rng.integers(0, hi, n_ports).astype(np.int32)
        r_st = rcong.monitor_update(r_st, q, tick * 200, r_tb, rp)
        p_st = pcong.monitor_update(p_st, torch.from_numpy(q), tick * 200,
                                    p_tb, pp)
        for f in dataclasses.fields(pcong.CongState):
            _eq(getattr(p_st, f.name), getattr(r_st, f.name), f.name)
        saw_negative |= bool((p_st.trend < 0).any())
        _eq(pcong.calc_cong_cost(p_st, p_tb, pp),
            rcong.calc_cong_cost(r_st, r_tb, rp), "c_cong")
        for got, want in zip(pcong.cong_signals(p_st, p_tb, pp),
                             rcong.cong_signals(r_st, r_tb, rp)):
            _eq(got, want, "signals")
    assert saw_negative


# ---------------------------------------------------------------- select
def test_tables_and_registers_need_a_card_unless_cpu_is_asked(monkeypatch):
    """The bootstrap tables and the congestion registers default to the
    card like every entry point: without one they raise unless the CPU
    is asked for; a shape-only ``meta`` state still builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ptables.level_score_table(16),
                 lambda: ptables.capacity_class_thresholds(400),
                 lambda: ptables.queue_thresholds(10**9),
                 lambda: pcong.CongState.init(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert ptables.queue_thresholds(10**9, device="cpu").device.type == "cpu"
    assert pcong.CongState.init(4, device="meta").trend.is_meta


def test_fmix32_hash_edges():
    rng = np.random.default_rng(0)
    x = np.concatenate([HASH_EDGES, rng.integers(0, 1 << 32, 4096)])
    x = x.astype(np.uint32)
    want = np.asarray(rselect.fmix32(jnp.asarray(x)))
    got = pselect.fmix32(torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    _eq(got, want.astype(np.int64))
    # an int32 bit pattern hashes like its uint32 value
    _eq(pselect.fmix32(torch.from_numpy(x.view(np.int32))), want.astype(np.int64))


def _select_inputs(seed, F, P):
    rng = np.random.default_rng(seed)
    fids = rng.integers(0, 1 << 32, F).astype(np.uint32)
    fids[:len(HASH_EDGES)] = HASH_EDGES
    c_path = rng.integers(0, 256, (F, P)).astype(np.int32)
    c_cong = rng.integers(0, 256, (F, P)).astype(np.int32)
    valid = rng.random((F, P)) < 0.8
    valid[F // 4] = False                       # no valid candidate
    valid[F // 3] = False
    c_cong[F // 2:F // 2 + 8] = rng.integers(230, 256, (8, P))   # fallback
    c_path[F // 5] = 7                          # full cost ties
    c_cong[F // 5] = 3
    return fids, c_path, c_cong, valid


def _torch_inputs(fids, c_path, c_cong, valid):
    return (torch.from_numpy(fids.astype(np.int64)), torch.from_numpy(c_path),
            torch.from_numpy(c_cong), torch.from_numpy(valid))


@pytest.mark.parametrize("params", SELECT_SWEEP)
@pytest.mark.parametrize("P", range(2, 9))
def test_select_egress_bit_exact(P, params):
    fids, c_path, c_cong, valid = _select_inputs(P, 400, P)
    r_idx, r_cost = rselect.select_egress(fids, c_path, c_cong, valid,
                                          rselect.SelectParams(**params))
    p_idx, p_cost = pselect.select_egress(
        *_torch_inputs(fids, c_path, c_cong, valid),
        pselect.SelectParams(**params))
    assert p_idx.dtype == torch.int32
    _eq(p_idx, r_idx, "choice")
    _eq(p_cost, r_cost, "cost")
    assert (p_idx.numpy()[~valid.any(-1)] == -1).all()


def test_select_egress_broadcast_candidates_and_weights_out_of_slice():
    # broadcast (P,) candidates, without and with the capacity weights of
    # lcmp_w (ported since: the weighted stage 2 equals the reference's)
    fids = np.arange(50, dtype=np.uint32)
    c_path = np.array([10, 20, 30, 40], np.int32)
    c_cong = np.array([0, 5, 250, 9], np.int32)
    valid = np.array([True, True, False, True])
    weights = np.array([400, 0, 100, 25], np.int32)
    for w in (None, weights):
        r_idx, _ = rselect.select_egress(fids, c_path, c_cong, valid,
                                         weights=w)
        p_idx, _ = pselect.select_egress(
            torch.from_numpy(fids.astype(np.int64)), torch.from_numpy(c_path),
            torch.from_numpy(c_cong), torch.from_numpy(valid),
            weights=None if w is None else torch.from_numpy(w))
        _eq(p_idx, r_idx)


@pytest.mark.parametrize("P", range(2, 9))
def test_ecmp_select_bit_exact(P):
    fids, _, _, valid = _select_inputs(100 + P, 400, P)
    want = rselect.ecmp_select(fids, valid)
    got = pselect.ecmp_select(torch.from_numpy(fids.astype(np.int64)),
                              torch.from_numpy(valid))
    assert got.dtype == torch.int32
    _eq(got, want)
