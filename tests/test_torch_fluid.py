"""Port parity of the fluid engine (repro_torch.netsim.engine/fluid/carry):
``build()`` arrays, one step from carried reference state, the import
boundary, and the device rule. Full runs are in test_torch_fluid_runs.py.
"""
import dataclasses
import os
import subprocess
import sys

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTBED8 = dict(topology="testbed8", load=0.5, duration_us=400_000)
WAN2000 = dict(topology="wan2000:dcs=24,segs=2,chords=12", pairs="main",
               load=0.5, bg_load=0.25, cap_scale=0.0625, duration_us=400_000)
# float fields of one step from identical state: the port sums the same
# float32 terms as XLA on the CPU, in possibly another order (per-hop sums,
# index_add_ for segment_sum), so they agree to float32 rounding
FLOAT_RTOL = 1e-5


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


def _worlds(kw):
    r = rexp.build_experiment(rexp.ExpSpec(**kw))
    p = pexp.build_experiment(pexp.ExpSpec(**kw))
    return r, p


def _assert_flat_equal(got, want, rtol=0.0):
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


@pytest.mark.parametrize("kw", [TESTBED8, WAN2000], ids=["testbed8", "wan2000"])
def test_build_arrays_exact(kw):
    (_, rt, rf, rcfg), (_, pt, pf, pcfg) = _worlds(kw)
    r_arr, r_st = rfluid.build(rt, rf, rcfg)
    p_arr, p_st = pfluid.build(pt, pf, pcfg, device="cpu")
    assert pcfg.num_steps == rcfg.num_steps == 4000
    _assert_flat_equal(carry.to_numpy(p_arr), flat(r_arr))
    _assert_flat_equal(carry.to_numpy(p_st), flat(r_st))
    # arrival bucketing covers every flow exactly once
    a = p_arr.arrivals.numpy()
    assert np.array_equal(np.sort(a[a >= 0]), np.arange(pf.num_flows))


@pytest.mark.parametrize("field,value", [("dt_us", 10),
                                         ("sig_delay_scale", 40.0)])
def test_hist_guard_raises_like_reference(field, value):
    (_, rt, rf, rcfg), (_, pt, pf, pcfg) = _worlds(TESTBED8)
    with pytest.raises(ValueError, match="history ring too short") as r_err:
        rfluid.build(rt, rf, dataclasses.replace(rcfg, **{field: value}))
    with pytest.raises(ValueError, match="history ring too short") as p_err:
        pfluid.build(pt, pf, dataclasses.replace(pcfg, **{field: value}),
                     device="cpu")
    assert str(p_err.value) == str(r_err.value)


# ------------------------------------------------ one step from carried state
CARRY_STEPS = (1, 500, 2000)


@pytest.fixture(scope="module", params=["lcmp", "ecmp"])
def carried(request):
    """Reference arrays + states after k steps of its own scanned
    ``make_step``, and the reference's own step k from each."""
    kw = dict(TESTBED8, policy=request.param)
    _, rt, rf, rcfg = rexp.build_experiment(rexp.ExpSpec(**kw))
    r_arr, st = rfluid.build(rt, rf, rcfg)
    step = rfluid.make_step(r_arr, rcfg)
    scan = jax.jit(lambda s, ts: jax.lax.scan(step, s, ts)[0])
    one = jax.jit(step)
    out, t = {}, 0
    for k in CARRY_STEPS:
        st = scan(st, jnp.arange(t, k))
        t = k
        out[k] = (flat(st), flat(one(st, k)[0]))
    return request.param, flat(r_arr), out


@pytest.mark.parametrize("k", CARRY_STEPS)
def test_one_step_from_carried_state(carried, k):
    policy, r_arr, states = carried
    before, want = states[k]
    p_arr, p_st = carry.from_reference(r_arr, before, device="cpu")
    cfg = pexp.spec_to_cfg(pexp.ExpSpec(**dict(TESTBED8, policy=policy)),
                           pexp.build_world("testbed8")[0])
    got = carry.to_numpy(pfluid.make_step(p_arr, cfg)(p_st, k))
    ints = {n for n, v in want.items() if not np.issubdtype(v.dtype, np.floating)}
    _assert_flat_equal({n: got[n] for n in ints}, {n: want[n] for n in ints})
    _assert_flat_equal({n: got[n] for n in want if n not in ints},
                       {n: want[n] for n in want if n not in ints},
                       rtol=FLOAT_RTOL)
    if k >= 500:       # the carried state really has traffic in flight
        assert before["active"].any() and before["q_bytes"].any()


def test_carry_round_trip_keeps_dtypes():
    (_, rt, rf, rcfg), _ = _worlds(TESTBED8)
    r_arr, r_st = rfluid.build(rt, rf, rcfg)
    p_arr, p_st = carry.from_reference(flat(r_arr), flat(r_st), device="cpu")
    assert p_arr.f_id.dtype == torch.int64
    assert isinstance(p_arr.tables.high_water_level, int)
    _assert_flat_equal(carry.to_numpy(p_st), flat(r_st))


# ------------------------------------------------ import boundary, device rule
def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "for m in ('dist.compress', 'dist.lcmp_collectives', 'models.arch',\n"
        "          'models.layers', 'models.carry', 'train.optim', 'train.step',\n"
        "          'data.synth', 'configs', 'configs.qwen3_4b',\n"
        "          'kernels.qsr_int8', 'serve.decode', 'launch.serve',\n"
        "          'launch.train', 'train.checkpoint', 'configs.dbrx_132b'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, "-c", code, REPO], capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert int(p.stdout.strip()) >= 35          # really imported the port


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = pexp.ExpSpec(topology="testbed8", load=0.5, duration_us=20_000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pexp.run_experiment(spec)
    _, table, flows, cfg = pexp.build_experiment(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pfluid.build(table, flows, cfg)
    stats, _, _ = pexp.run_experiment(spec, device="cpu")
    assert stats.completed > 0


@pytest.mark.parametrize("change,item", [
    (dict(engine="packet", cosim_model="zamba2-1.2b"), "item 11"),
    (dict(engine="packet", cosim_model="falcon-mamba-7b"), "item 11"),
    (dict(cosim_model="internvl2-2b"), "item 11"),
    (dict(cosim_model="whisper-medium"), "item 11"),
])
def test_outside_the_slice_raises_naming_the_roadmap(change, item):
    # these co-simulated models' families were outside the port, and
    # raised naming ROADMAP.md queue A ``item``, until that item's model
    # stack was ported: now they run, their buckets sized by the
    # reference's smoke parameter count
    from repro.cosim import workload as rworkload
    from repro_torch.cosim import workload as pworkload
    spec = pexp.ExpSpec(**dict(TESTBED8, duration_us=20_000, **change))
    stats, _, _ = pexp.run_experiment(spec, device="cpu")
    assert stats.completed > 0
    model = change["cosim_model"]
    assert (pworkload._smoke_param_count(model)
            == rworkload._smoke_param_count(model))


def test_route_arrivals_ignores_pad_slots():
    # flow 0 arrives in a step whose other slots are pads: the pads must
    # not overwrite it (the reference drops their writes out of bounds)
    _, table, flows, cfg = pexp.build_experiment(pexp.ExpSpec(**TESTBED8))
    arrs, st = pfluid.build(table, flows, cfg, device="cpu")
    t = int(np.nonzero((arrs.arrivals == 0).any(1).numpy())[0][0])
    row = arrs.arrivals[t]
    assert (row < 0).any()
    st = pengine._route_arrivals(t, st, arrs, cfg)
    assert int(st.flow_path[0]) >= 0 and bool(st.active[0])
    assert int(st.route_step[0]) == t
    routed = st.flow_path.numpy() >= 0
    assert routed.sum() == int((row >= 0).sum())
