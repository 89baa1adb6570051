"""The names the port once lacked, against the JAX package on the CPU:
``core.switchd.candidate_costs`` (bit for bit over seeded monitor ticks
and a port death, and equal at every tick to the switch's own
``c_path``, ``c_cong`` and liveness), ``repro_torch.core``'s 26
re-exports, ``tables.bytes_to_cells``, ``path_cong_view`` (as
``fluid`` and ``engine`` export it) on rings read with early, wrapping
offsets, the ``Engine`` protocol, ``FLOW_FIELDS`` and the engine surface
that ``fluid`` and ``packet`` re-export. About 5 s on one worker.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rcore
from repro.core import switchd as rswitchd
from repro.core import tables as rtables
from repro.netsim import engine as rengine
from repro.netsim import fluid as rfluid

import repro_torch.core as tcore
from repro_torch.core import switchd, tables
from repro_torch.netsim import engine, fluid, packet, sanitize

# 8 ports, 6 candidates on 6 of them (Fig. 1's {200,200,100,100,40,40}
# Gbps x {5,250} ms paths)
RATES = [40, 100, 200, 400, 100, 40, 400, 200]
CAND_PORT = [3, 0, 5, 1, 7, 2]
DELAYS = [5_000, 250_000, 5_000, 250_000, 5_000, 250_000]
CAPS = [200, 200, 100, 100, 40, 40]
TICKS, DEAD_TICK = 20, 20


def _switches():
    ref = rswitchd.make_switch(rtables.bootstrap_tables(RATES), DELAYS, CAPS,
                               CAND_PORT, len(RATES))
    port = switchd.make_switch(tables.bootstrap_tables(RATES, device="cpu"),
                               DELAYS, CAPS, CAND_PORT, len(RATES),
                               device="cpu")
    return ref, port


def _same_costs(ref, port):
    want = [np.asarray(x) for x in rswitchd.candidate_costs(ref)]
    got = switchd.candidate_costs(port)
    for w, g in zip(want, got):
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w)
    kept = (port.c_path, port.c_cong[port.cand_port],
            port.cand_valid & port.port_alive[port.cand_port])
    for k, g in zip(kept, got):
        assert torch.equal(k, g)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_costs_equals_reference(seed):
    """At bootstrap, after each of 20 monitor ticks of seeded queues (cells:
    random walks inside the 6 GB buffer), and after a port death and 3
    more ticks."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-600_000, 700_000, (TICKS + 3, len(RATES)))
    queues = np.clip(np.cumsum(steps, 0), 0, 5_800_000).astype(np.int32)
    ref, port = _switches()
    _same_costs(ref, port)
    scores = []
    for tick in range(TICKS + 3):
        if tick == DEAD_TICK:
            alive = np.ones(len(RATES), bool)
            alive[CAND_PORT[seed]] = False
            ref = rswitchd.set_port_liveness(ref, jnp.asarray(alive))
            port = switchd.set_port_liveness(port, alive)
        ref = rswitchd.monitor_tick(ref, jnp.asarray(queues[tick]), tick * 100)
        port = switchd.monitor_tick(port, torch.from_numpy(queues[tick]),
                                    tick * 100)
        _, c_cong, valid = _same_costs(ref, port)
        scores.append(c_cong)
    assert int(torch.stack(scores).max()) > 0      # the registers moved
    assert not bool(valid[seed]) and int(valid.sum()) == len(CAND_PORT) - 1


def test_core_all_equals_reference_and_imports():
    assert tcore.__all__ == rcore.__all__
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    space = {}
    exec("from repro_torch.core import *", space)
    assert set(rcore.__all__) <= set(space)
    assert tcore.candidate_costs is switchd.candidate_costs
    with pytest.raises(AttributeError):
        tcore.no_such_name


@pytest.mark.parametrize("b", [0, 1, 1023, 1024, 1025, 6 * 10**9, 2**31 - 1,
                               1536.7, 2047.999, 1024.0],
                         ids=lambda b: f"{type(b).__name__}{b}")
def test_bytes_to_cells_scalars(b):
    got = tables.bytes_to_cells(b, device="cpu")
    want = np.asarray(rtables.bytes_to_cells(b))
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want)


def test_bytes_to_cells_arrays():
    """Seeded float32 byte counts with exact multiples of 1024 and the
    float32 values just below them, as an array and as a tensor."""
    rng = np.random.default_rng(5)
    k = rng.integers(0, 6_000_000, 64).astype(np.float32) * 1024
    b = np.concatenate([k, np.nextafter(k, np.float32(0)), k - 1,
                        rng.uniform(0, 6e9, 64).astype(np.float32)])
    want = np.asarray(rtables.bytes_to_cells(jnp.asarray(b)))
    for x in (b, torch.from_numpy(b), torch.from_numpy(b).double()):
        got = tables.bytes_to_cells(x, device="cpu")
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t", [0, 1, 7, 63, 200, rfluid.HIST - 1, rfluid.HIST + 5])
def test_path_cong_view_equals_reference(t):
    """Seeded rings read at early steps, so ``t - sig_delay`` wraps to the
    ring's end; -1 hop pads; through ``fluid`` and ``engine``."""
    rng = np.random.default_rng(t)
    L, N, H = 6, 40, 4
    hist_c = rng.integers(0, 256, (L, rfluid.HIST)).astype(np.int32)
    links = rng.integers(-1, L, (N, H)).astype(np.int32)
    sig = rng.integers(0, 100, (N, H)).astype(np.int32)
    want = np.asarray(rfluid.path_cong_view(jnp.asarray(hist_c),
                                            jnp.asarray(links),
                                            jnp.asarray(sig), t))
    args = (torch.from_numpy(hist_c), torch.from_numpy(links),
            torch.from_numpy(sig), t)
    for fn in (fluid.path_cong_view, engine.path_cong_view):
        np.testing.assert_array_equal(fn(*args).numpy(), want)


@pytest.mark.parametrize("name", ["fluid", "packet"])
def test_engines_satisfy_the_protocol(name):
    mod = engine.get_engine(name)
    assert isinstance(mod, engine.Engine) and mod.name == name
    assert not isinstance(sanitize, engine.Engine)


def test_flow_fields_equal_reference():
    assert engine.FLOW_FIELDS == rengine.FLOW_FIELDS
    assert engine.POLICY_CODES == rengine.POLICY_CODES
    assert engine.REDECIDE_POLICIES == rengine.REDECIDE_POLICIES
    assert engine.ENGINES == rengine.ENGINES


@pytest.mark.parametrize("name", [
    "ENGINES", "POLICIES", "POLICY_CODES", "REDECIDE_POLICIES", "ctrl_refresh",
    "decide", "monitor_tick", "path_cong_view", "policy_code"])
def test_fluid_re_exports_the_engine_surface(name):
    assert hasattr(rfluid, name)
    assert getattr(fluid, name) is getattr(engine, name)


def test_fluid_and_packet_re_export_engine():
    assert fluid.engine is engine
    assert packet.monitor_tick is engine.monitor_tick
    assert fluid.policy_code("lcmp_r") == rfluid.policy_code("lcmp_r")
