"""The packet engine's flowlet re-decision plane in the port
(``tests/test_redecision.py``'s cases): on a degraded 1G world the
detector fires only after a genuine idle gap, moves traffic onto the
clean path after the degrade, and re-decides the same flows at the same
slots as the JAX package; an uncongested pair never drains long enough,
so an armed detector stays silent and the run equals the unarmed one bit
for bit; a gap far above the real idle runs never fires. 5000 slots of
12 flows a run; about a minute on one worker.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.select import ecmp_select
from repro.netsim import packet as rpacket
from repro.netsim import paths as rpaths
from repro.netsim import topo as rtopo
from repro.netsim.engine import SimConfig as RSimConfig
from repro.netsim.engine import attach_link_caps as rattach
from repro.traffic.gen import FlowSet as RFlowSet
from repro_torch.netsim import engine as pengine
from repro_torch.netsim import packet as ppacket
from repro_torch.netsim import paths as ppaths
from repro_torch.netsim import topo as ptopo
from repro_torch.traffic.gen import FlowSet as PFlowSet


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The worlds here are small: torch's intra-op threads would only
    contend with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flow_ids(n):
    """``n`` flow ids that ecmp pins to path 0 of two."""
    fids = np.arange(1, 4000, dtype=np.uint32)
    k = np.asarray(ecmp_select(jnp.asarray(fids),
                               jnp.ones((len(fids), 2), bool)))
    return fids[k == 0][:n]


def _world(fids, reference=False):
    """Two 1G parallel paths, ``fids`` arriving together at 1 ms with
    200 kB each."""
    topo, paths, attach, flowset = ((rtopo, rpaths, rattach, RFlowSet)
                                    if reference else
                                    (ptopo, ppaths, pengine.attach_link_caps,
                                     PFlowSet))
    t = topo.parallel_paths(caps=(1, 1), delays_us=(200, 200))
    table = paths.build_path_table(t, [(0, 3)])
    attach(table, t)
    n = len(fids)
    flows = flowset(arrival_us=np.full(n, 1000, np.int64),
                    size_bytes=np.full(n, 2e5), pair_id=np.zeros(n, np.int32),
                    flow_id=np.array(fids, np.uint32))
    return table, flows


def _run(fids, gap_us, degrade=True, reference=False):
    table, flows = _world(fids, reference)
    deg = ((int(table.path_first[0]), 5000, 0.5),) if degrade else ()
    kw = dict(engine="packet", policy="fatpaths", horizon_us=1_000_000,
              flowlet_gap_us=gap_us, ecn_kmin_bytes=2e4, degrade_sched=deg)
    if reference:
        cfg = RSimConfig(**kw)
        return rpacket.run(*rpacket.build(table, flows, cfg), cfg)
    cfg = pengine.SimConfig(**kw)
    return ppacket.run(*ppacket.build(table, flows, cfg, device="cpu"), cfg)


def test_packet_flowlet_fires_after_genuine_idle_gap():
    fids = _flow_ids(12)
    f = _run(fids, gap_us=800)
    nonce, fp = f.route_nonce.numpy(), f.flow_path.numpy()
    assert (nonce > 0).sum() >= len(nonce) // 2      # the detector fired
    moved = fp == 1
    assert moved.any()                               # traffic re-balanced
    assert (f.route_step.numpy()[moved] > 5000 // 200).all()
    assert f.done.all()
    r = _run(fids, gap_us=800, reference=True)
    np.testing.assert_array_equal(nonce, np.asarray(r.route_nonce))
    np.testing.assert_array_equal(fp, np.asarray(r.flow_path))
    np.testing.assert_array_equal(f.route_step.numpy(), np.asarray(r.route_step))
    np.testing.assert_allclose(f.fct_us.numpy(), np.asarray(r.fct_us),
                               rtol=1e-5)


def test_packet_flowlet_needs_idle_not_just_time():
    armed = _run([42, 99], gap_us=800, degrade=False)
    off = _run([42, 99], gap_us=0, degrade=False)
    assert int(armed.route_nonce.max()) == 0
    for name in ("fct_us", "flow_path", "done", "delivered"):
        assert torch.equal(getattr(armed, name), getattr(off, name)), name
    f = _run(_flow_ids(12), gap_us=400_000)
    assert int(f.route_nonce.max()) == 0
