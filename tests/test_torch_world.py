"""Port parity: world and traffic tables (repro_torch.netsim.topo/paths/
scenarios, repro_torch.traffic.cdf/gen) equal the JAX package's bit for
bit, for every registered scenario."""
import dataclasses

import numpy as np
import pytest

from repro.netsim import experiment as rexp
from repro.netsim import scenarios as rscen
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import scenarios as pscen

WAN2000 = dict(topology="wan2000:dcs=24,segs=2,chords=12", pairs="main",
               load=0.5, bg_load=0.25, cap_scale=0.0625, duration_us=400_000)


def _assert_same(a, b, what):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if va is None or vb is None:
            assert va is None and vb is None, f"{what}.{f.name}"
        elif isinstance(va, np.ndarray):
            assert va.dtype == np.asarray(vb).dtype, f"{what}.{f.name}"
            np.testing.assert_array_equal(va, vb, err_msg=f"{what}.{f.name}")
        else:
            assert va == vb, f"{what}.{f.name}"


def test_scenario_names_match():
    assert pscen.names() == rscen.names()


@pytest.mark.parametrize("name", rscen.names())
def test_world_and_flows_bit_exact(name):
    rs, rt = rexp.build_world(name)
    ps, pt = pexp.build_world(name)
    _assert_same(pt, rt, "PathTable")
    for attr in ("_link_caps", "_link_delays"):
        np.testing.assert_array_equal(getattr(pt, attr), getattr(rt, attr))
    assert ps.main_pair == rs.main_pair
    assert ps.fail_sched == rs.fail_sched
    assert ps.degrade_sched == rs.degrade_sched
    assert ps.traffic_pairs == rs.traffic_pairs
    kw = dict(topology=name, load=0.5, duration_us=100_000, seed=3)
    _assert_same(pexp.make_flows(pexp.ExpSpec(**kw), ps, pt),
                 rexp.make_flows(rexp.ExpSpec(**kw), rs, rt), "FlowSet")


@pytest.mark.parametrize("pairs", ["main", "all"])
def test_wan2000_flows_with_background_bit_exact(pairs):
    kw = dict(WAN2000, pairs=pairs)
    rs, rt = rexp.build_world(kw["topology"])
    ps, pt = pexp.build_world(kw["topology"])
    _assert_same(pt, rt, "PathTable")
    pf = pexp.make_flows(pexp.ExpSpec(**kw), ps, pt)
    _assert_same(pf, rexp.make_flows(rexp.ExpSpec(**kw), rs, rt), "FlowSet")
    # with "main" the other pairs are background; with "all" none are left
    assert pf.foreground.all() == (pairs == "all")
