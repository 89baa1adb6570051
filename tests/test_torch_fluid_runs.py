"""Port parity of whole fluid runs: testbed8, lcmp and ecmp, load 0.5 over
400 ms (the fig5 main path), the port on the CPU against the JAX package.

Bands: ``flow_path`` equal for >= 99% of the flows routed in the first
1000 steps, FCT-slowdown p50 within 3%, p99 within 10%, completions
within 1% of offered. Only float rounding separates the two runs (sum
order in the per-hop and per-link reductions); it can move a queue cell
across a threshold and with it a later decision, nothing else can.
The reference numbers ``chip_smoke.py`` holds the card's runs to are
pinned here to what the JAX package computes.
"""
import os
import sys

import numpy as np
import pytest

from repro.netsim import experiment as rexp
from repro_torch.netsim import experiment as pexp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTBED8 = dict(topology="testbed8", load=0.5, duration_us=400_000)


@pytest.mark.parametrize("policy", ["lcmp", "ecmp"])
def test_testbed8_full_run_within_bands(policy):
    kw = dict(TESTBED8, policy=policy)
    r_stats, _, (_, _, flows, cfg, r_fin) = rexp.run_experiment(rexp.ExpSpec(**kw))
    p_stats, p_util, (_, _, _, _, p_fin) = pexp.run_experiment(
        pexp.ExpSpec(**kw), device="cpu")

    step = np.minimum(flows.arrival_us // cfg.dt_us, cfg.num_steps - 1)
    early = step < 1000
    r_path, p_path = np.asarray(r_fin.flow_path), p_fin.flow_path.numpy()
    differ = early & (r_path != p_path)
    first = int(step[differ].min()) if differ.any() else None
    same = float((r_path[early] == p_path[early]).mean())
    print(f"{policy}: same path {same:.4f} of {int(early.sum())} early flows; "
          f"first differing step {first}; p50 {p_stats.p50:.4f} vs "
          f"{r_stats.p50:.4f}; p99 {p_stats.p99:.4f} vs {r_stats.p99:.4f}; "
          f"completed {p_stats.completed} vs {r_stats.completed} of "
          f"{r_stats.offered}")

    assert same >= 0.99
    assert p_stats.offered == r_stats.offered == flows.num_flows
    assert abs(p_stats.p50 - r_stats.p50) <= 0.03 * r_stats.p50
    assert abs(p_stats.p99 - r_stats.p99) <= 0.10 * r_stats.p99
    assert abs(p_stats.completed - r_stats.completed) <= 0.01 * r_stats.offered
    assert np.isfinite(p_util).all() and (p_util <= 1.0 + 1e-6).all()


@pytest.mark.parametrize("world,policy", [("testbed8", "lcmp"),
                                          ("testbed8", "ecmp"),
                                          ("wan2000", "lcmp"),
                                          ("wan2000", "ecmp")])
def test_chip_smoke_reference_numbers_are_the_jax_packages(world, policy):
    # chip_smoke.py holds the card's runs to these numbers; pin them to
    # what the JAX package computes on the same specs
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    spec = rexp.ExpSpec(**chip_smoke.WORLDS[world], policy=policy)
    stats, _, _ = rexp.run_experiment(spec)
    p50, p99, completed, offered = chip_smoke.REFERENCE[(world, policy)]
    assert abs(stats.p50 - p50) <= 0.005 * p50      # printed to 3-4 digits
    assert abs(stats.p99 - p99) <= 0.005 * p99
    assert (stats.completed, stats.offered) == (completed, offered)
