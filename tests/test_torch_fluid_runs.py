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


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.mark.parametrize("run", list(_chip_smoke().RUNS))
def test_chip_smoke_reference_numbers_are_the_jax_packages(run):
    # chip_smoke.py holds the card's runs to these numbers; pin them to
    # what the JAX package computes on the same specs
    chip_smoke = _chip_smoke()
    spec = rexp.ExpSpec(**chip_smoke.RUNS[run])
    stats, _, _ = rexp.run_experiment(spec)
    p50, p99, completed, offered = chip_smoke.REFERENCE[run]
    assert abs(stats.p50 - p50) <= 0.005 * p50      # printed to 3-4 digits
    assert abs(stats.p99 - p99) <= 0.005 * p99
    assert (stats.completed, stats.offered) == (completed, offered)


@pytest.mark.parametrize("kw", [
    dict(topology="testbed8_failover:fail_ms=5", load=0.3, policy="lcmp"),
    dict(topology="staleness:deg_ms=5", load=0.4, policy="lcmp_r",
         redecide_period_us=4_000),
], ids=["failover", "epochs"])
def test_chip_smoke_plain_calls_see_the_cpu_steps_plain_versions(kw):
    # on the CPU every phase runs its plain version, so the check the card's
    # runs must pass with no call sees each of them, and the failover's and
    # re-decision's decisions number what chip_smoke expects of `decide`
    chip_smoke = _chip_smoke()
    from repro_torch.kernels import ref
    saved = dict(vars(ref))
    spec = pexp.ExpSpec(duration_us=10_000, **kw)
    with chip_smoke.PlainCalls() as plain:
        _, _, (_, _, _, cfg, _) = pexp.run_experiment(spec, device="cpu")
    assert plain.called["monitor_tick_ref"] == cfg.num_steps
    assert plain.called["route_arrivals_ref"] == cfg.num_steps
    assert plain.called["decide_ref"] == chip_smoke.expected_decides(cfg) > 0
    assert plain.calls > 3 * cfg.num_steps
    assert all(vars(ref)[k] is v for k, v in saved.items())
