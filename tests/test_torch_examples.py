"""The port's counterparts of the reference's three examples
(``examples/torch_routing_sim.py``, ``torch_multipod_grad_routes.py``,
``torch_quickstart.py``) on the CPU, against the JAX package: the herd
block's histogram bit for bit against ``repro.core.select.select_egress``;
the multipod example's part on 2 Gloo ranks (one module pool), its two
route bindings against the reference's ``schedule_buckets`` and its
reduced buckets against the f32 mean, for the reference's buckets and
for seeded ones; the routing example's sweep specs and the quickstart's
launcher calls (each with ``--device``). The sweep blocks and the
launcher subprocesses do not run here (the sweep and launcher tests
cover them); chip_smoke.py's phase examples runs all three on the card.
About 10 s on one worker.
"""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_group_workers as w
from repro.core import select as rselect
from repro.dist import lcmp_collectives as rlc

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import torch_multipod_grad_routes as multipod  # noqa: E402
import torch_quickstart as quickstart  # noqa: E402
import torch_routing_sim as routing_sim  # noqa: E402


@pytest.fixture(scope="module")
def pool():
    made = w.GlooPool(multipod.PODS)
    yield made
    made.close()


def test_herd_histogram_equals_reference():
    fids = jnp.arange(1000, dtype=jnp.uint32) * jnp.uint32(2654435761)
    idx, _ = rselect.select_egress(fids, jnp.array(routing_sim.HERD_C_PATH),
                                   jnp.zeros(6, jnp.int32), jnp.ones(6, bool))
    want = np.bincount(np.asarray(idx), minlength=6)
    got = routing_sim.herd("cpu")
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 1000 and got[3:].sum() == 0


def _reference_bindings():
    ids = rlc._fmix32_host(np.arange(1, 7, dtype=np.uint32))
    rlc._TELEMETRY.reset()
    try:
        alive = rlc.schedule_buckets(ids)
        rlc.set_route_liveness([False, True, True])
        return alive, rlc.schedule_buckets(ids)
    finally:
        rlc._TELEMETRY.reset()


@pytest.mark.parametrize("seed", [None, 3], ids=["reference", "seeded"])
def test_multipod_on_two_ranks(pool, seed):
    alive, dead = _reference_bindings()
    np.testing.assert_array_equal(multipod.bucket_ids(),
                                  rlc._fmix32_host(np.arange(1, 7, dtype=np.uint32)))
    results = pool.run(multipod.rank_main, "cpu", seed)
    want = {k: np.mean(np.stack([multipod.pod_buckets(p, "cpu", seed)[k].numpy()
                                 for p in range(multipod.PODS)]), 0,
                       dtype=np.float32)
            for k in results[0]["reduced"]}
    assert len(want) == multipod.BUCKETS
    for res in results:
        np.testing.assert_array_equal(res["alive"], alive)
        np.testing.assert_array_equal(res["dead"], dead)
        assert res["reduced_ok"] is True
        for k, v in res["reduced"].items():
            np.testing.assert_array_equal(v, want[k])
    assert not np.array_equal(alive, dead)
    if seed is None:                     # bucket i is i + 1 on every pod
        for i in range(multipod.BUCKETS):
            assert (results[0]["reduced"][f"bucket{i}"] == i + 1).all()


def test_routing_sim_sweeps_take_the_reference_specs():
    fig5 = routing_sim.testbed_specs()
    scen = routing_sim.scenario_specs()
    stale = routing_sim.staleness_specs()
    assert [s.policy for s in fig5] == ["ecmp", "ucmp", "lcmp", "lcmp_w"]
    assert {(s.topology, s.load, s.duration_us) for s in fig5} == {
        ("testbed8", 0.3, 400_000)}
    assert [(s.topology, s.policy) for s in scen] == [
        ("longhaul_mesh:routes=6,segs=3", "lcmp"),
        ("longhaul_mesh:routes=6,segs=3", "ecmp"),
        ("testbed8_failover:fail_ms=100", "lcmp"),
        ("testbed8_failover:fail_ms=100", "ecmp")]
    assert {(s.load, s.duration_us) for s in scen} == {(0.3, 300_000)}
    assert [(s.sig_delay_scale, s.ctrl_period_us, s.policy) for s in stale] == [
        (sds, per, pol) for sds, per in [(0.0, 50_000), (1.0, 50_000),
                                         (4.0, 50_000), (1.0, 0)]
        for pol in ("lcmp", "ecmp")]
    assert {(s.topology, s.seed, s.load, s.duration_us) for s in stale} == {
        ("staleness:deg_ms=60", 1, 0.5, 300_000)}


def test_quickstart_calls_pass_the_device():
    cmds = quickstart.commands("/ck", "cpu")
    assert [c[2] for c in cmds] == ["repro_torch.launch.train",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.serve"]
    for c in cmds:
        assert c[c.index("--device") + 1] == "cpu"
    first, resume, serve = cmds
    assert first[first.index("--steps") + 1] == "30"
    assert first[first.index("--ckpt-every") + 1] == "10"
    assert resume[resume.index("--steps") + 1] == "40" and "--resume" in resume
    assert serve[serve.index("--gen") + 1] == "16"


@pytest.mark.parametrize("example", [routing_sim, multipod, quickstart],
                         ids=lambda m: m.__name__)
def test_examples_need_a_card_unless_asked(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
