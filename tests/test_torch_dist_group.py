"""The port's pod reduce across processes: ``dist.lcmp_collectives`` over
a ``PodGroup`` (one pod on each rank of a Gloo process group) against
the one-process ``PodAxis`` path on the same per-pod vectors, bit for
bit, over 2 and 4 CPU ranks (a group of 4, and a subgroup of its first
2); the route accounting and dead routes; and the pod-group train step
against the ``PodAxis`` step.

The ``PodAxis`` path is itself held against the reference's
``shard_map`` reduce by tests/test_torch_dist.py, so this is also the
cross-process half of tests/test_dist.py's pod-reduce contract. The
module spawns its 4 ranks once; every rank and the oracle run one
intra-op thread.
"""
import numpy as np
import pytest
import torch

import torch_group_workers as w
from repro_torch.dist import lcmp_collectives as lc
from repro_torch.kernels.qsr_int8 import BLOCK
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    made = w.GlooPool(4)
    yield made
    made.close()


def _ranks(results, n):
    """The results of the group's n ranks (the others return None)."""
    assert all(r is None for r in results[n:])
    return results[:n]


def _oracle(n, m, compress, seed, alive=None):
    lc._TELEMETRY.reset()
    if alive is not None:
        lc.set_route_liveness(alive)
    out = lc.pod_reduce_flat(torch.from_numpy(w.pod_rows(n, m, seed)),
                             lc.PodAxis("pod", n), compress)
    res = out.numpy(), lc._TELEMETRY.route_bytes.copy()
    lc._TELEMETRY.reset()
    return res


# the int8 legs align when m splits into n chunks of whole scale blocks
ALIGNED = {2: 2 * 3 * BLOCK * 64, 4: 4 * 3 * BLOCK * 16}
UNALIGNED = 3 * lc.BUCKET_ELEMS + 123


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("compress", [False, True], ids=["lcmp", "lcmp_int8"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_pod_reduce_flat_equals_pod_axis(pool, n, compress, aligned):
    m = ALIGNED[n] if aligned else UNALIGNED
    want, want_bytes = _oracle(n, m, compress, seed=n + 10 * compress)
    got = _ranks(pool.run(w.reduce_flat, n, m, compress, n + 10 * compress),
                 n)
    ids, routes = lc.bucket_binding(m)
    for out, route_bytes, bucket_routes, legs in got:
        assert out.shape == (m,) and out.dtype == np.float32
        assert np.array_equal(out.view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(route_bytes, want_bytes)
        np.testing.assert_array_equal(bucket_routes, routes)
        assert legs == ["all_gather", "all_to_all"]
    if compress:
        assert want_bytes.sum() <= 0.26 * 4 * m
    else:
        assert want_bytes.sum() == 4 * m


def test_dead_routes_as_on_the_pod_axis(pool):
    """A dead route gets no bucket and no byte on any rank, as on the
    one-device axis, and the mean is unchanged."""
    alive = np.array([True, False, True])
    m = UNALIGNED
    want, want_bytes = _oracle(2, m, True, seed=5, alive=alive)
    assert want_bytes[1] == 0 and want_bytes.sum() > 0
    for out, route_bytes, bucket_routes, _ in _ranks(pool.run(
            w.reduce_flat, 2, m, True, 5, alive), 2):
        assert np.array_equal(out.view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(route_bytes, want_bytes)
        assert 1 not in set(bucket_routes.tolist())
    none = np.zeros(3, bool)                     # no live route at all
    want, want_bytes = _oracle(2, m, True, seed=5, alive=none)
    assert want_bytes.sum() == 0
    for out, route_bytes, bucket_routes, _ in _ranks(pool.run(
            w.reduce_flat, 2, m, True, 5, none), 2):
        assert np.array_equal(out.view(np.int32), want.view(np.int32))
        assert route_bytes.sum() == 0 and (bucket_routes == -1).all()


@pytest.mark.parametrize("compress", [False, True], ids=["lcmp", "lcmp_int8"])
def test_lcmp_pod_reduce_of_unstacked_leaves(pool, compress):
    rows = w.pod_rows(4, 70_000 + 300 * 300 + 7, 9)
    stacked = {"b": torch.from_numpy(rows[:, :70_000].copy()),
               "a": {"w": torch.from_numpy(
                         rows[:, 70_000:160_000].reshape(4, 300, 300).copy()),
                     "s": torch.from_numpy(rows[:, 160_000:].copy())}}
    want = lc.lcmp_pod_reduce(stacked, lc.PodAxis("pod", 4), compress)
    lc._TELEMETRY.reset()
    for got in pool.run(w.reduce_tree, 9, compress):
        for key, leaf in (("b", want["b"]), ("w", want["a"]["w"]),
                          ("s", want["a"]["s"])):
            assert got[key].shape == tuple(leaf.shape[1:])
            assert np.array_equal(got[key], leaf[0].numpy())


def test_pod_reduce_flat_shape_checks():
    with pytest.raises(ValueError, match=r"\(n, M\)"):
        lc.pod_reduce_flat(torch.zeros(3, 8), lc.PodAxis("pod", 2))
    with pytest.raises(ValueError, match="rank's own"):
        lc.pod_reduce_flat(torch.zeros(2, 8), lc.PodGroup())


@pytest.mark.parametrize("mode", ["lcmp_int8", "lcmp", "psum"])
def test_pod_group_step_equals_pod_axis_step(pool, mode):
    """Two ranks, each one pod of a 4-row qwen3 smoke batch: every
    rank's parameters, moments, losses, norm and reduced gradient equal
    the one-device PodAxis step's, bit for bit."""
    from repro_torch import configs
    from repro_torch.data.synth import batch_at
    cfg = configs.get("qwen3_4b", smoke=True)
    params, opt = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, TrainConfig(pod_reduce=mode,
                                            pod_axis=lc.PodAxis("pod", 2)))
    params, opt, m = step(params, opt, batch_at(cfg, 0, batch=4, seq=32,
                                                device="cpu"))
    lc._TELEMETRY.reset()
    want = w.numpy_state(params, opt)
    for state, loss, gnorm, reduced, grads_shape in _ranks(pool.run(
            w.pod_group_step, 2, mode, 4, 32), 2):
        assert grads_shape == (1, step.grads.shape[1])
        assert np.array_equal(loss, m["loss"].numpy())
        assert np.array_equal(gnorm, m["grad_norm"].numpy())
        assert np.array_equal(reduced, step.reduced.numpy())
        assert len(state) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(state, want))
