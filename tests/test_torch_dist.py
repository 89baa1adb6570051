"""Port parity of the dist layer: the int8 wire (``kernels.ref`` qsr
plain versions, ``dist.compress``) and the LCMP-scheduled pod reduce
(``dist.lcmp_collectives``), held against the JAX package.

The 2-pod reference runs under ``shard_map`` in a subprocess that sets
``XLA_FLAGS`` before importing jax (as tests/test_dist.py does); the
port runs the same numpy inputs with its pods on one CPU device.

On quantization: the port's plain quantizer equals the reference's
``qsr_int8_ref`` (run eagerly) bit for bit, both divisions being IEEE
divisions. Under ``jit`` (the interpret-mode Pallas kernel, and the
reference's pod reduce) XLA rewrites ``amax / 127.0`` into
``amax * (1/127)``, which differs in the last bit on a few percent of
blocks; q then differs by one step on about 1e-5 of elements. So
against jitted reference code the tests hold the reference's own
contract: |dq| <= 1 on < 1e-4 of elements, scales within rtol 1e-6.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.dist import compress as pcomp
from repro_torch.dist import lcmp_collectives as plc
from repro_torch.kernels import ops, ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jref():
    import jax
    import jax.numpy as jnp

    from repro.dist import compress as rcomp
    from repro.dist import lcmp_collectives as rlc
    from repro.kernels import ops as rops
    from repro.kernels import ref as rref
    return types.SimpleNamespace(jax=jax, jnp=jnp, comp=rcomp, lc=rlc,
                                 ops=rops, ref=rref)


@pytest.fixture
def telemetry(jref):
    """Fresh route telemetry on both sides."""
    for t in (jref.lc._TELEMETRY, plc._TELEMETRY):
        t.reset()
    yield jref.lc._TELEMETRY, plc._TELEMETRY
    for t in (jref.lc._TELEMETRY, plc._TELEMETRY):
        t.reset()


def _qsr_inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 100.0], n)).astype(np.float32)
    bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return x, bits


def _bits_t(bits):
    return torch.from_numpy(bits.view(np.int32).copy())


# ---------------------------------------------------------------- qsr plain
@pytest.mark.parametrize("n", [1024, 4096, 1 << 16])
def test_qsr_plain_matches_reference(jref, n):
    x, bits = _qsr_inputs(n, n)
    x[:1024] = 0.0                               # a zero block
    qr, sr = jref.ref.qsr_int8_ref(jref.jnp.asarray(x), jref.jnp.asarray(bits))
    qk, sk = jref.ops.qsr_int8(jref.jnp.asarray(x), jref.jnp.asarray(bits))
    q, s = ops.qsr_int8(torch.from_numpy(x), _bits_t(bits))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    # bit-exact against the eager oracle
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    # the reference's contract against its interpret-mode Pallas kernel
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(qk, np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() < 1e-4
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)
    assert (q.numpy()[:1024] == 0).all() and s[0] == 0
    x_back = ops.qsr_dequant(q, s)
    np.testing.assert_array_equal(
        x_back.numpy(), np.asarray(jref.ref.qsr_dequant_ref(qr, sr)))
    step = np.repeat(s.numpy(), 1024)
    assert (np.abs(x_back.numpy() - x) <= step + 1e-7).all()


def test_qsr_plain_takes_int32_and_int64_bits():
    x, bits = _qsr_inputs(4096, 1)
    a = ref.qsr_int8_ref(torch.from_numpy(x), _bits_t(bits))
    b = ref.qsr_int8_ref(torch.from_numpy(x), torch.from_numpy(bits.astype(np.int64)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_qsr_zero_block_and_unbiasedness():
    n = 2048
    x = torch.zeros(n)
    x[1024:] = 0.3
    acc = torch.zeros(n, dtype=torch.float64)
    for s in range(64):
        q, sc = ops.qsr_int8(x, pcomp.rand_bits(n, s, device="cpu"))
        acc += ops.qsr_dequant(q, sc).double()
    acc /= 64
    assert (acc[:1024] == 0).all()
    np.testing.assert_allclose(acc[1024:].numpy(), 0.3, atol=2e-3)


def test_qsr_rejects_ragged_lengths():
    with pytest.raises(ValueError, match="multiple of 1024"):
        ops.qsr_int8(torch.zeros(1000), torch.zeros(1000, dtype=torch.int32))


def test_qsr_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        ops.qsr_int8(torch.zeros(1024, device="meta"),
                     torch.zeros(1024, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.qsr_dequant(torch.zeros(1024, dtype=torch.int8, device="meta"),
                        torch.zeros(1, device="meta"))


# ------------------------------------------------------------------ compress
@pytest.mark.parametrize("n,seed,salt", [(1, 0, 0), (5000, 3, 1),
                                         (4096, 1364076727, 0),
                                         (777, 0xFFFFFFFF, 7),
                                         ((1 << 24) + 5, 3, 1)])
def test_rand_bits_bit_exact(jref, n, seed, salt):
    want = np.asarray(jref.comp.rand_bits(n, np.uint32(seed), salt))
    got = pcomp.rand_bits(n, seed, salt, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n", [1500, 4096, 5000])
def test_encode_decode_match_reference(jref, n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    rw = jref.comp.encode(jref.jnp.asarray(x), seed=5, salt=1)
    pw = pcomp.encode(torch.from_numpy(x), seed=5, salt=1)
    assert pw.orig_len == rw.orig_len == n
    assert pw.q.shape[0] == pcomp.padded_len(n) == rw.q.shape[0]
    dq = np.abs(pw.q.numpy().astype(np.int32) - np.asarray(rw.q, np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() < 1e-4
    np.testing.assert_allclose(pw.scales.numpy(), np.asarray(rw.scales), rtol=1e-6)
    assert pcomp.wire_bytes(pw) == jref.comp.wire_bytes(rw)
    assert pcomp.wire_bytes(pw) < 0.3 * 4 * n or n < 4096
    y = pcomp.decode(pw)
    assert y.shape == (n,)
    step = np.repeat(pw.scales.numpy(), 1024)[:n]
    np.testing.assert_allclose(y.numpy(), np.asarray(jref.comp.decode(rw)),
                               rtol=0, atol=float(step.max()) + 1e-7)
    assert (np.abs(y.numpy() - x) <= step + 1e-7).all()


def test_encode_ef_matches_reference(jref):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1500).astype(np.float32)
    r0 = (rng.standard_normal(1500) * 1e-2).astype(np.float32)
    rw, rres = jref.comp.encode_ef(jref.jnp.asarray(x), jref.jnp.asarray(r0), seed=5)
    pw, pres = pcomp.encode_ef(torch.from_numpy(x), torch.from_numpy(r0), seed=5)
    np.testing.assert_allclose((pcomp.decode(pw) + pres).numpy(), x + r0, atol=1e-6)
    step = float(pw.scales.max())
    np.testing.assert_allclose(pres.numpy(), np.asarray(rres), atol=step + 1e-7)


# ------------------------------------------------------- routes, telemetry
def test_route_constants_match(jref):
    for name in ("NUM_ROUTES", "ALPHA", "BETA", "BUCKET_ELEMS"):
        assert getattr(plc, name) == getattr(jref.lc, name), name
    for name in ("ROUTE_PROP_US", "ROUTE_CAP_GBPS", "C_PATH"):
        np.testing.assert_array_equal(getattr(plc, name), getattr(jref.lc, name))
    x = np.random.default_rng(0).integers(0, 1 << 32, 1000, dtype=np.uint64)
    x = x.astype(np.uint32)
    np.testing.assert_array_equal(plc._fmix32_host(x), jref.lc._fmix32_host(x))


def test_schedule_buckets_bit_exact_and_dead_routes(jref, telemetry):
    ids = jref.lc._fmix32_host(np.arange(64, dtype=np.uint32))
    np.testing.assert_array_equal(plc.schedule_buckets(ids),
                                  jref.lc.schedule_buckets(ids))
    alive = np.ones(plc.NUM_ROUTES, bool)
    alive[plc.schedule_buckets(ids)[0]] = False
    for mod in (plc, jref.lc):
        mod.set_route_liveness(alive)
    got = plc.schedule_buckets(ids)
    np.testing.assert_array_equal(got, jref.lc.schedule_buckets(ids))
    assert not set(got.tolist()) & set(np.nonzero(~alive)[0].tolist())
    for mod in (plc, jref.lc):
        mod.set_route_liveness(np.zeros(plc.NUM_ROUTES, bool))
    assert (plc.schedule_buckets(ids) == -1).all()
    with pytest.raises(ValueError):
        plc.set_route_liveness(np.ones(2, bool))


def _same_registers(a, b):
    for f in ("cur", "trend", "dur", "alive", "route_bytes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.last_step == b.last_step


def test_telemetry_observe_and_cong_scores_bit_exact(jref, telemetry):
    r, p = telemetry
    rng = np.random.default_rng(0)
    for step in range(40):
        ms = rng.integers(0, 1200, 3) if step % 5 else [50, 900, 50]
        r.observe(ms, step)
        p.observe(ms, step)
        _same_registers(r, p)
        np.testing.assert_array_equal(p.cong_scores(), r.cong_scores())
    ids = jref.lc._fmix32_host(np.arange(256, dtype=np.uint32))
    np.testing.assert_array_equal(plc.schedule_buckets(ids),
                                  jref.lc.schedule_buckets(ids))


def test_telemetry_observe_measured_bit_exact(jref, telemetry, monkeypatch):
    monkeypatch.setattr(jref.lc, "C_PATH", np.zeros_like(jref.lc.C_PATH))
    monkeypatch.setattr(plc, "C_PATH", np.zeros_like(plc.C_PATH))
    r, p = telemetry
    ids = jref.lc._fmix32_host(np.arange(64, dtype=np.uint32))
    for step in range(12):
        args = (np.array([50, 900, 50, 880, 7], np.int64),
                np.array([0, 1, 2, 1, -1], np.int64), step)
        r.observe_measured(*args)
        p.observe_measured(*args)
        _same_registers(r, p)
        np.testing.assert_array_equal(plc.schedule_buckets(ids),
                                      jref.lc.schedule_buckets(ids))
    assert 1 not in set(plc.schedule_buckets(ids).tolist())
    with pytest.raises(ValueError):
        p.observe_measured(np.array([1, 2]), np.array([0]), step=13)


# ---------------------------------------------------------------- pod reduce
_REF_REDUCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import jax
import jax.numpy as jnp
import repro
from jax import shard_map
from jax.sharding import PartitionSpec as P
from repro.dist import lcmp_collectives as lc

data = np.load(sys.argv[1])
mesh = jax.make_mesh((2,), ("pod",))
out = {}
for case in ("tree", "big"):
    if case == "tree":
        tree = {"b": data["b"], "a": {"w": data["w"], "s": data["s"]}}
    else:
        tree = {"g": data["g"]}
    for compress in (False, True):
        f = shard_map(lambda t: lc.lcmp_pod_reduce(t, "pod", compress=compress),
                      mesh=mesh, in_specs=P("pod"), out_specs=P("pod"),
                      check_vma=False)
        lc._TELEMETRY.reset()
        res = jax.jit(f)(jax.tree.map(jnp.asarray, tree))
        tag = f"{case}/{int(compress)}"
        for path, leaf in jax.tree_util.tree_flatten_with_path(res)[0]:
            key = "/".join(str(k.key) for k in path)
            out[f"{tag}/{key}"] = np.asarray(leaf)
        out[f"{tag}/route_bytes"] = lc._TELEMETRY.route_bytes.copy()
np.savez(sys.argv[2], **out)
"""


def _reduce_inputs():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 300, 300)) * rng.choice([1e-3, 1.0, 10.0],
                                                         (2, 300, 300))
    return {"b": rng.standard_normal((2, 70_000)).astype(np.float32),
            "w": w.astype(np.float32),
            "s": rng.standard_normal((2, 7)).astype(np.float32),
            "g": rng.standard_normal((2, 3 * 65_536 + 123)).astype(np.float32)}


def _case_tree(data, case):
    if case == "tree":
        return {"b": data["b"], "a": {"w": data["w"], "s": data["s"]}}
    return {"g": data["g"]}


@pytest.fixture(scope="module")
def ref_reduce(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod_reduce")
    data = _reduce_inputs()
    np.savez(d / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, "-c", _REF_REDUCE, str(d / "in.npz"),
                        str(d / "out.npz")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return data, dict(np.load(d / "out.npz"))


def _port_reduce(data, case, compress):
    plc._TELEMETRY.reset()
    tree = {k: torch.from_numpy(v) for k, v in data.items()}
    out = plc.lcmp_pod_reduce(_case_tree(tree, case), plc.PodAxis("pod", 2),
                              compress=compress)
    leaves = {}
    for key, leaf in (("b", out.get("b")), ("a/w", out.get("a", {}).get("w")),
                      ("a/s", out.get("a", {}).get("s")), ("g", out.get("g"))):
        if leaf is not None:
            leaves[key] = leaf.numpy()
    return leaves, plc._TELEMETRY.route_bytes.copy()


@pytest.mark.parametrize("case", ["tree", "big"])
def test_pod_reduce_f32_matches_reference(ref_reduce, case):
    data, want = ref_reduce
    got, route_bytes = _port_reduce(data, case, compress=False)
    for key, leaf in got.items():
        ref_leaf = want[f"{case}/0/{key}"]
        assert leaf.shape == ref_leaf.shape
        np.testing.assert_allclose(leaf, ref_leaf, rtol=1e-6, atol=0)
        src = data[key.split("/")[-1]]
        np.testing.assert_allclose(leaf[0], src.mean(0), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(route_bytes, want[f"{case}/0/route_bytes"])


@pytest.mark.parametrize("case", ["tree", "big"])
def test_pod_reduce_int8_matches_reference(ref_reduce, case):
    """Every element within one final-leg quantization step of the
    reference; all but < 1e-4 of elements equal up to the last bit of
    their block's scale (the jitted reference's amax * (1/127))."""
    data, want = ref_reduce
    got, route_bytes = _port_reduce(data, case, compress=True)
    flat_src = np.concatenate([data[k.split("/")[-1]].reshape(2, -1)
                               for k in sorted(got)], 1)
    scale = float(np.abs(flat_src).max()) / 127
    n_diff = n_all = 0
    for key, leaf in got.items():
        ref_leaf = want[f"{case}/1/{key}"]
        assert leaf.shape == ref_leaf.shape
        d = np.abs(leaf - ref_leaf)
        assert d.max() <= scale * 1.0001
        n_diff += int((d > 2e-6 * np.abs(ref_leaf) + 1e-30).sum())
        n_all += d.size
        exact = data[key.split("/")[-1]].mean(0)
        assert np.abs(leaf[0] - exact).max() <= 2.1 * scale
    assert n_diff < 1e-4 * n_all, (n_diff, n_all)
    np.testing.assert_array_equal(route_bytes, want[f"{case}/1/route_bytes"])
    assert plc._TELEMETRY.bucket_routes.shape == (-(-flat_src.shape[1] // plc.BUCKET_ELEMS),)


def test_pod_reduce_route_bytes_per_call_and_wire_ratio():
    data = _reduce_inputs()
    total = data["g"].shape[1]
    ids, routes = plc.bucket_binding(total)
    plc._TELEMETRY.reset()
    tree = {"g": torch.from_numpy(data["g"])}
    ax = plc.PodAxis("pod", 2)
    plc.lcmp_pod_reduce(tree, ax, compress=True)
    one = plc._TELEMETRY.route_bytes.copy()
    plc.lcmp_pod_reduce(tree, ax, compress=True)      # eager: counted per call
    np.testing.assert_array_equal(plc._TELEMETRY.route_bytes, 2 * one)
    want = np.zeros(plc.NUM_ROUTES, np.int64)
    for b, r in enumerate(routes):                    # the reference's loop
        blen = min((b + 1) * plc.BUCKET_ELEMS, total) - b * plc.BUCKET_ELEMS
        want[r] += blen + 4 * (-(-blen // 1024))
    np.testing.assert_array_equal(one, want)
    assert one.sum() <= 0.26 * 4 * total
    plc._TELEMETRY.reset()


def test_pod_reduce_noop_without_axis():
    tree = {"a": torch.arange(8.0), "b": torch.ones((3, 5))}
    assert plc.lcmp_pod_reduce(tree, None) is tree
    assert plc.lcmp_pod_reduce(tree, plc.PodAxis("pod", 1), compress=True) is tree
    with pytest.raises(ValueError):
        plc.PodAxis("pod", 0)
    with pytest.raises(ValueError, match="leading pod dimension"):
        plc.lcmp_pod_reduce({"a": torch.zeros(3, 4)}, plc.PodAxis("pod", 2))


def test_tree_flatten_order_matches_jax(jref):
    tree = {"z": np.zeros(1), "a": {"y": np.zeros(2), "b": [np.zeros(3), np.zeros(4)]},
            "m": (np.zeros(5),)}
    want = [leaf.shape for leaf in jref.jax.tree.leaves(tree)]
    leaves, rebuild = plc.tree_flatten(tree)
    assert [leaf.shape for leaf in leaves] == want
    back = rebuild([np.ones(s) for s in want])
    assert back["a"]["b"][1].shape == (4,) and isinstance(back["m"], tuple)
    assert json.dumps(sorted(back)) == json.dumps(sorted(tree))
