"""Port parity of ``dist.mesh_rules`` (the FSDP x TP rules) and
``launch.mesh``: for all ten configurations at full width, the port's
parameter and cache specs (trees built under ``FakeTensorMode``) equal
the reference's ``PartitionSpec`` trees (built over ``jax.eval_shape``)
leaf for leaf on three meshes, {data 2, model 4}, {data 16, model 16}
and {pod 2, data 16, model 16}; every sharded dim divides; the layer
axis is never sharded; the DTensor placements and the checkpoint
manifest strings follow. The counterpart of tests/test_dist_unit.py's
mesh-rule contracts. The production meshes are built on a fake process
group of 512 ranks.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as rconfigs
from repro.dist import mesh_rules as rrules
from repro.models.arch import init_params as rinit
from repro.serve.decode import init_cache as rcache
from repro_torch import configs
from repro_torch.dist import mesh_rules as mr
from repro_torch.models.arch import init_params
from repro_torch.serve.decode import init_cache

MESHES = {"d2m4": {"data": 2, "model": 4},
          "d16m16": {"data": 16, "model": 16},
          "p2d16m16": {"pod": 2, "data": 16, "model": 16}}
CACHE_SHAPES = [(128, 32_768), (2, 64)]      # decode_32k; a batch of 2


def _ref_leaves(tree, specs):
    """{path: (shape, tuple(spec))} of a reference tree and its specs."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    sl = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    return {tuple(str(k.key) for k in path): (tuple(leaf.shape), tuple(spec))
            for (path, leaf), spec in zip(leaves, sl)}


def _port_leaves(tree, specs):
    out = {}
    mr.map_with_path(tree, lambda path, leaf: out.__setitem__(
        path, tuple(leaf.shape)))
    spec_of = {}
    mr.map_with_path(tree, lambda path, leaf: spec_of.__setitem__(path, None))
    for path in spec_of:
        node = specs
        for k in path:
            node = node[k]
        spec_of[path] = node
    return {path: (shape, spec_of[path]) for path, shape in out.items()}


@pytest.fixture(scope="module")
def trees():
    """Every configuration's parameter tree and caches, both packages,
    without storage."""
    out = {}
    with FakeTensorMode():
        for arch in configs.ARCH_IDS:
            cfg = configs.get(arch)
            out[arch] = {"params": init_params(cfg, 0, device="cpu")}
            for b, s in CACHE_SHAPES:
                out[arch][(b, s)] = init_cache(cfg, b, s, device="cpu")
    ref = {}
    for arch in configs.ARCH_IDS:
        rcfg = rconfigs.get(arch)
        ref[arch] = {"params": jax.eval_shape(
            lambda: rinit(rcfg, jax.random.key(0)))}
        for b, s in CACHE_SHAPES:
            ref[arch][(b, s)] = jax.eval_shape(
                lambda: rcache(rcfg, b, s))
    return out, ref


def _check_divides(leaves, axes):
    for path, (shape, spec) in leaves.items():
        assert len(spec) == len(shape), path
        named = [a for e in spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))]
        assert len(set(named)) == len(named), path      # no axis used twice
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            size = 1
            for a in entry if isinstance(entry, tuple) else (entry,):
                size *= axes[a]
            assert shape[dim] % size == 0, (path, shape, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_reference(trees, arch, mesh):
    port, ref = trees
    axes = MESHES[mesh]
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    rtree = ref[arch]["params"]
    want = _ref_leaves(rtree, rrules.Rules(rcfg, axes).param_specs(rtree))
    ptree = port[arch]["params"]
    got = _port_leaves(ptree, mr.Rules(cfg, axes).param_specs(ptree))
    assert got == want
    _check_divides(got, axes)
    for path, (shape, spec) in got.items():
        if path[0] in ("layers", "enc_layers"):
            assert spec[0] is None, path                # layer axis
        assert mr.spec_string(spec) == str(P(*spec))    # manifest form
    if cfg.family in ("dense", "moe", "vlm") and axes["model"] > 1:
        attn = mr.Rules(cfg, axes).param_specs(ptree)["layers"]["attn"]
        assert attn["wq"][-1] == "model" and attn["wo"][-2] == "model"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_equal_reference(trees, arch, mesh):
    port, ref = trees
    axes = MESHES[mesh]
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    for shape in CACHE_SHAPES:
        rtree = ref[arch][shape]
        want = _ref_leaves(rtree, rrules.Rules(rcfg, axes).cache_specs(rtree))
        ptree = port[arch][shape]
        got = _port_leaves(ptree, mr.Rules(cfg, axes).cache_specs(ptree))
        assert got == want
        _check_divides(got, axes)


def test_batch_specs_and_manifest_strings():
    cfg = configs.get("qwen3_4b", smoke=True)
    r2 = mr.Rules(cfg, {"pod": 2, "data": 2, "model": 1})
    assert r2.train_batch_specs(8, 32)["tokens"] == (("pod", "data"), None)
    assert r2.train_batch_specs(6, 32)["tokens"] == (None, None)
    assert r2.decode_token_spec(8) == (("pod", "data"), None)
    for spec in [(), ("data",), (None, "model"), (("pod", "data"), None),
                 ("data", None, "model")]:
        assert mr.spec_string(spec) == str(P(*spec))


@pytest.fixture(scope="module")
def fake_group():
    """A fake 512-rank process group (no communication), torn down after
    the module so that no later test sees a default group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    yield
    dist.destroy_process_group()


def test_meshes_and_placements(fake_group):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as lmesh
    cfg = configs.get("qwen3_4b")
    single = lmesh.make_production_mesh(device_type="cpu")
    multi = lmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert single.device_type == multi.device_type == "cpu"
    assert mr.axis_sizes_of(single) == {"data": 16, "model": 16}
    assert mr.axis_sizes_of(multi) == {"pod": 2, "data": 16, "model": 16}
    assert mr.make_rules(cfg, multi).axis_sizes == mr.axis_sizes_of(multi)
    assert mr.placements(("data", "model"), single) == [Shard(0), Shard(1)]
    assert mr.placements((None, "data"), single) == [Shard(1), Replicate()]
    assert mr.placements((), single) == [Replicate(), Replicate()]
    assert mr.placements((("pod", "data"), None), multi) == \
        [Shard(0), Shard(0), Replicate()]
    assert mr.placements(("model", None, "data"), multi) == \
        [Replicate(), Shard(2), Shard(0)]
    with pytest.raises(ValueError, match="does not have"):
        mr.placements((("pod", "data"), None), single)
    with pytest.raises(ValueError, match="world size 512"):
        lmesh.make_host_mesh(2, 2, device_type="cpu")
    if not torch.cuda.is_available():       # the card by default, or raise
        for make in (lmesh.make_production_mesh,
                     lambda: lmesh.make_host_mesh(16, 32)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    # each leaf of qwen3-4b on the multi-pod mesh: a DTensor's local shard
    # is its global numel over the mesh sizes of its sharded dims
    with FakeTensorMode():
        params = init_params(cfg, 0, device="cpu")
    specs = mr.Rules(cfg, mr.axis_sizes_of(multi)).param_specs(params)
    sizes = mr.axis_sizes_of(multi)
    for path, (shape, spec) in _port_leaves(params, specs).items():
        pl = mr.placements(spec, multi)
        split = 1
        for name, p in zip(multi.mesh_dim_names, pl):
            if p.is_shard():
                assert shape[p.dim] % sizes[name] == 0
                split *= sizes[name]
        want = 1
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)) if e else ():
                want *= sizes[a]
        assert split == want, path
