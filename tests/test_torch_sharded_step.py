"""The port's FSDP x TP train step on a ``DeviceMesh`` over 4 Gloo CPU
ranks (``train.step.ShardedStep``), its elastic checkpoints and the
launcher's mesh, against the port's one-device step and the reference's
checkpoint reader.

The contracts are tests/test_dist.py's (which fails in the reference
under jax 0.9, ROADMAP.md queue C): on a 2 x 2 (data, model) mesh the
loss is within rtol 2e-3 and every parameter within 5e-3 of the
one-device step's; each rank holds only its shards; a checkpoint saved
on (data 2, model 2) restores on (data 4, model 1) bit for bit, and
loads in the reference's ``checkpoint.restore`` without a mesh. A first
AdamW step moves a parameter by about its learning rate (3e-6 in warm-up)
whatever the gradient, so the step is also held by its moments (``mu``
and ``nu`` follow the gradient's direction and size leaf by leaf) and by
the parameters' update against the one-device update. Then
``launch.train`` with ``--data 2 --model 2`` resumes the sharded step's
checkpoint in the same group and runs two steps in two microbatches,
printing the one-device run's lines and ending in its state, and a mesh
that does not match the world size raises. The same holds for one step
of the ssm, hybrid, sliding-window and moe families through the dry
run's train cell, leaf by leaf, and one decode step of a dense and a
hybrid model through its decode cell writes the caches the one-device
step writes. The group is spawned once for the module.
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_group_workers as w
from repro import configs as rconfigs
from repro.dist.mesh_rules import Rules as RRules
from repro.train import checkpoint as rckpt
from repro.train import step as rstep
from repro_torch import configs
from repro_torch.data.synth import batch_at
from repro_torch.dist.lcmp_collectives import tree_flatten
from repro_torch.dist.mesh_rules import Rules, map_with_path
from repro_torch.launch import train as ltrain
from repro_torch.train.step import init_train_state, make_train_step

WORLD = 4
LAUNCH = ["--arch", "qwen3_4b", "--smoke", "--seq", "32", "--log-every", "1",
          "--device", "cpu"]
# Relative L2 gaps between the 2 x 2 step and the one-device step,
# measured on these inputs (bf16 activations summed in other orders):
# mu 0.013, nu 0.014, the parameters' update 0.14 (Adam's first update is
# about lr times the gradient's sign, so elements whose gradient is near
# 0 may flip). A step that updates nothing, flips the gradient's sign or
# applies gradient shards to the wrong parameter shards is 1 or more off.
MOMENT_GAP = 0.05
UPDATE_GAP = 0.3


def rel_gap(got: list, want: list) -> float:
    """||got - want|| / ||want|| over lists of arrays, in float64."""
    num = sum(float(np.square(a.astype(np.float64) - b).sum())
              for a, b in zip(got, want))
    den = sum(float(np.square(b.astype(np.float64)).sum()) for b in want)
    return float(np.sqrt(num / den))


def assert_state_close(got: list, want: list, before: list) -> None:
    """``got`` and ``want`` (parameters, mu, nu, whole, in leaf order),
    reached from the parameters ``before``: every parameter within 5e-3,
    the moments and the update (parameters less ``before``) within their
    measured gaps."""
    n = len(before)
    assert len(got) == len(want) == 3 * n
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert max(float(np.abs(a - b).max())
               for a, b in zip(got[:n], want[:n])) < 5e-3
    assert rel_gap(got[n:2 * n], want[n:2 * n]) < MOMENT_GAP
    assert rel_gap(got[2 * n:], want[2 * n:]) < MOMENT_GAP
    assert rel_gap([a - p for a, p in zip(got[:n], before)],
                   [b - p for b, p in zip(want[:n], before)]) < UPDATE_GAP


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    made = w.GlooPool(WORLD)
    yield made
    made.close()


@pytest.fixture(scope="module")
def sharded(pool, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded_ckpt"))
    return pool.run(w.sharded_step, 2, 2, d)


@pytest.fixture(scope="module")
def one_device():
    """The one-device step's parameters before it, its state after it
    (whole arrays, as ``numpy_state``) and its metrics."""
    cfg = configs.get("qwen3_4b", smoke=True)
    params, opt = init_train_state(cfg, 0, device="cpu")
    before = [x.detach().numpy().copy() for x in tree_flatten(params)[0]]
    params, opt, m = make_train_step(cfg)(params, opt, batch_at(
        cfg, 0, batch=4, seq=32, device="cpu"))
    return before, w.numpy_state(params, opt), m


def test_sharded_step_matches_one_device(sharded, one_device):
    before, want, m = one_device
    for r in sharded:                       # every rank saw the same scalars
        assert r["loss"] == sharded[0]["loss"]
        assert r["grad_norm"] == sharded[0]["grad_norm"]
    np.testing.assert_allclose(sharded[0]["loss"], float(m["loss"]), rtol=2e-3)
    np.testing.assert_allclose(sharded[0]["grad_norm"], float(m["grad_norm"]),
                               rtol=2e-3)
    got = sharded[0]["whole"]
    assert_state_close(got, want, before)
    n = len(before)
    assert any(not np.array_equal(a, b)     # a real other summation order
               for a, b in zip(got[n:2 * n], want[n:2 * n]))


def test_off_device_tensors_raise(sharded):
    """Placing, or restoring into, tensors of another device type than
    the mesh's raises instead of moving them."""
    for r in sharded:
        for what in ("place", "restore"):
            assert "lies on meta, the mesh on cpu" in r["refused"][what]


def leaf_specs(axes: dict) -> list:
    """Each qwen3 smoke parameter's spec on a mesh of ``axes``, in leaf
    order."""
    cfg = configs.get("qwen3_4b", smoke=True)
    rules, out = Rules(cfg, axes), []
    map_with_path(init_train_state(cfg, 0, device="cpu")[0],
                  lambda path, leaf: out.append(
                      rules._leaf_spec(path, tuple(leaf.shape))))
    return out


def test_each_rank_holds_only_its_shards(sharded):
    axes = {"data": 2, "model": 2}
    per_leaf = leaf_specs(axes)
    sharded_dims = 0
    for r in sharded:
        assert len(r["shards"]) == len(per_leaf)
        for (local, whole, _), spec in zip(r["shards"], per_leaf):
            split = 1
            for entry in spec:
                if entry is not None:
                    split *= axes[entry]
            assert local * split == whole
            sharded_dims += split > 1
    assert sharded_dims > 0


def test_elastic_restore_on_another_mesh(sharded):
    for a, b in zip(sharded[0]["whole"], sharded[0]["restored"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sharded[0]["count"] == 1
    per_leaf = leaf_specs({"data": 4, "model": 1})
    for r in sharded:                       # (data 4, model 1)
        for (local, pl), (_, whole, _), spec in zip(
                r["back_shards"], r["shards"], per_leaf):
            assert local * (4 if "data" in spec else 1) == whole
            assert "model" not in spec and pl.endswith("Replicate())")


def test_sharded_checkpoint_restores_in_the_reference(sharded):
    path = sharded[0]["path"]
    rcfg = rconfigs.get("qwen3_4b", smoke=True)
    params, opt = jax.eval_shape(
        lambda: rstep.init_train_state(rcfg, jax.random.key(1)))
    got = rckpt.restore(path, {"params": params, "opt": opt})
    leaves = [np.asarray(x) for t in (got["params"], got["opt"].mu,
                                      got["opt"].nu)
              for x in jax.tree.leaves(t)]
    for a, b in zip(leaves, sharded[0]["whole"]):
        assert np.array_equal(a, b)
    assert int(got["opt"].count) == 1
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    pspecs = RRules(rcfg, {"data": 2, "model": 2}).param_specs(params)
    want = {"/".join(str(k) for k in p): str(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                {"params": pspecs,
                 "opt": type(opt)(count=P(), mu=pspecs, nu=pspecs)},
                is_leaf=lambda s: isinstance(s, P))[0]}
    assert manifest["specs"] == want


def test_launcher_on_a_mesh(pool, sharded, tmp_path, capsys):
    """``--data 2 --model 2`` over the 4 ranks, resumed from the sharded
    step's checkpoint (step 1), runs steps 2 and 3 in two microbatches of
    the step's 4 x 32 shape; rank 0 prints the lines of the one-device
    run resumed from the same checkpoint (losses within rtol 2e-3), the
    other ranks print nothing, both runs end in the same state within
    the step's gaps, and the mesh's checkpoint holds the specs."""
    runs = {}
    for kind in ("mesh", "one"):
        runs[kind] = str(tmp_path / kind)
        shutil.copytree(sharded[0]["path"],
                        os.path.join(runs[kind], "step-00000001"))
    args = LAUNCH + ["--steps", "3", "--batch", "8", "--microbatches", "2",
                     "--resume", "--ckpt-every", "3"]
    out = pool.run(w.launch, args + ["--data", "2", "--model", "2",
                                     "--ckpt", runs["mesh"]])
    assert all(err is None for _, err, _, _ in out), [e for _, e, _, _ in out]
    text = out[0][0].splitlines()
    assert text[0] == (f"[resume] step 1 from "
                       f"{os.path.join(runs['mesh'], 'step-00000001')}")
    assert [t.split(":")[0] for t in text[1:]] == ["step 2", "step 3", "done"]
    assert all(t[0] == "" for t in out[1:])
    one = ltrain.main(args + ["--ckpt", runs["one"]])
    capsys.readouterr()
    np.testing.assert_allclose(out[0][2], [r["loss"] for r in one.log],
                               rtol=2e-3)
    n = len(tree_flatten(one.params)[0])
    assert_state_close(out[0][3], w.numpy_state(one.params, one.opt),
                       sharded[0]["whole"][:n])
    with open(os.path.join(runs["mesh"], "step-00000003",
                           "MANIFEST.json")) as f:
        specs = json.load(f)["specs"]
    assert specs["['params']/['layers']/['attn']/['wq']"] == \
        "PartitionSpec(None, 'data', 'model')"


def test_launcher_refuses_a_mesh_of_another_size(pool):
    out = pool.run(w.launch, LAUNCH + ["--data", "2", "--model", "1"])
    for _, err, _, _ in out:
        assert err is not None and err.startswith("ValueError")
        assert "WORLD_SIZE = 2" in err and "got 4" in err



def leaf_gaps(got: list, want: list, before: list) -> tuple:
    """Each leaf's relative L2 gap of two states as ``assert_state_close``
    takes them: the largest over ``mu`` and ``nu``, and the largest over
    the update."""
    n = len(before)
    return (max(rel_gap([a], [b]) for a, b in zip(got[n:], want[n:])),
            max(rel_gap([a - p], [b - p])
                for a, b, p in zip(got[:n], want[:n], before)))


# The model's code under DTensor beyond the dense step: the mamba-1 scan
# and its causal conv (falcon-mamba), the SSD core and the shared
# attention block (zamba2), the sliding-window blocks (gemma2 at 96
# tokens, past twice its window of 32) and the moe dispatch (mixtral),
# run on local shards with their gradients placed back where the rules
# replicate an input. Each family's step runs through the dry run's
# train cell on the 2 x 2 mesh against the one-device step, in float32
# activations (``f32_smoke``). Besides the dense step's contract, every
# leaf's moments must be within LEAF_MOMENT_GAP and its update within
# LEAF_UPDATE_GAP (measured, leaf by leaf: moments at most 5.7e-6,
# updates at most 2.7e-3, from a few elements whose gradient is near
# 0): a gradient leaf that misses a shard's part is far outside both,
# even where the whole state's gap hides it.
LEAF_MOMENT_GAP = 1e-4
LEAF_UPDATE_GAP = 1e-2


@pytest.mark.parametrize("arch,seq", [("falcon_mamba_7b", 32),
                                      ("zamba2_1p2b", 32),
                                      ("gemma2_9b", 96),
                                      ("mixtral_8x7b", 32)])
def test_family_step_matches_one_device(pool, arch, seq):
    cfg = w.f32_smoke(arch)
    params, opt = init_train_state(cfg, 0, device="cpu")
    before = [x.detach().numpy().copy() for x in tree_flatten(params)[0]]
    params, opt, m = make_train_step(cfg)(params, opt, batch_at(
        cfg, 0, batch=4, seq=seq, device="cpu"))
    got = pool.run(w.family_step, arch, 2, 2, 4, seq)
    assert np.isfinite(float(m["loss"]))
    for r in got:
        assert r["loss"] == got[0]["loss"]
    np.testing.assert_allclose(got[0]["loss"], float(m["loss"]), rtol=2e-3)
    np.testing.assert_allclose(got[0]["grad_norm"], float(m["grad_norm"]),
                               rtol=2e-3)
    want = w.numpy_state(params, opt)
    assert_state_close(got[0]["whole"], want, before)
    moments, update = leaf_gaps(got[0]["whole"], want, before)
    assert moments < LEAF_MOMENT_GAP and update < LEAF_UPDATE_GAP


# Decode on the mesh writes the caches on local shards at ``pos``: every
# element the one-device step leaves as it was must come back bit for
# bit, and what it writes (the new key and value rows, the mamba states)
# within DECODE_GAP in relative L2, as must the logits (measured in
# float32: at most 5.3e-7).
DECODE_GAP = 1e-5


@pytest.mark.parametrize("arch", ["qwen3_4b", "zamba2_1p2b"])
def test_decode_step_matches_one_device(pool, arch):
    from repro_torch.models.arch import init_params
    from repro_torch.serve.decode import decode_step
    cfg = w.f32_smoke(arch)
    ins = w.decode_inputs(cfg, 4, 64, 3)
    before = [x.numpy().copy() for x in tree_flatten(ins["cache"])[0]]
    logits, cache = decode_step(init_params(cfg, 0, device="cpu"), cfg,
                                ins["cache"], ins["tokens"], ins["pos"])
    want = [logits.numpy()] + [x.numpy() for x in tree_flatten(cache)[0]]
    got = pool.run(w.sharded_decode, arch, 2, 2, 4, 64, 3)[0]
    assert len(got) == len(want)
    gaps = [rel_gap(got[:1], want[:1])]
    for g, x, b in zip(got[1:], want[1:], before):
        assert g.shape == x.shape
        kept = x == b
        assert np.array_equal(g[kept], b[kept])
        assert (~kept).any()
        gaps.append(rel_gap([g[~kept]], [x[~kept]]))
    assert max(gaps) < DECODE_GAP
