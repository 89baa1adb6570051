"""Port parity of ``train.checkpoint`` and ``launch.train``: the
reference's tests/test_checkpoint.py contracts on the port (interrupted
saves ignored, the none cases, the round trip, launcher resume with the
optimizer's count), checkpoints written by either package restoring bit
for bit in the other with the same leaf names and files, and the SIGTERM
emergency checkpoint. All on the CPU at qwen3 smoke size.
"""
import dataclasses
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro import configs
from repro.train import checkpoint as rckpt
from repro.train import step as rstep
from repro_torch import configs as pconfigs
from repro_torch.dist.lcmp_collectives import tree_flatten
from repro_torch.launch import train as ptrain
from repro_torch.models import carry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import init_train_state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    suite runs several workers on the host's cores: one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    params, opt = init_train_state(pconfigs.get("qwen3_4b", smoke=True), seed,
                                   device="cpu")
    return {"params": params, "opt": opt}


def _same(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
        for x, y in zip(la, lb))


# ------------------------------------------ tests/test_checkpoint.py's
def test_latest_ignores_interrupted_tmp_dirs(tmp_path):
    d = str(tmp_path)
    path = ckpt.save(d, 7, {"w": torch.arange(6.0).reshape(2, 3)})
    stale = tmp_path / "step-00000009.tmp-0"
    stale.mkdir()
    (stale / "MANIFEST.json").write_text("{}")
    (tmp_path / "step-garbage").mkdir()
    (tmp_path / "step-00000012").mkdir()          # no MANIFEST: incomplete
    assert ckpt.latest(d) == (7, path)


def test_latest_none_cases(tmp_path):
    assert ckpt.latest(str(tmp_path / "missing")) is None
    assert ckpt.latest(str(tmp_path)) is None


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(8.0), "b": {"c": torch.ones((3,), dtype=torch.int32)},
            "l": [torch.zeros(2), torch.ones(())]}
    path = ckpt.save(str(tmp_path), 3, tree)
    assert sorted(os.listdir(path)) == ["MANIFEST.json", "shard-0.npz"]
    out = ckpt.restore(path, tree)
    assert _same(out, tree)
    state = _state()
    path = ckpt.save(str(tmp_path), 4, state)
    like = _state(seed=1)
    out = ckpt.restore(path, like)
    assert _same(out, state)
    assert isinstance(out["opt"], type(state["opt"]))
    for p in tree_flatten(out["params"])[0]:
        assert p.requires_grad and p.is_leaf
    assert not out["opt"].mu["embed"].requires_grad
    with pytest.raises(ValueError, match="both mesh and specs"):
        ckpt.restore(path, like, mesh=object())
    # specs go to the manifest in the reference's string form
    specs = {"a": ("data",), "b": {"c": (None,)}, "l": [(None,), ()]}
    path = ckpt.save(str(tmp_path), 5, tree, specs=specs)
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["specs"] == {"['a']": "PartitionSpec('data',)",
                                 "['b']/['c']": "PartitionSpec(None,)",
                                 "['l']/[0]": "PartitionSpec(None,)",
                                 "['l']/[1]": "PartitionSpec()"}
    assert _same(ckpt.restore(path, tree), tree)


# -------------------------------------------------------- across packages
@pytest.fixture(scope="module")
def ref_state():
    rcfg = configs.get("qwen3_4b", smoke=True)
    params, opt = rstep.init_train_state(rcfg, jax.random.key(3))
    mu = jax.tree.map(lambda p: p * 0.5 + 1.0, params)     # nonzero moments
    return {"params": params, "opt": opt._replace(count=opt.count + 5, mu=mu)}


def test_reference_checkpoint_restores_in_the_port(tmp_path, ref_state):
    path = rckpt.save(str(tmp_path), 5, ref_state)
    like = _state()
    assert ckpt.leaf_names(like) == [n for n, _ in rckpt._flat(ref_state)[0]]
    out = ckpt.restore(path, like)
    want = carry.to_numpy({"params": carry.params_from_reference(
        jax.tree.map(np.asarray, ref_state["params"]), device="cpu")})
    got = carry.to_numpy({"params": out["params"]})
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for name in ("mu", "nu"):
        want = jax.tree.leaves(getattr(ref_state["opt"], name))
        got = tree_flatten(getattr(out["opt"], name))[0]
        assert all(np.array_equal(g.numpy(), np.asarray(w))
                   for g, w in zip(got, want))
    assert out["opt"].count.dtype == torch.int32 and int(out["opt"].count) == 5


def test_port_checkpoint_restores_in_the_reference(tmp_path, ref_state):
    state = _state(seed=2)
    state["opt"] = state["opt"]._replace(count=torch.tensor(9, dtype=torch.int32))
    path = ckpt.save(str(tmp_path / "port"), 9, state)
    out = rckpt.restore(path, ref_state)
    got = jax.tree.leaves(out)
    want = tree_flatten(state)[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.detach().numpy()
        assert np.asarray(g).dtype == w.dtype and np.array_equal(np.asarray(g), w)
    # the same tree saved by both packages: the same files and manifest
    rpath = rckpt.save(str(tmp_path / "ref"), 9, out)
    assert sorted(os.listdir(rpath)) == sorted(os.listdir(path))
    with open(os.path.join(path, "MANIFEST.json")) as f, \
            open(os.path.join(rpath, "MANIFEST.json")) as g:
        assert json.load(f) == json.load(g)
    a, b = (np.load(os.path.join(p, "shard-0.npz")) for p in (path, rpath))
    assert a.files == b.files
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


# ------------------------------------------------------------- launcher
COMMON = ["--arch", "qwen3_4b", "--smoke", "--batch", "2", "--seq", "16",
          "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]


def test_train_resume_restores_params_and_opt(tmp_path, capsys):
    d = str(tmp_path / "ck")
    first = ptrain.main(COMMON + ["--ckpt", d, "--steps", "2"])
    found = ckpt.latest(d)
    assert found and found[0] == 2
    saved = ckpt.restore(found[1], _state())
    assert int(saved["opt"].count) == 2
    assert _same(saved, {"params": first.params, "opt": first.opt})
    capsys.readouterr()
    resumed = ptrain.main(COMMON + ["--ckpt", d, "--steps", "4", "--resume"])
    out = capsys.readouterr().out
    assert f"[resume] step 2 from {found[1]}" in out
    assert "step 3: loss=" in out and "gnorm=" in out and out.endswith("done\n")
    found2 = ckpt.latest(d)
    assert found2 and found2[0] == 4
    assert int(ckpt.restore(found2[1], _state())["opt"].count) == 4
    # the resumed run continues the uninterrupted one
    whole = ptrain.main(COMMON + ["--ckpt", str(tmp_path / "whole"),
                                  "--steps", "4"])
    assert [r["step"] for r in resumed.log] == [3, 4]
    np.testing.assert_allclose([r["loss"] for r in resumed.log],
                               [r["loss"] for r in whole.log[2:]], rtol=1e-5)


def test_train_resume_of_a_mamba_run(tmp_path, capsys):
    """falcon-mamba at smoke size through the launcher's CLI on the CPU:
    a 2-step run resumed to 3 restores its state bit for bit and gives
    the uninterrupted run's step-3 loss."""
    common = ["--arch", "falcon_mamba_7b", "--smoke", "--batch", "2",
              "--seq", "16", "--ckpt-every", "2", "--log-every", "1",
              "--device", "cpu"]
    d = str(tmp_path / "ck")
    first = ptrain.main(common + ["--ckpt", d, "--steps", "2"])
    cfg = pconfigs.get("falcon_mamba_7b", smoke=True)
    params, opt = init_train_state(cfg, 1, device="cpu")
    saved = ckpt.restore(ckpt.latest(d)[1], {"params": params, "opt": opt})
    assert _same(saved, {"params": first.params, "opt": first.opt})
    capsys.readouterr()
    resumed = ptrain.main(common + ["--ckpt", d, "--steps", "3", "--resume"])
    assert "[resume] step 2 from" in capsys.readouterr().out
    whole = ptrain.main(common + ["--steps", "3"])
    assert [r["step"] for r in resumed.log] == [3]
    np.testing.assert_allclose(resumed.log[0]["loss"], whole.log[2]["loss"],
                               rtol=1e-5)


def test_train_refuses_a_mesh():
    """A mesh runs under torchrun: without a process group of data x
    model ranks, --data/--model > 1 raises."""
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        ptrain.main(COMMON + ["--data", "2"])


@pytest.mark.parametrize("inside_step", [False, True])
def test_sigterm_leaves_an_emergency_checkpoint(tmp_path, monkeypatch, capsys,
                                                inside_step):
    """SIGTERM while step 3's batch is made saves step 2 at once; SIGTERM
    inside step 3 (the port updates parameters in place) saves step 3
    when it returns. Either way the run exits with code 1, and the
    handler it replaced is back."""
    d = str(tmp_path / "ck")
    if inside_step:
        make = ptrain.make_train_step

        def make_step(cfg, tcfg):
            step = make(cfg, tcfg)

            def run(params, opt, batch):
                if int(opt.count) == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return step(params, opt, batch)
            return run
        monkeypatch.setattr(ptrain, "make_train_step", make_step)
    else:
        real = ptrain.batch_at

        def batch_at(cfg, step, **kw):
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return real(cfg, step, **kw)
        monkeypatch.setattr(ptrain, "batch_at", batch_at)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as e:
        ptrain.main(COMMON + ["--ckpt", d, "--steps", "6", "--ckpt-every", "10"])
    assert e.value.code == 1
    assert signal.getsignal(signal.SIGTERM) is before
    at = 3 if inside_step else 2
    assert f"[sigterm] emergency checkpoint at step {at}" in capsys.readouterr().out
    found = ckpt.latest(d)
    assert found and found[0] == at
    assert int(ckpt.restore(found[1], _state())["opt"].count) == at


def test_train_telemetry_skips_the_first_block(monkeypatch):
    """The route registers see the per-step wall time of every log block
    but the first, as the reference's launcher feeds them."""
    from repro_torch.dist import lcmp_collectives as lc
    seen = []
    monkeypatch.setattr(lc._TELEMETRY, "observe",
                        lambda ms, step: seen.append((ms.copy(), step)))
    cfg = dataclasses.replace(pconfigs.get("qwen3_4b", smoke=True), n_layers=1)
    run = ptrain.train(cfg, steps=5, batch=1, seq=8, log_every=2, device="cpu")
    assert [r["step"] for r in run.log] == [1, 2, 4]
    assert [s for _, s in seen] == [1, 3]
    for (ms, _), r in zip(seen, run.log[1:]):
        assert ms.shape == (lc.NUM_ROUTES,) and ms.dtype.kind == "i"
        assert (ms == int(r["seconds"] * 1e3 / r["steps"])).all()
