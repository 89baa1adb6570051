"""Port parity of the training stack: ``models.layers``/``arch``,
``train.optim``, ``train.step`` (the multi-pod LCMP train step),
``data.synth`` and ``models.carry``, held against the JAX package at the
qwen3 smoke size on carried weights.

The 2-pod reference step runs under ``shard_map`` over a 2-device host
mesh in a subprocess that sets ``XLA_FLAGS`` before importing jax; the
port runs its pods in turn on the CPU. Tolerances, with their reasons:

* forward, float32 activations: atol 1e-4 on logits of magnitude ~2
  (matmul and reduction order differ between XLA and PyTorch; measured
  ~2e-6);
* forward, bfloat16 activations: atol 5e-2 (both round every matmul
  output and activation to bf16's 8-bit mantissa, at different places;
  measured ~2e-2);
* one train step, float32 activations: losses and grad_norm rtol 1e-5,
  mu (= 0.1 g) atol 1e-7. Parameters: AdamW's first update is
  lr_1 * g / (|g| + eps) with lr_1 = 3e-6, so two runs differ by at
  most 2 * lr_1 = 6e-6 per element whatever their gradients, and where
  |g| is near eps = 1e-8 float32 rounding of g is amplified up to that
  bound; so every element within 6e-6, and all but < 1e-4 of them
  within 2e-7 plus one rounding of |p| (measured: one element of 98k
  beyond). With the int8 wire a gradient element may land one
  quantization step from the reference's (see test_torch_dist.py):
  grad_norm rtol 1e-4 and mu atol 2e-5 (0.1 of a step).
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as pconfigs
from repro_torch.data.synth import batch_at
from repro_torch.dist.lcmp_collectives import PodAxis, tree_flatten
from repro_torch.dist import lcmp_collectives as plc
from repro_torch.models import arch as parch
from repro_torch.models import carry
from repro_torch.models import layers as players
from repro_torch.train import optim as poptim
from repro_torch.train.step import (TrainConfig, init_train_state, loss_fn,
                                    make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ARCHS = ["zamba2_1p2b", "gemma2_9b", "glm4_9b", "mistral_nemo_12b",
             "qwen3_4b", "internvl2_2b", "falcon_mamba_7b", "mixtral_8x7b",
             "dbrx_132b", "whisper_medium"]


@pytest.fixture(scope="module")
def jref():
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models import arch, layers
    from repro.train import optim, step
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs, arch=arch,
                                 layers=layers, optim=optim, step=step)


def _port_cfg(rcfg):
    return parch.ArchConfig(**dataclasses.asdict(rcfg))


def _smoke(jref, act_dtype):
    return dataclasses.replace(jref.configs.get("qwen3_4b", smoke=True),
                               act_dtype=act_dtype)


def _numpy_tree(jref, tree):
    return jref.jax.tree.map(np.asarray, tree)


def _max_diff(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        return max(_max_diff(a[k], b[k]) for k in a)
    assert a.shape == b.shape
    return float(np.abs(a - b).max())


def _leaves(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        return [pair for k in sorted(a) for pair in _leaves(a[k], b[k])]
    assert a.shape == b.shape
    return [(a, b)]


def _assert_close(a, b, atol, rtol=2e-7):
    """Leaf by leaf; rtol 2e-7 allows one float32 rounding of |x|."""
    for x, y in _leaves(a, b):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


# After one AdamW step the update is lr_1 * g / (|g| + eps) (first step,
# bias-corrected), so parameters of two runs differ by at most
# 2 * lr_1 * B_1 = 6e-6 whatever their gradients (B_1 = 1 bounds the
# normalized update), and where |g| is near eps = 1e-8 float32 rounding
# of g is amplified up to that bound.
ADAM_BOUND_1 = 6e-6


def _assert_params_after_one_step(a, b):
    """Every element within the AdamW bound; all but < 1e-4 of them
    within one float32 rounding of the update (2e-7) and of |p|."""
    far = total = 0
    for x, y in _leaves(a, b):
        d = np.abs(x - y)
        assert (d <= ADAM_BOUND_1 + 2e-7 * np.abs(y)).all()
        far += int((d > 2e-7 + 2e-7 * np.abs(y)).sum())
        total += d.size
    assert far < 1e-4 * total, (far, total)


def _batch(vocab, B=4, S=32, seed=0):
    tokens = np.random.default_rng(seed).integers(0, vocab, (B, S))
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -1
    return tokens, labels


# ------------------------------------------------------------------- config
def test_port_config_equals_reference(jref):
    for smoke in (False, True):
        want = dataclasses.asdict(jref.configs.get("qwen3_4b", smoke=smoke))
        assert dataclasses.asdict(pconfigs.get("qwen3-4b", smoke=smoke)) == want
        want = dataclasses.asdict(jref.configs.get("falcon_mamba_7b",
                                                   smoke=smoke))
        assert dataclasses.asdict(pconfigs.get("falcon-mamba-7b",
                                               smoke=smoke)) == want
    assert pconfigs.ARCH_IDS == jref.configs.ARCH_IDS


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_param_count_from_shapes_matches_reference(jref, arch):
    """Every config counts as the reference does, in total and active
    per token (moe: top_k of n_experts experts)."""
    for smoke in (False, True):
        rcfg = jref.configs.get(arch, smoke=smoke)
        pcfg = _port_cfg(rcfg)
        assert pcfg.param_count() == rcfg.param_count()
        assert pcfg.active_param_count() == rcfg.active_param_count()


def test_param_tree_and_flat_order_match_jax(jref):
    rcfg = _smoke(jref, "float32")
    rp = jref.arch.init_params(rcfg, jref.jax.random.key(0))
    pp = parch.init_params(_port_cfg(rcfg), 0, device="cpu")
    rflat = jref.jax.tree_util.tree_flatten_with_path(rp)[0]
    want = ["/".join(k.key for k in path) for path, _ in rflat]
    leaves, _ = tree_flatten(pp)
    paths = []

    def walk(t, pre):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], pre + k + "/")
            else:
                paths.append(pre + k)
    walk(pp, "")
    assert paths == want
    for (_, rl), pl in zip(rflat, leaves):
        assert tuple(pl.shape) == rl.shape and pl.dtype == torch.float32
        assert pl.requires_grad
    # same init scheme: zero norms, unit-normal embed, 1/sqrt(fan_in) matrices
    pp = carry.to_numpy(pp)
    assert float(np.abs(pp["final_ln"]).max()) == 0.0
    assert abs(float(pp["embed"].std()) - 1.0) < 0.05
    wq = pp["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(wq.shape[1]) - 1.0) < 0.05


def test_other_families_raise(jref):
    """The ssm, hybrid, encdec and vlm families run (their configs,
    parameters, forward and batches); what the reference cannot run
    still raises: a family it does not know, a vlm or encdec forward
    without its patch or frame embeddings, a mamba scan over a sequence
    that is not a whole number of chunks."""
    for arch in ("falcon_mamba_7b", "zamba2_1p2b", "whisper_medium",
                 "internvl2_2b"):
        cfg = _port_cfg(jref.configs.get(arch, smoke=True))
        assert dataclasses.asdict(pconfigs.get(arch, smoke=True)) \
            == dataclasses.asdict(cfg)
        params = parch.init_params(cfg, device="cpu")
        b = batch_at(cfg, 0, batch=1, seq=4, device="cpu")
        assert ("extra" in b) == (cfg.family in ("vlm", "encdec"))
        with torch.no_grad():
            logits = parch.forward(params, cfg, b["tokens"], extra=b.get("extra"))
        assert logits.shape == (1, 4, cfg.vocab)
        if "extra" in b:
            with pytest.raises(ValueError, match="extra inputs"):
                parch.forward(params, cfg, b["tokens"])
        if cfg.family in ("ssm", "hybrid"):
            with pytest.raises(ValueError, match="multiple of the scan chunk"):
                parch.forward(params, cfg, torch.zeros((1, 130), dtype=torch.long))
    odd = dataclasses.replace(_port_cfg(_smoke(jref, "float32")), family="rnn")
    for call in (odd.param_count, lambda: parch.forward({}, odd, None)):
        with pytest.raises(ValueError, match="rnn"):
            call()


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("act_dtype,atol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_forward_matches_reference(jref, act_dtype, atol):
    rcfg = _smoke(jref, act_dtype)
    rp = jref.arch.init_params(rcfg, jref.jax.random.key(1))
    tokens, labels = _batch(rcfg.vocab, B=2, S=16)
    want = np.asarray(jref.jax.jit(lambda p, t: jref.arch.forward(p, rcfg, t))(
        rp, jref.jnp.asarray(tokens, jref.jnp.int32)))
    pp = carry.params_from_reference(_numpy_tree(jref, rp), device="cpu")
    with torch.no_grad():
        got = parch.forward(pp, _port_cfg(rcfg), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    if act_dtype == "float32":
        rl = float(jref.step.loss_fn(rp, rcfg, jref.jnp.asarray(tokens),
                                     jref.jnp.asarray(labels)))
        with torch.no_grad():
            pl = float(loss_fn(pp, _port_cfg(rcfg), torch.from_numpy(tokens),
                               torch.from_numpy(labels)))
        np.testing.assert_allclose(pl, rl, rtol=1e-5)


def test_layers_match_reference(jref):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    jnp = jref.jnp
    want = np.asarray(jref.layers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v)))
    got = players.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    pos = np.arange(9)[None]
    np.testing.assert_allclose(
        players.rope(torch.from_numpy(q), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jref.layers.rope(jnp.asarray(q), jnp.asarray(pos), 1e6)),
        atol=1e-5)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        players.rms_norm(torch.from_numpy(q), torch.from_numpy(scale)).numpy(),
        np.asarray(jref.layers.rms_norm(jnp.asarray(q), jnp.asarray(scale))),
        atol=1e-5)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.2
         for s in ((16, 32), (16, 32), (32, 16))]
    np.testing.assert_allclose(
        players.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w)).numpy(),
        np.asarray(jref.layers.swiglu(jnp.asarray(x), *map(jnp.asarray, w))),
        atol=1e-5)


# -------------------------------------------------------------------- optim
def test_schedule_matches_reference(jref):
    cfg_r, cfg_p = jref.optim.AdamWConfig(), poptim.AdamWConfig()
    assert dataclasses.asdict(cfg_r) == dataclasses.asdict(cfg_p)
    for step in (0, 1, 3, 50, 100, 101, 5000, 9999, 10_000, 20_000):
        want = float(jref.optim._schedule(cfg_r, jref.jnp.float32(step)))
        got = float(poptim._schedule(cfg_p, torch.tensor(float(step))))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])     # unclipped, clipped
def test_adamw_update_matches_reference(jref, grad_scale):
    rng = np.random.default_rng(4)
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    params = {"a": mk((7, 5)), "b": {"c": mk((11,)), "d": mk((3, 2, 4))}}
    cfg_r = jref.optim.AdamWConfig(warmup_steps=2)
    cfg_p = poptim.AdamWConfig(warmup_steps=2)
    rp = jref.jax.tree.map(jref.jnp.asarray, params)
    ro = jref.optim.adamw_init(rp)
    pp = carry.params_from_reference(params, device="cpu")
    po = poptim.adamw_init(pp)
    for _ in range(3):
        g = {"a": mk((7, 5)) * grad_scale,
             "b": {"c": mk((11,)) * grad_scale, "d": mk((3, 2, 4)) * grad_scale}}
        rp, ro, rgn = jref.optim.adamw_update(
            cfg_r, rp, jref.jax.tree.map(jref.jnp.asarray, g), ro)
        gt = {"a": torch.from_numpy(g["a"]),
              "b": {k: torch.from_numpy(v) for k, v in g["b"].items()}}
        pp, po, pgn = poptim.adamw_update(cfg_p, pp, gt, po)
        np.testing.assert_allclose(float(pgn), float(rgn), rtol=1e-6)
        assert int(po.count) == int(ro.count)
        assert _max_diff(carry.to_numpy(pp), _numpy_tree(jref, rp)) < 1e-6
        assert _max_diff(carry.to_numpy(po.mu), _numpy_tree(jref, ro.mu)) < 1e-6
        assert _max_diff(carry.to_numpy(po.nu), _numpy_tree(jref, ro.nu)) < 1e-6
    gc, gn = poptim.clip_by_global_norm(
        {"x": torch.full((4,), 3.0)}, 1.0)
    np.testing.assert_allclose(float(gn), 6.0)
    np.testing.assert_allclose(gc["x"].numpy(), 0.5, rtol=1e-6)


# --------------------------------------------------------------- train step
_REF_STEP = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import jax
import jax.numpy as jnp
import repro
from jax import shard_map
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.dist import lcmp_collectives as lc
from repro.train.step import TrainConfig, init_train_state, make_train_step

cfg = dataclasses.replace(configs.get("qwen3_4b", smoke=True), act_dtype="float32")
params, opt = init_train_state(cfg, jax.random.key(0))
data = np.load(sys.argv[1])
batch = dict(tokens=jnp.asarray(data["tokens"], jnp.int32),
             labels=jnp.asarray(data["labels"], jnp.int32))
out = {}
def put(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
put(params, "init/")
mesh = jax.make_mesh((2,), ("pod",))
for mode, mb in (("psum", 1), ("lcmp", 1), ("lcmp_int8", 1), ("lcmp", 2)):
    step = make_train_step(cfg, TrainConfig(pod_reduce=mode, pod_axis="pod",
                                            microbatches=mb))
    def f(p, o, b):
        p2, o2, m = step(p, o, b)
        return p2, o2, m["loss"][None], m["grad_norm"]
    g = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(), P(), P("pod")),
                          out_specs=(P(), P(), P("pod"), P()), check_vma=False))
    lc._TELEMETRY.reset()
    p2, o2, loss, gn = g(params, opt, batch)
    tag = f"{mode}{mb}/"
    put(p2, tag + "params/")
    put(o2.mu, tag + "mu/")
    out[tag + "loss"] = np.asarray(loss)
    out[tag + "grad_norm"] = np.asarray(gn)
    out[tag + "route_bytes"] = lc._TELEMETRY.route_bytes.copy()
np.savez(sys.argv[2], **out)
"""


def _unflatten(d, prefix):
    tree = {}
    for key, val in d.items():
        if key.startswith(prefix):
            *parents, leaf = key[len(prefix):].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val
    return tree


@pytest.fixture(scope="module")
def ref_steps(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_step")
    tokens, labels = _batch(512)
    np.savez(d / "in.npz", tokens=tokens, labels=labels)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, "-c", _REF_STEP, str(d / "in.npz"),
                        str(d / "out.npz")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return (tokens, labels), dict(np.load(d / "out.npz"))


# mode, microbatches, grad_norm rtol, mu atol (module docstring)
STEP_CASES = [("psum", 1, 1e-5, 1e-7), ("lcmp", 1, 1e-5, 1e-7),
              ("lcmp_int8", 1, 1e-4, 2e-5), ("lcmp", 2, 1e-5, 1e-7)]


@pytest.mark.parametrize("mode,mb,gn_rtol,mu_atol", STEP_CASES)
def test_train_step_matches_reference(jref, ref_steps, mode, mb, gn_rtol,
                                      mu_atol):
    (tokens, labels), want = ref_steps
    cfg = _port_cfg(_smoke(jref, "float32"))
    params = carry.params_from_reference(_unflatten(want, "init/"), device="cpu")
    opt = poptim.adamw_init(params)
    step = make_train_step(cfg, TrainConfig(pod_reduce=mode, microbatches=mb,
                                            pod_axis=PodAxis("pod", 2)))
    plc._TELEMETRY.reset()
    batch = dict(tokens=torch.from_numpy(tokens), labels=torch.from_numpy(labels))
    params, opt, m = step(params, opt, batch)
    tag = f"{mode}{mb}/"
    assert m["loss"].shape == (2,)
    np.testing.assert_allclose(m["loss"].numpy(), want[tag + "loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(want[tag + "grad_norm"]),
                               rtol=gn_rtol)
    _assert_params_after_one_step(carry.to_numpy(params),
                                  _unflatten(want, tag + "params/"))
    _assert_close(carry.to_numpy(opt.mu), _unflatten(want, tag + "mu/"), mu_atol)
    assert int(opt.count) == 1
    np.testing.assert_array_equal(plc._TELEMETRY.route_bytes, want[tag + "route_bytes"])
    # the step's own record: every pod's flat gradient and the reduced one
    M = cfg.param_count()
    assert step.grads.shape == (2, M) and step.reduced.shape == (M,)
    exact = step.grads.mean(0)
    scale = float(step.grads.abs().max()) / 127
    tol = 2.1 * scale if mode == "lcmp_int8" else 1e-6 * float(exact.abs().max())
    assert float((step.reduced - exact).abs().max()) <= tol
    assert step.split_ms() == {}                   # no CUDA events on the CPU
    plc._TELEMETRY.reset()


def test_train_step_without_pod_axis_matches_reference(jref):
    rcfg = _smoke(jref, "float32")
    rp, ro = jref.step.init_train_state(rcfg, jref.jax.random.key(2))
    tokens, labels = _batch(rcfg.vocab, B=2, S=16, seed=5)
    rbatch = dict(tokens=jref.jnp.asarray(tokens, jref.jnp.int32),
                  labels=jref.jnp.asarray(labels, jref.jnp.int32))
    rp2, _, rm = jref.jax.jit(jref.step.make_train_step(rcfg))(rp, ro, rbatch)
    pp = carry.params_from_reference(_numpy_tree(jref, rp), device="cpu")
    step = make_train_step(_port_cfg(rcfg))
    pp, po, pm = step(pp, poptim.adamw_init(pp),
                      dict(tokens=torch.from_numpy(tokens),
                           labels=torch.from_numpy(labels)))
    assert pm["loss"].shape == ()
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-5)
    _assert_params_after_one_step(carry.to_numpy(pp), _numpy_tree(jref, rp2))


def test_train_step_rejects_bad_configs():
    cfg = pconfigs.get("qwen3_4b", smoke=True)
    with pytest.raises(ValueError, match="pod_reduce"):
        make_train_step(cfg, TrainConfig(pod_reduce="allreduce"))
    params, opt = init_train_state(cfg, device="cpu")
    step = make_train_step(cfg, TrainConfig(pod_axis=PodAxis("pod", 2),
                                            microbatches=2))
    b = batch_at(cfg, 0, batch=2, seq=8, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        step(params, opt, b)


def test_smoke_steps_lower_the_loss_with_int8_wire():
    """A few port steps on the CPU, 2 pods over the int8 wire: finite,
    and the loss on a repeated batch goes down."""
    cfg = dataclasses.replace(pconfigs.get("qwen3_4b", smoke=True),
                              act_dtype="float32")
    params, opt = init_train_state(cfg, 3, device="cpu")
    step = make_train_step(cfg, TrainConfig(
        pod_reduce="lcmp_int8", pod_axis=PodAxis("pod", 2),
        optim=poptim.AdamWConfig(lr=3e-3, warmup_steps=1)))
    batch = batch_at(cfg, 0, batch=4, seq=16, device="cpu")
    losses = []
    for _ in range(4):
        params, opt, m = step(params, opt, batch)
        assert torch.isfinite(m["loss"]).all() and torch.isfinite(m["grad_norm"])
        losses.append(float(m["loss"].mean()))
    assert losses[-1] < losses[0]
    plc._TELEMETRY.reset()


# --------------------------------------------------------------- data, carry
def test_batch_at_is_a_pure_function_of_seed_step_host():
    cfg = pconfigs.get("qwen3_4b", smoke=True)
    a = batch_at(cfg, 3, batch=2, seq=8, seed=1, device="cpu")
    b = batch_at(cfg, 3, batch=2, seq=8, seed=1, device="cpu")
    c = batch_at(cfg, 4, batch=2, seq=8, seed=1, device="cpu")
    d = batch_at(cfg, 3, batch=2, seq=8, seed=1, host=1, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert a["tokens"].dtype == torch.int64
    assert ((a["tokens"] >= 0) & (a["tokens"] < cfg.vocab)).all()
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == -1).all()


def test_carry_round_trip(jref):
    rcfg = _smoke(jref, "float32")
    rp, ro = jref.step.init_train_state(rcfg, jref.jax.random.key(0))
    rp = _numpy_tree(jref, rp)
    pp = carry.params_from_reference(rp, device="cpu")
    assert _max_diff(carry.to_numpy(pp), rp) == 0.0
    po = carry.opt_from_reference(3, _numpy_tree(jref, ro.mu),
                                  _numpy_tree(jref, ro.nu), device="cpu")
    assert int(po.count) == 3 and po.count.dtype == torch.int32
    assert not tree_flatten(po.mu)[0][0].requires_grad


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pconfigs.get("qwen3_4b", smoke=True)
    for call in (lambda: init_train_state(cfg),
                 lambda: batch_at(cfg, 0, batch=1, seq=4),
                 lambda: parch.init_params(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ------------------------------------------- chip_smoke.py's train checks
def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def _broken_wire(fault, reduce_int8):
    """The int8 reduce with one fault planted in its result."""
    def reduce(seg, n, seed):
        out = reduce_int8(seg, n, seed)
        if fault == "roll":                 # blocks misplaced by one
            return torch.roll(out, 1024)
        if fault == "scale":                # one block in 7 scaled 2x
            out = out.clone()
            out[:out.numel() // 1024 * 1024].view(-1, 1024)[::7] *= 2
            return out
        if fault == "pod":                  # pod 1 dropped
            return seg[0].clone()
        return out
    return reduce


@pytest.fixture(scope="module")
def third_step_state():
    """Smoke-size 2-pod state after two int8 steps, and the parameters
    one f32-wire step takes it to: chip_smoke.py's train phase in small."""
    cfg = pconfigs.get("qwen3_4b", smoke=True)
    ax = PodAxis("pod", 2)
    params, opt = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, TrainConfig(pod_reduce="lcmp_int8", pod_axis=ax))
    for k in range(2):
        params, opt, _ = step(params, opt, batch_at(cfg, k, batch=2, seq=64,
                                                    device="cpu"))
    saved = [[x.detach().clone() for x in tree_flatten(t)[0]]
             for t in (params, opt.mu, opt.nu)]
    f32 = make_train_step(cfg, TrainConfig(pod_reduce="lcmp", pod_axis=ax))
    p32, _, _ = f32(params, opt, batch_at(cfg, 2, batch=2, seq=64, device="cpu"))
    p32 = [x.detach().clone() for x in tree_flatten(p32)[0]]
    plc._TELEMETRY.reset()
    return cfg, ax, saved, p32


@pytest.mark.parametrize("fault", ["none", "roll", "scale", "pod"])
def test_chip_smoke_train_checks_catch_a_broken_wire(third_step_state,
                                                     monkeypatch, fault):
    """The int8 wire as it is passes both checks of chip_smoke.py's train
    phase (the per-block error bound, and the share of parameters beyond
    rounding against the f32 wire's after one step from the same state);
    a wire with a fault planted fails both."""
    cs = _chip_smoke()
    cfg, ax, saved, p32 = third_step_state
    monkeypatch.setattr(plc, "_reduce_flat_int8",
                        _broken_wire(fault, plc._reduce_flat_int8))
    params = parch.init_params(cfg, 0, device="cpu")
    leaves, rebuild = tree_flatten(params)
    with torch.no_grad():
        for x, h in zip(leaves, saved[0]):
            x.copy_(h)
    opt = poptim.AdamWState(count=torch.tensor(2, dtype=torch.int32),
                            mu=rebuild([h.clone() for h in saved[1]]),
                            nu=rebuild([h.clone() for h in saved[2]]))
    step = make_train_step(cfg, TrainConfig(pod_reduce="lcmp_int8", pod_axis=ax))
    params, _, _ = step(params, opt, batch_at(cfg, 2, batch=2, seq=64,
                                              device="cpu"))
    plc._TELEMETRY.reset()
    worst, blocks_ok = cs.int8_block_errors(step.reduced, step.grads, chunk=1 << 14)
    ocfg = poptim.AdamWConfig()
    limit = 2 * float(poptim._schedule(ocfg, torch.tensor(3.0))) * cs.adam_bound(ocfg, 3)
    _, far, within = cs.params_within(tree_flatten(params)[0], p32, limit,
                                      torch.device("cpu"))
    if fault == "none":
        assert blocks_ok and worst < 2.0
        assert within and far < cs.FAR_SHARE, far
    else:
        assert not blocks_ok
        assert far > 2 * cs.FAR_SHARE, far
