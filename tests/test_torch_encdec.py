"""Port parity of the encoder-decoder and VLM families: ``models.arch``
(the whisper encoder, cross-attention, the vlm patch prefix), one
``train.step`` step with ``extra`` inputs, ``serve.decode``
(``init_cache`` for every family, ``prefill_cross_cache``, the encdec
and vlm decode), ``data.synth``'s extra inputs and checkpoints of the
hybrid and encdec trees, held against the JAX package on the CPU on
weights carried by ``models.carry`` and inputs from a numpy seed.

Tolerances: forward, decode and cross caches in float32 atol 1e-4 on
values of magnitude ~2 (reduction order only), in bfloat16 atol 5e-2;
one train step as tests/test_torch_ssm.py (loss and grad norm rtol 1e-4,
parameters within AdamW's first-step bound 6e-6); teacher-forced decode
against ``forward`` rtol = atol = 2e-2, the reference's own oracle.

As in the reference, the vlm family decodes as a dense decoder without
its patch prefix, so its decode oracle is ``forward`` of the same
parameters under ``family="dense"``, not the vlm ``forward``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.data import synth as rsynth
from repro.models import arch as rarch
from repro.models import layers as rlayers
from repro.serve import decode as rdecode
from repro.train import checkpoint as rckpt
from repro.train import step as rstep
from repro_torch import configs as pconfigs
from repro_torch.data.synth import batch_at
from repro_torch.dist.lcmp_collectives import tree_flatten
from repro_torch.models import arch as parch
from repro_torch.models import carry
from repro_torch.serve import decode as pdecode
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import adamw_init
from repro_torch.train.step import make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    suite runs several workers on the host's cores: one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["whisper_medium", "internvl2_2b"]
ADAM_BOUND_1 = 6e-6


def _cfgs(arch, act_dtype="float32"):
    rcfg = dataclasses.replace(configs.get(arch, smoke=True),
                               act_dtype=act_dtype)
    return rcfg, parch.ArchConfig(**dataclasses.asdict(rcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _names(tree, pre=""):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _names(tree[k], pre + k + "/")
        else:
            out.append(pre + k)
    return out


def _extra(cfg, B, seed):
    n = cfg.enc_seq if cfg.family == "encdec" else cfg.n_patches
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


def _ref_encode(rp, rcfg, frames):
    """The reference's encoder as tests/test_models_smoke.py runs it."""
    e = jnp.asarray(frames).astype(rcfg.adt)

    def enc_layer(h, lp):
        h = rarch._attn_apply(lp["attn"], h, rcfg, causal=False, use_rope=False)
        return rarch._mlp_apply(lp["mlp"], h), None
    e, _ = jax.lax.scan(enc_layer, e, rp["enc_layers"])
    return rlayers.rms_norm(e, rp["enc_final_ln"])


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg, _ = _cfgs(arch)
            rp, ro = rstep.init_train_state(rcfg, jax.random.key(21))
            cache[arch] = rp, ro, _np(rp)
        return cache[arch]
    return get


# --------------------------------------------------------------- forward
@pytest.mark.parametrize("act_dtype,atol", [("float32", 1e-4),
                                            ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ref_params, arch, act_dtype, atol):
    rcfg, pcfg = _cfgs(arch, act_dtype)
    rp, _, rp_np = ref_params(arch)
    tokens = np.random.default_rng(1).integers(0, rcfg.vocab, (2, 24))
    extra = _extra(rcfg, 2, 2)
    want = np.asarray(jax.jit(lambda p, t, e: rarch.forward(p, rcfg, t, extra=e))(
        rp, jnp.asarray(tokens, jnp.int32), jnp.asarray(extra)))
    with torch.no_grad():
        got = parch.forward(carry.params_from_reference(rp_np, device="cpu"),
                            pcfg, torch.from_numpy(tokens),
                            extra=torch.from_numpy(extra))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 24, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(ref_params, arch):
    """One step with the batch's ``extra`` in both packages, split into
    two microbatches (the port splits ``extra`` with the tokens)."""
    from repro_torch.train.step import TrainConfig
    rcfg, pcfg = _cfgs(arch)
    rp, ro, rp_np = ref_params(arch)
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 16))
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -1
    extra = _extra(rcfg, 2, 4)
    rbatch = dict(tokens=jnp.asarray(tokens, jnp.int32),
                  labels=jnp.asarray(labels, jnp.int32),
                  extra=jnp.asarray(extra))
    rp2, _, rm = jax.jit(rstep.make_train_step(
        rcfg, rstep.TrainConfig(microbatches=2)))(rp, ro, rbatch)
    pp = carry.params_from_reference(rp_np, device="cpu")
    pp, _, pm = make_train_step(pcfg, TrainConfig(microbatches=2))(
        pp, adamw_init(pp), dict(tokens=torch.from_numpy(tokens),
                                 labels=torch.from_numpy(labels),
                                 extra=torch.from_numpy(extra)))
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-4)
    got, want = tree_flatten(carry.to_numpy(pp))[0], jax.tree.leaves(_np(rp2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (np.abs(g - w) <= ADAM_BOUND_1 + 2e-7 * np.abs(w)).all()


# ---------------------------------------------------------------- decode
def test_prefill_cross_cache_matches_reference(ref_params):
    rcfg, pcfg = _cfgs("whisper_medium")
    rp, _, rp_np = ref_params("whisper_medium")
    pp = carry.params_from_reference(rp_np, device="cpu")
    frames = _extra(rcfg, 2, 5)
    r_enc = _ref_encode(rp, rcfg, frames)
    with torch.no_grad():
        p_enc = parch.encode(pp, pcfg, torch.from_numpy(frames))
    np.testing.assert_allclose(p_enc.numpy(), np.asarray(r_enc), atol=1e-4)
    want = _np(rdecode.prefill_cross_cache(rp, rcfg, r_enc))
    got = pdecode.prefill_cross_cache(pp, pcfg, torch.from_numpy(np.array(r_enc)))
    shape = (rcfg.n_layers, 2, rcfg.enc_seq, rcfg.n_kv, rcfg.hd)
    for kv in ("k", "v"):
        assert tuple(got[kv].shape) == want[kv].shape == shape
        assert got[kv].dtype == torch.float32
        np.testing.assert_allclose(got[kv].numpy(), want[kv], atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(ref_params, arch):
    """20 positions in float32 from the same tokens (whisper: each
    package's cross cache from its own encoder output); logits at every
    position, then the self-attention cache."""
    rcfg, pcfg = _cfgs(arch)
    rp, _, rp_np = ref_params(arch)
    pp = carry.params_from_reference(rp_np, device="cpu")
    B, S = 2, 20
    tokens = np.random.default_rng(6).integers(0, rcfg.vocab, (B, S))
    rc = rdecode.init_cache(rcfg, B, S)
    pc = pdecode.init_cache(pcfg, B, S, device="cpu")
    if rcfg.family == "encdec":
        frames = _extra(rcfg, B, 7)
        rc = dict(rc, cross=rdecode.prefill_cross_cache(
            rp, rcfg, _ref_encode(rp, rcfg, frames)))
        pc["cross"] = pdecode.prefill_cross_cache(
            pp, pcfg, parch.encode(pp, pcfg, torch.from_numpy(frames)))
    rstep_fn = jax.jit(lambda p, c, t, i: rdecode.decode_step(p, rcfg, c, t, i))
    for i in range(S):
        want, rc = rstep_fn(rp, rc, jnp.asarray(tokens[:, i:i + 1], jnp.int32),
                            jnp.int32(i))
        got, pc = pdecode.decode_step(pp, pcfg, pc,
                                      torch.from_numpy(tokens[:, i:i + 1]),
                                      torch.tensor(i))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4, err_msg=f"position {i}")
    for kv in ("k", "v"):
        np.testing.assert_allclose(pc["attn"][kv].numpy(),
                                   np.asarray(rc["attn"][kv]), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    """The cache oracle in bfloat16 through 32 positions: whisper against
    ``forward(tokens, extra=frames)`` with the cross cache from
    ``prefill_cross_cache`` of the encoder's output; internvl2 against
    the dense-family forward of the same parameters (module docstring),
    and its vlm forward with patches finite, of the tokens' shape."""
    rcfg, cfg = _cfgs(arch, "bfloat16")
    params = carry.params_from_reference(
        _np(rarch.init_params(rcfg, jax.random.key(22))), device="cpu")
    S = 32
    tokens = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab, (1, S)))
    extra = torch.from_numpy(_extra(cfg, 1, 24))
    cache = pdecode.init_cache(cfg, 1, S, device="cpu")
    with torch.no_grad():
        if cfg.family == "encdec":
            ref = parch.forward(params, cfg, tokens, extra=extra)
            cache["cross"] = pdecode.prefill_cross_cache(
                params, cfg, parch.encode(params, cfg, extra))
        else:
            ref = parch.forward(params, dataclasses.replace(cfg, family="dense"),
                                tokens)
            vlm = parch.forward(params, cfg, tokens, extra=extra)
            assert vlm.shape == ref.shape and torch.isfinite(vlm).all()
            assert (vlm - ref).abs().max() > 2e-2     # the patches are seen
    outs = []
    for i in range(S):
        lg, cache = pdecode.decode_step(params, cfg, cache, tokens[:, i:i + 1], i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_init_cache_matches_reference(arch):
    """Every family's cache: the same leaves, shapes and dtypes, zeroed."""
    rcfg = configs.get(arch, smoke=True)
    pcfg = pconfigs.get(arch, smoke=True)
    want = rdecode.init_cache(rcfg, 2, 9)
    got = pdecode.init_cache(pcfg, 2, 9, device="cpu")
    assert _names(got) == _names(want)
    for g, w in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()


# ---------------------------------------------------- data, checkpoints
@pytest.mark.parametrize("arch", ["internvl2_2b", "whisper_medium", "qwen3_4b"])
def test_batch_at_extra_matches_reference_layout(arch):
    """``extra`` has the reference's shape and dtype (normal x 0.02, so a
    standard deviation near 0.02); token-only families have none."""
    rcfg = configs.get(arch, smoke=True)
    want = rsynth.batch_at(rcfg, 3, batch=2, seq=8)
    got = batch_at(pconfigs.get(arch, smoke=True), 3, batch=2, seq=8,
                   device="cpu")
    assert sorted(got) == sorted(want)
    if "extra" in want:
        assert tuple(got["extra"].shape) == want["extra"].shape
        assert str(got["extra"].dtype).split(".")[-1] == str(want["extra"].dtype)
        assert abs(float(got["extra"].std()) - 0.02) < 0.002
        again = batch_at(pconfigs.get(arch, smoke=True), 3, batch=2, seq=8,
                         device="cpu")
        assert torch.equal(again["extra"], got["extra"])


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "whisper_medium"])
def test_checkpoints_restore_across_packages(tmp_path, arch):
    """The hybrid tree (``shared_attn``) and the encdec tree
    (``enc_layers``, ``enc_final_ln``, ``xattn``) with their optimizer
    state: saved by either package, restored bit for bit by the other,
    with the reference's leaf names."""
    rcfg = configs.get(arch, smoke=True)
    pcfg = pconfigs.get(arch, smoke=True)
    rp, ro = rstep.init_train_state(rcfg, jax.random.key(31))
    ro = ro._replace(count=ro.count + 3, mu=jax.tree.map(lambda p: p * 0.5, rp))
    ref_state = {"params": rp, "opt": ro}
    params, opt = parch.init_params(pcfg, 1, device="cpu"), None
    opt = adamw_init(params)
    like = {"params": params, "opt": opt}
    assert ckpt.leaf_names(like) == [n for n, _ in rckpt._flat(ref_state)[0]]
    # reference -> port
    out = ckpt.restore(rckpt.save(str(tmp_path / "ref"), 3, ref_state), like)
    for g, w in zip(tree_flatten(out)[0], jax.tree.leaves(ref_state)):
        w = np.asarray(w)
        assert g.detach().numpy().dtype == w.dtype
        assert np.array_equal(g.detach().numpy(), w)
    # port -> reference
    state = {"params": params, "opt": opt._replace(
        count=torch.tensor(7, dtype=torch.int32))}
    back = rckpt.restore(ckpt.save(str(tmp_path / "port"), 7, state), ref_state)
    for g, w in zip(jax.tree.leaves(back), tree_flatten(state)[0]):
        assert np.array_equal(np.asarray(g), w.detach().numpy())
    assert sorted(os.listdir(tmp_path / "port" / "step-00000007")) \
        == ["MANIFEST.json", "shard-0.npz"]
