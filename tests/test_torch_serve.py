"""Port parity of the serving stack: ``serve.decode`` (``init_cache``,
``decode_step``), ``train.step.make_serve_step`` and
``launch.serve.prefill_then_decode``, held against the JAX package on
the CPU at smoke size, on weights carried by ``models.carry``.

Tolerances: one decode step in float32 atol 1e-4 on logits of magnitude
~2 and 1e-5 on the cache (reduction order only); teacher-forced decode
against ``forward`` at rtol = atol = 2e-2, the reference's own oracle
(tests/test_models_smoke.py); generated tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.launch import serve as rserve
from repro.models import arch as rarch
from repro.serve import decode as rdecode
from repro_torch import configs as pconfigs
from repro_torch.launch import serve as pserve
from repro_torch.models import arch as parch
from repro_torch.models import carry
from repro_torch.models import layers as players
from repro_torch.serve import decode as pdecode
from repro_torch.train.step import make_serve_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    suite runs several workers on the host's cores: one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

DECODE_ARCHS = ["qwen3_4b", "gemma2_9b", "mixtral_8x7b"]


def _carried(arch, act_dtype, seed):
    rcfg = dataclasses.replace(configs.get(arch, smoke=True),
                               act_dtype=act_dtype)
    rp = rarch.init_params(rcfg, jax.random.key(seed))
    pp = carry.params_from_reference(jax.tree.map(np.asarray, rp),
                                     device="cpu")
    return rcfg, parch.ArchConfig(**dataclasses.asdict(rcfg)), rp, pp


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_matches_reference(arch):
    """40 positions (past gemma smoke's 32-token window, so its local
    layers mask the oldest keys) from the same random tokens."""
    rcfg, pcfg, rp, pp = _carried(arch, "float32", 3)
    B, S = 2, 40
    tokens = np.random.default_rng(4).integers(0, rcfg.vocab, (B, S))
    rstep = jax.jit(lambda p, c, t, i: rdecode.decode_step(p, rcfg, c, t, i))
    rc = rdecode.init_cache(rcfg, B, S)
    pc = pdecode.init_cache(pcfg, B, S, device="cpu")
    step = make_serve_step(pcfg)
    for i in range(S):
        want, rc = rstep(rp, rc, jnp.asarray(tokens[:, i:i + 1], jnp.int32),
                         jnp.int32(i))
        got, pc = step(pp, pc, torch.from_numpy(tokens[:, i:i + 1]),
                       torch.tensor(i))
        assert got.shape == (B, 1, rcfg.vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4, err_msg=f"position {i}")
    for kv in ("k", "v"):
        np.testing.assert_allclose(pc["attn"][kv].numpy(),
                                   np.asarray(rc["attn"][kv]), atol=1e-5)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_teacher_forced_decode_matches_forward(arch, monkeypatch):
    """The KV-cache oracle in the activation dtype (bfloat16): decode
    through 40 positions reproduces ``forward``'s logits.

    For mixtral the forward dispatches each token in a group of its own
    (``group_size=1``), as decode does. With the default 512-token
    groups the reference's forward does not equal its own decode: its
    slots are counted per choice rank, so one token's second choice
    shares an (expert, slot) with another's first and the expert sees
    their sum (the reference, mixtral smoke in float32: decode off
    forward by 0.8-2.5 at every position); the port reproduces that
    (test_torch_models.py holds the grouped forward to the reference).
    No token is dropped by either pass."""
    _, cfg, _, params = _carried(arch, "bfloat16", 5)
    S = 40
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab,
                                                                (1, S)))
    grouped = players.moe_block
    with players.record_drops() as drops, torch.no_grad():
        monkeypatch.setattr(players, "moe_block",
                            lambda *a, **k: grouped(*a, **k, group_size=1))
        ref = parch.forward(params, cfg, tokens)
        monkeypatch.setattr(players, "moe_block", grouped)
        cache = pdecode.init_cache(cfg, 1, S, device="cpu")
        outs = []
        for i in range(S):
            lg, cache = pdecode.decode_step(params, cfg, cache,
                                            tokens[:, i:i + 1], i)
            outs.append(lg[:, 0])
    if cfg.family == "moe":
        assert len(drops) == cfg.n_layers * (S + 1)
    assert all(int(d) == 0 for d in drops)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["qwen3_4b", "mixtral_8x7b"])
def test_prefill_then_decode_gives_reference_tokens(arch):
    rcfg, pcfg, rp, pp = _carried(arch, "float32", 7)
    prompt = np.random.default_rng(8).integers(0, rcfg.vocab, (2, 8))
    want = rserve.prefill_then_decode(rcfg, rp, jnp.asarray(prompt, jnp.int32), 8)
    got = pserve.prefill_then_decode(pcfg, pp, torch.from_numpy(prompt), 8)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_cache_layout_and_refusals():
    cfg = pconfigs.get("gemma2_9b", smoke=True)
    c = pdecode.init_cache(cfg, 3, 17, device="cpu")
    shape = (cfg.n_layers, 3, 17, cfg.n_kv, cfg.hd)
    assert tuple(c["attn"]["k"].shape) == tuple(c["attn"]["v"].shape) == shape
    assert c["attn"]["k"].dtype == torch.bfloat16
    assert pdecode.init_cache(cfg, 1, 2, torch.float32,
                              device="cpu")["attn"]["v"].dtype == torch.float32
    # every family has its cache now; a family the reference does not
    # know is refused by both packages' decode
    for arch in ("falcon_mamba_7b", "zamba2_1p2b", "whisper_medium",
                 "internvl2_2b"):
        assert pdecode.init_cache(pconfigs.get(arch, smoke=True), 1, 4,
                                  device="cpu")
    odd = dataclasses.replace(cfg, family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        pdecode.init_cache(odd, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        pdecode.decode_step({}, odd, {}, torch.zeros((1, 1), dtype=torch.long), 0)


def test_serve_refuses_encdec_as_the_reference(monkeypatch):
    """Both launchers refuse whisper with the same message (the example
    it names is not in the repo)."""
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "whisper_medium",
                                      "--smoke"])
    with pytest.raises(SystemExit) as want:
        rserve.main()
    with pytest.raises(SystemExit) as got:
        pserve.main(["--arch", "whisper_medium", "--smoke", "--device", "cpu"])
    assert str(got.value) == str(want.value) == \
        "use examples/whisper_serve.py for enc-dec serving"


def test_vlm_serve_decodes_without_patches_as_the_reference():
    """internvl2 at smoke size: the generated tokens are the reference's
    (both decode as a dense decoder, with no patch prefix)."""
    rcfg, pcfg, rp, pp = _carried("internvl2_2b", "float32", 9)
    prompt = np.random.default_rng(10).integers(0, rcfg.vocab, (2, 8))
    want = rserve.prefill_then_decode(rcfg, rp, jnp.asarray(prompt, jnp.int32), 8)
    got = pserve.prefill_then_decode(pcfg, pp, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "internvl2-2b"])
def test_serve_cli_on_the_cpu(capsys, arch):
    pserve.main(["--arch", arch, "--smoke", "--batch", "2",
                 "--prompt-len", "4", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 3) in" in out and "tok/s" in out


def test_serve_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pconfigs.get("qwen3_4b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdecode.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pserve.main(["--smoke"])
