"""Port parity of the attention-decoder model stack: ``models.layers``
(windowed, softcapped, offset and non-causal ``gqa_attention``,
``local_block_attention``, ``moe_block``) and ``models.arch.forward``
for gemma2-9b, glm4-9b, mistral-nemo-12b, mixtral-8x7b and dbrx-132b,
held against the JAX package on the CPU at smoke size, on weights
carried by ``models.carry`` and inputs from a numpy seed.

Tolerances: layers in float32 atol 1e-5 (reduction order only); the
forward in float32 atol 1e-4 and in bfloat16 atol 5e-2 on logits of
magnitude ~2, as tests/test_torch_train.py holds qwen3-4b's.

The moe configurations in bfloat16 are held layer by layer, each layer
fed the reference's own input to it: end to end, a one-ulp bfloat16
difference (XLA and PyTorch accumulate the expert einsums in other
orders; 8.0 on values of 1472 at mixtral's smoke size, whose expert
stacks the reference initializes at 1/sqrt(E)) moves a router logit
across a near-tie, the token goes to another expert, and every later
token sees it through attention (mixtral smoke, seed 11: 2 of 96 tokens
rerouted in layer 2, logits off by up to 2.6). Fed the same input, both
route alike, and each layer's output agrees within two bfloat16 ulps of
its largest value (2^-6 of it), the head's logits within 5e-2. The
reference runs these layers eagerly, rounding each op to bfloat16 as
PyTorch does; under jit XLA keeps fused intermediates in float32, and
that alone reroutes tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import arch as rarch
from repro.models import layers as rlayers
from repro_torch import configs as pconfigs
from repro_torch.models import arch as parch
from repro_torch.models import carry
from repro_torch.models import layers as players


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size tensors gain nothing from intra-op threads, and the
    suite runs several workers on the host's cores: one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

NEW_ARCHS = ["gemma2_9b", "glm4_9b", "mistral_nemo_12b", "mixtral_8x7b",
             "dbrx_132b"]


def _port_cfg(rcfg):
    return parch.ArchConfig(**dataclasses.asdict(rcfg))


def _qkv(rng, B, Sq, Sk, Hq, Hkv, D):
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(B, Sq, Hq, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D)


# ------------------------------------------------------------- attention
# (Sq, Sk, causal, window, softcap, q_offset)
GQA_CASES = [(12, 12, True, 5, None, 0), (12, 12, True, None, 2.0, 0),
             (12, 12, True, 4, 3.0, 0), (3, 12, True, None, None, 9),
             (1, 12, True, 6, 2.0, 11), (7, 12, False, None, None, 0),
             (12, 12, False, 4, 2.0, 0)]


@pytest.mark.parametrize("Sq,Sk,causal,window,softcap,q_offset", GQA_CASES)
def test_gqa_attention_matches_reference(Sq, Sk, causal, window, softcap,
                                         q_offset):
    q, k, v = _qkv(np.random.default_rng(Sq * 31 + Sk), 2, Sq, Sk, 4, 2, 16)
    want = rlayers.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, window=window, softcap=softcap,
                                 q_offset=q_offset)
    got = players.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window, softcap=softcap,
                                q_offset=torch.tensor(q_offset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_local_block_attention_matches_reference_and_windowed(softcap):
    """Against the reference, and against windowed ``gqa_attention`` on
    the same inputs: block 0's zero padding must stay masked."""
    W = 8
    q, k, v = _qkv(np.random.default_rng(7), 2, 4 * W, 4 * W, 4, 2, 16)
    want = rlayers.local_block_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), window=W,
                                         softcap=softcap)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = players.local_block_attention(tq, tk, tv, window=W, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    windowed = players.gqa_attention(tq, tk, tv, window=W, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), windowed.numpy(), atol=1e-5)


# ------------------------------------------------------------------- moe
def _slots(experts, E):
    """numpy twin of the reference's per-rank slot count: (t, k) -> slot."""
    onehot = np.eye(E)[experts]                          # (t,k,E)
    pos = np.cumsum(onehot, 0) - onehot
    return (pos * onehot).sum(-1).astype(int)            # (t,k)


# (tokens, E, top_k, capacity_factor, group_size)
MOE_CASES = {"shared_slots": (16, 4, 2, 1.25, 512),
             "overflow": (16, 4, 2, 0.25, 512),
             "groups": (24, 4, 2, 1.25, 8)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_matches_reference(case):
    T, E, k, cf, gs = MOE_CASES[case]
    rng = np.random.default_rng(len(case))
    D, Fd = 16, 32
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.3
         for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
    want = rlayers.moe_block(jnp.asarray(x), jnp.asarray(router),
                             *map(jnp.asarray, w), top_k=k,
                             capacity_factor=cf, group_size=gs)
    with players.record_drops() as drops:
        got = players.moe_block(torch.from_numpy(x), torch.from_numpy(router),
                                *map(torch.from_numpy, w), top_k=k,
                                capacity_factor=cf, group_size=gs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    # the case exercises what it is named for (no ties in the gates)
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, D) @ router), -1)
    top = torch.topk(probs, k, -1)
    assert bool((top.values[:, :-1] > top.values[:, 1:]).all())
    gsz = min(gs, T)
    cap = int(cf * (gsz * k) / E) + 1
    slots = [_slots(top.indices[g * gsz:(g + 1) * gsz].numpy(), E)
             for g in range(T // gsz)]
    dropped = sum(int((s >= cap).sum()) for s in slots)
    assert [int(d) for d in drops] == [dropped]
    if case == "shared_slots":            # a 1st and a 2nd choice share
        s, e = slots[0], top.indices[:gsz].numpy()
        cells = [(e[t, r], s[t, r]) for t in range(gsz) for r in range(k)]
        assert len(set(cells)) < len(cells) and dropped == 0
    if case == "overflow":
        assert dropped > 0


# --------------------------------------------------------------- forward
@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch, act_dtype):
        rcfg = dataclasses.replace(configs.get(arch, smoke=True),
                                   act_dtype=act_dtype)
        if arch not in cache:
            rp = rarch.init_params(rcfg, jax.random.key(11))
            cache[arch] = (rp, jax.tree.map(np.asarray, rp))
        return rcfg, cache[arch]
    return get


FORWARD_CASES = [(a, d, 48) for a in NEW_ARCHS
                 for d in ("float32", "bfloat16")] + \
    [("gemma2_9b", "float32", 128), ("gemma2_9b", "bfloat16", 128)]


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _layers_match(rcfg, rp, pp, tokens):
    """A moe forward in bfloat16, each layer fed the reference's input
    (module docstring)."""
    pcfg = _port_cfg(rcfg)
    x = rp["embed"][jnp.asarray(tokens)].astype(rcfg.adt)
    layers = parch._unstack(pp["layers"], rcfg.n_layers)
    for i in range(rcfg.n_layers):
        lr = jax.tree.map(lambda a: a[i], rp["layers"])
        y = rarch._decoder_layer(rcfg, lr, x, i)       # eager: op by op
        want = np.asarray(y, np.float32)
        got = parch._decoder_layer(pcfg, layers[i], _bf16(x)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -6 * np.abs(want).max())
        x = y
    want = rlayers.rms_norm(x, rp["final_ln"])
    want = np.asarray(jnp.einsum("bsd,vd->bsv", want,
                                 rp["lm_head"].astype(want.dtype)), np.float32)
    got = parch.head(pp, pcfg, _bf16(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


@pytest.mark.parametrize("arch,act_dtype,S", FORWARD_CASES)
def test_forward_matches_reference(ref_params, arch, act_dtype, S):
    """gemma at S=48 runs its local layers through the window mask, at
    S=128 (> 2 x its 32-token window) through local_block_attention."""
    rcfg, (rp, rp_np) = ref_params(arch, act_dtype)
    tokens = np.random.default_rng(S).integers(0, rcfg.vocab, (2, S))
    want = np.asarray(jax.jit(lambda p, t: rarch.forward(p, rcfg, t))(
        rp, jnp.asarray(tokens, jnp.int32)))
    pp = carry.params_from_reference(rp_np, device="cpu")
    if rcfg.family == "moe" and act_dtype == "bfloat16":
        with torch.no_grad():
            _layers_match(rcfg, rp, pp, tokens)
        return
    with torch.no_grad():
        got = parch.forward(pp, _port_cfg(rcfg), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    atol = 1e-4 if act_dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_port_configs_equal_reference():
    for arch in pconfigs.ARCH_IDS:
        for smoke in (False, True):
            assert (dataclasses.asdict(pconfigs.get(arch, smoke=smoke))
                    == dataclasses.asdict(configs.get(arch, smoke=smoke)))
    for alias, arch in pconfigs.ALIASES.items():
        assert configs.ALIASES[alias] == arch


def test_gemma_embedding_scale_is_cast_first():
    """sqrt(3584) = 59.866 is 59.75 in bfloat16; the scale multiplies in
    the activation dtype, as the reference's jnp.asarray(scale, adt)."""
    cfg = pconfigs.get("gemma2_9b", smoke=True)
    cfg = dataclasses.replace(cfg, d_model=3584)
    params = {"embed": torch.ones((4, 3584))}
    x = parch.embed(params, cfg, torch.tensor([[1]]))
    assert x.dtype == torch.bfloat16 and float(x[0, 0, 0]) == 59.75
    plain = parch.embed(params, dataclasses.replace(cfg, name="glm"),
                        torch.tensor([[1]]))
    assert float(plain[0, 0, 0]) == 1.0


def test_moe_params_carry_and_train_step(ref_params):
    """The (L, E, D, F) expert stacks and the (L, D, E) router carry over;
    one port train step on them is finite and moves every leaf."""
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import make_train_step
    rcfg, (_, rp_np) = ref_params("mixtral_8x7b", "float32")
    pp = carry.params_from_reference(rp_np, device="cpu")
    moe = pp["layers"]["moe"]
    L, E, D, Fd = rcfg.n_layers, rcfg.n_experts, rcfg.d_model, rcfg.d_ff
    assert tuple(moe["w_gate"].shape) == (L, E, D, Fd)
    assert tuple(moe["w_down"].shape) == (L, E, Fd, D)
    assert tuple(moe["router"].shape) == (L, D, E)
    tokens = np.random.default_rng(2).integers(0, rcfg.vocab, (2, 16))
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -1
    step = make_train_step(_port_cfg(rcfg))
    pp, opt, m = step(pp, adamw_init(pp), dict(tokens=torch.from_numpy(tokens),
                                               labels=torch.from_numpy(labels)))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    after = carry.to_numpy(pp)
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert not np.array_equal(after["layers"]["moe"][name],
                                  rp_np["layers"]["moe"][name])
