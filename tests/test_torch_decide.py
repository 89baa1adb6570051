"""``decide``'s factorization, on the CPU.

The card's ``decide`` is two kernels: one record per pair, then one
pick per decision from its pair's record. Their plain versions,
``ref.decide_records_ref`` and ``ref.decide_pick_ref``, must compose to
``ref.decide_ref`` bit for bit, for all ten laws and the sweep (a law
per pair), on worlds carried by the port's own fluid step (dead links, a
degrade schedule, random RedTE weights, the congestion fallback's ring),
at the failover's read (t = 0, ring step -1), a mid-run step and salted
keys; on hand-made edge rows (ties under every rotation, no valid
candidate, one valid candidate, pads inside the K slots, the fallback,
fatpaths' spill, zero capacities, the hash keys' edges); and against
the JAX package's ``engine.decide`` on the same numpy inputs.

The launcher's ctypes mirrors of the CUDA source's structs are checked
against the source's text: a field added on one side only would shift
every pointer the kernels read on the card.
"""
import ctypes
import dataclasses
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim import engine as rengine
from repro.netsim import experiment as rexp
from repro.netsim import fluid as rfluid
from repro_torch.core.select import SelectParams, fmix32
from repro_torch.kernels import lcmp_decide, ref
from repro_torch.netsim import carry
from repro_torch.netsim import engine as pengine
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import fluid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAWS = ref.LAWS
HASH_EDGES = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
CARRY = {"testbed8": 150, "wan2000": 100, "geo": 250}


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


CS = _chip_smoke()


def _factored(t, sig, fid, pair, st, ar, policy, select):
    rec = ref.decide_records_ref(t, sig, st, ar, policy, select)
    for name, x in rec.items():
        assert x.dtype == torch.int32, name
    return ref.decide_pick_ref(rec, fid, pair)


def _assert_factorization(t, sig, fid, pair, st, ar, policy, select, what):
    k, c = ref.decide_ref(t, fid, pair, st, ar, policy, select, sig)
    kf, cf = _factored(t, sig, fid, pair, st, ar, policy, select)
    assert kf.dtype == cf.dtype == torch.int32, what
    assert torch.equal(kf, k), f"{what}: k_idx ({int((kf != k).sum())} differ)"
    assert torch.equal(cf, c), f"{what}: chosen"
    return k


def _every_pair(ar, keys: int, seed: int):
    """``keys`` decisions on every pair, the hash keys' edges first."""
    npair = ar.pair_cand.shape[0]
    pair = torch.arange(npair, dtype=torch.int32).repeat(keys)
    fid = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 1 << 32, pair.shape[0]))
    fid[:len(HASH_EDGES)] = torch.tensor(HASH_EDGES)
    return fid, pair


# ------------------------------------------------ carried worlds, every law
@pytest.fixture(scope="module", params=["testbed8", "wan2000", "geo"])
def world(request):
    """A world the port's CPU fluid step (lcmp) carried ``CARRY`` steps,
    then with about a quarter of the links down, random RedTE weights and
    a degrade schedule; ``carry`` is the carried step."""
    name = request.param
    spec = pexp.ExpSpec(**CS.CHECK_WORLDS[name])
    _, table, flows, cfg = pexp.build_experiment(spec)
    ar, st = fluid.build(table, flows, cfg, device="cpu")
    step = fluid.make_step(ar, cfg)
    for t in range(CARRY[name]):
        st = step(st, t)
    assert bool(st.active.any())
    rng = np.random.default_rng(len(name))
    arrays = CS.random_degrade(carry.to_numpy(ar), rng)
    state = carry.to_numpy(st)
    state["link_alive"] = rng.random(state["link_alive"].shape[0]) >= 0.25
    state["redte_w"] = rng.integers(0, 300, state["redte_w"].shape).astype(np.int32)
    ar, st = carry.from_reference(arrays, state, device="cpu")
    return name, ar, st, cfg.select, CARRY[name]


@pytest.mark.parametrize("kind", ["dead", "fallback"])
@pytest.mark.parametrize("policy", LAWS + ("sweep",))
def test_factorization_equals_decide_on_carried_worlds(world, policy, kind):
    name, ar, st, select, k = world
    if kind == "fallback":
        st = dataclasses.replace(st, hist_c=torch.from_numpy(
            np.random.default_rng(9).integers(230, 256, tuple(st.hist_c.shape))
            .astype(np.int32)))
    if policy == "sweep":
        ar = CS.mixed_laws(ar, 4)
    F = ar.f_id.shape[0]
    salted = ar.f_id ^ fmix32(torch.arange(F) % 5)
    decided = 0
    # every flow: the failover's read, a mid-run step, salted keys
    for t, sig, fid in ((0, -1, ar.f_id), (k, k - 1, ar.f_id), (k, k, salted)):
        got = _assert_factorization(t, sig, fid, ar.f_pair, st, ar, policy,
                                    select, f"{name} {policy} t={t}")
        decided += int((got >= 0).sum())
    # every pair, with keys beyond the flows'
    fid, pair = _every_pair(ar, 16, k)
    _assert_factorization(k, k, fid, pair, st, ar, policy, select,
                          f"{name} {policy} every pair")
    assert decided > 0


# --------------------------------------------------- hand-made edge rows
def _edge_world(K: int = 8, H: int = 3, ring: int = 4):
    """A small world whose pairs are edge rows: 0 ties everywhere (equal
    capacities, scores, hop counts and congestion); 1 every candidate
    dead; 2 only pads; 3 one valid candidate; 4 pads inside the K slots;
    5 every valid candidate at or above the congestion fallback; 6
    fatpaths' shortest layer congested (a spill), the longer paths not;
    7 zero capacities and zero RedTE weights; 8-11 random rows."""
    rng = np.random.default_rng(3)
    npair, NP = 12, 12 * K
    L = NP * H
    path_links = np.arange(L, dtype=np.int32).reshape(NP, H)   # private links
    plen = rng.integers(1, H + 1, NP)
    path_links[np.arange(H)[None, :] >= plen[:, None]] = -1
    pair_cand = np.arange(NP, dtype=np.int32).reshape(npair, K)
    alive = np.ones(L, bool)
    hist = rng.integers(0, 200, (L, ring)).astype(np.int32)
    c_path = rng.integers(0, 256, NP).astype(np.int32)
    capg = rng.choice([0, 25, 40, 100, 400], NP).astype(np.int32)
    redte = rng.integers(0, 300, (npair, K)).astype(np.int32)
    link_cap = rng.choice([25, 40, 100, 400], L).astype(np.int32)
    rows = pair_cand.copy()

    def links(p):
        return path_links[rows[p]][path_links[rows[p]] >= 0]

    # 0: ties
    path_links[rows[0], 1:] = -1
    plen[rows[0]] = 1
    capg[rows[0]], c_path[rows[0]] = 100, 7
    hist[path_links[rows[0], 0]] = 50
    link_cap[path_links[rows[0], 0]] = 100
    deg_step = rng.integers(0, 4, L).astype(np.int32)
    deg_step[path_links[rows[0], 0]] = 1 << 20    # no degrade on row 0
    redte[0] = 40
    alive[links(1)] = False                      # 1: every candidate dead
    pair_cand[2] = -1                            # 2: only pads
    alive[path_links[rows[3, 1:]][path_links[rows[3, 1:]] >= 0]] = False
    pair_cand[4, [1, 4, 5]] = -1                 # 4: pads inside K
    hist[links(5)] = rng.integers(230, 256, (links(5).size, ring))
    short = rows[6][plen[rows[6]] == plen[rows[6]].min()]   # 6: spill
    hist[path_links[short][path_links[short] >= 0]] = 240
    capg[rows[7]], redte[7] = 0, 0               # 7: zero weights
    plen = (path_links >= 0).sum(1).astype(np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    empty = torch.empty(0)
    ar = pengine.SimArrays(**{f.name: empty for f in dataclasses.fields(
        pengine.SimArrays)})
    ar = dataclasses.replace(
        ar, f_id=t(np.array(HASH_EDGES, np.int64)),
        f_pair=t(np.zeros(len(HASH_EDGES), np.int32)),
        pair_cand=t(pair_cand), path_links=t(path_links),
        path_sig_delay=t(rng.integers(0, 2 * ring, (NP, H)).astype(np.int32)),
        path_cap_gbps=t(capg), path_len=t(plen), link_cap_gbps=t(link_cap),
        link_deg_step=t(deg_step),
        link_deg_factor=t(rng.choice([0.1, 0.25, 1.0], L).astype(np.float32)),
        pair_policy=t(np.arange(npair, dtype=np.int32) % len(LAWS)),
        tables=None)
    st = pengine.SimState(cong=None, **{
        f.name: empty for f in dataclasses.fields(pengine.SimState)
        if f.name != "cong"})
    st = dataclasses.replace(st, link_alive=t(alive), hist_c=t(hist),
                             c_path=t(c_path), redte_w=t(redte))
    return ar, st


@pytest.mark.parametrize("select", [SelectParams(), SelectParams(keep_num=1),
                                    SelectParams(alpha=1, beta=3, keep_num=3,
                                                 cong_fallback=100)])
@pytest.mark.parametrize("policy", LAWS + ("sweep",))
def test_factorization_equals_decide_on_edge_rows(policy, select):
    ar, st = _edge_world()
    # 512 keys a pair: every rotation and every rank is taken
    fid, pair = _every_pair(ar, 512, 1)
    for t, sig in ((0, -1), (3, 2), (3, 3)):
        k = _assert_factorization(t, sig, fid, pair, st, ar, policy, select,
                                  f"{policy} t={t}")
        law = (policy if policy != "sweep" else
               LAWS[int(ar.pair_policy[1])])
        # the rows with no valid candidate decide nothing
        assert (k[(pair == 1) | (pair == 2)] == -1).all(), law
        assert (k[pair == 3] == 0).all()
    if policy in ("ucmp", "matchrdma"):
        # row 0's eight tied slots: each is taken, by the rotation
        assert set(k[pair == 0].tolist()) == set(range(8))


def test_edge_rows_records():
    ar, st = _edge_world()
    sel = SelectParams()
    rec = {p: ref.decide_records_ref(3, 3, st, ar, p, sel) for p in LAWS}
    for p in LAWS:
        assert (rec[p]["n"][[1, 2]] == 0).all() or p in (
            "ucmp", "matchrdma", "wcmp", "redte"), p
        assert (rec[p]["path"][2] == -1).all()
        assert rec[p]["path"][4, 1] == -1
    assert (rec["wcmp"]["cum"][[1, 2]] == 0).all()         # zero total
    assert (rec["ucmp"]["mask"][[1, 2]] == 0).all()
    assert rec["lcmp"]["n"][5] == 1                        # fallback
    assert rec["lcmp_w"]["n"][5] == 1 and rec["lcmp_w"]["cum"][5, 1] == 0
    assert rec["ucmp"]["mask"][0] == 0xFF                  # ties
    assert rec["matchrdma"]["mask"][0] == 0xFF
    assert rec["lcmp"]["order"][0].tolist() == list(range(8))
    fat = rec["fatpaths"]
    assert fat["mask"][6] == rec["ecmp"]["mask"][6]        # the spill
    assert rec["ecmp"]["n"][4] == 5 and rec["ecmp"]["mask"][4] == 0b11001101
    assert rec["wcmp"]["cum"][7].tolist() == list(range(1, 9))  # max(0, 1)
    assert rec["redte"]["cum"][7].tolist() == list(range(1, 9))


# ----------------------------------------------- against the JAX package
@pytest.mark.parametrize("policy", LAWS)
def test_factorization_equals_reference_decide(policy):
    # the same numpy inputs through the JAX package's engine.decide and
    # the port's two halves: testbed8 with a third of the links down, a
    # random ring and C_path, RedTE weights and a degrade schedule, on
    # every pair with the hash keys' edges
    spec = CS.CHECK_WORLDS["testbed8"]
    _, rt, rf, rcfg = rexp.build_experiment(rexp.ExpSpec(**spec))
    r_arr, r_st = rfluid.build(rt, rf, rcfg)
    rng = np.random.default_rng(5)
    L, ring = r_st.hist_c.shape
    state = dict(link_alive=rng.random(L) >= 0.33,
                 hist_c=rng.integers(0, 256, (L, ring)).astype(np.int32),
                 c_path=rng.integers(0, 256, r_st.c_path.shape).astype(np.int32),
                 redte_w=rng.integers(0, 300, r_st.redte_w.shape).astype(np.int32))
    arrays = CS.random_degrade({n: np.asarray(getattr(r_arr, n)) for n in (
        "link_deg_step", "link_deg_factor", "link_cap")}, rng)
    r_st = dataclasses.replace(r_st, **{n: jnp.asarray(v) for n, v in state.items()})
    r_arr = dataclasses.replace(r_arr, **{n: jnp.asarray(v)
                                          for n, v in arrays.items()})
    rcfg = dataclasses.replace(rcfg, policy=policy)
    _, pt, pf, pcfg = pexp.build_experiment(pexp.ExpSpec(**spec))
    p_arr, p_st = fluid.build(pt, pf, pcfg, device="cpu")
    p_st = dataclasses.replace(p_st, **{n: torch.from_numpy(v)
                                        for n, v in state.items()})
    p_arr = dataclasses.replace(p_arr, **{n: torch.from_numpy(np.array(v))
                                          for n, v in arrays.items()})
    fid, pair = _every_pair(p_arr, 64, 2)
    for t, sig in ((0, -1), (700, 699)):
        rk, rc = rengine.decide(t, jnp.asarray(fid.numpy().astype(np.uint32)),
                                jnp.asarray(pair.numpy()), r_st, r_arr, rcfg,
                                sig_step=sig)
        k, c = _factored(t, sig, fid, pair, p_st, p_arr, policy, pcfg.select)
        np.testing.assert_array_equal(k.numpy(), np.asarray(rk), f"{policy} t={t}")
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc), f"{policy} t={t}")
        assert (k >= 0).any() and (k < 0).any()


# ------------------------------------------- the ctypes mirrors of the source
_C_TYPES = {"pointer": ctypes.c_void_p, "long long": ctypes.c_longlong,
            "int": ctypes.c_int}


def _c_struct(name: str) -> list:
    """``[(field, C type)]`` of ``struct name { ... }`` in
    ``csrc/lcmp_decide.cu``, the type one of ``_C_TYPES``."""
    path = os.path.join(os.path.dirname(lcmp_decide.__file__), "csrc",
                        "lcmp_decide.cu")
    src = open(path).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        if "*" in decl:                 # one pointer a declaration
            fields.append((decl.rsplit("*", 1)[1].strip(), "pointer"))
            continue
        words = re.findall(r"\w+", decl)
        ctype = [w for w in words if w in ("unsigned", "long", "int")]
        fields += [(n, " ".join(ctype)) for n in words[len(ctype):]]
    return fields


@pytest.mark.parametrize("struct, mirror", [
    ("RouteArgs", lcmp_decide._RouteArgs),
    ("StepTensors", lcmp_decide._StepTensors),
    ("SwitchArgs", lcmp_decide._SwitchArgs)])
def test_ctypes_mirrors_match_the_source(struct, mirror):
    src = _c_struct(struct)
    assert [n for n, _ in src] == [n for n, _ in mirror._fields_]
    for (n, ctype), (_, mtype) in zip(src, mirror._fields_):
        assert ctype in _C_TYPES, (n, ctype)
        assert _C_TYPES[ctype] is mtype, (n, ctype, mtype)


def test_unpack_records_reads_the_kernel_layout():
    # a table packed as the CUDA source's decide_pairs stores it, from
    # the edge world's records: unpacked, the same fields
    ar, st = _edge_world()
    for policy in ("lcmp_w", "ucmp", "fatpaths", "redte", "sweep"):
        rec = ref.decide_records_ref(3, 3, st, ar, policy, SelectParams())
        masked = torch.isin(rec["law"], torch.tensor(
            [LAWS.index(p) for p in lcmp_decide.MASK_LAWS]))
        sel = torch.where(masked, rec["mask"].long(), sum(
            rec["order"][:, r].long() << (3 * r) for r in range(8)))
        hdr = sel | (rec["n"].long() << 24) | (rec["law"].long() << 28)
        words = torch.stack([(rec["path"][:, k].long() & ((1 << 28) - 1))
                             | (((hdr >> (4 * k)) & 15) << 28)
                             for k in range(8)], 1)
        words = torch.where(words >= 1 << 31, words - (1 << 32), words)
        table = torch.cat([words.to(torch.int32), rec["cum"]], 1)
        assert table.shape[1] == lcmp_decide.RECORD_WORDS
        got = lcmp_decide.unpack_records(table)
        for name, want in rec.items():
            assert torch.equal(got[name], want), (policy, name)
