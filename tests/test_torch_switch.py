"""The port's switch object model (``repro_torch.core.flowcache`` and
``core.switchd``) on the CPU: each contract of
``tests/test_core_switch.py`` (stickiness, GC, lazy fast-failover, the
routing preferences, the bounded cache, the storage budget), then
``monitor_tick`` and ``route_batch`` against the JAX package's on the
same inputs over many ticks (integers exact; batches whose cache slots
are distinct), and the port's one rule for batch collisions, pinned:
``fc.insert`` alone, and whole batches of ``route_batch`` (hits and
inserts on one slot, a dead cached egress, every candidate dead) against
the rule written as a loop.

The ``cuda``-marked tests hold the card against the plain versions (the
switch's launchers under ``switchd``: ``cong_update`` and the two
``switch_route`` kernels; the collision rule) and skip without a card;
the JAX package is imported by the ``jref`` fixture only, so they also
run on a machine without JAX (``pytest -m cuda``). About 10 s on one
worker.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core import flowcache as fc
from repro_torch.core import switchd, tables
from repro_torch.core.select import fmix32
from repro_torch.kernels import ops, ref

# 6 candidate paths (Fig. 1): {200,200,100,100,40,40} Gbps x {5,250} ms
DELAYS = [5_000, 250_000, 5_000, 250_000, 5_000, 250_000]
CAPS = [200, 200, 100, 100, 40, 40]
PORTS = list(range(6))


@pytest.fixture(scope="module")
def jref():
    """The JAX package's switch and tables."""
    import jax.numpy as jnp

    from repro.core import switchd, tables
    return types.SimpleNamespace(jnp=jnp, switchd=switchd, tables=tables)


def _mk(cache_capacity=512, dev="cpu"):
    tb = tables.bootstrap_tables(CAPS, buffer_bytes=6 * 10**9, device=dev)
    return switchd.make_switch(tb, DELAYS, CAPS, PORTS, num_ports=6,
                               cache_capacity=cache_capacity, device=dev)


def _ids(x):
    return torch.tensor(np.asarray(x, np.uint32).astype(np.int64))


# ------------------------------------------- test_core_switch.py's contracts
def test_first_packet_decides_second_sticks():
    sw = _mk()
    fids = _ids([101, 202, 303])
    sw, idx1, new1 = switchd.route_batch(sw, fids, now_us=0)
    assert bool(new1.all())
    sw, idx2, new2 = switchd.route_batch(sw, fids, now_us=10)
    assert not bool(new2.any())
    assert torch.equal(idx1, idx2)


def test_gc_evicts_idle_flows():
    sw = _mk()
    fids = _ids([7])
    sw, _, _ = switchd.route_batch(sw, fids, now_us=0)
    p = switchd.SwitchParams(idle_timeout_us=1000)
    sw = switchd.gc_tick(sw, now_us=5000, params=p)
    _, _, new = switchd.route_batch(sw, fids, now_us=5001)
    assert bool(new.all())


def test_lazy_failover_rehashes_to_live_port():
    sw = _mk()
    fids = _ids(np.arange(200, dtype=np.uint32) * np.uint32(2654435761))
    sw, idx1, _ = switchd.route_batch(sw, fids, now_us=0)
    idx1 = idx1.numpy()
    dead_port = int(np.bincount(idx1, minlength=6).argmax())
    alive = np.ones(6, bool)
    alive[dead_port] = False
    sw = switchd.set_port_liveness(sw, alive)
    sw, idx2, renew = switchd.route_batch(sw, fids, now_us=10)
    idx2, renew = idx2.numpy(), renew.numpy()
    assert (idx2 != dead_port).all()
    moved = idx1 == dead_port
    assert renew[moved].all()
    same = ~renew
    assert (idx2[same] == idx1[same]).all()
    assert same[~moved].mean() > 0.7


def test_routing_prefers_low_delay_paths_when_uncongested():
    sw = _mk()
    fids = _ids(np.arange(2000, dtype=np.uint32) * np.uint32(40503) + 17)
    sw, idx, _ = switchd.route_batch(sw, fids, now_us=0)
    counts = np.bincount(idx.numpy(), minlength=6)
    assert counts[[1, 3, 5]].sum() == 0, counts
    assert counts[[0, 2, 4]].min() > 0


def test_congestion_shifts_traffic_away():
    tb = tables.bootstrap_tables([100] * 4, buffer_bytes=6 * 10**9,
                                 device="cpu")
    sw = switchd.make_switch(tb, [5_000, 5_000, 20_000, 20_000], [100] * 4,
                             list(range(4)), num_ports=4, device="cpu")
    for i in range(300):
        q = torch.zeros(4, dtype=torch.int32)
        q[0] = (4 + i // 40) * 10**9 // 1024
        sw = switchd.monitor_tick(sw, q, now_us=i * 100)
    fids = _ids(np.arange(2000, dtype=np.uint32) * np.uint32(48271) + 3)
    sw, idx, _ = switchd.route_batch(sw, fids, now_us=30_100)
    counts = np.bincount(idx.numpy(), minlength=4)
    assert counts[0] == 0, counts
    assert counts[1] > 0


def test_route_batch_shapes_and_dtypes():
    sw = _mk()
    sw2, idx, new = switchd.route_batch(sw, torch.arange(64), now_us=0)
    assert idx.shape == (64,) and idx.dtype == torch.int32
    assert new.dtype == torch.bool and sw2.cache.flow_id.dtype == torch.int64


def test_flowcache_direct_mapped_collision_overwrite():
    cache = fc.FlowCache.init(4, device="cpu")
    ids = _ids([1, 2, 3, 4, 5])
    cache = fc.insert(cache, ids, torch.arange(5, dtype=torch.int32), 0,
                      torch.ones(5, dtype=torch.bool))
    hit, _, _ = fc.lookup(cache, ids, torch.ones(8, dtype=torch.bool))
    assert int(hit.sum()) <= 4


def test_per_flow_and_per_port_storage_budget():
    """Paper §4: 24 B/port, 20 B/flow, 50k flows ~= 1.2 MB."""
    per_port = 4 + 4 + 4 + 4 + 8
    per_flow = 8 + 4 + 8
    assert per_port == 24 and per_flow == 20
    assert 48 * per_port == 1152
    assert abs(50_000 * 24 - 1.2e6) / 1.2e6 < 0.01


def test_invalidate_ports_drops_dead_egress():
    cache = fc.FlowCache.init(64, device="cpu")
    ids = _ids([11, 12, 13])
    cache = fc.insert(cache, ids, torch.tensor([0, 1, 2], dtype=torch.int32),
                      0, torch.ones(3, dtype=torch.bool))
    cache = fc.invalidate_ports(cache, torch.tensor([True, False, True]))
    hit, out, _ = fc.lookup(cache, ids, torch.ones(3, dtype=torch.bool))
    assert hit.tolist() == [True, False, True]
    assert out.tolist() == [0, -1, 2]


# -------------------------------------------------- against the reference
def _batch(rng, keep, n, capacity):
    """``keep`` (established ids) then new uint32 ids up to ``n`` lanes,
    every lane's cache slot distinct (a constant batch shape, so the
    reference traces once)."""
    used = set((fmix32(_ids(keep)) % capacity).tolist())
    new = []
    while len(keep) + len(new) < n:
        fid = int(rng.integers(1, 2**32))
        slot = int(fmix32(_ids([fid]))[0]) % capacity
        if slot not in used:
            used.add(slot)
            new.append(fid)
    return np.concatenate([np.asarray(keep, np.uint32),
                           np.asarray(new, np.uint32)])


@pytest.mark.parametrize("ports,cands,capacity", [(48, 8, 1 << 16),
                                                  (6, 6, 512)])
def test_switch_equals_the_reference(jref, ports, cands, capacity):
    jnp, rsw, rtables = jref.jnp, jref.switchd, jref.tables
    rng = np.random.default_rng(ports)
    rates = [int(x) for x in rng.choice([40, 100, 200, 400], ports)]
    delays = rng.integers(1000, 300_000, cands)
    caps = rng.choice([40, 100, 200, 400], cands)
    cport = rng.choice(ports, cands, replace=False)
    rtb = rtables.bootstrap_tables(rates, buffer_bytes=6 * 10**9)
    ptb = tables.bootstrap_tables(rates, buffer_bytes=6 * 10**9, device="cpu")
    params = switchd.SwitchParams(idle_timeout_us=2_000)
    rparams = rsw.SwitchParams(idle_timeout_us=2_000)
    r = rsw.make_switch(rtb, jnp.array(delays), jnp.array(caps),
                        jnp.array(cport, jnp.int32), num_ports=ports,
                        cache_capacity=capacity)
    p = switchd.make_switch(ptb, delays, caps, cport, num_ports=ports,
                            cache_capacity=capacity, device="cpu")
    q = np.zeros(ports, np.int64)
    prev = None
    for tick in range(30):
        now = tick * 100
        q = np.maximum(q + rng.integers(-3000, 4000, ports), 0)
        r = rsw.monitor_tick(r, jnp.array(q, jnp.int32), now)
        p = switchd.monitor_tick(p, torch.tensor(q), now)
        for f in dataclasses.fields(p.cong):
            np.testing.assert_array_equal(np.asarray(getattr(r.cong, f.name)),
                                          getattr(p.cong, f.name).numpy())
        fids = _batch(rng, [] if prev is None else prev[:48], 96, capacity)
        prev = fids
        r, ri, rn = rsw.route_batch(r, jnp.array(fids), now, rparams)
        p, pi, pn = switchd.route_batch(p, _ids(fids), now, params)
        np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
        np.testing.assert_array_equal(np.asarray(rn), pn.numpy())
        if tick == 15:
            alive = np.ones(ports, bool)
            alive[cport[0]] = False
            r = rsw.set_port_liveness(r, jnp.array(alive))
            p = switchd.set_port_liveness(p, alive)
        if tick % 10 == 9:
            r = rsw.gc_tick(r, now, rparams)
            p = switchd.gc_tick(p, now, params)
        for f in dataclasses.fields(p.cache):
            np.testing.assert_array_equal(
                np.asarray(getattr(r.cache, f.name)).astype(np.int64),
                getattr(p.cache, f.name).numpy().astype(np.int64),
                err_msg=f"tick {tick} {f.name}")


# --------------------------------------------------------- collision rule
def _colliding_batch():
    """48 lanes over an 8-slot cache: many lanes per slot, some masked,
    some repeated ids, some without a decision."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 2**32, 48, dtype=np.uint64).astype(np.int64)
    ids[10:14] = ids[2]
    out = rng.integers(-1, 6, 48).astype(np.int32)
    do = rng.random(48) < 0.7
    return torch.tensor(ids), torch.tensor(out), torch.tensor(do)


def _expected_insert(cache, ids, out, do):
    """The rule written as a loop: lanes in order, each lane with
    ``do`` and a decision overwrites its slot."""
    fid, oi = cache.flow_id.clone(), cache.out_idx.clone()
    seen, valid = cache.last_seen.clone(), cache.valid.clone()
    slots = (fmix32(ids) % cache.capacity).tolist()
    for lane, s in enumerate(slots):
        if bool(do[lane]) and int(out[lane]) >= 0:
            fid[s], oi[s], seen[s], valid[s] = ids[lane], out[lane], 77, True
    return fid, oi, seen, valid


def test_insert_collision_rule_last_writer_wins():
    ids, out, do = _colliding_batch()
    cache = fc.FlowCache.init(8, device="cpu")
    cache = fc.insert(cache, ids[:4], torch.zeros(4, dtype=torch.int32), 5,
                      torch.ones(4, dtype=torch.bool))
    want = _expected_insert(cache, ids, out, do)
    got = fc.insert(cache, ids, out, 77, do)
    for w, g in zip(want, (got.flow_id, got.out_idx, got.last_seen,
                           got.valid)):
        assert torch.equal(w, g)


def test_refresh_touches_every_slot_a_hit_maps_to():
    cache = fc.FlowCache.init(8, device="cpu")
    slot = torch.tensor([1, 1, 3, 5, 5], dtype=torch.int32)
    hit = torch.tensor([False, True, False, True, True])
    got = fc.refresh(cache, slot, hit, 9)
    assert got.last_seen.tolist() == [0, 9, 0, 0, 0, 9, 0, 0]


def _expected_batch(sw, ids, now):
    """``route_batch``'s rule written as a loop over lanes: each lane
    probes the cache as it was before the batch; a hit (valid slot, same
    key, cached candidate installed on a live port) keeps its candidate
    and refreshes its slot; every other lane takes the fresh decision
    (``ref.lcmp_decide_ref`` over the switch's candidates), and of those
    with a decision the last lane of a slot writes it. Returns
    ``(choice, is_new, (flow_id, out_idx, last_seen, valid), hit slots,
    written slots, lanes whose cached egress died)``."""
    c = sw.cache
    fid, oi = c.flow_id.clone(), c.out_idx.clone()
    seen, valid = c.last_seen.clone(), c.valid.clone()
    alive = (sw.port_alive[sw.cand_port] & sw.cand_valid).tolist()
    F, P = len(ids), len(alive)
    fresh = ref.lcmp_decide_ref(
        ids, sw.c_path.expand(F, P).contiguous(),
        sw.c_cong[sw.cand_port].expand(F, P).contiguous(),
        torch.tensor(alive).expand(F, P).contiguous()).tolist()
    slots = (fmix32(ids) % c.capacity).tolist()
    choice, is_new, hits, writes, died = [], [], set(), {}, 0
    for lane, s in enumerate(slots):
        key, out = int(ids[lane]) & 0xFFFFFFFF, int(c.out_idx[s])
        cached = bool(c.valid[s]) and int(c.flow_id[s]) == key
        died += cached and not alive[max(out, 0)]
        if cached and alive[max(out, 0)]:
            choice.append(out)
            is_new.append(False)
            seen[s] = now
            hits.add(s)
            continue
        choice.append(fresh[lane])
        is_new.append(True)
        if fresh[lane] >= 0:
            writes[s] = (key, fresh[lane])
    for s, (key, out) in writes.items():
        fid[s], oi[s], seen[s], valid[s] = key, out, now, True
    return (torch.tensor(choice, dtype=torch.int32), torch.tensor(is_new),
            (fid, oi, seen, valid), hits, set(writes), died)


@pytest.mark.parametrize("case", ["hit_and_insert_on_one_slot",
                                  "dead_egress", "all_dead"])
def test_route_batch_collisions_follow_the_loop_rule(case):
    """Two batches over an 8-slot cache, each held to the loop rule:
    the first fills the cache, the second brings established, repeated
    and new ids after ``case``'s change of liveness."""
    rng = np.random.default_rng(11)
    sw = _mk(cache_capacity=8)
    first = _ids(rng.integers(0, 2**32, 24, dtype=np.uint64)
                 .astype(np.uint32))
    second = torch.cat([first[::2], first[:3], _ids(
        rng.integers(0, 2**32, 20, dtype=np.uint64).astype(np.uint32))])
    for batch, (ids, now) in enumerate(((first, 100), (second, 200))):
        if batch == 1 and case == "dead_egress":
            cached = sw.cache.out_idx[sw.cache.valid]
            alive = np.ones(6, bool)
            alive[int(sw.cand_port[int(torch.mode(cached).values)])] = False
            sw = switchd.set_port_liveness(sw, alive)
        if batch == 1 and case == "all_dead":
            sw = switchd.set_port_liveness(sw, np.zeros(6, bool))
        choice, new, cache, hits, writes, died = _expected_batch(sw, ids, now)
        sw, got_choice, got_new = switchd.route_batch(sw, ids, now)
        assert torch.equal(got_choice, choice) and torch.equal(got_new, new)
        for want, got in zip(cache, (sw.cache.flow_id, sw.cache.out_idx,
                                     sw.cache.last_seen, sw.cache.valid)):
            assert torch.equal(got, want)
    # the second batch holds what the case names
    if case == "hit_and_insert_on_one_slot":
        assert hits & writes
    elif case == "dead_egress":
        assert hits and writes and died
    else:
        assert (choice == -1).all() and bool(new.all()) and not writes


def test_switch_entries_refuse_other_devices():
    sw = _mk()
    with pytest.raises(ValueError, match="unsupported device"):
        ops.switch_route(sw, torch.arange(4, device="meta"), 0)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.switch_monitor(sw, torch.zeros(6, dtype=torch.int32,
                                           device="meta"), 0)


# ------------------------------------------------------- on the card (cuda)
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels of repro_torch)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_collision_rule_equals_the_cpu(cuda):
    ids, out, do = _colliding_batch()
    base = fc.insert(fc.FlowCache.init(8, device="cpu"), ids[:4],
                     torch.zeros(4, dtype=torch.int32), 5,
                     torch.ones(4, dtype=torch.bool))
    want = fc.insert(base, ids, out, 77, do)
    on = fc.FlowCache(*[x.to(cuda) for x in (base.flow_id, base.out_idx,
                                             base.last_seen, base.valid)])
    got = fc.insert(on, ids.to(cuda), out.to(cuda), 77, do.to(cuda))
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name).cpu(), getattr(want, f.name))


@pytest.mark.cuda
def test_cuda_switch_equals_the_cpu(cuda):
    """The card's switch (its launchers: the CUDA cong_update entry and
    the two switch_route kernels) against the CPU's plain versions, tick
    by tick, bit for bit."""
    rng = np.random.default_rng(3)
    ports, cands = 48, 8
    rates = [int(x) for x in rng.choice([40, 100, 200, 400], ports)]
    delays, caps = rng.integers(1000, 300_000, cands), rng.choice([100, 400],
                                                                  cands)
    cport = rng.choice(ports, cands, replace=False)
    sws = {d: switchd.make_switch(
        tables.bootstrap_tables(rates, buffer_bytes=6 * 10**9, device=d),
        delays, caps, cport, num_ports=ports, cache_capacity=1 << 12,
        device=d) for d in ("cpu", cuda)}
    ops.reset_counts()
    for tick in range(30):
        q = torch.tensor(rng.integers(0, 6 * 10**6, ports))
        fids = _ids(rng.integers(0, 2**32, 512, dtype=np.uint64)
                    .astype(np.uint32))
        res = {}
        for d in sws:
            sws[d] = switchd.monitor_tick(sws[d], q.to(d), tick * 100)
            sws[d], idx, new = switchd.route_batch(sws[d], fids.to(d),
                                                   tick * 100)
            res[d] = (idx, new)
        for a, b in zip(res["cpu"], res[cuda]):
            assert torch.equal(a, b.cpu())
        for f in dataclasses.fields(sws["cpu"].cache):
            assert torch.equal(getattr(sws["cpu"].cache, f.name),
                               getattr(sws[cuda].cache, f.name).cpu())
    counts = ops.counts()
    assert counts["switch_route"] == counts["cong_update"] == 30
    assert counts["lcmp_decide"] == 0


@pytest.mark.cuda
def test_cuda_switch_route_equals_the_plain_version(cuda):
    """4,096 lanes over 64 slots, after a first batch: hits (the first
    batch's last lanes won its slots), misses, repeated ids and many
    lanes bidding for each slot; the card's in-place cache against the
    plain version's new one."""
    rng = np.random.default_rng(5)
    sws = {d: _mk(cache_capacity=64, dev=d) for d in ("cpu", cuda)}
    first = _ids(rng.integers(0, 2**32, 4096, dtype=np.uint64)
                 .astype(np.uint32))
    second = torch.cat([first[2048:], _ids(
        rng.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32))])
    before = ops.counts()["switch_route"]
    for ids, now in ((first, 100), (second, 200)):
        res = {}
        for d in sws:
            sws[d], idx, new = switchd.route_batch(sws[d], ids.to(d), now)
            res[d] = (idx, new)
        for a, b in zip(res["cpu"], res[cuda]):
            assert torch.equal(a, b.cpu())
        for f in dataclasses.fields(sws["cpu"].cache):
            assert torch.equal(getattr(sws["cpu"].cache, f.name),
                               getattr(sws[cuda].cache, f.name).cpu())
    assert 0 < int(res["cpu"][1].sum()) < 4096       # hits and misses
    assert ops.counts()["switch_route"] == before + 2


@pytest.mark.cuda
def test_cuda_switch_refuses_wide_candidate_sets(cuda):
    tb = tables.bootstrap_tables([100] * 9, device=cuda)
    with pytest.raises(ValueError, match="P <= 8"):
        switchd.make_switch(tb, [5_000] * 9, [100] * 9, list(range(9)),
                            num_ports=9, device=cuda)
