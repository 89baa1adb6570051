"""The port's sharded sweep (``run_sweep(use_mesh=True)``,
``repro_torch.netsim.sweep.run_sharded``) on the CPU.

The counterpart of ``tests/test_sweep.py``'s shard_map test: there the
cell axis is sharded over 2 host devices of one XLA program; here each
static group's cells split over a device list, each shard a merged
world run by a worker process of its own. ``[cpu, cpu]`` stands in for
the reference's ``--xla_force_host_platform_device_count=2``. Held here:

- the reference test's grid (testbed8, load 0.3, seed 1, 40 ms; lcmp,
  ecmp, ucmp, split 2 + 1) equals the sequential loop and the merged
  run bit for bit, and the JAX package's ``run_sweep`` within
  ``tests/test_torch_sweep.py``'s bands;
- a fluid and a packet group, the packet one with fewer cells than
  workers: results in input order, ``group_cells`` as unsharded;
- a checked run raises the merged run's ``InvariantError`` (the least
  ``(step, slot)`` over the shards), the corruptor installed in each
  worker by ``tests/torch_mutations.py``'s helpers;
- the device list (``mesh_devices``) with ``torch.cuda`` patched, no
  worker with one device, and a worker that raises or dies is raised
  here with nothing left running.

Two workers serve every test but those of failing workers (one pool
for the module); a pool starts in about 4 s.
"""
import multiprocessing
import pickle

import numpy as np
import pytest
import torch
import torch_mutations as tm

from repro.netsim import experiment as rexp
from repro.netsim import sweep as rsweep
from repro_torch.kernels import ops
from repro_torch.netsim import experiment as pexp
from repro_torch.netsim import sanitize, sweep

FINAL = ("done", "fct_us", "flow_path", "serv_bytes", "c_path", "route_nonce")
P50_BAND, P99_BAND, COMPLETED_BAND = 0.03, 0.10, 0.01   # test_torch_sweep.py
CPU2 = [torch.device("cpu")] * 2
REF_GRID = dict(topology="testbed8", load=0.3, duration_us=40_000, seed=1)
REF_POLICIES = ("lcmp", "ecmp", "ucmp")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The worlds here are small: torch's intra-op threads would only
    contend with the suite's other workers (the sweep's workers take
    this count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool(_one_thread):
    # the corruptor only acts in checked runs (``checks=1``), so the
    # unchecked runs of the other tests share these workers unchanged
    with sweep.SweepWorkers(CPU2, initializer=(
            tm.install, ("first_done_split",))) as workers:
        yield workers


def _ref_specs(**over):
    return [pexp.ExpSpec(policy=p, **{**REF_GRID, **over})
            for p in REF_POLICIES]


def _same(a, b):
    assert a.spec == b.spec
    for n in FINAL:
        np.testing.assert_array_equal(getattr(a.final, n), getattr(b.final, n),
                                      err_msg=f"{b.spec} {n}")
    np.testing.assert_array_equal(a.stats.slowdown, b.stats.slowdown)
    np.testing.assert_array_equal(a.util, b.util)
    assert a.stats.completed == b.stats.completed


@pytest.fixture(scope="module")
def ref_sharded(pool):
    return sweep.run_sharded(_ref_specs(), workers=pool)


def test_reference_grid_equals_sequential_and_merged(ref_sharded):
    seq = sweep.run_sweep(_ref_specs(), sequential=True, device="cpu")
    merged = sweep.run_sweep(_ref_specs(), device="cpu")
    assert (ref_sharded.num_cells, ref_sharded.num_groups,
            ref_sharded.group_cells) == (3, 1, [3])
    for s, m, b in zip(seq.results, merged.results, ref_sharded.results):
        _same(s, b)
        _same(m, b)
    assert all(r.stats.completed > 0 for r in ref_sharded)


def test_reference_grid_within_bands_of_the_reference_sweep(ref_sharded):
    # the reference's own mesh test holds its mesh run equal to this output
    theirs = rsweep.run_sweep([rexp.ExpSpec(policy=p, **REF_GRID)
                               for p in REF_POLICIES])
    for p, m, r in zip(REF_POLICIES, ref_sharded.results, theirs.results):
        m, r = m.stats, r.stats
        assert m.offered == r.offered, p
        assert abs(m.p50 - r.p50) <= P50_BAND * r.p50, (p, m.p50, r.p50)
        assert abs(m.p99 - r.p99) <= P99_BAND * r.p99, (p, m.p99, r.p99)
        assert abs(m.completed - r.completed) <= COMPLETED_BAND * r.offered, p


def test_fluid_and_packet_groups_in_input_order(pool):
    # the packet group's one cell leaves the second worker idle
    fluid = _ref_specs(duration_us=20_000)
    packet = pexp.ExpSpec(policy="lcmp", engine="packet",
                          **{**REF_GRID, "duration_us": 20_000})
    specs = [fluid[0], packet, fluid[1], fluid[2]]
    seq = sweep.run_sweep(specs, sequential=True, device="cpu")
    rep = sweep.run_sharded(specs, workers=pool)
    # unsharded, the fluid cells form one group of 3, the packet cell one
    assert (rep.num_cells, rep.num_groups, rep.group_cells) == (4, 2, [3, 1])
    for a, b in zip(seq.results, rep.results):
        _same(a, b)
    assert [w["device"] for w in rep.workers] == ["cpu", "cpu"]
    assert all(w["startup_s"] > 0 for w in rep.workers)


def test_cell_sums_do_not_depend_on_threads():
    # a CPU worker takes the parent's intra-op thread count: a merged
    # world's sums must not change with it
    specs = _ref_specs(duration_us=20_000)
    one = sweep.run_sweep(specs, device="cpu")
    torch.set_num_threads(3)
    try:
        three = sweep.run_sweep(specs, device="cpu")
    finally:
        torch.set_num_threads(1)
    for a, b in zip(one.results, three.results):
        _same(a, b)


def test_checked_sharded_run_raises_the_merged_error(pool, monkeypatch):
    # the 0.3 cells (shard 0) first complete a flow at step 1, the 0.5
    # cell (shard 1) at step 0: at step 0 shard 0 fails cong_quantized and
    # shard 1 queue_nonneg, the earlier check, which the merged run reports
    specs = [pexp.ExpSpec(policy=p, checks=1, **{**REF_GRID, "load": load})
             for load, p in ((0.3, "lcmp"), (0.3, "ecmp"), (0.5, "lcmp"))]
    monkeypatch.setattr(sanitize, "_MUTATION", tm._first_done_split)
    with pytest.raises(sanitize.InvariantError) as merged:
        sweep.run_sweep(specs, device="cpu")
    monkeypatch.setattr(sanitize, "_MUTATION", None)
    with pytest.raises(sanitize.InvariantError) as sharded:
        sweep.run_sharded(specs, workers=pool)  # installed in each worker
    assert (merged.value.invariant, merged.value.step) == ("queue_nonneg", 0)
    assert (sharded.value.invariant, sharded.value.step, sharded.value.slot,
            str(sharded.value)) == (merged.value.invariant, merged.value.step,
                                    merged.value.slot, str(merged.value))


def test_invariant_error_pickles():
    e = sanitize.InvariantError("ring_head: hist_q slot t != q_bytes", 7, 3)
    back = pickle.loads(pickle.dumps(e))
    assert type(back) is sanitize.InvariantError
    assert (str(back), back.invariant, back.step, back.slot) == (
        str(e), "ring_head", 7, 3)


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("cards,devices,want", [
    (2, None, ["cuda:0", "cuda:1"]), (2, 8, ["cuda:0", "cuda:1"]),
    (2, 1, ["cuda:0"]), (4, 3, ["cuda:0", "cuda:1", "cuda:2"]),
    (1, None, ["cuda:0"])])
def test_mesh_devices_on_cards(monkeypatch, cards, devices, want):
    _cards(monkeypatch, cards)
    assert [str(d) for d in sweep.mesh_devices("cuda", devices)] == want


def test_cpu_and_bad_device_lists(monkeypatch):
    _cards(monkeypatch, 4)      # the CPU's one host device, cards or not
    assert sweep.mesh_devices("cpu", 8) == [torch.device("cpu")]
    with pytest.raises(ValueError, match=">= 0"):
        sweep.mesh_devices("cpu", -1)
    with pytest.raises(ValueError, match="devices or workers"):
        sweep.run_sharded(_ref_specs(), [])


def test_use_mesh_hands_the_cards_to_the_sharded_runner(monkeypatch):
    _cards(monkeypatch, 2)
    seen = []
    monkeypatch.setattr(sweep, "run_sharded",
                        lambda specs, devs: seen.append(devs) or "sharded")
    assert sweep.run_sweep(_ref_specs()[:2], use_mesh=True) == "sharded"
    assert seen == [[torch.device("cuda", 0), torch.device("cuda", 1)]]


def test_one_device_starts_no_worker(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("a worker was started")
    monkeypatch.setattr(sweep, "SweepWorkers", refuse)
    specs = _ref_specs(duration_us=10_000)
    for devices in (None, 1, 2):
        rep = sweep.run_sweep(specs, use_mesh=True, devices=devices,
                              device="cpu")
        assert rep.workers is None and rep.group_cells == [3]
    def in_process(*_, **__):
        raise LookupError("the merged run in process")
    _cards(monkeypatch, 2)
    monkeypatch.setattr(sweep, "run_sharded", refuse)
    monkeypatch.setattr(sweep, "build_group", in_process)
    with pytest.raises(LookupError, match="in process"):
        sweep.run_sweep(specs, use_mesh=True, devices=1)


def test_worker_counts_join_this_process():
    ops.reset_counts()
    ops.add_counts({"monitor_tick": 3, "decide": 1})
    ops.add_counts({"monitor_tick": 2})
    got = ops.counts()
    ops.reset_counts()
    assert (got["monitor_tick"], got["decide"], got["route_arrivals"]) == (
        5, 1, 0)


def _children():
    return {p.pid for p in multiprocessing.active_children()}


@pytest.mark.parametrize("initializer,devices,match", [
    # the other worker is still running its shard when the failure comes
    ((tm.install_raise_at, (3,)), CPU2,
     "ValueError: seeded worker failure at step 3"),
    ((tm.exit_now, (3,)), CPU2[:1], r"died \(exit code 3\)")])
def test_failed_worker_is_raised_and_nothing_is_left(initializer, devices,
                                                     match):
    before = _children()
    specs = _ref_specs(duration_us=10_000, checks=1)
    with pytest.raises(RuntimeError, match=match):
        sweep.run_sharded(specs, devices, initializer=initializer)
    assert _children() <= before
