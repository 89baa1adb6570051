"""The reference numbers of ``chip_smoke.py``'s phase ``sweep``.

Each cell of ``chip_smoke.SWEEPS`` is held on the card to the JAX
package's result on the same spec: the cells a run of ``chip_smoke.RUNS``
covers take ``REFERENCE`` (pinned by ``tests/test_torch_fluid_runs.py``),
the others ``SWEEP_REFERENCE``, pinned here to what the JAX package's
``run_sweep`` computes for them on the CPU, one call per group.
"""
import os
import sys

import pytest

from repro.netsim import experiment as rexp
from repro.netsim import sweep as rsweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


CS = _chip_smoke()


def test_every_sweep_cell_has_a_reference_number():
    names = []
    for group in CS.SWEEPS:
        for name, _, run in CS.sweep_cells(group):
            assert (run is None) == (name in CS.SWEEP_REFERENCE), name
            assert run is None or run in CS.REFERENCE, name
            names.append(name)
    assert sorted(CS.SWEEP_REFERENCE) == sorted(
        n for n in names if n in CS.SWEEP_REFERENCE)
    assert len(names) == len(set(names)) == 22


@pytest.mark.parametrize("group", sorted({n.split("/")[0]
                                          for n in CS.SWEEP_REFERENCE}))
def test_sweep_reference_numbers_are_the_jax_packages(group):
    cells = [(name, kw) for name, kw, run in CS.sweep_cells(group)
             if run is None]
    rep = rsweep.run_sweep([rexp.ExpSpec(**kw) for _, kw in cells])
    for (name, _), res in zip(cells, rep.results):
        p50, p99, completed, offered = CS.SWEEP_REFERENCE[name]
        st = res.stats
        assert abs(st.p50 - p50) <= 0.005 * p50, (name, st.p50)   # printed
        assert abs(st.p99 - p99) <= 0.005 * p99, (name, st.p99)   # to 4 digits
        assert (st.completed, st.offered) == (completed, offered), name


def test_every_run_is_driven_alone_or_as_a_group_cell():
    cells = {run for g in CS.SWEEPS for _, _, run in CS.sweep_cells(g) if run}
    assert set(CS.ALONE) <= set(CS.RUNS)
    assert set(CS.RUNS) == set(CS.ALONE) | cells
    packet_cells = {run for grid in CS.FIDELITY_DURATION
                    for _, _, run in CS.fidelity_cells(grid) if run}
    assert set(CS.PACKET_ALONE) <= set(CS.PACKET_RUNS)
    assert set(CS.PACKET_RUNS) == set(CS.PACKET_ALONE) | packet_cells
    # a merged cell of each engine is held to its run alone on the card
    assert set(CS.ALONE) & cells and set(CS.PACKET_ALONE) & packet_cells
    for a, b, _ in CS.ORDERINGS:
        assert {a, b} <= set(CS.RUNS)
    for a, b, _ in CS.PACKET_ORDERINGS:
        assert {a, b} <= set(CS.PACKET_RUNS)


def test_orderings_read_runs_alone_and_group_cells():
    runs = {"a": {"p99": 1.0}}
    groups = {"g": {"per_cell": [{"run": "b", "p99": 2.0},
                                 {"run": None, "p99": 0.0}]}}
    CS.check_orderings(runs, groups, {"a": 0, "b": 0}, [("a", "b", "p99")])
    with pytest.raises(RuntimeError, match="p99: b < a"):
        CS.check_orderings(runs, groups, {"a": 0, "b": 0}, [("b", "a", "p99")])
    with pytest.raises(RuntimeError, match=r"missing \['c'\]"):
        CS.check_orderings(runs, groups, {"a": 0, "c": 0}, [])
