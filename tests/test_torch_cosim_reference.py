"""The reference numbers of ``chip_smoke.py``'s phase cosim, pinned to
what the JAX package computes on the CPU.

Each cell of fig_training's design point (``chip_smoke.cosim_cells``: the
degraded wan2000, 2 models x 5 policies x both engines) is held on the
card to ``COSIM_REFERENCE``, the strict iteration p50/p99, iterations
done and completions of the reference's ``run_sweep`` on the same specs,
and each (engine, model)'s LCMP ordering flag to ``COSIM_ORDERING``
(False in all four in the reference). The JAX package alone runs here;
about 45 s on one worker.
"""
import os
import sys

from repro.cosim import build_plan, iteration_stats
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


def test_every_cosim_cell_has_a_reference_number():
    names = [name for name, _ in CS.cosim_cells()]
    assert sorted(names) == sorted(CS.COSIM_REFERENCE)
    assert len(names) == len(set(names)) == 20
    assert CS.COMPLETION_FLOOR == 0.99       # benchmarks/figures.py's


def test_cosim_reference_numbers_are_the_jax_packages():
    cells = CS.cosim_cells()
    rep = rsweep.run_sweep([rexp.ExpSpec(**kw) for _, kw in cells])
    scen, table = rexp.build_world(CS.COSIM["topology"])
    numbers = {}
    for (name, _), res in zip(cells, rep.results):
        it = iteration_stats(build_plan(res.spec, scen, table), res.flows,
                             res.final)
        numbers[name] = (it.pct_strict(50), it.pct_strict(99), it.iters_done,
                         res.stats.completed, res.stats.offered)
        p50, p99, iters, completed, offered = CS.COSIM_REFERENCE[name]
        assert abs(numbers[name][0] - p50) <= 0.005 * p50, (name, numbers[name])
        assert abs(numbers[name][1] - p99) <= 0.005 * p99, (name, numbers[name])
        assert numbers[name][2:] == (iters, completed, offered), name
    assert CS.cosim_orderings(numbers) == CS.COSIM_ORDERING
