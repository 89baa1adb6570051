"""The reference numbers of ``chip_smoke.py``'s phase ``packet``, pinned
to what the JAX package computes on the CPU.

Each run of ``chip_smoke.PACKET_RUNS`` is held on the card to
``PACKET_REFERENCE``, the reference's ``run_experiment`` on the same
spec. The JAX package alone runs here; about a minute on one worker.
The fidelity grids' numbers are in test_torch_fidelity_reference.py.
"""
import os
import sys

import pytest

from repro.netsim import experiment as rexp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


CS = _chip_smoke()


def _pinned(stats, nums, what):
    p50, p99, completed, offered = nums
    assert abs(stats.p50 - p50) <= 0.005 * p50, (what, stats.p50)  # printed
    assert abs(stats.p99 - p99) <= 0.005 * p99, (what, stats.p99)  # to 4 digits
    assert (stats.completed, stats.offered) == (completed, offered), what


def test_every_packet_run_and_fidelity_cell_has_a_reference_number():
    assert sorted(CS.PACKET_RUNS) == sorted(CS.PACKET_REFERENCE)
    assert all(kw["engine"] == "packet" for kw in CS.PACKET_RUNS.values())
    names = []
    for grid in CS.FIDELITY_DURATION:
        cells = CS.fidelity_cells(grid)
        assert len(cells) == 12
        for name, kw, run in cells:
            assert (run is None) == (name in CS.FIDELITY_REFERENCE), name
            assert run is None or kw["engine"] == "packet", name
            names.append(name)
    assert len(names) == len(set(names))
    assert sorted(CS.FIDELITY_REFERENCE) == sorted(
        n for n in names if n in CS.FIDELITY_REFERENCE)


@pytest.mark.parametrize("run", list(CS.PACKET_RUNS))
def test_packet_reference_numbers_are_the_jax_packages(run):
    stats, _, _ = rexp.run_experiment(rexp.ExpSpec(**CS.PACKET_RUNS[run]))
    _pinned(stats, CS.PACKET_REFERENCE[run], run)
