"""The control on the card: the reference with its per-link sums one
precision below the configuration's (float32 for float64) has to read
past the comparison's limits, where the program reads within them:
fig5-fluid's grid at its own size (a grid's time is the host's per
step, whatever its cells); ``portbench/control.py`` gives the readings
of every cell on more seeds."""
import pytest

from portbench import cells, compare
from portbench.control import worst


@pytest.mark.cuda
def test_float32_control_fails_where_the_program_passes(card):
    from portbench.reference import grid as refgrid
    from repro_torch.netsim import sweep
    from repro_torch.netsim.experiment import ExpSpec

    cell = cells.load_cell("testbed8.fig5-fluid")
    fields = cell.grid(1234567891)
    rep = sweep.run_sweep([ExpSpec(**f) for f in fields], device=card)
    prog = {i: compare.cell_view(r) for i, r in enumerate(rep.results)}
    ref = refgrid.run_grid(fields, card, "float64")
    ctl = refgrid.run_grid(fields, card, "float32")
    lower = worst({i: compare.numbers(prog[i], ref[i]) for i in ref})
    upper = worst({i: compare.numbers(ctl[i], ref[i]) for i in ref})
    assert all(lower[k] <= lim for k, lim in cell.limits.items()), lower
    assert any(upper[k] > lim for k, lim in cell.limits.items()), upper
