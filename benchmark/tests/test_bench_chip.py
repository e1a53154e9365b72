"""On the card, at each cell's own size: the program passes the check and
both controls fail it.  Skips without a CUDA device."""

import pytest

from benchmark.harness import cells, runner

CELLS = ("dl1x1.b128.snr25", "tm4.b128.snr28")


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_the_controls_fail_and_the_program_passes_on_the_card(cuda, name):
    cell = cells.find(name)
    r = runner.run(cell, 2**31 + 99, 2.0, device="cuda")
    assert r["correct"], runner.describe(r)
    for control in runner.CONTROLS:
        c = runner.run(cell, 2**31 + 99, 0.5, device="cuda", control=control)
        assert not c["correct"], (control, runner.describe(c))
