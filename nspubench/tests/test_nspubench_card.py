"""The tiny cells on the card (skip without one): the kernels' path, the
device trace and the comparison end to end."""
from __future__ import annotations

import io
import json

import pytest

from nspubench import guard, run
from nspubench.tests.conftest import TINY_CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_tiny_cell_on_the_card(tiny_root, card, cell):
    buf = io.StringIO()
    run.run(cell, 3, 0.5, True, root=tiny_root, device=card, t_start=0.0, out=buf,
                   loaded_before=guard.forbidden_modules())
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
