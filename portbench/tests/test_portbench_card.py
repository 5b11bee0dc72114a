"""On the card: each cell at a tiny size comes out correct and its bf16
control does not.  Run there with
``python -m pytest --noconftest -m cuda portbench/tests``."""
from __future__ import annotations

import pytest

from portbench import control
from portbench.tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tgn-train", "tgat-train", "tgn-serve"])
def test_cell_and_control_on_card(card, name):
    cell = tiny.cell(name)
    (_, good), = control.readings(cell, [8], seconds=0.5, device=card)
    assert all(good[k] <= lim for k, lim in cell.limits.items()), good
    (_, low), = control.readings(cell, [8], dtype="bfloat16", seconds=0.5,
                                 device=card)
    assert any(not low[k] <= lim for k, lim in cell.limits.items()), low
