"""With the timed path broken underneath, a run comes out not correct:
for each fault a cell can have, and for the lower-precision control (the
program's bf16 compute path), at a size the CPU holds.  The chip's
readings at the cells' own size come from ``python -m portbench.control``.
"""
from __future__ import annotations

import pytest

from portbench import control
from portbench.tests import tiny

CASES = [("tgn-train", "unchanged"), ("tgn-train", "half_batch"),
         ("tgat-train", "unchanged"), ("tgat-train", "half_batch"),
         ("tgn-serve", "unchanged"), ("tgn-serve", "answer")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    cell = tiny.cell(name)
    (_, nums), = control.readings(cell, [5], fault=fault, seconds=0.5,
                                  device="cpu")
    over = [k for k, lim in cell.limits.items() if not nums[k] <= lim]
    assert over, nums


@pytest.mark.parametrize("name", ["tgn-train", "tgat-train", "tgn-serve"])
def test_bf16_control_is_not_correct(name):
    cell = tiny.cell(name)
    (_, nums), = control.readings(cell, [6], dtype="bfloat16",
                                  seconds=0.5, device="cpu")
    over = [k for k, lim in cell.limits.items() if not nums[k] <= lim]
    assert over, nums
