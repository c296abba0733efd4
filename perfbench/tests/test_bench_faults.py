"""The check fails a run whose timed path is broken, and passes one whose
path is sound: the whole run (set-up, window, check) at tiny sizes on the
CPU, the harness's look for a chip skipped; and the control (the
reference in the program's place at the precision below the
configuration's) reads above the sound run."""

import math

import pytest
import torch

from perfbench import control, faults, harness
from perfbench.tests import tiny

SEED = 2 ** 31 + 12345


def limits(cell):
    """Limits above the tiny runs' own rounding, far below a fault's."""
    if cell == "serve-b8":
        return {"length_mismatch": 0, "log_d_gap": 0.05, "pitch_gap": 0.05, "energy_gap": 0.05,
                "mel_gap": 0.05, "wav_gap": 0.1}
    return {"loss_gap": 1e-3, "grad_gap": 0.1, "change_gap": 0.1}


CASES = [(cell, None) for cell in tiny.CELLS] + [
    (cell, name) for cell in tiny.CELLS
    for name in faults.BY_ENTRY[tiny.mix(cell)["entry"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    torch.manual_seed(0)
    patch = None if fault is None else faults.BY_ENTRY[tiny.mix(cell)["entry"]][fault]
    res, checks = harness.run_cell(cell, SEED, 0.5, False, limits=limits(cell), patch=patch,
                                   **tiny.cell_args(cell))
    assert res["attempted"] > 0
    assert res["correct"] is (fault is None), checks


@pytest.mark.parametrize("cell", ["serve-b8", "base-train-b80"])
def test_control_reads_above_the_program(cell):
    args = tiny.cell_args(cell)
    c = harness.driver(args["mix"]["entry"]).Cell(args["cfg"], args["mix"], SEED, torch.device("cpu"))
    c.setup()
    if cell == "serve-b8":
        c.run_window(0.3)
    c.free()
    sound = c.check()
    low = control.control_readings(c)
    assert all(math.isfinite(v) for v in low.values())
    assert any(low[k] > 3 * sound[k] for k in sound if sound[k] > 0), (sound, low)
