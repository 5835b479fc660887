"""The control of each cell's `correct`: the reference in the next precision
down (an fp8 backbone) in the program's place. On the card, at the cell's
own size, it fails one of the cell's limits on every seed while the
program passes them all (`-m cuda`, three seeds a cell). On the CPU the
same readings run at a tiny size, where the planted faults read far
above the program."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import control
from benchmark.run import BENCH_DIR, resolve
from benchmark.tests._tiny import tiny_spec

CELLS = ("vits8-eval-default", "vitb8-eval-default", "vits8-train-b32", "vits8-serve-open")
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def _spec(cell):
    from benchmark.tests._serve import CELL, serve_spec

    return serve_spec() if cell == CELL["name"] else resolve(cell)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the readings are taken at the cell's own size")
    limits = json.loads((BENCH_DIR / "limits" / f"{cell}.json").read_text())
    for row in control.readings(_spec(cell), list(SEEDS), torch.device("cuda", 0)):
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row


def test_faults_read_far_above_the_program_at_a_tiny_size():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ev = control.readings(tiny_spec("vits8-eval-default"), [7], torch.device("cpu"))[0]
        tr = control.readings(tiny_spec("vits8-train-b32"), [7], torch.device("cpu"))[0]
    finally:
        torch.set_num_threads(old)
    assert ev["program"]["count_gap"] == 0 < ev["faults"]["half_batch"]["count_gap"]
    assert ev["faults"]["answer_altered"]["label_gap"] > 10 * ev["program"]["label_gap"]
    assert tr["faults"]["half_batch"]["grad_gap"] > 10 * tr["program"]["grad_gap"]
    assert set(tr["control"]) == set(tr["program"]) == {"loss_gap", "grad_gap",
                                                        "update_gap_median"}
