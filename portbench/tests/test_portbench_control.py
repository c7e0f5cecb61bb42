"""The control: the plain reference computed in bfloat16 (the nearest
precision below the float32 the configurations state), put in the
program's place, has to come out not correct under each cell's limits.

On the CPU at a toy size (20k splats, 256x256); on the card at the cells'
own sizes with `-m cuda` (`readings.py` prints the same readings with the
program's beside them)."""

import pytest
import torch

import _portbench_toy as toy
import readings
from harness import check, scene

CELLS = ["inria6m.orbit", "multi3x1m.orbit", "inria6m.edit", "inria6m.served"]


def _fails(cell, numbers) -> bool:
    ok, _ = check.verdict({**{k: 0 for k in cell.limits}, **numbers}, cell.limits)
    return not ok


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_toy_size(workload):
    cell = toy.toy_cell(workload)
    models = scene.make_models(cell.config, toy.SEED, "cpu")
    numbers = readings.control_numbers(cell, models, toy.SEED, "cpu")
    assert _fails(cell, numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control at the cell's own size")
    cell = toy.cell(workload)
    for seed in (4100000001, 4100000002, 4100000003):
        models = scene.make_models(cell.config, seed, "cuda")
        numbers = readings.control_numbers(cell, models, seed, "cuda")
        assert _fails(cell, numbers), numbers
        del models
