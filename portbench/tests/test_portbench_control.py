"""The control of ``correct``: the reference's direct solve one precision below the traffic's,
put in the program's place, comes out not correct, while the program passes (CPU, a small grid)."""

import pytest
import torch

from portbench import cell as cellmod
from portbench.reference import solve as rs
from portbench_helpers import CELLS, tiny

torch.set_num_threads(1)


def control_in_place(cell):
    problem, pc = cell.config["problem"], cell.config["problem_config"]
    precision = rs.control_precision(cell.traffic)
    return lambda fn: (lambda b: (rs.solve(problem, pc, b.to(torch.float64), precision), None))


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_and_the_program_is(name):
    cell = tiny(name, N_x=128, N_t=64)
    seed = 2**31 + 99
    program = cellmod.run_cell(cell, seed, 0.1, False, device="cpu")
    control = cellmod.run_cell(cell, seed, 0.1, False, device="cpu", wrap=control_in_place(cell))
    assert program["correct"] and not control["correct"]
    assert control["check"]["rel_residual"]["value"] > 3 * program["check"]["rel_residual"]["value"]
