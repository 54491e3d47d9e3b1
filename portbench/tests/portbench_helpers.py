"""Small cells for the CPU tests: a cell's files at a tiny grid."""

import dataclasses

from portbench import manifest

CELLS = ["wave1d_headline.direct", "heat1d_headline.batch8", "wave1d_headline.gmres_f64"]


def tiny(name: str, N_x: int = 64, N_t: int = 32, trace: bool = False, root: str = manifest.ROOT):
    """Cell ``name`` (``<config>.<traffic>``) from its files, on an N_x x N_t grid."""
    config, traffic = name.split(".", 1)
    cell = manifest.make_cell(name, config, traffic, 1, trace, root)
    pc = dict(cell.config["problem_config"], N_x=N_x, N_t=N_t)
    return dataclasses.replace(cell, config=dict(cell.config, problem_config=pc))
