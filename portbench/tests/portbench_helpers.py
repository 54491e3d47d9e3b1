"""Small cells for the CPU tests: a cell's files at a tiny grid."""

import dataclasses
import os

from portbench import manifest

CELLS = ["wave1d_headline.direct", "heat1d_headline.batch8", "wave1d_headline.gmres_f64", "heat2d_lumped.batch8",
         "wave2d_consistent.batch8_f64"]


def tiny(name: str, N_x: int = 64, N_t: int = 32, trace: bool = False, root: str = manifest.ROOT):
    """Cell ``name`` (``<config>.<traffic>``) from its files, on an N_x x N_t grid."""
    config, traffic = name.split(".", 1)
    cell = manifest.make_cell(name, config, traffic, 1, trace, root)
    pc = dict(cell.config["problem_config"], N_x=N_x, N_t=N_t)
    return dataclasses.replace(cell, config=dict(cell.config, problem_config=pc))


def consistent_cell(traffic: str, N_x: int, N_t: int, limit: float = 1.0) -> manifest.Cell:
    """A 2D consistent-mass wave cell on an N_x x N_t grid under the traffic
    mix ``traffic``, built from dicts (no configuration of the benchmark has
    that space yet)."""
    pc = {"N_x": N_x, "N_t": N_t, "T": 2.0, "gamma": 1.0, "dim": 2, "scaled": True, "mass": "consistent"}
    return manifest.Cell(name=f"wave2d_consistent.{traffic}", chips=1, config={"problem": "wave", "problem_config": pc},
                         traffic=manifest.load_json(os.path.join(manifest.HERE, "traffic", traffic + ".json")),
                         limits={"rel_residual": limit}, metrics=[])


def mesh_config(N: int, N_t: int, jitter: float = 0.18, problem: str = "wave") -> dict:
    """A configuration on the perturbed unit-square mesh of ``portbench/mesh.py``."""
    pc = {"N_x": N, "N_t": N_t, "T": 2.0, "gamma": 1.0, "dim": 2, "scaled": True, "mass": "consistent"}
    return {"name": f"mesh_n{(N - 1) ** 2}", "problem": problem, "problem_config": pc,
            "mesh": {"kind": "perturbed_unit_square", "jitter": jitter, "seed": 0}}


def mesh_cell(traffic: str, N: int, N_t: int, limit: float = 1.0, **kw) -> manifest.Cell:
    """A cell of ``mesh_config(N, N_t, **kw)`` under the traffic mix ``traffic``."""
    config = mesh_config(N, N_t, **kw)
    return manifest.Cell(name=f"{config['name']}.{traffic}", chips=1, config=config,
                         traffic=manifest.load_json(os.path.join(manifest.HERE, "traffic", traffic + ".json")),
                         limits={"rel_residual": limit}, metrics=[])
