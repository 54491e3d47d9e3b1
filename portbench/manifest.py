"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration ``<name>`` is ``configs/<name>.json``;
- a traffic mix ``<name>`` is ``traffic/<name>.json``;
- a cell ``<name>`` has its limits of ``correct`` in ``workloads/<name>.json``;
- a metric ``<name>`` is read by ``metrics/<name>.py`` (``read(run)``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    metrics: List[Metric]  # of the kind the run reports


def load_reader(name: str, here: str = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``; a name may hold '.' and '-', so the
    file is loaded by its path."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The entries of ``bench[kind]`` that ``cell`` reports: a metric with a
    ``workloads`` key in the cells it lists; an end-to-end metric without
    one everywhere; a per-layer metric without one wherever its ``moves``
    metric is reported."""
    e2e = {m["name"] for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_cell(name: str, trace: bool, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    entry = entries[0]
    return make_cell(name, entry["config"], entry["traffic"], int(entry["chips"]), trace, root, bench)


def make_cell(name: str, config: str, traffic: str, chips: int, trace: bool, root: str = ROOT,
              bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of configuration ``config`` under ``traffic``, its
    files found by name, with the metrics ``BENCHMARK.json`` gives it."""
    bench = bench if bench is not None else benchmark(root)
    here = os.path.join(root, "portbench")
    kind = "per_layer" if trace else "end_to_end"
    metrics = [Metric(m["name"], m["unit"], load_reader(m["name"], here)) for m in cell_metrics(bench, name, kind)]
    return Cell(
        name=name,
        chips=chips,
        config=load_json(os.path.join(here, "configs", config + ".json")),
        traffic=load_json(os.path.join(here, "traffic", traffic + ".json")),
        limits=load_json(os.path.join(here, "workloads", name + ".json"))["limits"],
        metrics=metrics,
    )
