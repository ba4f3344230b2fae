"""``BENCHMARK.json`` and the files it names, found by name.

    configs/<config>.json       a configuration: model layers, scheme,
                                input, serving settings, the limits of its
                                correctness check, source, reduced, assumed
    workloads/<cell>.json       a cell's traffic: loop, clients or rate,
                                request sizes, frames, sample sizes
    metrics/<metric>.py         one metric's reader: ``read(run)``

A cell, a configuration or a metric is added by adding its file and its
entry in ``BENCHMARK.json``; no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: Path = ROOT) -> Dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def _named(root: Path, folder: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return Path(root) / "portbench" / folder / f"{name}{suffix}"


def config(name: str, root: Path = ROOT) -> Dict:
    return json.loads(_named(root, "configs", name, ".json").read_text())


def workload(name: str, root: Path = ROOT) -> Dict:
    return json.loads(_named(root, "workloads", name, ".json").read_text())


def reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = _named(root, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: Dict, section: str, cell_name: str) -> List[Dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell reports: those naming it, and those naming no cells."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]
