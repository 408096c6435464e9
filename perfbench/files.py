"""Finding a cell's pieces by name: the files under ``perfbench/`` and the
cell's entry in ``BENCHMARK.json``.  Nothing here imports torch or the
port."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def config(name: str, base: str = HERE) -> dict:
    return load_json(base, "configs", f"{name}.json")


def traffic(name: str, base: str = HERE) -> dict:
    return load_json(base, "traffic", f"{name}.json")


def workload(name: str, base: str = HERE) -> dict:
    return load_json(base, "workloads", f"{name}.json")


def reader(kind: str, name: str, base: str = HERE):
    """The ``read`` function of ``<kind>/<name>.py`` (``kind`` is
    ``metrics`` or ``end_to_end``).  A metric split by cells,
    ``<metric>.<cells>``, without a file of its own is read by
    ``<metric>.py``.  Names may hold dots, so the file is loaded by path."""
    path = os.path.join(base, kind, f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(base, kind, f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, section: str) -> List[Dict]:
    """The ``section`` metrics (``end_to_end`` or ``per_layer``) a cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
