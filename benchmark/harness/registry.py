"""Finds what ``BENCHMARK.json`` names, by name, in files of their own:

* a cell: an entry of ``workloads``;
* a configuration: ``configs/<config>.json``, which names its generator
  (``gen/<generator>.py``) and its plain reference
  (``reference/<reference>.py``);
* a traffic mix: ``mixes/<traffic>.json``;
* a per-layer metric: ``metrics/<name>.py`` with ``read(trace)``.

A later change adds any of them by adding files and entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def benchmark_json() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def mix_path(traffic: str) -> str:
    return os.path.join(HERE, "mixes", f"{traffic}.json")


def module(kind: str, name: str) -> ModuleType:
    """``gen.<name>`` or ``reference.<name>``: the benchmark's folder is on
    ``sys.path``."""
    return importlib.import_module(f"{kind}.{name}")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded by path (a metric name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: dict, cell_name: str) -> list:
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])]
