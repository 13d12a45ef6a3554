"""The benchmark's own tests: the harness, the generators, the plain
reference and the port through ``Context(device="cpu")`` at a small scale.
Run from the repository's root: ``python -m pytest benchmark/tests``."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def cell_entry(name: str) -> dict:
    """A ``workloads`` entry: from ``BENCHMARK.json``, or, for a cell whose
    files are here and whose entry is not yet (PERF.md's open questions),
    the entry ``<config>.<traffic>`` names on one chip."""
    from harness import registry

    for w in registry.benchmark_json()["workloads"]:
        if w["name"] == name:
            return w
    config, traffic = name.rsplit(".", 1)
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}
