"""A configuration, a mix and a metric added as new files are found by
the names ``BENCHMARK.json`` gives them, with no edit to a file that is
there."""

import json
import os
import shutil

import pytest

from harness import registry
from harness.traffic import Mix


@pytest.fixture
def copy(tmp_path, monkeypatch):
    dst = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(registry, "HERE", str(dst))
    return dst


def test_new_files_are_found_by_name(copy):
    cfg = registry.config("ssb-sf20")
    cfg.update(name="ssb-sf1", scale_factor=1)
    (copy / "configs" / "ssb-sf1.json").write_text(json.dumps(cfg))
    mix = json.loads((copy / "mixes" / "flights.json").read_text())
    mix["templates"] = mix["templates"][:2]
    (copy / "mixes" / "two.json").write_text(json.dumps(mix))
    (copy / "metrics" / "queries_traced.py").write_text(
        "def read(trace):\n    return float(trace.n_queries)\n")

    assert registry.config("ssb-sf1")["scale_factor"] == 1
    assert Mix(registry.mix_path("two")).names == ["q1.1", "q1.2"]

    class T:
        n_queries = 3
    assert registry.metric_reader("queries_traced").read(T()) == 3.0


def test_metrics_by_cell():
    b = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
         "per_layer": [{"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in registry.end_to_end(b, "y")] == ["a"]
    assert [m["name"] for m in registry.per_layer(b, "y")] == ["c"]
    assert registry.per_layer(b, "x") == []


def test_every_metric_of_benchmark_json_has_a_reader():
    b = registry.benchmark_json()
    for m in b["per_layer"]:
        assert callable(registry.metric_reader(m["name"]).read)
    assert os.path.isdir(os.path.join(registry.HERE, "metrics"))
