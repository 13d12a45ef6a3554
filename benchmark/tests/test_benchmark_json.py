"""``BENCHMARK.json`` keeps to the benchmark's contract where a test can
see it: names, units and text fields of the allowed characters and
lengths, every named file present, every metric's layer and the one
end-to-end metric it moves."""

import json
import os
import re

from conftest import HERE

ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in b["paths"])
    assert len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_and_units():
    b = bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for group in ("end_to_end", "per_layer"):
        for m in b[group]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert one_line(w["why"]) and w["chips"] in (1, 4)
    for c in b["configs"]:
        assert one_line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_named_file_is_there():
    b = bench()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert os.path.isfile(os.path.join(HERE, "mixes",
                                           w["traffic"] + ".json"))
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))


def test_layers_and_moves():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert one_line(m["layer"])
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    assert {c["config"] for c in b["workloads"]} == {
        c["name"] for c in b["configs"]}
