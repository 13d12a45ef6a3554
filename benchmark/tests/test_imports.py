"""Nothing under ``benchmark/`` imports JAX or the JAX package: the top
level of every imported name is compared whole, so ``harkdb_tpu_torch``
passes and ``harkdb_tpu`` does not."""

import ast
import os

from conftest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "harkdb_tpu"}


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def sources():
    for d, _dirs, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    found = {(p, m) for p in sources() for m in imported_tops(p)
             if m in FORBIDDEN}
    assert not found, found


def test_the_port_is_imported_and_passes():
    tops = {m for p in sources() for m in imported_tops(p)}
    assert "harkdb_tpu_torch" in tops


def test_run_refuses_a_process_holding_jax(monkeypatch):
    import sys
    import types

    import run

    monkeypatch.setitem(sys.modules, "harkdb_tpu.api", types.ModuleType("x"))
    assert run.loaded_forbidden() == ["harkdb_tpu.api"]
    monkeypatch.delitem(sys.modules, "harkdb_tpu.api")
    monkeypatch.setitem(sys.modules, "harkdb_tpu_torch_x", types.ModuleType("y"))
    assert run.loaded_forbidden() == []
