"""The layers of harkdb_tpu_torch point one way.

From left to right:

    config, utils/metrics → columnar, io → kernels → prims → ops, sql
    → plan (with utils/checks) → parallel → api, __main__ → the package root

A module imports only from its own layer or from layers to its left. Every
module of the package is read with ``ast``, and every import counts:
those at top level and those inside a function alike. Besides the order:
no module imports an underscore name from another subpackage, and only
``kernels/`` imports the CUDA library's loader ``kernels._lib``.
"""

import ast
from pathlib import Path

PACKAGE = "harkdb_tpu_torch"
PACKAGE_DIR = Path(__file__).resolve().parent.parent / PACKAGE

#: Each layer's modules, left to right, by dotted prefix under the package;
#: the longest prefix decides (``utils.checks`` sits with ``plan``, the
#: rest of ``utils`` at the left end). "" is the package root alone: its
#: ``__init__`` gathers the public face.
LAYERS = [
    ("config", "utils"),
    ("columnar", "io"),
    ("kernels",),
    ("prims",),
    ("ops", "sql"),
    ("plan", "utils.checks"),
    ("parallel",),
    ("api", "__main__"),
    ("",),
]

#: The only imports that point to the right: (importing module, imported
#: module) → the reason.
EXCEPTIONS = {
    ("__main__", ""):
        "the CLI is a program on the package's public face: it takes "
        "Context from the package root, as any user does",
    ("parallel.multihost", ""):
        "worker_sql checks the mesh end to end across real processes "
        "through the public Context, as a user program would",
}

#: The CUDA library's loader, which only the kernel wrappers may import.
LIBRARY_LOADER = "kernels._lib"


def _modules() -> dict:
    """Dotted name under the package ("" for the root) → its source file."""
    out = {}
    for path in sorted(PACKAGE_DIR.rglob("*.py")):
        parts = list(path.relative_to(PACKAGE_DIR).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        out[".".join(parts)] = path
    return out


MODULES = _modules()


def _imports(name: str, path: Path):
    """``(line, target module, imported name or None)`` for every import of
    the package in one module, function-local ones included; a name that
    is itself a module of the package becomes the target."""
    is_pkg = path.name == "__init__.py"
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == PACKAGE or alias.name.startswith(
                        PACKAGE + "."):
                    yield node.lineno, alias.name[len(PACKAGE) + 1:], None
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = name.split(".") if name else []
                if not is_pkg:
                    base = base[:-1]
                base = base[:len(base) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            elif node.module == PACKAGE:
                mod = ""
            elif (node.module or "").startswith(PACKAGE + "."):
                mod = node.module[len(PACKAGE) + 1:]
            else:
                continue
            for alias in node.names:
                sub = f"{mod}.{alias.name}" if mod else alias.name
                if sub in MODULES:
                    yield node.lineno, sub, None
                else:
                    yield node.lineno, mod, alias.name


def _layer(module: str) -> int:
    best, at = None, -1
    for i, prefixes in enumerate(LAYERS):
        for p in prefixes:
            hit = module == p if p == "" else (
                module == p or module.startswith(p + "."))
            if hit and len(p) > at:
                best, at = i, len(p)
    return best


def _subpackage(module: str) -> str:
    return module.split(".")[0]


def _sites(check) -> list:
    out = []
    for name, path in MODULES.items():
        for line, target, imported in _imports(name, path):
            if check(name, target, imported):
                what = target + (f" {imported}" if imported else "")
                out.append(f"{name or PACKAGE}:{line} imports {what}")
    return out


def test_every_module_has_a_layer():
    assert [m for m in MODULES if _layer(m) is None] == []


def test_no_import_points_to_a_layer_to_the_right():
    def rightward(name, target, _imported):
        return (_layer(target) > _layer(name)
                and (name, target) not in EXCEPTIONS)

    assert _sites(rightward) == []


def test_the_listed_exceptions_are_still_needed():
    """Each exception names an import that exists and points right."""
    for (name, target), reason in EXCEPTIONS.items():
        assert reason and _layer(target) > _layer(name)
        assert any(t == target for _l, t, _i in _imports(name,
                                                          MODULES[name]))


def test_no_underscore_name_from_another_subpackage():
    def private(name, target, imported):
        if _subpackage(target) == _subpackage(name):
            return False
        parts = target.split(".") + ([imported] if imported else [])
        return any(p.startswith("_") and not p.startswith("__")
                   for p in parts)

    assert _sites(private) == []


def test_only_kernels_import_the_library_loader():
    def loader(name, target, _imported):
        return (_subpackage(name) != "kernels"
                and (target == LIBRARY_LOADER
                     or target.startswith(LIBRARY_LOADER + ".")))

    assert _sites(loader) == []
