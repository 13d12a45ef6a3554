"""The port's examples run on the CPU: examples/torch_demo.py prints what
examples/demo.py (the JAX package) prints, and examples/torch_tour.py runs
its single-device part and its mesh part (4 gloo ranks it starts itself)
to the end, printing every section."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _run(*args, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_torch_demo_prints_what_demo_prints():
    got = _run(os.path.join(EXAMPLES, "torch_demo.py"), "--cpu")
    assert got.returncode == 0, got.stderr
    ref = _run(os.path.join(EXAMPLES, "demo.py"))
    assert ref.returncode == 0, ref.stderr
    assert got.stdout == ref.stdout


def test_torch_tour_runs_on_cpu_mesh():
    sys.path.insert(0, EXAMPLES)
    try:
        import torch_tour
    finally:
        sys.path.remove(EXAMPLES)
    got = _run(os.path.join(EXAMPLES, "torch_tour.py"), "--cpu")
    assert got.returncode == 0, got.stderr
    for title, _sql in torch_tour.SINGLE:
        assert f"— {title} —" in got.stdout, title
    for title, _sql in torch_tour.MESH:
        assert f"— on a mesh of 4 ranks: {title} —" in got.stdout, title
    assert "hot_products" in got.stdout
