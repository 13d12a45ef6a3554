"""``python -m harkdb_tpu_torch`` vs ``python -m harkdb_tpu``, and
``Context.profile``, on the CPU.

Both CLIs' ``main([...])`` run in-process on tests/data/data.csv and must
print the same table on stdout (the JAX CLI on the CPU backend the test
session pins; the port's with ``--cpu``) and a stderr line of the same
shape; ``--explain`` prints the same plan; ``--profile DIR`` prints the
raw matrix and leaves a trace file in DIR. Without pandas the default
output stops with a message naming pandas, and ``--mesh`` without a
launcher (torchrun) raises, naming it.
"""

import json
import os
import re

import numpy as np
import pytest

import harkdb_tpu
import harkdb_tpu_torch
from harkdb_tpu.__main__ import main as jax_main
from harkdb_tpu_torch import __main__ as cli

DATA_CSV = os.path.join(os.path.dirname(__file__), "data", "data.csv")
TABLE = ["--table", f"game_1={DATA_CSV}"]
QUERIES = [
    "select col1, max(col3) from game_1 group by col1",
    "select col1, col3 from game_1 where col2 > 2 order by col3 desc",
    "select col2 + col4 as s, col8 from game_1 limit 3",
]
STDERR = re.compile(r"^\(\d+ rows, plan \d+\.\d ms, exec \d+\.\d ms\)$")


def _run(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr()
    return out.out, out.err


@pytest.mark.parametrize("query", QUERIES)
def test_cli_prints_what_the_jax_cli_prints(query, capsys):
    out_j, err_j = _run(jax_main, [*TABLE, query], capsys)
    out_p, err_p = _run(cli.main, ["--cpu", *TABLE, query], capsys)
    assert out_p == out_j
    assert STDERR.match(err_p.strip()) and STDERR.match(err_j.strip())
    assert err_p.split()[0] == err_j.split()[0]          # the row count


def test_cli_explain_and_profile(tmp_path, capsys):
    q = QUERIES[0]
    out_j, _ = _run(jax_main, [*TABLE, "--explain", q], capsys)
    out_p, _ = _run(cli.main, ["--cpu", *TABLE, "--explain", q], capsys)
    assert out_p == out_j and "Aggregate keys=[game_1.col1]" in out_p
    trace_dir = tmp_path / "trace"
    out_p, err_p = _run(cli.main,
                        ["--cpu", *TABLE, "--profile", str(trace_dir), q],
                        capsys)
    j = harkdb_tpu.Context()
    j.create_table("game_1", DATA_CSV)
    assert out_p == f"{j.sql(q)}\n"
    assert err_p == f"(trace written to {trace_dir})\n"
    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(trace_dir / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_profile_returns_the_matrix(tmp_path):
    """Context.profile returns sql's matrix and adds one trace per call."""
    c = harkdb_tpu_torch.Context(device="cpu")
    c.create_table("t", {"k": np.int32([1, 2, 2]), "v": np.int32([3, 4, 5])})
    q = "select k, sum(v) from t group by k"
    for n in (1, 2):
        np.testing.assert_array_equal(c.profile(q, str(tmp_path)), c.sql(q))
        assert len(os.listdir(tmp_path)) == n


def test_cli_without_pandas_names_it(monkeypatch, capsys):
    real = cli.importlib.util.find_spec
    monkeypatch.setattr(cli.importlib.util, "find_spec",
                        lambda name: None if name == "pandas" else real(name))
    assert cli.main(["--cpu", *TABLE, QUERIES[0]]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "needs pandas" in out.err
    assert cli.main(["--cpu", *TABLE, "--explain", QUERIES[0]]) == 0


def test_cli_mesh_not_ported(monkeypatch):
    """``--mesh`` runs under torchrun only: without a launcher's
    environment it raises, naming torchrun."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["--cpu", "--mesh", *TABLE, QUERIES[0]])


def test_cli_mesh_under_torchrun(capsys):
    """``--mesh`` under torchrun on 2 CPU ranks (gloo): rank 0 prints the
    table the single-device CLI prints; rank 1 prints nothing."""
    import subprocess
    import sys

    out_p, _err = _run(cli.main, ["--cpu", *TABLE, QUERIES[0]], capsys)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port", port, "-m",
         "harkdb_tpu_torch", "--cpu",
         "--mesh", *TABLE, QUERIES[0]],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == out_p
