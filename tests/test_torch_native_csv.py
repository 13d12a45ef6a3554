"""harkdb_tpu_torch's native CSV loader vs harkdb_tpu's, on the CPU.

tests/test_native_csv.py's seven cases run through both packages'
``native_read_csv`` on the same files and must give the same names, dtypes
and values. Added: two processes that build the loader at once both load;
a CSV registered through ``Context.create_table`` gives the JAX package's
query result; a failed build raises with the compiler's output; a CSV
with text cells raises an ImportError naming pandas when pandas is absent;
and chip_smoke.py's CSV writer writes what ``np.savetxt`` writes.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import harkdb_tpu
import harkdb_tpu_torch
from harkdb_tpu.config import EngineConfig as JaxConfig
from harkdb_tpu.io.native_csv import native_read_csv as jax_read_csv
from harkdb_tpu_torch.config import EngineConfig
from harkdb_tpu_torch.io import native_csv
from harkdb_tpu_torch.io.native_csv import native_read_csv

from test_torch_derived import assert_query_same, make_pair

CFG = EngineConfig()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_CSV = os.path.join(ROOT, "tests", "data", "data.csv")


def _both(path):
    """Both packages' native parse of ``path``: equal names, dtypes and
    values (or both None); returns the port's."""
    got = native_read_csv(str(path), CFG)
    want = jax_read_csv(str(path), JaxConfig())
    if want is None:
        assert got is None
        return None
    cols, names = got
    assert names == want[1]
    for n in names:
        assert cols[n].dtype == want[0][n].dtype, n
        np.testing.assert_array_equal(cols[n], want[0][n])
    return got


def test_reference_csv_matches_pandas():
    cols, names = _both(DATA_CSV)
    ref = pd.read_csv(DATA_CSV, skipinitialspace=True)
    assert names == list(ref.columns)
    for n in names:
        np.testing.assert_array_equal(
            cols[n], ref[n].to_numpy().astype(np.int32))


def test_dtype_inference(tmp_path):
    p = tmp_path / "mix.csv"
    p.write_text("i,f\n1,1.5\n-2,2.5\n30,-0.25\n")
    cols, names = _both(p)
    assert names == ["i", "f"]
    assert cols["i"].dtype == np.int32
    assert cols["f"].dtype == np.float32
    np.testing.assert_array_equal(cols["i"], [1, -2, 30])
    np.testing.assert_allclose(cols["f"], [1.5, 2.5, -0.25])


def test_no_trailing_newline(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("a,b\n1,2\n3,4")
    cols, _ = _both(p)
    np.testing.assert_array_equal(cols["a"], [1, 3])
    np.testing.assert_array_equal(cols["b"], [2, 4])


def test_scientific_notation(tmp_path):
    p = tmp_path / "e.csv"
    p.write_text("x\n1e3\n-2.5e-2\n1E2\n")
    cols, _ = _both(p)
    np.testing.assert_allclose(cols["x"], [1000.0, -0.025, 100.0])


def test_text_falls_back_to_pandas(tmp_path):
    p = tmp_path / "text.csv"
    p.write_text("a,b\n1,hello\n")
    assert _both(p) is None


def test_random_roundtrip_vs_pandas(tmp_path):
    rng = np.random.default_rng(0)
    n = 5000
    df = pd.DataFrame({
        "a": rng.integers(-10**6, 10**6, n),
        "b": rng.random(n) * 100 - 50,
    })
    p = tmp_path / "r.csv"
    df.to_csv(p, index=False)
    cols, _ = _both(p)
    np.testing.assert_array_equal(cols["a"], df.a.to_numpy().astype(np.int32))
    np.testing.assert_allclose(
        cols["b"], df.b.to_numpy().astype(np.float32), rtol=2e-6, atol=1e-4)


def test_ingest_uses_native_transparently(tmp_path, monkeypatch):
    """load_csv reads a numeric file without pandas."""
    from harkdb_tpu_torch.columnar.ingest import load_csv

    p = tmp_path / "t.csv"
    p.write_text("x,y\n5,6\n7,8\n")
    monkeypatch.setitem(sys.modules, "pandas", None)    # import would fail
    cols, names, dicts = load_csv(str(p), CFG)
    assert names == ["x", "y"] and dicts == {}
    np.testing.assert_array_equal(cols["x"], [5, 7])


def test_text_csv_without_pandas_names_it(tmp_path, monkeypatch):
    p = tmp_path / "text.csv"
    p.write_text("a,b\n1,hello\n")
    monkeypatch.setitem(sys.modules, "pandas", None)
    c = harkdb_tpu_torch.Context(device="cpu")
    with pytest.raises(ImportError, match="pandas") as e:
        c.create_table("t", str(p))
    assert "only all-numeric CSVs load without pandas" in str(e.value)


def test_create_table_from_csv_matches_jax(tmp_path):
    """A numeric CSV registered through create_table gives the JAX
    package's result (and the dict-loaded table's)."""
    rng = np.random.default_rng(3)
    n = 3000
    k = rng.integers(0, 50, n).astype(np.int32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    f = rng.standard_normal(n).astype(np.float32)
    p = tmp_path / "t.csv"
    pd.DataFrame({"k": k, "v": v, "f": f}).to_csv(p, index=False)
    j, c = make_pair({"t": str(p)})
    q = ("select k, sum(v) as s, max(v) as m, count(*) as n, min(f) as lo "
         "from t where v > 0 group by k order by s desc")
    assert_query_same(j, c, q)
    d = harkdb_tpu_torch.Context(device="cpu")
    d.create_table("t", {"k": k, "v": v, "f": c.tables["t"].host_columns[
        "f"]})
    np.testing.assert_array_equal(c.sql(q), d.sql(q))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native_csv, "SRC", str(bad))
    monkeypatch.setattr(native_csv, "LIB", str(tmp_path / "b" / "x.so"))
    with pytest.raises(RuntimeError, match="native CSV loader failed") as e:
        native_csv.build()
    assert "broken.cpp" in str(e.value) and "error" in str(e.value)
    assert os.listdir(tmp_path / "b") == []       # no half-written library


_BUILD_AND_LOAD = """
import os, sys, time
from harkdb_tpu_torch.config import EngineConfig
from harkdb_tpu_torch.io import native_csv
native_csv.LIB = sys.argv[1]
deadline = time.time() + 60
while not os.path.exists(sys.argv[2]) and time.time() < deadline:
    time.sleep(0.01)
cols, names = native_csv.native_read_csv(sys.argv[3], EngineConfig())
assert names == ["x", "y"] and cols["y"].tolist() == [2, 4], (names, cols)
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    """Both find no library, both build (each to a file of its own, renamed
    into place), both load and parse."""
    lib = tmp_path / "build" / "csv_loader.so"
    go = tmp_path / "go"
    csv = tmp_path / "d.csv"
    csv.write_text("x,y\n1,2\n3,4\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_AND_LOAD, str(lib), str(go), str(csv)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    go.write_text("")
    for proc in procs:
        _out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err
    assert os.listdir(lib.parent) == ["csv_loader.so"]


def test_chip_smoke_csv_writer_reads_back(tmp_path):
    """chip_smoke.write_csv (the card run's 2^24-row CSV) writes exactly
    what ``np.savetxt`` writes, and the native loader reads it back."""
    import chip_smoke

    rng = np.random.default_rng(4)
    cols = {"k": rng.integers(0, 1 << 20, 20000).astype(np.int32),
            "v": rng.integers(-1000, 1000, 20000).astype(np.int32)}
    cols["v"][:4] = [0, -1, -1000, 999]
    fast, slow = tmp_path / "fast.csv", tmp_path / "slow.csv"
    chip_smoke.write_csv(str(fast), cols)
    with open(slow, "w") as f:
        f.write("k,v\n")
        np.savetxt(f, np.stack([cols["k"], cols["v"]], axis=1), fmt="%d",
                   delimiter=",")
    assert fast.read_bytes() == slow.read_bytes()
    got, names = _both(fast)
    assert names == ["k", "v"]
    for n in names:
        np.testing.assert_array_equal(got[n], cols[n])
