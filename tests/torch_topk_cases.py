"""The top-k LIMIT path's tables and queries, shared by
tests/test_torch_topk.py (against the JAX package on the CPU) and
tests/test_torch_cuda.py (the card against the CPU port). Imports neither
jax nor pandas, so the card's machine can import it."""

import numpy as np

N = 3000
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def special_floats(rng, n) -> np.ndarray:
    """float32 with NaN of both signs, ±0.0 and ±inf planted among normal
    values."""
    f = rng.normal(0, 100, n).astype(np.float32)
    specials = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf],
                        np.float32)
    specials[1] = -specials[0]                   # sign bit set on the NaN
    pos = rng.choice(n, 60, replace=False)
    f[pos] = np.resize(specials, 60)
    return f


def tables():
    rng = np.random.default_rng(9)
    t = {
        "k": np.arange(N, dtype=np.int32),
        "v": rng.integers(-1000, 1000, N).astype(np.int32),
        "f": special_floats(rng, N),
        "t3": rng.integers(0, 3, N).astype(np.int32),
        "c": np.full(N, 7, np.int32),
        "b8": rng.integers(-128, 128, N).astype(np.int8),
        "s16": rng.integers(-2**15, 2**15, N).astype(np.int16),
        "x": rng.integers(I32_MIN, I32_MAX, N, dtype=np.int64).astype(
            np.int32),
    }
    t["x"][:5] = [I32_MIN, I32_MAX, I32_MIN, I32_MAX, 0]
    probe = {"k": np.arange(6, dtype=np.int32),
             "f": np.array([0.0, -0.0, 1.0, np.nan, np.nan, 2.0],
                           np.float32)}
    probe["f"][4] = -probe["f"][3]
    a = {"k": np.arange(40, dtype=np.int32),
         "v": rng.integers(0, 100, 40).astype(np.int32)}
    r = {"k": np.arange(0, 40, 3, dtype=np.int32),
         "w": rng.integers(-5, 5, 14).astype(np.int32)}
    return {"t": t, "probe": probe, "a": a, "r": r}


def bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint64) if a.dtype == np.float64 else (
        a.view(np.uint32) if a.dtype == np.float32 else a)


def assert_same(want: np.ndarray, got: np.ndarray, query: str) -> None:
    assert want.shape == got.shape, (query, want.shape, got.shape)
    assert want.dtype == got.dtype, (query, want.dtype, got.dtype)
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=query)


# (query, takes the top-k path)
QUERIES = [
    # the probe of the NaN-order difference
    ("select k, f from probe order by f limit 3", True),
    ("select k, f from probe order by f desc limit 3", True),
    ("select k, f from probe order by f limit 2000", False),
    # NaN of both signs, ±0.0, ±inf among 3000 rows
    ("select k, f from t order by f limit 10", True),
    ("select k, f from t order by f desc limit 10", True),
    ("select k, f from t order by f limit 1024", True),
    ("select k, f from t order by f limit 1025", False),
    ("select k, f from t order by f desc limit 1025", False),
    # the gate's edges
    ("select k, v from t order by v limit 1024", True),
    ("select k, v from t order by v limit 1025", False),
    ("select k, v from t order by v desc limit 1000 offset 24", True),
    ("select k, v from t order by v desc limit 1000 offset 25", False),
    # these take the sort path: two keys, DISTINCT
    ("select k, v from t order by v, k limit 10", False),
    ("select k, f from t order by f, k desc limit 10", False),
    ("select distinct t3 from t order by t3 limit 2", False),
    ("select distinct f from t order by f limit 4", False),
    # heavy ties: one value, three values
    ("select k, c from t order by c limit 50", True),
    ("select k, c from t order by c desc limit 50 offset 7", True),
    ("select k, t3 from t order by t3 limit 100 offset 5", True),
    ("select k, t3 from t order by t3 desc limit 300", True),
    # keys ingested from int8, int16 and int32 data, int32 extremes
    ("select k, b8 from t order by b8 limit 20", True),
    ("select k, s16 from t order by s16 desc limit 20", True),
    ("select k, x from t order by x limit 20", True),
    ("select k, x from t order by x desc limit 20", True),
    ("select k, v from t order by v * 3 - k limit 15", True),
    # a pending WHERE, OFFSET past the live rows, empty results
    ("select k, v from t where v > 500 order by v desc limit 20 offset 3",
     True),
    ("select k, f from t where v < 0 order by f limit 30", True),
    ("select k, v from t where v > 990 order by v limit 20 offset 1000",
     True),
    ("select k, v from t where v > 5000 order by v limit 5", True),
    ("select k, v from t order by v limit 0", True),
    ("select k, v from t order by v limit 3 offset 2990", False),
]
