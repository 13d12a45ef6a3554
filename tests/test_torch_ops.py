"""harkdb_tpu_torch operators vs the JAX package's, on the CPU.

Each test makes its inputs with numpy from a seed and runs the same call
through ``harkdb_tpu`` (JAX on the CPU, as its own tests run it) and
``harkdb_tpu_torch`` (torch on the CPU, where the kernels take their plain
versions). Integer outputs are compared bit for bit in the live region;
float32 outputs with rtol=1e-6, atol=0 (observed equal: the port keeps the
JAX package's operation order on the CPU).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from harkdb_tpu.columnar.batch import ColumnBatch as JBatch
from harkdb_tpu.ops.groupby import (
    groupby_aggregate as jax_groupby_aggregate,
    groupby_batch as jax_groupby_batch,
)
import harkdb_tpu.ops.join as JJ
from harkdb_tpu.ops.sort import (
    sort_batch as jax_sort_batch, sort_permutation as jax_sort_permutation,
)
from harkdb_tpu.plan.aggregates import (
    apply_post_computes as jax_apply_post_computes,
)
from harkdb_tpu.plan.expr import eval_expr as jax_eval_expr
from harkdb_tpu.prims.compaction import compact_batch as jax_compact_batch
from harkdb_tpu.prims.segmented import doubling_segmented_scan as jax_doubling
from harkdb_tpu.sql.ast_nodes import BinOp as JBinOp

from harkdb_tpu_torch.columnar.batch import ColumnBatch as TBatch
from harkdb_tpu_torch.ops.groupby import groupby_aggregate, groupby_batch
from harkdb_tpu_torch.ops import join as TJ
from harkdb_tpu_torch.ops.sort import sort_batch, sort_permutation
from harkdb_tpu_torch.plan.aggregates import apply_post_computes
from harkdb_tpu_torch.plan.expr import eval_expr
from harkdb_tpu_torch.prims.compaction import compact_arrays, compact_batch
from harkdb_tpu_torch.kernels.segscan import doubling_segmented_scan
from harkdb_tpu_torch.sql import ast_nodes as T

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _batches(arrays, n_valid):
    cap = len(next(iter(arrays.values())))
    jb = JBatch({k: jnp.asarray(v) for k, v in arrays.items()},
                jnp.int32(n_valid))
    tb = TBatch({k: torch.from_numpy(np.array(v)) for k, v in arrays.items()},
                torch.tensor(n_valid, dtype=torch.int32))
    assert tb.capacity == cap
    return jb, tb


def _assert_live_equal(jb, tb, names=None):
    n = int(jb.n_valid)
    assert int(tb.n_valid) == n
    assert tb.n_valid.dtype == torch.int32 and tb.n_valid.dim() == 0
    for name in names or jb.names:
        a = np.asarray(jb.columns[name])[:n]
        b = tb.columns[name].numpy()[:n]
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0,
                                       equal_nan=True, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def _table(rng, n):
    return {
        "k": rng.integers(0, 40, n).astype(np.int32),
        "k2": rng.integers(-3, 3, n).astype(np.int32),
        "v": rng.integers(-1000, 1000, n).astype(np.int32),
        "w": rng.integers(1, 50, n).astype(np.int32),
        "f": rng.standard_normal(n).astype(np.float32),
    }


def test_column_batch_numpy_round_trip(rng):
    arrays = {"a": rng.integers(-9, 9, 300).astype(np.int32),
              "f": rng.standard_normal(300).astype(np.float32)}
    j = JBatch.from_numpy(arrays, capacity=1024)
    t = TBatch.from_numpy(arrays, capacity=1024, device="cpu")
    assert t.capacity == j.capacity == 1024
    assert t.n_valid.dtype == torch.int32 and int(t.n_valid) == 300
    jm, jn = j.to_numpy()
    tm, tn = t.to_numpy()
    assert tn == jn
    np.testing.assert_array_equal(tm, jm)


class TestCompaction:
    @pytest.mark.parametrize("n,sel", [(1000, 0.0), (5000, 0.5),
                                       (16385, 1.0), (40000, 0.3)])
    def test_compact_batch(self, n, sel):
        rng = np.random.default_rng(n)
        arrays = _table(rng, n)
        arrays["b"] = rng.random(n) < 0.5          # bool column rides too
        mask = rng.random(n) < sel
        nv = n - 17
        jb, tb = _batches(arrays, nv)
        _assert_live_equal(
            jax_compact_batch(jb, jnp.asarray(mask), use_pallas=False),
            compact_batch(tb, torch.from_numpy(mask)),
        )

    def test_compact_arrays_word_types(self, rng):
        """8-, 2- and 1-byte columns travel as 32-bit words and come back
        bit for bit."""
        n = 3000
        arrays = [
            torch.from_numpy(rng.integers(-2**62, 2**62, n)),   # int64
            torch.from_numpy(rng.standard_normal(n)),           # float64
            torch.from_numpy(rng.integers(-99, 99, n).astype(np.int16)),
            torch.from_numpy(rng.random(n) < 0.5),              # bool
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
        ]
        mask = torch.from_numpy(rng.random(n) < 0.4)
        packed, cnt = compact_arrays(arrays, mask,
                                     torch.tensor(n, dtype=torch.int32))
        keep = mask.numpy()
        assert int(cnt) == keep.sum()
        for a, p in zip(arrays, packed):
            assert p.dtype == a.dtype and p.shape == a.shape
            np.testing.assert_array_equal(p.numpy()[: keep.sum()],
                                          a.numpy()[keep])


class TestSort:
    @pytest.mark.parametrize("desc", [(False, False), (True, False),
                                      (False, True), (True, True)])
    def test_sort_batch_multi_key(self, rng, desc):
        n = 5000
        arrays = _table(rng, n)
        arrays["k"][::97] = I32_MIN                 # DESC bijection edge
        arrays["k"][::89] = I32_MAX
        nv = n - 300                                # junk padding rows
        jb, tb = _batches(arrays, nv)
        mask = rng.random(n) < 0.7
        _assert_live_equal(
            jax_sort_batch(jb, ["k", "k2"], list(desc),
                           mask=jnp.asarray(mask)),
            sort_batch(tb, ["k", "k2"], list(desc),
                       mask=torch.from_numpy(mask)),
        )

    @pytest.mark.parametrize("desc", [False, True])
    def test_float_keys_nan_and_signed_zero(self, rng, desc):
        """lax.sort order: -0.0 ties 0.0 (stable), NaNs after +inf."""
        n = 4000
        f = rng.integers(-3, 3, n).astype(np.float32)
        f[rng.random(n) < 0.2] = -0.0
        f[rng.random(n) < 0.1] = np.nan
        f[rng.random(n) < 0.05] = -np.nan
        f[rng.random(n) < 0.05] = np.inf
        arrays = {"f": f, "i": np.arange(n, dtype=np.int32)}
        jb, tb = _batches(arrays, n)
        j = jax_sort_batch(jb, ["f"], [desc])
        t = sort_batch(tb, ["f"], [desc])
        np.testing.assert_array_equal(t.columns["i"].numpy(),
                                      np.asarray(j.columns["i"]))

    def test_sort_permutation(self, rng):
        n = 3000
        a = rng.integers(-5, 5, n).astype(np.int32)
        b = rng.standard_normal(n).astype(np.float32)
        nv = 2500
        jp, jk = jax_sort_permutation([jnp.asarray(a), jnp.asarray(b)],
                                      jnp.int32(nv), [True, False])
        tp, tk = sort_permutation([torch.from_numpy(a), torch.from_numpy(b)],
                                  torch.tensor(nv, dtype=torch.int32),
                                  [True, False])
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        for x, y in zip(tk, jk):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    def test_ties_keep_input_order(self):
        """ORDER BY s desc ties come out in input (ascending key) order."""
        s = np.array([5, 7, 5, 7, 5, 1], np.int32)
        k = np.arange(6, dtype=np.int32)
        _jb, tb = _batches({"s": s, "k": k}, 6)
        out = sort_batch(tb, ["s"], [True])
        np.testing.assert_array_equal(out.columns["k"].numpy(),
                                      [1, 3, 0, 2, 4, 5])


AGGS = [("v", "sum", "s"), ("v", "max", "mx"), ("v", "min", "mn"),
        ("w", "prod", "p"), ("v", "count", "c"), ("w", "countd", "cd"),
        ("f", "sum", "fs"), ("f", "max", "fmx"), ("f", "quantile@0.5", "med"),
        ("v", "quantile@0.25", "q1"), (("v", "ok"), "countd", "cdn"),
        (("f", "ok"), "quantile@0.5", "medn")]


class TestGroupBy:
    @pytest.mark.parametrize("keys", [["k"], ["k", "k2"], ["k2"]])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("u32", [False, True])
    def test_groupby_batch(self, keys, masked, u32):
        rng = np.random.default_rng(3)
        n = 6000
        arrays = _table(rng, n)
        arrays["w"] = rng.integers(1, 3, n).astype(np.int32)   # prod wraps
        arrays["ok"] = (rng.random(n) < 0.8).astype(np.int32)
        mask = rng.random(n) < 0.6 if masked else None
        jb, tb = _batches(arrays, n - 50)
        j = jax_groupby_batch(
            jb, keys, AGGS, u32_key_order=u32,
            mask=None if mask is None else jnp.asarray(mask),
        )
        t = groupby_batch(
            tb, keys, AGGS, u32_key_order=u32,
            mask=None if mask is None else torch.from_numpy(mask),
        )
        assert t.names == j.names
        _assert_live_equal(j, t)

    # tests/test_ops.py's TestGroupby cases that call groupby_aggregate
    # directly: the reference's one real test (test.py:7: groupby col1,
    # max(col3) over data.csv) and the pandas differentials' inputs.
    @pytest.mark.parametrize("case", ["reference_example"] + [
        f"pandas_{op}" for op in ("sum", "prod", "max", "min", "count")])
    def test_groupby_aggregate_matches_jax(self, case):
        if case == "reference_example":
            k = np.array([6, 0, 0, 0, 0, 6, 1], np.int32)
            v = np.array([1, 4, 4, 4, 4, 770, 3], np.int32)
            op, n = "max", 7
        else:
            rng = np.random.default_rng(0)
            op, n = case.split("_")[1], 500
            k = np.zeros(1024, np.int32)
            v = np.zeros(1024, np.int32)
            k[:n] = rng.integers(0, 20, n)
            v[:n] = rng.integers(1, 5, n)
        jk, jouts, jn = jax_groupby_aggregate(
            jnp.asarray(k), [(jnp.asarray(v), op)], jnp.int32(n))
        tk, touts, tn = groupby_aggregate(
            torch.from_numpy(k), [(torch.from_numpy(v), op)],
            torch.tensor(n, dtype=torch.int32))
        groups = int(jn)
        assert int(tn) == groups and tn.dtype == torch.int32
        got_k, got = tk[0].numpy()[:groups], touts[0].numpy()[:groups]
        np.testing.assert_array_equal(got_k, np.asarray(jk[0])[:groups])
        np.testing.assert_array_equal(got, np.asarray(jouts[0])[:groups])
        assert got.dtype == np.asarray(jouts[0]).dtype
        if case == "reference_example":
            assert groups == 3
            np.testing.assert_array_equal(got_k, [0, 1, 6])
            np.testing.assert_array_equal(got, [4, 3, 770])
        else:
            import pandas as pd

            want = pd.DataFrame({"k": k[:n], "v": v[:n]}).groupby(
                "k")["v"].agg(op).sort_index()
            np.testing.assert_array_equal(got_k, want.index.to_numpy())
            # pandas aggregates in int64; the engine wraps at int32.
            np.testing.assert_array_equal(
                got, want.to_numpy().astype(np.int64).astype(
                    np.uint32).view(np.int32))

    def test_no_live_rows(self, rng):
        n = 2000
        arrays = _table(rng, n)
        jb, tb = _batches(arrays, 0)
        aggs = [("v", "sum", "s"), ("f", "max", "m"), ("v", "count", "c")]
        j = jax_groupby_batch(jb, ["k"], aggs)
        t = groupby_batch(tb, ["k"], aggs)
        assert int(t.n_valid) == int(j.n_valid) == 0

    def test_int32_sum_wraps(self):
        n = 4096
        v = np.full(n, 2**30, np.int32)
        k = (np.arange(n) % 2).astype(np.int32)
        jb, tb = _batches({"k": k, "v": v}, n)
        aggs = [("v", "sum", "s"), ("v", "count", "c")]
        _assert_live_equal(jax_groupby_batch(jb, ["k"], aggs),
                           groupby_batch(tb, ["k"], aggs))

    def test_post_computes_avg_var(self, rng):
        n = 500
        cols = {
            "s": rng.integers(-999, 999, n).astype(np.int32),
            "c": rng.integers(0, 9, n).astype(np.int32),
            "q": rng.random(n).astype(np.float32) * 100,
            "fs": rng.standard_normal(n).astype(np.float32),
        }
        specs = [("avg", ("avg", "s", "c")), ("m0", ("mask0", "s", "c")),
                 ("var", ("var", "q", "fs", "c", 1, True)),
                 ("n1", ("nsub1", "c"))]
        jc = {k: jnp.asarray(v) for k, v in cols.items()}
        tc = {k: torch.from_numpy(v) for k, v in cols.items()}
        jax_apply_post_computes(jc, specs)
        apply_post_computes(tc, specs)
        for out, _spec in specs:
            a, b = np.asarray(jc[out]), tc[out].numpy()
            assert a.dtype == b.dtype
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)


def _ops():
    B, U, C, L = T.BinOp, T.UnOp, T.Col, T.Lit
    return [
        B("+", C("a"), B("*", C("b"), L(3))),
        B("/", C("a"), C("b")),                  # trunc toward zero, x/0=-1
        B("%", C("a"), C("b")),                  # x%0=x, INT_MIN%-1=0
        B("/", C("f"), C("g")),
        B("%", C("f"), L(1.5)),
        B("-", C("a"), C("f")),                  # int-float promotion
        U("round", C("f")),                      # half away from zero
        U("floor", C("f")), U("ceil", C("f")), U("abs", C("a")),
        U("sqrt", C("g")),
        U("cast_int", C("h")),                   # saturating, NaN -> 0
        U("cast_float", C("a")),
        U("-", C("a")),
        B("and", B(">", C("a"), L(0)), U("not", B("=", C("b"), L(2)))),
        B("or", B("<=", C("f"), L(0.5)), B("!=", C("a"), C("b"))),
        T.Case(((B(">", C("a"), L(10)), C("f")),
                (B("<", C("a"), L(-10)), L(7))), None),
        T.Case(((B(">=", C("b"), L(0)), C("a")),), L(-1)),
        L(5), L(2.5),
    ]


class TestEvalExpr:
    @pytest.mark.parametrize("i", range(len(_ops())))
    def test_vs_jax(self, i):
        rng = np.random.default_rng(11)
        n = 2000
        a = rng.integers(-50, 50, n).astype(np.int32)
        a[:4] = [I32_MIN, I32_MIN, 7, -7]
        b = rng.integers(-3, 4, n).astype(np.int32)
        b[:4] = [-1, 0, 0, 2]
        f = (rng.integers(-20, 20, n) / 4).astype(np.float32)  # x.5 ties
        g = rng.random(n).astype(np.float32)
        h = (rng.standard_normal(n) * 1e3).astype(np.float32)
        h[:5] = [np.nan, np.inf, -np.inf, 3e9, -3e9]
        cols = {"a": a, "b": b, "f": f, "g": g, "h": h}
        expr = _ops()[i]
        jexpr = _to_jax_ast(expr)
        want = np.asarray(jax_eval_expr(
            jexpr, {k: jnp.asarray(v) for k, v in cols.items()}, n))
        got = eval_expr(expr, {k: torch.from_numpy(v)
                               for k, v in cols.items()}, n).numpy()
        assert got.dtype == want.dtype
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(got, want)


def _to_jax_ast(e):
    """The same expression built from the JAX package's AST classes."""
    import harkdb_tpu.sql.ast_nodes as J

    if isinstance(e, T.BinOp):
        return JBinOp(e.op, _to_jax_ast(e.left), _to_jax_ast(e.right))
    if isinstance(e, T.UnOp):
        return J.UnOp(e.op, _to_jax_ast(e.operand))
    if isinstance(e, T.Col):
        return J.Col(e.name)
    if isinstance(e, T.Lit):
        return J.Lit(e.value)
    if isinstance(e, T.Case):
        return J.Case(
            tuple((_to_jax_ast(c), _to_jax_ast(r)) for c, r in e.whens),
            None if e.else_ is None else _to_jax_ast(e.else_),
        )
    raise TypeError(e)


class TestDoublingScan:
    @pytest.mark.parametrize("all_minus_one", [False, True])
    def test_vs_jax(self, rng, all_minus_one):
        """Including the JAX version's zero-fill at sid -1 rows."""
        n = 5000
        sid = (np.full(n, -1, np.int32) if all_minus_one
               else np.sort(rng.integers(0, 80, n)).astype(np.int32))
        v = rng.integers(-99, 99, (n, 2)).astype(np.int32)
        for jop, top in [(jnp.maximum, torch.maximum), (jnp.add, torch.add),
                         (jnp.multiply, torch.mul)]:
            want = np.asarray(jax_doubling(jop, jnp.asarray(sid),
                                           jnp.asarray(v)))
            got = doubling_segmented_scan(top, torch.from_numpy(sid),
                                          torch.from_numpy(v)).numpy()
            np.testing.assert_array_equal(got, want)


# -- joins (ops/join.py) -------------------------------------------------------

def _live_equal(a, b, n, what):
    a = np.asarray(a)[:n]
    b = b.numpy()[:n]
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, equal_nan=True,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


def _assert_ranges_equal(j, t):
    """Every JoinRanges field, on live entries (rows past the live counts
    are unspecified on the kernel paths)."""
    for name in ("n_lefts", "total", "total_left"):
        assert int(getattr(t, name)) == int(getattr(j, name)), name
        assert getattr(t, name).dtype == torch.int32, name
    nlv = int(j.n_lefts)
    for name in ("l_orig", "counts", "lo"):
        _live_equal(getattr(j, name), getattr(t, name), nlv, name)
    for i, (a, b) in enumerate(zip(j.l_payload, t.l_payload)):
        _live_equal(a, b, nlv, f"l_payload[{i}]")
    assert float(t.total_approx) == float(j.total_approx)
    if j.total_full is None:
        assert t.total_full is None and t.r_matched is None
    else:
        assert int(t.total_full) == int(j.total_full)


def _join_inputs(rng, nl, nr, nkeys, span, n_l, n_r):
    lk = [rng.integers(0, span, nl).astype(np.int32) for _ in range(nkeys)]
    rk = [rng.integers(0, span, nr).astype(np.int32) for _ in range(nkeys)]
    lc = [rng.integers(-10**6, 10**6, nl).astype(np.int32),
          rng.standard_normal(nl).astype(np.float32)]
    rc = [rng.integers(-10**6, 10**6, nr).astype(np.int32)]
    return lk, rk, lc, rc


class TestJoinRanges:
    @pytest.mark.parametrize("nkeys", [1, 3])
    @pytest.mark.parametrize("nulls", [False, True])
    @pytest.mark.parametrize("need_full", [False, True])
    def test_vs_jax(self, nkeys, nulls, need_full):
        rng = np.random.default_rng(nkeys * 10 + nulls * 2 + need_full)
        nl, nr, n_l, n_r = 3000, 700, 2900, 650
        lk, rk, lc, rc = _join_inputs(rng, nl, nr, nkeys,
                                      60 if nkeys == 1 else 5, n_l, n_r)
        l_null = rng.random(nl) < 0.1 if nulls else None
        r_null = rng.random(nr) < 0.1 if nulls else None
        j = JJ.compute_join_ranges(
            [jnp.asarray(k) for k in lk], jnp.int32(n_l),
            [jnp.asarray(k) for k in rk], jnp.int32(n_r),
            l_cols=[jnp.asarray(c) for c in lc],
            r_cols=[jnp.asarray(c) for c in rc],
            l_null=None if l_null is None else jnp.asarray(l_null),
            r_null=None if r_null is None else jnp.asarray(r_null),
            need_full=need_full,
        )
        t = TJ.compute_join_ranges(
            [torch.from_numpy(k) for k in lk], torch.tensor(n_l, dtype=torch.int32),
            [torch.from_numpy(k) for k in rk], torch.tensor(n_r, dtype=torch.int32),
            l_cols=[torch.from_numpy(c) for c in lc],
            r_cols=[torch.from_numpy(c) for c in rc],
            l_null=None if l_null is None else torch.from_numpy(l_null),
            r_null=None if r_null is None else torch.from_numpy(r_null),
            need_full=need_full,
        )
        _assert_ranges_equal(j, t)
        # live right rows: the right split keeps the live (non-pad) rights
        n_rights = n_r
        _live_equal(j.r_orig, t.r_orig, n_rights, "r_orig")
        for i, (a, b) in enumerate(zip(j.r_payload, t.r_payload)):
            _live_equal(a, b, n_rights, f"r_payload[{i}]")
        if need_full:
            np.testing.assert_array_equal(t.r_matched.numpy(),
                                          np.asarray(j.r_matched))

    def test_key_traps(self, rng):
        """INT32_MAX keys collide with the pads' fill; float keys carry
        -0.0 (equal to 0.0) and NaN (matches nothing)."""
        hi = np.iinfo(np.int32).max
        lk = np.array([hi, 1, hi, 5, 0], np.int32)
        rk = np.array([hi, hi, 5, 7], np.int32)
        fl = np.array([0.0, -0.0, np.nan, 1.5, np.inf], np.float32)
        fr = np.array([-0.0, np.nan, np.inf, 1.5], np.float32)
        for a, b in ((lk, rk), (fl, fr)):
            j = JJ.compute_join_ranges(
                jnp.asarray(np.resize(a, 8)), jnp.int32(len(a)),
                jnp.asarray(np.resize(b, 8)), jnp.int32(len(b)),
                l_cols=[jnp.arange(8, dtype=jnp.int32)], need_full=True)
            t = TJ.compute_join_ranges(
                torch.from_numpy(np.resize(a, 8)),
                torch.tensor(len(a), dtype=torch.int32),
                torch.from_numpy(np.resize(b, 8)),
                torch.tensor(len(b), dtype=torch.int32),
                l_cols=[torch.arange(8, dtype=torch.int32)], need_full=True)
            _assert_ranges_equal(j, t)

    def test_join_match_count(self, rng):
        lk = rng.integers(0, 30, 500).astype(np.int32)
        rk = rng.integers(0, 40, 300).astype(np.int32)
        for kind in ("inner", "left", "full"):
            j = JJ.join_match_count(jnp.asarray(lk), jnp.int32(480),
                                    jnp.asarray(rk), jnp.int32(290), kind)
            t = TJ.join_match_count(
                torch.from_numpy(lk), torch.tensor(480, dtype=torch.int32),
                torch.from_numpy(rk), torch.tensor(290, dtype=torch.int32),
                kind)
            assert int(t) == int(j), kind


def _both_jax_paths(fn):
    """``fn()`` on the JAX package as it runs on the CPU by default, then
    with its kernel expand path forced (interpret mode)."""
    try:
        JJ._FORCE_KERNEL_EXPAND = False
        ref = fn()
        JJ._FORCE_KERNEL_EXPAND = True
        kern = fn()
    finally:
        JJ._FORCE_KERNEL_EXPAND = None
    return ref, kern


class TestJoinMaterialize:
    @pytest.mark.parametrize("kind", ["inner", "left"])
    def test_join_indices(self, rng, kind):
        nl, nr, cap = 3000, 500, 1 << 15
        lk = rng.integers(0, 400, nl).astype(np.int32)
        rk = rng.integers(0, 400, nr).astype(np.int32)
        jouts = _both_jax_paths(lambda: JJ.join_indices(
            jnp.asarray(lk), jnp.int32(2500), jnp.asarray(rk),
            jnp.int32(450), cap, kind))
        t = TJ.join_indices(
            torch.from_numpy(lk), torch.tensor(2500, dtype=torch.int32),
            torch.from_numpy(rk), torch.tensor(450, dtype=torch.int32),
            cap, kind)
        for j in jouts:
            n = int(j[3])
            assert int(t[3]) == n
            for a, b, what in zip(j[:3], t[:3], ("l", "r", "matched")):
                _live_equal(a, b, n, what)

    @pytest.mark.parametrize("kind", ["inner", "left", "full"])
    def test_join_batches(self, rng, kind):
        nl, nr, cap = 2000, 300, 1 << 15
        arrays_l = {"k": rng.integers(0, 150, nl).astype(np.int32),
                    "a": rng.integers(0, 10**6, nl).astype(np.int32),
                    "f": rng.standard_normal(nl).astype(np.float32)}
        arrays_r = {"j": rng.integers(0, 150, nr).astype(np.int32),
                    "b": rng.integers(0, 10**6, nr).astype(np.int32)}
        jl, tl = _batches(arrays_l, 1900)
        jr, tr = _batches(arrays_r, 280)
        extra = dict(matched_out="#m", l_matched_out="#lm")
        jouts = _both_jax_paths(lambda: JJ.join_batches(
            jl, jr, "k", "j", cap, kind=kind, **extra))
        t = TJ.join_batches(tl, tr, "k", "j", cap, kind=kind, **extra)
        for j in jouts:
            assert t.names == j.names
            _assert_live_equal(j, t)

    def test_empty_and_tiny(self):
        lk = np.array([5, 7, 9], np.int32)
        rk = np.array([7], np.int32)

        def both(n_l, n_r):
            jouts = _both_jax_paths(lambda: JJ.join_indices(
                jnp.asarray(lk), jnp.int32(n_l), jnp.asarray(rk),
                jnp.int32(n_r), 128, "inner"))
            t = TJ.join_indices(
                torch.from_numpy(lk), torch.tensor(n_l, dtype=torch.int32),
                torch.from_numpy(rk), torch.tensor(n_r, dtype=torch.int32),
                128, "inner")
            for j in jouts:
                assert int(t[3]) == int(j[3])
                for a, b in zip(j[:3], t[:3]):
                    _live_equal(a, b, int(j[3]), "tiny")
            return t

        l, r, _m, t = both(3, 1)
        assert int(t) == 1 and int(l[0]) == 1 and int(r[0]) == 0
        assert int(both(0, 0)[3]) == 0

    def test_inner_join_indices(self, rng):
        lk = rng.integers(0, 40, 200).astype(np.int32)
        rk = rng.integers(0, 40, 150).astype(np.int32)
        j = JJ.inner_join_indices(jnp.asarray(lk), jnp.int32(200),
                                  jnp.asarray(rk), jnp.int32(150), 2048)
        t = TJ.inner_join_indices(
            torch.from_numpy(lk), torch.tensor(200, dtype=torch.int32),
            torch.from_numpy(rk), torch.tensor(150, dtype=torch.int32), 2048)
        n = int(j[2])
        assert int(t[2]) == n
        _live_equal(j[0], t[0], n, "l")
        _live_equal(j[1], t[1], n, "r")

    def test_column_order_left_then_right(self):
        left = TBatch.from_numpy({"a": np.array([1, 2], np.int32),
                                  "b": np.array([10, 20], np.int32)},
                                 capacity=8, device="cpu")
        right = TBatch.from_numpy({"c": np.array([2, 1], np.int32),
                                   "d": np.array([200, 100], np.int32)},
                                  capacity=8, device="cpu")
        out = TJ.join_batches(left, right, "a", "c", out_capacity=8)
        assert out.names == ["a", "b", "c", "d"]
        mat, _ = out.to_numpy()
        np.testing.assert_array_equal(mat, [[1, 10, 1, 100], [2, 20, 2, 200]])

    def test_precomputed_ranges_need_outputs(self):
        jl = JBatch.from_numpy({"a": np.array([1, 2], np.int32)}, capacity=4)
        jr = JBatch.from_numpy({"c": np.array([2, 1], np.int32)}, capacity=4)
        jrng = JJ.compute_join_ranges(
            jl.column("a"), jl.n_valid, jr.column("c"), jr.n_valid,
            l_cols=[jl.column("a")], r_cols=[jr.column("c")])
        left = TBatch.from_numpy({"a": np.array([1, 2], np.int32)},
                                 capacity=4, device="cpu")
        right = TBatch.from_numpy({"c": np.array([2, 1], np.int32)},
                                  capacity=4, device="cpu")
        trng = TJ.compute_join_ranges(
            left.column("a"), left.n_valid, right.column("c"), right.n_valid,
            l_cols=[left.column("a")], r_cols=[right.column("c")])
        with pytest.raises(ValueError) as ej:
            JJ.join_batches(None, None, "a", "c", 4, ranges=jrng)
        with pytest.raises(ValueError) as et:
            TJ.join_batches(None, None, "a", "c", 4, ranges=trng)
        assert str(et.value) == str(ej.value)
        out = TJ.join_batches(None, None, "a", "c", 4, {"a": "a"},
                              {"c": "c"}, ranges=trng)
        np.testing.assert_array_equal(out.to_numpy()[0], [[1, 1], [2, 2]])
        with pytest.raises(ValueError, match="need_full=True"):
            TJ.join_batches(None, None, "a", "c", 4, {"a": "a"}, {"c": "c"},
                            kind="full", ranges=trng)


_CARRIED_DTYPES = [np.int32, np.float32, np.int64, np.float64, np.uint8,
                   np.int16]


def _carried(rng, n, dtype):
    """A column of ``dtype`` over its whole range; floats carry NaN, -0.0
    and values float32 would round."""
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = (rng.standard_normal(n) * 1e3 + 1e-9).astype(dt)
        x[rng.random(n) < 0.05] = np.nan
        x[rng.random(n) < 0.05] = -0.0
        return x
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _jax_words(arrays):
    """The JAX package's join carries 4-byte columns only: a 1- or 2-byte
    column rides as int32 values, an 8-byte one as its two int32 words."""
    out = {}
    for name, a in arrays.items():
        if a.dtype.itemsize == 8:
            w = a.view(np.int32).reshape(-1, 2)
            out[name + ".lo"] = w[:, 0].copy()
            out[name + ".hi"] = w[:, 1].copy()
        elif a.dtype.itemsize < 4:
            out[name] = a.astype(np.int32)
        else:
            out[name] = a
    return out


def _from_jax_words(cols, name, dtype):
    dt = np.dtype(dtype)
    if dt.itemsize == 8:
        w = np.stack([cols[name + ".lo"], cols[name + ".hi"]], 1)
        return np.ascontiguousarray(w).view(dt).reshape(-1)
    return cols[name].astype(dt) if dt.itemsize < 4 else cols[name]


def _run_join(mod, left, right, cap, kind, precomputed):
    """One join step as the planner runs it: RIGHT is LEFT with the
    operands swapped; ``precomputed`` hands ``join_batches`` the count
    phase's ranges."""
    lk, rk = "k", "j"
    if kind == "right":
        left, right, lk, rk, kind = right, left, rk, lk, "left"
    extra = dict(matched_out="#m", l_matched_out="#lm")
    if not precomputed:
        return mod.join_batches(left, right, lk, rk, cap, kind=kind, **extra)
    rng = mod.compute_join_ranges(
        left.column(lk), left.n_valid, right.column(rk), right.n_valid,
        l_cols=[left.column(n) for n in left.names],
        r_cols=[right.column(n) for n in right.names],
        need_full=kind == "full")
    return mod.join_batches(None, None, None, None, cap,
                            {n: n for n in left.names},
                            {n: n for n in right.names}, kind=kind,
                            ranges=rng, **extra)


class TestLateMaterialization:
    """The join reads each carried column once, from the caller's column,
    at the output's size; its output stays the JAX package's: values,
    dtype, pads and row order, on every slot of the capacity."""

    @pytest.mark.parametrize("precomputed", [False, True])
    @pytest.mark.parametrize("dtype", _CARRIED_DTYPES,
                             ids=lambda d: np.dtype(d).name)
    @pytest.mark.parametrize("kind", ["inner", "left", "full", "right"])
    def test_join_batches_vs_jax(self, kind, dtype, precomputed):
        rng = np.random.default_rng(
            ["inner", "left", "full", "right"].index(kind) * 100
            + _CARRIED_DTYPES.index(dtype) * 10 + precomputed)
        nl, nr, cap = 600, 160, 2048
        arrays_l = {"k": rng.integers(0, 90, nl).astype(np.int32),
                    "a": _carried(rng, nl, dtype),
                    "b": _carried(rng, nl, dtype)}
        arrays_r = {"j": rng.integers(0, 90, nr).astype(np.int32),
                    "c": _carried(rng, nr, dtype)}
        jl, _ = _batches(_jax_words(arrays_l), 570)
        jr, _ = _batches(_jax_words(arrays_r), 150)
        _, tl = _batches(arrays_l, 570)
        _, tr = _batches(arrays_r, 150)
        j = _run_join(JJ, jl, jr, cap, kind, precomputed)
        t = _run_join(TJ, tl, tr, cap, kind, precomputed)
        assert int(t.n_valid) == int(j.n_valid)
        jc = {n: np.asarray(c) for n, c in j.columns.items()}
        names = [n.rsplit(".", 1)[0] if n.endswith((".lo", ".hi")) else n
                 for n in j.names]
        assert t.names == list(dict.fromkeys(names))
        src = {**arrays_l, **arrays_r}
        for name in t.names:
            got = t.columns[name].numpy()
            want = (_from_jax_words(jc, name, src[name].dtype)
                    if name in src else jc[name])
            assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
            assert got.shape == (cap,), name
            # bit for bit, pads included: the join only moves values
            np.testing.assert_array_equal(
                got.view(f"u{got.dtype.itemsize}"),
                want.view(f"u{want.dtype.itemsize}"), err_msg=name)

    @pytest.mark.parametrize("need_full", [False, True])
    @pytest.mark.parametrize("n_carried", [0, 1, 8])
    def test_ranges_compact_the_row_index_only(self, monkeypatch, n_carried,
                                               need_full):
        """compute_join_ranges compacts 3 columns left (row, count, first
        match) and 1 right (+ the matched flag under need_full), however
        many columns the join carries: in the runs' plain version
        (``kernels/join_runs``), or in the composition's compactions under
        need_full; the ranges keep the caller's columns themselves."""
        from harkdb_tpu_torch.kernels import join_runs

        widths = []
        real, real_split = TJ.compact_arrays, join_runs.flat_compact_reference

        def spy(arrays, mask, n_valid):
            widths.append(len(arrays))
            return real(arrays, mask, n_valid)

        def spy_split(cols, mask, n_valid):
            widths.append(len(cols))
            return real_split(cols, mask, n_valid)

        monkeypatch.setattr(TJ, "compact_arrays", spy)
        monkeypatch.setattr(join_runs, "flat_compact_reference", spy_split)
        rng = np.random.default_rng(n_carried)
        lk = torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32))
        rk = torch.from_numpy(rng.integers(0, 50, 100).astype(np.int32))
        l_cols = [torch.from_numpy(_carried(rng, 400, np.float64))
                  for _ in range(n_carried)]
        r_cols = [torch.from_numpy(_carried(rng, 100, np.int16))
                  for _ in range(n_carried)]
        n = torch.tensor(90, dtype=torch.int32)
        ranges = TJ.compute_join_ranges(lk, n, rk, n, l_cols=l_cols,
                                        r_cols=r_cols, need_full=need_full)
        assert widths == [3, 2 if need_full else 1]
        assert all(a is b for a, b in zip(ranges.l_cols, l_cols))
        assert all(a is b for a, b in zip(ranges.r_cols, r_cols))


# -- running max / min (prims.scan), the window and set-operation pieces ------

_RUN_LENGTHS = [0, 1, 2, 1023, 1024, 1025]


def _edge_ints(rng, n):
    x = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
    if n:
        x[rng.random(n) < 0.05] = I32_MIN
        x[rng.random(n) < 0.05] = I32_MAX
        x[0] = (I32_MIN, I32_MAX)[n % 2]
    return torch.from_numpy(x)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("n", _RUN_LENGTHS)
def test_running_max_min_match_torch_cummax(n, op, reverse):
    """The helper equals torch.cummax / torch.cummin on int32, edge values
    included; so does kernel B's plain version over one segment, which is
    what a CUDA tensor takes."""
    from harkdb_tpu_torch.kernels.segscan import flat_segscan_reference
    from harkdb_tpu_torch.prims.scan import running_max, running_min

    x = _edge_ints(np.random.default_rng(n), n)
    helper = running_max if op == "max" else running_min
    cum = torch.cummax if op == "max" else torch.cummin

    def expect(a):
        if reverse:
            return torch.flip(cum(torch.flip(a, [0]), 0).values, [0])
        return cum(a, 0).values

    got = helper(x, reverse=reverse)
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert torch.equal(got, expect(x))
    xs = torch.flip(x, [0]) if reverse else x
    plain = flat_segscan_reference(
        op, torch.zeros(n, dtype=torch.int32), [xs],
        I32_MIN if op == "max" else I32_MAX)[0]
    if reverse:
        plain = torch.flip(plain, [0])
    assert torch.equal(plain, expect(x))


# Lengths around kernel B's 4096-row tiles.
_TILE_LENGTHS = [1, 4095, 4096, 4097, 3 * 4096 + 5]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("n", _TILE_LENGTHS)
def test_running_max_min_match_lax(n, op, reverse):
    """The helper equals the JAX package's running scans: lax.cummax /
    lax.cummin, and jnp.flip(lax.cummin(jnp.flip(x))) for the reversed
    form (ops/join.py, ops/groupby.py), on int32 edge values."""
    from jax import lax

    from harkdb_tpu_torch.prims.scan import running_max, running_min

    x = _edge_ints(np.random.default_rng(n + 7), n)
    helper = running_max if op == "max" else running_min
    scan = lax.cummax if op == "max" else lax.cummin
    xj = jnp.asarray(x.numpy())
    exp = jnp.flip(scan(jnp.flip(xj))) if reverse else scan(xj)
    got = helper(x, reverse=reverse)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_running_max_rejects_other_dtypes():
    from harkdb_tpu_torch.prims.scan import running_max

    with pytest.raises(ValueError, match="1-D int32"):
        running_max(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="1-D int32"):
        running_max(torch.zeros((2, 2), dtype=torch.int32))


def _runs(rng, cap, count):
    """Run starts over ``count`` live rows of ``cap`` (random lengths)."""
    starts = np.zeros(cap, bool)
    if count:
        starts[0] = True
        starts[:count] |= rng.random(count) < 0.3
    return starts


@pytest.mark.parametrize("cap,count", [(1, 1), (64, 0), (64, 64),
                                        (300, 211), (1024, 1000)])
def test_window_take_first_broadcasts_match_doubling_scan(cap, count):
    """plan/windows.py's run_first / run_last gathers equal the JAX
    package's take-first doubling scans (windows.py peers_last /
    part_last, first_value and the suffix scan's partition-first value)
    on every row, padding rows included."""
    from harkdb_tpu_torch.plan.windows import run_first, run_last

    rng = np.random.default_rng(cap + count)
    starts = _runs(rng, cap, count)
    x = rng.integers(-99, 99, cap).astype(np.int32)
    f = rng.standard_normal(cap).astype(np.float32)
    idx = np.arange(cap)
    valid = idx < count
    sid = (np.cumsum(starts) - 1).astype(np.int32)
    safe = np.where(valid, sid, np.int32(1 << 30)).astype(np.int32)

    def take_first(s, v):
        return np.asarray(jax_doubling(lambda cur, prev: prev,
                                       jnp.asarray(s), jnp.asarray(v)))

    def take_last(s, v):
        rev = np.flip(np.int32(1 << 30) - s).copy()
        return np.flip(take_first(rev, np.flip(v).copy()))

    t_starts = torch.from_numpy(starts | (idx == count))
    for v in (x, f):
        tv = torch.from_numpy(v)
        np.testing.assert_array_equal(run_last(tv, t_starts).numpy(),
                                      take_last(safe, v))
        np.testing.assert_array_equal(run_first(tv, t_starts).numpy(),
                                      take_first(safe, v))
        # first_value's scan runs over sid itself: with no live row at all
        # every id is -1 and the JAX scan reads its zero fill there; those
        # rows are padding either way
        has = sid >= 0
        np.testing.assert_array_equal(
            run_first(tv, torch.from_numpy(starts)).numpy()[has],
            take_first(sid, v)[has])


def test_window_restore_permutation_matches_sort():
    """The restore scatter equals the JAX package's sort by the carried
    original position (windows.py's restore step)."""
    import jax

    from harkdb_tpu_torch.plan.windows import restore_order

    rng = np.random.default_rng(5)
    n = 777
    origpos = rng.permutation(n).astype(np.int32)
    a = rng.integers(-9, 9, n).astype(np.int32)
    b = rng.standard_normal(n).astype(np.float32)
    want = jax.lax.sort([jnp.asarray(origpos), jnp.asarray(a),
                         jnp.asarray(b)], num_keys=1, is_stable=False)[1:]
    got = restore_order(torch.from_numpy(origpos),
                        [torch.from_numpy(a), torch.from_numpy(b)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _set_tuples(rng, n):
    """A packed tuple with duplicates: two value columns (one float) and
    one NULL-indicator column whose NULL cells hold the value 0."""
    k = rng.integers(0, 6, n).astype(np.int32)
    f = rng.choice(np.float32([0.5, -1.0, 2.0]), n)
    flag = (rng.random(n) < 0.8).astype(np.int32)
    k = np.where(flag == 1, k, 0).astype(np.int32)
    return [k, f, flag]


def _union_plans():
    from harkdb_tpu.config import DEFAULT_CONFIG as JCFG
    from harkdb_tpu.plan.union_plan import UnionPlan as JUnion
    from harkdb_tpu_torch.config import DEFAULT_CONFIG
    from harkdb_tpu_torch.plan.union_plan import UnionPlan

    ju = JUnion.__new__(JUnion)
    ju.config = JCFG
    tu = UnionPlan.__new__(UnionPlan)
    tu.config = DEFAULT_CONFIG
    return ju, tu


def _same_tuples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", [0, 1, 9, 400])
def test_union_dedupe_matches_jax(n):
    ju, tu = _union_plans()
    cols = _set_tuples(np.random.default_rng(n), n)
    got = tu._dedupe([torch.from_numpy(c) for c in cols], 1)
    want = ju._dedupe([jnp.asarray(c) for c in cols], 1)
    _same_tuples(got, want)


@pytest.mark.parametrize("op", ["intersect", "except"])
@pytest.mark.parametrize("na,nc", [(0, 5), (7, 0), (1, 1), (250, 180)])
def test_union_set_combine_matches_jax(op, na, nc):
    ju, tu = _union_plans()
    rng = np.random.default_rng(na * 1000 + nc)
    cols = [np.concatenate([a, c]) for a, c in
            zip(_set_tuples(rng, na), _set_tuples(rng, nc))]
    tag = np.concatenate([np.zeros(na, np.int32), np.ones(nc, np.int32)])
    got = tu._set_combine([torch.from_numpy(c) for c in cols],
                          torch.from_numpy(tag), op)
    want = ju._set_combine([jnp.asarray(c) for c in cols],
                           jnp.asarray(tag), op)
    _same_tuples(got, want)


# -- the radix pair sort under lexsort_permutation --------------------------

#: Key-dtype mixes by the order words they make: one word of at most 32
#: bits, one word of 33-64 bits, and two words.
_SORT_MIXES = {
    "le32": [("int32",), ("float32",), ("bool", "int8", "uint8"),
             ("int16", "int16")],
    "33to64": [("bool", "int32"), ("int32", "uint8"), ("float32", "int16"),
               ("int8", "int16", "int32"), ("int64",), ("float64",)],
    "two_words": [("int32", "int32"), ("int64", "bool"),
                  ("bool", "float64"), ("uint8", "float32", "int32")],
}
_SORT_CASES = [(cls, mix) for cls, mixes in _SORT_MIXES.items()
               for mix in mixes]


def _sort_key(rng, dtype: str, n: int) -> np.ndarray:
    """Few distinct values (ties), the dtype's extremes, and for floats
    ±0.0, NaN of both signs and ±inf."""
    if dtype == "bool":
        return rng.random(n) < 0.5
    dt = np.dtype(dtype)
    if dt.kind == "f":
        a = rng.integers(-3, 3, n).astype(dt)
        for v, p in ((-0.0, 0.15), (0.0, 0.1), (np.nan, 0.1), (-np.nan, 0.05),
                     (np.inf, 0.05), (-np.inf, 0.05)):
            a[rng.random(n) < p] = v
        return a
    info = np.iinfo(dt)
    a = rng.integers(max(info.min, -4), min(info.max, 4), n).astype(dt)
    a[rng.random(n) < 0.05] = info.min
    a[rng.random(n) < 0.05] = info.max
    return a


def _np_order(keys) -> np.ndarray:
    """NumPy's stable lexicographic order (``keys[0]`` most significant)
    under lax.sort's float order: -0.0 ties 0.0, every NaN after +inf."""
    cols = []
    for k in keys:
        if k.dtype.kind == "f":
            nan = np.isnan(k)
            cols += [nan, np.where(nan | (k == 0), 0, k)]
        else:
            cols.append(k.astype(np.int64) if k.dtype == bool else k)
    return np.lexsort(cols[::-1])


def _unsigned(word: torch.Tensor, bits: int) -> np.ndarray:
    w = word.numpy().view(np.uint32 if word.dtype == torch.int32
                          else np.uint64)
    return w & np.array((1 << bits) - 1, dtype=w.dtype)


@pytest.mark.parametrize("carry", [False, True], ids=["perm", "values"])
@pytest.mark.parametrize("cls,mix", _SORT_CASES,
                         ids=[f"{c}-{'+'.join(m)}" for c, m in _SORT_CASES])
def test_pair_sort_matches_numpy_stable_order(cls, mix, carry):
    """``order_words`` makes the mix's word class; ``sort_pairs``' plain
    twin sorts each word as NumPy's stable argsort of its low bits does;
    ``lexsort_permutation`` gives NumPy's stable lexicographic order (ties
    in input order, INT32_MIN / INT32_MAX, ±0.0 and NaN included), as the
    int32 permutation or as the sorted last word and carried values; and
    ``sort_batch`` puts pad rows last."""
    from harkdb_tpu_torch.kernels import radix_sort as R
    from harkdb_tpu_torch.ops import sort as S

    rng = np.random.default_rng(len(_SORT_CASES) * carry
                                + _SORT_CASES.index((cls, mix)))
    n = 3001
    keys = [_sort_key(rng, d, n) for d in mix]
    tkeys = [torch.from_numpy(k) for k in keys]
    words = S.order_words(tkeys)
    bits = [b for _w, b in words]
    if cls == "two_words":
        assert len(words) == 2
    else:
        assert len(words) == 1 and (bits[0] <= 32) == (cls == "le32")
        assert words[0][0].dtype == (torch.int32 if cls == "le32"
                                     else torch.int64)
    assert S.one_integer_word(tkeys) == (
        len(words) == 1 and all(np.dtype(d).kind != "f" for d in mix))

    values = rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
    values[:2] = (I32_MIN, I32_MAX)
    for w, b in words:
        for low in (b, max(1, b - 5)):          # its own bits, and fewer
            got_w, got_v = R.sort_pairs(w.clone(), low,
                                        torch.from_numpy(values))
            order = np.argsort(_unsigned(w, low), kind="stable")
            np.testing.assert_array_equal(got_w.numpy(), w.numpy()[order])
            np.testing.assert_array_equal(got_v.numpy(), values[order])

    want = _np_order(keys)
    if carry:
        sword, sval = S.lexsort_permutation(tkeys, torch.from_numpy(values))
        np.testing.assert_array_equal(sval.numpy(), values[want])
        np.testing.assert_array_equal(sword.numpy(),
                                      words[-1][0].numpy()[want])
    else:
        perm = S.lexsort_permutation(tkeys)
        assert perm.dtype == torch.int32
        np.testing.assert_array_equal(perm.numpy(), want)

    n_valid = n - 400
    cols = {f"k{i}": t for i, t in enumerate(tkeys)}
    cols["row"] = torch.arange(n, dtype=torch.int32)
    out = sort_batch(TBatch(cols, torch.tensor(n_valid, dtype=torch.int32)),
                     list(cols)[:-1])
    is_pad = np.arange(n) >= n_valid
    np.testing.assert_array_equal(out.columns["row"].numpy(),
                                  _np_order([is_pad] + keys))
    assert int(out.n_valid) == n_valid


def _brute_ranges(lk, rk, n_l, n_r, l_null, r_null):
    """compute_join_ranges' live fields by definition: lefts and rights in
    stable (key tuple, null code) order; a left matches the live rights of
    its tuple when neither is NULL; ``lo`` counts the rights before its
    tuple."""
    def side(keys, n_valid, null, code):
        tup = [tuple(int(k[i]) for k in keys)
               + ((code if null is not None and null[i] else 0),)
               for i in range(n_valid)]
        order = sorted(range(n_valid), key=lambda i: tup[i])
        return order, [tup[i] for i in order]

    l_order, l_tup = side(lk, n_l, l_null, 2)
    r_order, r_tup = side(rk, n_r, r_null, 1)
    counts = [sum(t == u for u in r_tup) if t[-1] == 0 else 0 for t in l_tup]
    lo = [sum(u < t for u in r_tup) for t in l_tup]
    r_matched = [u[-1] == 0 and u in l_tup for u in r_tup]
    total = sum(counts)
    total_left = sum(max(c, 1) for c in counts)
    return dict(l_orig=l_order, counts=counts, lo=lo, r_orig=r_order,
                r_matched=r_matched, total=total, total_left=total_left,
                total_full=total_left + r_matched.count(False))


_ONE_WORD_KEYS = [("int32",), ("int32", "nulls"), ("int16", "int8"),
                  ("int64",)]


@pytest.mark.parametrize("need_full", [False, True])
@pytest.mark.parametrize("sides", ["both", "empty_left", "empty_right"])
@pytest.mark.parametrize("layout", _ONE_WORD_KEYS,
                         ids=["+".join(k) for k in _ONE_WORD_KEYS])
def test_join_ranges_one_word_path(monkeypatch, layout, sides, need_full):
    """``compute_join_ranges`` with integer keys that pack into one order
    word reads its runs off the sorted word and carries the tag through the
    sort; field by field it equals the per-operand path (the same inputs
    with the one-word test turned off) and a brute-force reference, with
    duplicate keys, keys equal to the pads' fill, NULL codes, n_valid below
    capacity, an empty side and the FULL OUTER fields."""
    rng = np.random.default_rng(_ONE_WORD_KEYS.index(layout) * 10
                                + len(sides) + need_full)
    dtypes = [d for d in layout if d != "nulls"]
    nl, nr = 300, 200
    n_l = 0 if sides == "empty_left" else 280
    n_r = 0 if sides == "empty_right" else 190

    def keys(n):
        out = []
        for d in dtypes:
            k = rng.integers(0, 12, n).astype(d)
            k[rng.random(n) < 0.05] = np.iinfo(d).max    # the pads' fill
            k[rng.random(n) < 0.03] = np.iinfo(d).min
            out.append(k)
        return out

    lk, rk = keys(nl), keys(nr)
    l_null = rng.random(nl) < 0.15 if "nulls" in layout else None
    r_null = rng.random(nr) < 0.15 if "nulls" in layout else None

    def ranges():
        return TJ.compute_join_ranges(
            [torch.from_numpy(k) for k in lk],
            torch.tensor(n_l, dtype=torch.int32),
            [torch.from_numpy(k) for k in rk],
            torch.tensor(n_r, dtype=torch.int32),
            l_null=None if l_null is None else torch.from_numpy(l_null),
            r_null=None if r_null is None else torch.from_numpy(r_null),
            need_full=need_full)

    assert TJ.one_integer_word([torch.from_numpy(k) for k in lk]
                               + ([torch.from_numpy(l_null)]
                                  if l_null is not None else []))
    one = ranges()
    monkeypatch.setattr(TJ, "one_integer_word", lambda keys: False)
    per_operand = ranges()
    want = _brute_ranges(lk, rk, n_l, n_r, l_null, r_null)

    for got in (one, per_operand):
        n_lefts = int(got.n_lefts)
        assert n_lefts == n_l
        for name in ("l_orig", "counts", "lo"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy()[:n_lefts], want[name],
                err_msg=name)
        np.testing.assert_array_equal(got.r_orig.numpy()[:n_r],
                                      want["r_orig"])
        assert int(got.total) == want["total"]
        assert int(got.total_left) == want["total_left"]
        assert float(got.total_approx) == want["total"]
        if need_full:
            assert int(got.total_full) == want["total_full"]
            np.testing.assert_array_equal(got.r_matched.numpy()[:n_r],
                                          want["r_matched"])
            assert got.r_matched.numpy()[n_r:].all()
        else:
            assert got.total_full is None and got.r_matched is None
    for name in ("l_orig", "counts", "lo", "r_orig", "n_lefts", "total",
                 "total_left", "total_approx"):
        assert torch.equal(getattr(one, name), getattr(per_operand, name)), \
            name
    if need_full:
        assert torch.equal(one.r_matched, per_operand.r_matched)
        assert torch.equal(one.total_full, per_operand.total_full)


def test_sort_counters_give_a_lone_int32_join_key_32_bits():
    """``QueryMetrics.sort_rows`` / ``sort_row_bits``: a join on one int32
    key sorts both sides' rows (to their capacities) once, over 32 bits; a
    group-by on the joined rows (a key span too wide for the dense path)
    adds a word of the drop flag and its int32 key, 33 bits."""
    import harkdb_tpu_torch as H

    rng = np.random.default_rng(7)
    ctx = H.Context(device="cpu")
    ctx.create_table("f", {"k": rng.integers(0, 50, 1000).astype(np.int32),
                           "v": rng.integers(0, 9, 1000).astype(np.int32)})
    ctx.create_table("d", {"j": np.arange(64, dtype=np.int32),
                           "g": rng.integers(0, 10**7, 64).astype(np.int32)})
    ctx.sql("select f.v, d.g from f join d on f.k = d.j")
    m = ctx.last_metrics
    assert m.sort_rows >= 1000 + 64
    assert m.sort_row_bits == 32 * m.sort_rows
    ctx.sql("select f.v, d.g from f join d on f.k = d.j")
    assert ctx.last_metrics.sort_rows == m.sort_rows      # per query
    ctx.sql("select d.g, sum(f.v) as s from f join d on f.k = d.j "
            "group by d.g")
    m = ctx.last_metrics
    assert m.sort_row_bits > 32 * m.sort_rows
