"""harkdb_tpu_torch.prims vs harkdb_tpu.prims, on the CPU.

Every case of tests/test_prims.py and of test_parity.py's
TestExpandOuterReduceFoldsNe runs through both packages on the same inputs
(one parametrised test, a case each): the golden values hold for both, and
the port's outputs equal JAX's. Seeded random differentials
follow, per operator and dtype, for ``segmented_scan``,
``segmented_reduce``, ``expand``, ``expand_reduce``, ``expand_outer_reduce``
and ``compact``; then the public accessors of ``ColumnBatch`` and ``Table``
(``ShardedBatch``'s run on the gloo pool in tests/test_torch_parallel.py).

Tolerance: integers and bit patterns exact. A float32 add may differ by
1e-6 of the largest |prefix sum| of the input: JAX scans by differences of
one global cumsum (``harkdb_tpu/prims/segmented.py:95-104``), kernel B
and its plain version sum each segment, so the two round differently. A
float32 product of a segment may differ by 1e-4 of its value: JAX's
``segment_prod`` multiplies in row order, the scan in doubling order
(about one rounding per factor, segments of up to a few hundred rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import harkdb_tpu.prims as JP
import harkdb_tpu_torch.prims as TP
from harkdb_tpu.columnar.batch import ColumnBatch as JBatch
from harkdb_tpu_torch.columnar.batch import ColumnBatch as TBatch

I32_MIN = -(2**31)


class Jax:
    P = JP
    add, maximum, minimum, mul = jnp.add, jnp.maximum, jnp.minimum, \
        jnp.multiply
    bitwise_xor = jnp.bitwise_xor

    @staticmethod
    def arr(x, dtype=np.int32):
        return jnp.asarray(np.asarray(x, dtype))

    @staticmethod
    def count(n):
        return jnp.int32(n)

    @staticmethod
    def batch(arrays):
        return JBatch.from_numpy(arrays)


class Torch:
    P = TP
    add, maximum, minimum, mul = torch.add, torch.maximum, torch.minimum, \
        torch.mul
    bitwise_xor = torch.bitwise_xor

    @staticmethod
    def arr(x, dtype=np.int32):
        return torch.from_numpy(np.array(x, dtype))

    @staticmethod
    def count(n):
        return torch.tensor(n, dtype=torch.int32)

    @staticmethod
    def batch(arrays):
        return TBatch.from_numpy(arrays, device="cpu")


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- tests/test_prims.py, case by case -----------------------------------------
# Each case runs on one backend ``B``, checks the golden values of
# tests/test_prims.py and returns its outputs for the cross-package check.

def scan_golden(B):
    out = B.P.segmented_scan(B.add, 0, B.arr([1, 0, 0, 1, 0, 0, 1, 0, 0],
                                             np.bool_),
                             B.arr([1, 2, 3, 4, 5, 6, 7, 8, 9]))
    np.testing.assert_array_equal(_np(out), [1, 3, 6, 4, 9, 15, 7, 15, 24])
    return [out]


def scan_single_segment(B):
    out = B.P.segmented_scan(B.add, 0, B.arr([1, 0, 0, 0], np.bool_),
                             B.arr([2, 2, 2, 2]))
    np.testing.assert_array_equal(_np(out), [2, 4, 6, 8])
    return [out]


def scan_max_op(B):
    out = B.P.segmented_scan(B.maximum, I32_MIN, B.arr([1, 0, 1, 0], np.bool_),
                             B.arr([3, 1, -5, -2]))
    np.testing.assert_array_equal(_np(out), [3, 3, -5, -2])
    return [out]


def scan_random_vs_numpy(B):
    rng = np.random.default_rng(0)
    n = 1000
    vals = rng.integers(-50, 50, n).astype(np.int32)
    flags = rng.random(n) < 0.1
    flags[0] = True
    out = B.P.segmented_scan(B.add, 0, B.arr(flags, np.bool_), B.arr(vals))
    expect = np.zeros(n, np.int32)
    acc = 0
    for i in range(n):
        acc = vals[i] if flags[i] else acc + vals[i]
        expect[i] = acc
    np.testing.assert_array_equal(_np(out), expect)
    return [out]


def reduce_golden(B):
    out, n = B.P.segmented_reduce(
        B.add, 0, B.arr([1, 0, 0, 1, 0, 0, 1, 0, 0], np.bool_),
        B.arr([1, 2, 3, 4, 5, 6, 7, 8, 9]))
    assert int(n) == 3
    np.testing.assert_array_equal(_np(out)[:3], [6, 15, 24])
    return [out, n]


def reduce_unflagged_first_element_opens_segment(B):
    out, n = B.P.segmented_reduce(B.add, 0, B.arr([0, 0, 1, 0], np.bool_),
                                  B.arr([1, 2, 10, 20]))
    assert int(n) == 2
    np.testing.assert_array_equal(_np(out)[:2], [3, 30])
    return [out, n]


def reduce_padding_ignored(B):
    out, n = B.P.segmented_reduce(
        B.add, 0, B.arr([1, 0, 1, 0, 1, 0], np.bool_),
        B.arr([1, 2, 3, 4, 99, 99]), n_valid=B.count(4))
    assert int(n) == 2
    np.testing.assert_array_equal(_np(out)[:2], [3, 7])
    return [out, n]


def reduce_empty(B):
    out, n = B.P.segmented_reduce(B.add, 0, B.arr([1, 0], np.bool_),
                                  B.arr([5, 5]), n_valid=B.count(0))
    assert int(n) == 0
    return [out, n]


def reduce_random_vs_numpy(B):
    rng = np.random.default_rng(0)
    n = 512
    vals = rng.integers(0, 100, n).astype(np.int32)
    flags = rng.random(n) < 0.15
    out, k = B.P.segmented_reduce(B.add, 0, B.arr(flags, np.bool_),
                                  B.arr(vals))
    f = flags.copy()
    f[0] = True
    seg_ids = np.cumsum(f.astype(np.int64)) - 1
    expect = np.zeros(seg_ids[-1] + 1, np.int32)
    np.add.at(expect, seg_ids, vals)
    assert int(k) == len(expect)
    np.testing.assert_array_equal(_np(out)[: int(k)], expect)
    return [out, k]


def iota_golden(B):
    ids, total = B.P.replicated_iota(B.arr([2, 3, 1]), out_capacity=8)
    assert int(total) == 6
    np.testing.assert_array_equal(_np(ids)[:6], [0, 0, 1, 1, 1, 2])
    return [ids, total]


def iota_zero_length_segments(B):
    ids, total = B.P.replicated_iota(B.arr([2, 0, 1]), out_capacity=4)
    assert int(total) == 3
    np.testing.assert_array_equal(_np(ids)[:3], [0, 0, 2])
    return [ids, total]


def iota_leading_zero(B):
    ids, total = B.P.replicated_iota(B.arr([0, 0, 3]), out_capacity=4)
    assert int(total) == 3
    np.testing.assert_array_equal(_np(ids)[:3], [2, 2, 2])
    return [ids, total]


def iota_all_empty(B):
    ids, total = B.P.replicated_iota(B.arr([0, 0, 0]), out_capacity=4)
    assert int(total) == 0
    return [ids, total]


def iota_capacity_truncation(B):
    ids, total = B.P.replicated_iota(B.arr([2, 3, 4]), out_capacity=4,
                                     n_valid=B.count(2))
    assert int(total) == 5
    np.testing.assert_array_equal(_np(ids), [0, 0, 1, 1])
    return [ids, total]


def iota_truncation_with_invalid_tail(B):
    ids, total = B.P.replicated_iota(B.arr([3, 3, 7, 9]), out_capacity=4,
                                     n_valid=B.count(3))
    assert int(total) == 13
    np.testing.assert_array_equal(_np(ids), [0, 0, 0, 1])
    return [ids, total]


def segmented_iota_golden(B):
    out = B.P.segmented_iota(B.arr([1, 0, 0, 1, 0, 1], np.bool_))
    np.testing.assert_array_equal(_np(out), [0, 1, 2, 0, 1, 0])
    return [out]


def expand_golden(B):
    src = B.arr([1, 2, 3])
    out, total = B.P.expand(2 * src, lambda s, loc: src[s] * loc,
                            out_capacity=16)
    assert int(total) == 12
    np.testing.assert_array_equal(_np(out)[:12],
                                  [0, 1, 0, 2, 4, 6, 0, 3, 6, 9, 12, 15])
    return [out, total]


def expand_with_empty_rows(B):
    src = B.arr([5, 7, 9])
    out, total = B.P.expand(B.arr([2, 0, 1]), lambda s, loc: src[s] + loc,
                            out_capacity=8)
    assert int(total) == 3
    np.testing.assert_array_equal(_np(out)[:3], [5, 6, 9])
    return [out, total]


def compaction_basic(B):
    idx, count = B.P.compact_indices(B.arr([0, 1, 1, 0, 1, 0], np.bool_))
    assert int(count) == 3
    np.testing.assert_array_equal(_np(idx)[:3], [1, 2, 4])
    return [idx, count]


def compaction_compact_values(B):
    out, count = B.P.compact(B.arr([10, 11, 12, 13, 14, 15]),
                             B.arr([1, 0, 0, 1, 0, 1], np.bool_))
    assert int(count) == 3
    np.testing.assert_array_equal(_np(out)[:3], [10, 13, 15])
    return [out, count]


def compaction_respects_n_valid(B):
    idx, count = B.P.compact_indices(B.arr([1, 1, 1, 1], np.bool_),
                                     n_valid=B.count(2))
    assert int(count) == 2
    return [idx, count]


def compaction_none_survive(B):
    idx, count = B.P.compact_indices(B.arr([0, 0, 0], np.bool_))
    assert int(count) == 0
    return [idx, count]


def compaction_batch(B):
    batch = B.batch({"a": np.array([1, 2, 3, 4], np.int32),
                     "b": np.array([10, 20, 30, 40], np.int32)})
    out = B.P.compact_batch(batch, B.arr([0, 1, 0, 1], np.bool_))
    assert int(out.n_valid) == 2
    np.testing.assert_array_equal(_np(out.column("a"))[:2], [2, 4])
    np.testing.assert_array_equal(_np(out.column("b"))[:2], [20, 40])
    return [out.n_valid, out.column("a")[:2], out.column("b")[:2]]


def compaction_stable_order_random(B):
    rng = np.random.default_rng(0)
    n = 2048
    vals = rng.integers(0, 1000, n).astype(np.int32)
    mask = rng.random(n) < 0.4
    out, count = B.P.compact(B.arr(vals), B.arr(mask, np.bool_))
    np.testing.assert_array_equal(_np(out)[: int(count)], vals[mask])
    return [out, count]


def expand_reduce_golden(B):
    src = B.arr([1, 2, 3])
    out, _n = B.P.expand_reduce(2 * src, lambda s, loc: src[s] * loc, B.add,
                                0, out_capacity=16)
    np.testing.assert_array_equal(_np(out)[:3], [1, 12, 45])
    return [out, _n]


def expand_reduce_zero_sizes_yield_ne(B):
    vals = B.arr([5, 7, 9])
    out, _n = B.P.expand_reduce(B.arr([2, 0, 1]), lambda s, loc: vals[s],
                                B.add, 0, out_capacity=8)
    np.testing.assert_array_equal(_np(out)[:3], [10, 0, 9])
    return [out, _n]


def expand_reduce_max_op_fallback(B):
    out, _n = B.P.expand_outer_reduce(
        B.arr([3, 2]), lambda s, loc: (s + 1) * 10 + loc, B.maximum, I32_MIN,
        out_capacity=8)
    np.testing.assert_array_equal(_np(out)[:2], [12, 21])
    return [out, _n]


# tests/test_parity.py's TestExpandOuterReduceFoldsNe: a non-identity ``ne``
# folds into every row (segmented.fut:97-103: row i is [ne] ++ elems).

def outer_reduce_folds_non_identity_ne(B):
    vals = B.arr([10, 20, 30])
    out, n = B.P.expand_outer_reduce(
        B.arr([2, 0, 1]), lambda s, loc: vals[s] + loc, B.add, 5,
        out_capacity=8)
    # row0: 5 + (10 + 11) = 26; row1: ne = 5; row2: 5 + 30 = 35
    np.testing.assert_array_equal(_np(out)[:3], [26, 5, 35])
    return [out, n]


def outer_reduce_identity_ne_matches_expand_reduce(B):
    vals = B.arr([4, 7, 2])

    def get(s, loc):
        return vals[s] * (loc + 1)

    a, na = B.P.expand_reduce(B.arr([3, 1, 2]), get, B.add, 0,
                              out_capacity=8)
    b, nb = B.P.expand_outer_reduce(B.arr([3, 1, 2]), get, B.add, 0,
                                    out_capacity=8)
    np.testing.assert_array_equal(_np(a)[:3], _np(b)[:3])
    return [a, na, b, nb]


def outer_reduce_max_with_floor_ne(B):
    vals = B.arr([3, 100])
    out, n = B.P.expand_outer_reduce(
        B.arr([2, 0]), lambda s, loc: vals[s] + loc, B.maximum, 50,
        out_capacity=4)
    np.testing.assert_array_equal(_np(out)[:2], [50, 50])   # ne as a floor
    return [out, n]


FOLDS_NE_CASES = [
    outer_reduce_folds_non_identity_ne,
    outer_reduce_identity_ne_matches_expand_reduce,
    outer_reduce_max_with_floor_ne,
]

PRIMS_CASES = [
    scan_golden, scan_single_segment, scan_max_op, scan_random_vs_numpy,
    reduce_golden, reduce_unflagged_first_element_opens_segment,
    reduce_padding_ignored, reduce_empty, reduce_random_vs_numpy,
    iota_golden, iota_zero_length_segments, iota_leading_zero,
    iota_all_empty, iota_capacity_truncation,
    iota_truncation_with_invalid_tail, segmented_iota_golden, expand_golden,
    expand_with_empty_rows, compaction_basic, compaction_compact_values,
    compaction_respects_n_valid, compaction_none_survive, compaction_batch,
    compaction_stable_order_random, expand_reduce_golden,
    expand_reduce_zero_sizes_yield_ne, expand_reduce_max_op_fallback,
]


@pytest.mark.parametrize("case", PRIMS_CASES + FOLDS_NE_CASES,
                         ids=lambda c: c.__name__)
def test_prims_case_matches_jax(case):
    """A case of tests/test_prims.py or of test_parity.py's
    TestExpandOuterReduceFoldsNe on both packages: golden values, and the
    port's outputs equal JAX's whole (padding included)."""
    want = case(Jax)
    got = case(Torch)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_every_jax_prim_is_exported():
    assert set(JP.__all__) <= set(TP.__all__)
    for name in TP.__all__:
        assert callable(getattr(TP, name))


# -- seeded random differentials --------------------------------------------------

OPS = ["add", "maximum", "minimum", "mul"]
DTYPES = [np.int32, np.float32, np.int16, np.int8]


def _values(rng, n, op, dtype):
    if dtype == np.float32:
        if op == "mul":
            return rng.uniform(0.5, 1.5, n).astype(np.float32)
        return rng.standard_normal(n).astype(np.float32)
    if op == "mul":
        return rng.integers(-3, 4, n).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, n).astype(dtype)


def _neutral(op, dtype):
    if op in ("add", "mul"):
        return 0 if op == "add" else 1
    if dtype == np.float32:
        return float("-inf") if op == "maximum" else float("inf")
    info = np.iinfo(dtype)
    return int(info.min) if op == "maximum" else int(info.max)


def _assert_close(got, want, op, dtype, values):
    got, want = _np(got), _np(want)
    if dtype == np.float32 and op in ("add", "mul"):
        if op == "add":
            tol = 1e-6 * np.abs(np.cumsum(values.astype(np.float64))).max(
                initial=0.0)
        else:
            tol = 1e-4 * np.abs(want)
        assert np.all(np.abs(got.astype(np.float64) - want) <= tol), (
            np.abs(got.astype(np.float64) - want).max())
    else:
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("op", OPS)
def test_segmented_scan_and_reduce_random(op, dtype):
    rng = np.random.default_rng(OPS.index(op) * 10 + DTYPES.index(dtype))
    for n, p_flag in ((1, 0.5), (37, 0.0), (1000, 0.1), (5000, 0.01)):
        vals = _values(rng, n, op, dtype)
        flags = rng.random(n) < p_flag
        ne = _neutral(op, dtype)
        want = JP.segmented_scan(getattr(Jax, op), ne, Jax.arr(flags, np.bool_),
                                 Jax.arr(vals, dtype))
        got = TP.segmented_scan(getattr(Torch, op), ne,
                                Torch.arr(flags, np.bool_),
                                Torch.arr(vals, dtype))
        assert got.dtype == torch.from_numpy(vals).dtype
        _assert_close(got, want, op, dtype, vals)
        for nv in sorted({0, n // 2, n}):
            want, wn = JP.segmented_reduce(
                getattr(Jax, op), ne, Jax.arr(flags, np.bool_),
                Jax.arr(vals, dtype), Jax.count(nv))
            got, gn = TP.segmented_reduce(
                getattr(Torch, op), ne, Torch.arr(flags, np.bool_),
                Torch.arr(vals, dtype), Torch.count(nv))
            assert int(gn) == int(wn)
            _assert_close(got, want, op, dtype, vals[:nv])


@pytest.mark.parametrize("op", OPS + ["bitwise_xor"])
def test_expand_reduce_random(op):
    """``expand``, ``expand_reduce`` and ``expand_outer_reduce`` with a
    ``get`` that gathers from two planes, over sizes with empty rows, an
    ``n_valid`` cut and an output capacity that cuts the expansion."""
    rng = np.random.default_rng(100 + (OPS + ["bitwise_xor"]).index(op))
    for n in (1, 300):
        sizes = rng.integers(0, 6, n).astype(np.int32)
        sizes[rng.random(n) < 0.3] = 0
        a = rng.integers(-1000, 1000, n).astype(np.int32)
        b = rng.integers(-3, 4, n).astype(np.int32)
        ne = _neutral(op, np.int32) if op in OPS else 0
        total = int(sizes.sum())
        for nv in sorted({0, n // 2, n}):
            for cap in sorted({max(1, total // 2), total + 5}):
                outs = []
                for B in (Jax, Torch):
                    pa, pb = B.arr(a), B.arr(b)

                    def get(s, loc, pa=pa, pb=pb):
                        return pa[s] * (op != "mul") + pb[s] * loc + (
                            op == "mul")

                    r = [B.P.expand(B.arr(sizes), get, cap, B.count(nv)),
                         B.P.expand_reduce(B.arr(sizes), get, getattr(B, op),
                                           ne, cap, B.count(nv)),
                         B.P.expand_outer_reduce(
                             B.arr(sizes), get, getattr(B, op), ne, cap,
                             B.count(nv))]
                    outs.append([_np(x) for pair in r for x in pair])
                for w, g in zip(*outs):
                    np.testing.assert_array_equal(g, w, err_msg=(
                        f"n={n} nv={nv} cap={cap}"))


@pytest.mark.parametrize("op", ["bitwise_xor", "first"])
def test_other_callables_take_the_pair_scan(op):
    """A callable other than add / maximum / minimum / mul: JAX's
    ``lax.associative_scan`` over (flag, value) against the port's
    doubling pair scan; ``first`` (keep the left operand) is associative
    but not commutative, so it pins the operand order."""
    fn = {"bitwise_xor": (jnp.bitwise_xor, torch.bitwise_xor),
          "first": (lambda x, y: x, lambda x, y: x)}[op]
    rng = np.random.default_rng(7)
    for n in (1, 33, 1000):
        vals = rng.integers(-1000, 1000, n).astype(np.int32)
        flags = rng.random(n) < 0.2
        want = JP.segmented_scan(fn[0], 0, Jax.arr(flags, np.bool_),
                                 Jax.arr(vals))
        got = TP.segmented_scan(fn[1], 0, Torch.arr(flags, np.bool_),
                                Torch.arr(vals))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want, wn = JP.segmented_reduce(fn[0], 0, Jax.arr(flags, np.bool_),
                                       Jax.arr(vals), Jax.count(n - n // 3))
        got, gn = TP.segmented_reduce(fn[1], 0, Torch.arr(flags, np.bool_),
                                      Torch.arr(vals), Torch.count(n - n // 3))
        assert int(gn) == int(wn)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.bool_, np.int16])
def test_compact_random(dtype):
    rng = np.random.default_rng(11)
    for n in (1, 100, 4097):
        if dtype == np.float32:
            vals = rng.standard_normal(n).astype(np.float32)
            vals[rng.random(n) < 0.1] = np.nan
            vals[rng.random(n) < 0.1] = -0.0
        elif dtype == np.bool_:
            vals = rng.random(n) < 0.5
        else:
            vals = rng.integers(-30000, 30000, n).astype(dtype)
        for sel in (0.0, 0.3, 1.0):
            mask = rng.random(n) < sel
            for nv in (None, n // 2):
                jn = None if nv is None else Jax.count(nv)
                tn = None if nv is None else Torch.count(nv)
                want, wc = JP.compact(Jax.arr(vals, dtype),
                                      Jax.arr(mask, np.bool_), jn, fill=3)
                got, gc = TP.compact(Torch.arr(vals, dtype),
                                     Torch.arr(mask, np.bool_), tn, fill=3)
                assert int(gc) == int(wc)
                assert got.dtype == torch.from_numpy(vals).dtype
                np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                              np.asarray(want).view(np.uint8))


def test_eight_byte_types_raise_on_the_card_only():
    """int64 has no kernel B route: on the CPU it scans plainly (as JAX
    does under x64); a CUDA tensor would raise, which the card tests pin."""
    vals = np.arange(10, dtype=np.int64) * (1 << 40)
    flags = np.arange(10) % 3 == 0
    got = TP.segmented_scan(torch.add, 0, torch.from_numpy(flags),
                            torch.from_numpy(vals))
    expect = np.concatenate([np.cumsum(vals[i:i + 3])
                             for i in range(0, 10, 3)])
    np.testing.assert_array_equal(got.numpy(), expect)


# -- the accessors ----------------------------------------------------------------

def test_column_batch_accessors_match_jax():
    cols = {"a": np.array([3, 1, 2, 9, 9], np.int32),
            "b": np.array([0.5, 1.5, -2.0, 0.0, 0.0], np.float32)}
    jb = JBatch(JBatch.from_numpy(cols).columns, jnp.int32(3))
    tb = TBatch(TBatch.from_numpy(cols, device="cpu").columns,
                torch.tensor(3, dtype=torch.int32))
    np.testing.assert_array_equal(tb.valid_mask().numpy(),
                                  np.asarray(jb.valid_mask()))
    assert tb.valid_mask().dtype == torch.bool
    jr, tr = jb.rename({"a": "x"}), tb.rename({"a": "x"})
    assert tr.names == jr.names == ["x", "b"]
    assert tr.n_valid is tb.n_valid
    jw = jb.with_columns({"c": jb.columns["a"]})
    tw = tb.with_columns({"c": tb.columns["a"]})
    assert tw.names == jw.names == ["c"] and int(tw.n_valid) == 3
    np.testing.assert_array_equal(tw.to_numpy()[0], jw.to_numpy()[0])


def test_table_nbytes_matches_jax():
    import harkdb_tpu
    import harkdb_tpu_torch

    data = {"k": np.arange(1500, dtype=np.int32),
            "f": np.linspace(0, 1, 1500).astype(np.float32)}
    j = harkdb_tpu.Context()
    j.create_table("t", dict(data))
    t = harkdb_tpu_torch.Context(device="cpu")
    t.create_table("t", dict(data))
    assert t.tables["t"].nbytes() == j.tables["t"].nbytes() > 0
