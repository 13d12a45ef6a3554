"""The join's count phase around the pair sort (``kernels/join_runs.py``),
on the CPU: the words kernel's plain version against ``ops.sort``'s order
words of the padded keys, bit for bit, and ``compute_join_ranges`` against
the JAX package's at the count phase's edges (an empty side, no live rows,
one key for every row, live keys at INT32_MAX beside the pads, INT32_MIN,
NULL codes on either side); which joins take the two kernels' path; and the
per-query counters of the rows that took it.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``,
which holds them to these plain versions bit for bit).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import harkdb_tpu.ops.join as JJ
import harkdb_tpu_torch as H
from harkdb_tpu_torch.kernels import join_runs as K
from harkdb_tpu_torch.ops import join as TJ
from harkdb_tpu_torch.ops import sort as S

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1

#: (name, (left capacity, right capacity, live left, live right), keys,
#: NULL flags on: "" / "l" / "r" / "lr")
EDGES = [
    ("both_live", (300, 200, 280, 190), "few", ""),
    ("empty_left_capacity", (0, 200, 0, 190), "few", ""),
    ("empty_right_capacity", (300, 0, 280, 0), "few", ""),
    ("no_live_left", (300, 200, 0, 190), "few", ""),
    ("no_live_right", (300, 200, 280, 0), "few", ""),
    ("all_pads", (300, 200, 0, 0), "few", ""),
    ("one_key_every_row", (300, 200, 300, 200), "one", ""),
    ("int32_max_beside_pads", (300, 200, 250, 150), "max", ""),
    ("int32_min", (300, 200, 280, 190), "min", ""),
    ("nulls_left", (300, 200, 280, 190), "few", "l"),
    ("nulls_right", (300, 200, 280, 190), "few", "r"),
    ("nulls_both_at_max", (300, 200, 250, 150), "max", "lr"),
]


def edge_inputs(i, sizes, keys, nulls):
    """numpy keys over whole capacities (pads hold junk, INT32_MAX among
    it), live counts and NULL flags for one edge case."""
    rng = np.random.default_rng(100 + i)
    nl, nr, n_l, n_r = sizes

    def side(n):
        k = rng.integers(-3, 9, n).astype(np.int32)
        if keys == "one":
            k[:] = 7
        elif keys == "max":
            k[rng.random(n) < 0.4] = I32_MAX
        elif keys == "min":
            k[rng.random(n) < 0.4] = I32_MIN
        return k

    lk, rk = side(nl), side(nr)
    lk[n_l:][::3] = I32_MAX             # junk on the pads
    rk[n_r:][::2] = I32_MAX
    l_null = rng.random(nl) < 0.2 if "l" in nulls else None
    r_null = rng.random(nr) < 0.2 if "r" in nulls else None
    return lk, rk, n_l, n_r, l_null, r_null


def torch_ranges(lk, rk, n_l, n_r, l_null, r_null, need_full=False):
    def t(a):
        return None if a is None else torch.from_numpy(a)
    return TJ.compute_join_ranges(
        [t(k) for k in lk], torch.tensor(n_l, dtype=torch.int32),
        [t(k) for k in rk], torch.tensor(n_r, dtype=torch.int32),
        l_null=t(l_null), r_null=t(r_null), need_full=need_full)


def jax_ranges(lk, rk, n_l, n_r, l_null, r_null):
    def j(a):
        return None if a is None else jnp.asarray(a)
    return JJ.compute_join_ranges(
        [j(k) for k in lk], jnp.int32(n_l), [j(k) for k in rk],
        jnp.int32(n_r), l_null=j(l_null), r_null=j(r_null))


def assert_live_equal(got, want, n_l, n_r):
    """``got`` (the port's JoinRanges) against ``want`` (the JAX
    package's) on the live rows and the totals."""
    def field(name):
        return np.asarray(getattr(want, name))

    assert int(got.n_lefts) == int(field("n_lefts")) == n_l
    for name in ("l_orig", "counts", "lo"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[:n_l],
                                      field(name)[:n_l], err_msg=name)
    np.testing.assert_array_equal(got.r_orig.numpy()[:n_r],
                                  field("r_orig")[:n_r])
    for name in ("total", "total_left"):
        assert int(getattr(got, name)) == int(field(name)), name
        assert getattr(got, name).dtype == torch.int32, name
    assert float(got.total_approx) == int(field("total"))
    assert not got.counts[n_l:].any()


@pytest.mark.parametrize("i", range(len(EDGES)), ids=[e[0] for e in EDGES])
def test_join_words_reference_is_order_words_of_the_padded_keys(i):
    """Bit for bit: the word of every row, pads included, is
    ``ops.sort.order_words`` of today's padded keys (and NULL codes), and
    the tag is the row within its side with the side and pad bits."""
    _name, sizes, keys, nulls = EDGES[i]
    lk, rk, n_l, n_r, l_null, r_null = edge_inputs(i, sizes, keys, nulls)
    tl, tr = torch.from_numpy(lk), torch.from_numpy(rk)
    tn = [None if f is None else torch.from_numpy(f) for f in (l_null, r_null)]
    nlt, nrt = (torch.tensor(v, dtype=torch.int32) for v in (n_l, n_r))
    word, bits, tag = K.join_words_reference(tl, nlt, tr, nrt, *tn)
    (want, want_bits), = S.order_words(TJ._padded_keys(
        [tl], nlt, [tr], nrt, *tn))
    assert bits == want_bits == (40 if nulls else 32)
    assert word.dtype == want.dtype
    assert torch.equal(word, want)
    nl, nr = sizes[:2]
    side = np.r_[np.zeros(nr, np.int64), np.ones(nl, np.int64)]
    row = np.r_[np.arange(nr), np.arange(nl)]
    pad = np.r_[np.arange(nr) >= n_r, np.arange(nl) >= n_l]
    want_tag = (row | side << 30 | pad.astype(np.int64) << 31)
    np.testing.assert_array_equal(tag.numpy(), want_tag.astype(np.int32))
    # the wrapper takes the plain version on the CPU
    w2, b2, t2 = K.join_words(tl, nlt, tr, nrt, *tn)
    assert torch.equal(w2, word) and b2 == bits and torch.equal(t2, tag)


@pytest.mark.parametrize("i", range(len(EDGES)), ids=[e[0] for e in EDGES])
def test_join_ranges_at_the_count_phase_edges(i):
    """``compute_join_ranges`` through the words and runs path equals the
    JAX package's on the live rows, the counts' zeros past them and every
    total, and ``join_match_count``'s LEFT total equals the JAX
    package's."""
    _name, sizes, keys, nulls = EDGES[i]
    lk, rk, n_l, n_r, l_null, r_null = edge_inputs(i, sizes, keys, nulls)
    got = torch_ranges([lk], [rk], n_l, n_r, l_null, r_null)
    assert_live_equal(got, jax_ranges([lk], [rk], n_l, n_r, l_null, r_null),
                      n_l, n_r)
    def t(a):
        return None if a is None else torch.from_numpy(a)

    def j(a):
        return None if a is None else jnp.asarray(a)

    left = TJ.join_match_count(
        t(lk), torch.tensor(n_l, dtype=torch.int32), t(rk),
        torch.tensor(n_r, dtype=torch.int32), "left", l_null=t(l_null),
        r_null=t(r_null))
    jleft = JJ.join_match_count(j(lk), jnp.int32(n_l), j(rk), jnp.int32(n_r),
                                "left", l_null=j(l_null), r_null=j(r_null))
    assert int(left) == int(jleft) == int(got.total_left)


def _spy(monkeypatch):
    calls = []
    for name in ("join_words", "join_runs"):
        fn = getattr(TJ, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(TJ, name, spy)
    return calls


#: (keys a side as numpy dtypes, NULL flags, need_full) → the path's calls
PATHS = [
    ((np.int32,), False, False, ["join_words", "join_runs"]),
    ((np.int32,), True, False, ["join_words", "join_runs"]),
    ((np.int16, np.int8), False, False, ["join_runs"]),
    ((np.int64,), False, False, ["join_runs"]),
    ((np.int32,), False, True, []),
    ((np.int32, np.int32), False, False, []),
    ((np.float32,), False, False, []),
]


@pytest.mark.parametrize("case", range(len(PATHS)), ids=[
    "+".join(np.dtype(d).name for d in p[0]) + ("+nulls" if p[1] else "")
    + ("+full" if p[2] else "") for p in PATHS])
def test_which_joins_take_the_kernels_path(monkeypatch, case):
    """One int32 key a side (with or without NULL codes) takes both
    kernels' plain versions; other keys of one integer word build their
    word as before and take the runs; several words (a two-key join),
    float keys and FULL OUTER keep the composition. Every path equals the
    JAX package's."""
    dtypes, nulls, need_full, want_calls = PATHS[case]
    rng = np.random.default_rng(case)
    nl, nr, n_l, n_r = 400, 300, 380, 260

    def keys(n):
        return [rng.integers(0, 6, n).astype(d) for d in dtypes]

    lk, rk = keys(nl), keys(nr)
    if dtypes == (np.float32,):
        lk[0][::7], rk[0][::5] = np.nan, -0.0
    l_null = rng.random(nl) < 0.1 if nulls else None
    r_null = rng.random(nr) < 0.1 if nulls else None
    calls = _spy(monkeypatch)
    got = torch_ranges(lk, rk, n_l, n_r, l_null, r_null, need_full)
    assert calls == want_calls
    def j(a):
        return None if a is None else jnp.asarray(a)
    want = JJ.compute_join_ranges(
        [j(k) for k in lk], jnp.int32(n_l), [j(k) for k in rk],
        jnp.int32(n_r), l_null=j(l_null), r_null=j(r_null),
        need_full=need_full)
    assert_live_equal(got, want, n_l, n_r)
    if need_full:
        assert int(got.total_full) == int(want.total_full)
        np.testing.assert_array_equal(got.r_matched.numpy(),
                                      np.asarray(want.r_matched))


def test_join_runs_reference_reads_runs_off_the_word():
    """The runs' plain version on a hand-made sorted word and tag: a run
    crossing the pads, a left with no rights, and rights of a run with no
    left; the counts are 0 past the live lefts."""
    L, P = K.LEFT_BIT, K.PAD_BIT
    # word:  1  1  1  2  3  3  9  9  9    (sorted)
    # side:  r  r  l  l  r  l  r  pad-r l  pad-l
    word = torch.tensor([1, 1, 1, 2, 3, 3, 9, 9, 9, 9], dtype=torch.int32)
    tag = torch.tensor([4, 0, L | 2, L | 0, 1, L | 3, 3, P | 2, L | 1,
                        P | L | 4], dtype=torch.int32)
    runs = K.join_runs_reference(word, tag, 5, 4)
    assert int(runs.n_lefts) == 4
    assert runs.l_orig[:4].tolist() == [2, 0, 3, 1]
    assert runs.counts.tolist() == [2, 0, 1, 1, 0]
    assert runs.lo[:4].tolist() == [0, 2, 2, 3]
    assert runs.r_orig[:4].tolist() == [4, 0, 1, 3]
    assert (int(runs.total), int(runs.total_left),
            float(runs.total_approx)) == (4, 5, 4.0)
    assert all(torch.equal(a, b)
               for a, b in zip(K.join_runs(word, tag, 5, 4), runs))


def test_join_counters_count_the_count_phase_rows():
    """``QueryMetrics.join_rows``: both sides' capacities of every join
    step; ``join_fused_rows``: those whose count phase ran in the kernels,
    none on the CPU (the plain versions)."""
    rng = np.random.default_rng(3)
    ctx = H.Context(device="cpu")
    ctx.create_table("f", {"k": rng.integers(0, 50, 1000).astype(np.int32),
                           "v": rng.integers(0, 9, 1000).astype(np.int32)})
    ctx.create_table("d", {"j": np.arange(64, dtype=np.int32),
                           "g": rng.integers(0, 9, 64).astype(np.int32)})
    ctx.sql("select f.v, d.g from f join d on f.k = d.j")
    m = ctx.last_metrics
    assert m.join_rows >= 1000 + 64 and m.join_fused_rows == 0
    ctx.sql("select f.v, d.g from f join d on f.k = d.j")
    assert ctx.last_metrics.join_rows == m.join_rows      # per query
    ctx.sql("select v from f where k < 3")
    assert ctx.last_metrics.join_rows == 0
