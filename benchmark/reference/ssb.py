"""The Star Schema Benchmark's 13 queries in plain NumPy.

Each function takes a :class:`~reference.common.Ref` over the generated
tables and the template's parameters, and returns the matrix the query's
SQL text asks for: string outputs as their dictionary codes, sums wrapped
to int32, rows in the ORDER BY's order with ties in ascending group-key
order. The queries keep the specification's literals; the parameters are
accepted for templates that draw them.
"""

from __future__ import annotations

import numpy as np

from reference.common import Ref, matrix, order_rows, radix_key

FACT = "lineorder"
DIMS = {  # dimension -> (fact column, dimension key)
    "date": ("lo_orderdate", "d_datekey"),
    "customer": ("lo_custkey", "c_custkey"),
    "part": ("lo_partkey", "p_partkey"),
    "supplier": ("lo_suppkey", "s_suppkey"),
}


def prepare(R: Ref) -> None:
    """Fact row -> dimension row maps, made once for every query."""
    for dim, (fk, key) in DIMS.items():
        dim_rows(R, dim)


def dim_rows(R: Ref, dim: str) -> np.ndarray:
    cache = R._rows
    k = ("#fact", dim)
    if k not in cache:
        fk, key = DIMS[dim]
        cache[k] = R.row_of(dim, key, R.col(FACT, fk))
    return cache[k]


def star(R: Ref, fact_mask, dim_ok: dict, groups, value):
    """Rows of the fact table passing ``fact_mask`` (or None) and every
    dimension mask in ``dim_ok`` (dimension -> boolean over its rows),
    grouped by ``groups`` (``(dimension, column, is_string)``, the first
    most significant), ``value(rows)`` summed per group. Returns the
    group-key columns and the sums, groups in ascending key order."""
    sel = (np.flatnonzero(fact_mask) if fact_mask is not None
           else np.arange(R.col(FACT, "lo_orderkey").size))
    for dim, ok in dim_ok.items():
        r = dim_rows(R, dim)[sel]
        sel = sel[(r >= 0) & ok[np.maximum(r, 0)]]
    parts, sizes, decode = [], [], []
    for dim, col, is_str in groups:
        r = dim_rows(R, dim)[sel]
        v = (R.codes(dim, col) if is_str else R.col(dim, col)).astype(
            np.int64)
        lo = int(v.min()) if v.size else 0
        parts.append(v[r] - lo)
        sizes.append(int(v.max()) - lo + 1 if v.size else 1)
        decode.append(lo)
    if not groups:
        return [], np.asarray([R.total(value(sel))])
    key = radix_key(parts, sizes)
    uniq, gid = np.unique(key, return_inverse=True)
    sums = R.gsum(gid, value(sel), uniq.size)
    cols = []
    rest = uniq
    for size, lo in reversed(list(zip(sizes, decode))):
        cols.append(rest % size + lo)
        rest = rest // size
    return cols[::-1], sums


def _q1(R: Ref, date_ok, disc, qty):
    lo = R.t[FACT]
    d, q = lo["lo_discount"], lo["lo_quantity"]
    m = (d >= disc[0]) & (d <= disc[1]) & (q >= qty[0]) & (q <= qty[1])
    _c, s = star(R, m, {"date": date_ok}, [],
                 lambda rows: lo["lo_extendedprice"][rows].astype(np.int64)
                 * lo["lo_discount"][rows])
    return matrix([s], np.int32)


def q1_1(R: Ref, p=None):
    return _q1(R, R.col("date", "d_year") == 1993, (1, 3), (-2**31, 24))


def q1_2(R: Ref, p=None):
    return _q1(R, R.col("date", "d_yearmonthnum") == 199401, (4, 6),
               (26, 35))


def q1_3(R: Ref, p=None):
    return _q1(R, (R.col("date", "d_weeknuminyear") == 6)
               & (R.col("date", "d_year") == 1994), (5, 7), (26, 35))


def _revenue(R):
    return lambda rows: R.t[FACT]["lo_revenue"][rows]


def _profit(R):
    lo = R.t[FACT]
    return lambda rows: (lo["lo_revenue"][rows].astype(np.int64)
                         - lo["lo_supplycost"][rows])


def _q2(R: Ref, part_ok, region):
    (year, brand), s = star(
        R, None, {"part": part_ok,
                  "supplier": R.col("supplier", "s_region") == region},
        [("date", "d_year", False), ("part", "p_brand1", True)], _revenue(R))
    return matrix([s, year, brand], np.int32)


def q2_1(R: Ref, p=None):
    return _q2(R, R.col("part", "p_category") == "MFGR#12", "AMERICA")


def q2_2(R: Ref, p=None):
    b = R.col("part", "p_brand1")
    return _q2(R, (b >= "MFGR#2221") & (b <= "MFGR#2228"), "ASIA")


def q2_3(R: Ref, p=None):
    return _q2(R, R.col("part", "p_brand1") == "MFGR#2239", "EUROPE")


def _q3(R: Ref, cust_ok, supp_ok, date_ok, what):
    (c, s_, y), rev = star(
        R, None, {"customer": cust_ok, "supplier": supp_ok, "date": date_ok},
        [("customer", f"c_{what}", True), ("supplier", f"s_{what}", True),
         ("date", "d_year", False)], _revenue(R))
    cols = [c, s_, y, rev]
    o = order_rows(cols, [(2, False), (3, True)])
    return matrix([x[o] for x in cols], np.int32)


def _years(R, lo, hi):
    y = R.col("date", "d_year")
    return (y >= lo) & (y <= hi)


def q3_1(R: Ref, p=None):
    return _q3(R, R.col("customer", "c_region") == "ASIA",
               R.col("supplier", "s_region") == "ASIA", _years(R, 1992, 1997),
               "nation")


def q3_2(R: Ref, p=None):
    return _q3(R, R.col("customer", "c_nation") == "UNITED STATES",
               R.col("supplier", "s_nation") == "UNITED STATES",
               _years(R, 1992, 1997), "city")


def _ki(R, dim, prefix):
    c = R.col(dim, f"{prefix}_city")
    return (c == "UNITED KI1") | (c == "UNITED KI5")


def q3_3(R: Ref, p=None):
    return _q3(R, _ki(R, "customer", "c"), _ki(R, "supplier", "s"),
               _years(R, 1992, 1997), "city")


def q3_4(R: Ref, p=None):
    return _q3(R, _ki(R, "customer", "c"), _ki(R, "supplier", "s"),
               R.col("date", "d_yearmonth") == "Dec1997", "city")


def _mfgr12(R):
    m = R.col("part", "p_mfgr")
    return (m == "MFGR#1") | (m == "MFGR#2")


def q4_1(R: Ref, p=None):
    (y, n), s = star(
        R, None, {"customer": R.col("customer", "c_region") == "AMERICA",
                  "supplier": R.col("supplier", "s_region") == "AMERICA",
                  "part": _mfgr12(R)},
        [("date", "d_year", False), ("customer", "c_nation", True)],
        _profit(R))
    return matrix([y, n, s], np.int32)


def q4_2(R: Ref, p=None):
    y = R.col("date", "d_year")
    (yy, n, c), s = star(
        R, None, {"customer": R.col("customer", "c_region") == "AMERICA",
                  "supplier": R.col("supplier", "s_region") == "AMERICA",
                  "part": _mfgr12(R), "date": (y == 1997) | (y == 1998)},
        [("date", "d_year", False), ("supplier", "s_nation", True),
         ("part", "p_category", True)], _profit(R))
    return matrix([yy, n, c, s], np.int32)


def q4_3(R: Ref, p=None):
    y = R.col("date", "d_year")
    (yy, c, b), s = star(
        R, None, {"customer": R.col("customer", "c_region") == "AMERICA",
                  "supplier": R.col("supplier", "s_nation") == "UNITED STATES",
                  "part": R.col("part", "p_category") == "MFGR#14",
                  "date": (y == 1997) | (y == 1998)},
        [("date", "d_year", False), ("supplier", "s_city", True),
         ("part", "p_brand1", True)], _profit(R))
    return matrix([yy, c, b, s], np.int32)
