"""The TPC-DS queries of the channels mix in plain NumPy.

Each function takes a :class:`~reference.common.Ref` over the generated
tables and the parameters the template was drawn with (dates as
``datetime.date``), and returns the matrix the query's SQL text asks for
under the configuration's rules: string outputs as the codes of their
column's sorted dictionary, sums wrapped to int32, ratios and averages in
float32, rows in the ORDER BY's order.

Departures from the specification's SQL, each the configuration's rule:

* a NULL foreign key is stored as -1 and matches no dimension row, as
  NULL does; Q97 leaves the NULL customers' groups out, which match
  nothing and count in none of its three sums;
* a NULL that leaves a derived table reads 0 (the port's rule): Q51's
  ``web_sales`` / ``store_sales`` of a key that one channel lacks read 0,
  and so do the running maxima over them before that channel's first
  sale, where the specification's maxima are NULL and its
  ``web_cumulative > store_cumulative`` drops the row;
* ``round(x, 2)`` is ``round(x * 100) / 100`` in float32, half away from
  zero (Q2).

With ``R.control`` set (the control: one precision below the
configuration's), the sums round to float32 (:class:`Ref`) and the ratios
and averages, float32 in the configuration, are computed in float16.
"""

from __future__ import annotations

import numpy as np

from harness.tables import EPOCH
from reference.common import Ref, matrix, order_rows, wrap32

WEEKDAY_COLUMNS = 7


def day(d) -> int:
    return (d - EPOCH).days


def prepare(R: Ref) -> None:
    """Each sales and returns row's date row, made once."""
    for table, col in (("store_sales", "ss_sold_date_sk"),
                       ("catalog_sales", "cs_sold_date_sk"),
                       ("web_sales", "ws_sold_date_sk")):
        date_row(R, table, col)


def date_row(R: Ref, table: str, col: str) -> np.ndarray:
    k = ("#date", table, col)
    if k not in R._rows:
        R._rows[k] = R.row_of("date_dim", "d_date_sk", R.col(table, col))
    return R._rows[k]


def dcol(R: Ref, name: str, drow: np.ndarray) -> np.ndarray:
    return R.col("date_dim", name)[drow]


def group_ids(*parts) -> tuple:
    """Dense ids of the distinct tuples of ``parts`` in ascending tuple
    order (the first part most significant), and the distinct tuples as
    rows: one int64 mixed-radix key per row, over each part's own
    range."""
    parts = [np.asarray(p, np.int64) for p in parts]
    key = np.zeros(parts[0].shape, np.int64)
    lows, spans = [], []
    for p in parts:
        lo = int(p.min()) if p.size else 0
        span = (int(p.max()) - lo + 1) if p.size else 1
        lows.append(lo)
        spans.append(span)
        key = key * span + (p - lo)
    uniq, g = np.unique(key, return_inverse=True)
    cols = []
    for lo, span in zip(reversed(lows), reversed(spans)):
        cols.append(uniq % span + lo)
        uniq = uniq // span
    return g.reshape(-1), np.stack(cols[::-1], axis=1)


def real(R: Ref):
    """The dtype of ratios and averages: float32, as the configuration
    states, or float16 for the control."""
    return np.float16 if R.control else np.float32


def avg_over(f, part: np.ndarray, values: np.ndarray,
             n_parts: int) -> np.ndarray:
    """A window ``avg`` over each row's partition in dtype ``f``: the sum of
    the values over the count (exact sums in float32: every partial sum is
    below 2^24 here, so any order of addition gives these bits)."""
    s = np.bincount(part, weights=values.astype(np.float64),
                    minlength=n_parts)
    c = np.bincount(part, minlength=n_parts)
    with np.errstate(over="ignore"):          # float16 for the control
        return (s.astype(f) / c.astype(f))[part]


def rank_of(values: np.ndarray) -> np.ndarray:
    """SQL ``rank()`` over ascending ``values``: 1 + the count smaller."""
    srt = np.sort(values)
    return np.searchsorted(srt, values, side="left").astype(np.int64) + 1


def sql_round(v: np.ndarray) -> np.ndarray:
    """SQL ROUND in ``v``'s dtype: half away from zero."""
    half = v.dtype.type(0.5)
    with np.errstate(invalid="ignore", over="ignore"):
        return (np.sign(v) * np.floor(np.abs(v) + half)).astype(v.dtype)


# -- Q2 ----------------------------------------------------------------------
def q2(R: Ref, p):
    y = int(p["YEAR"])
    weeks, dows, vals = [], [], []
    for table, pre in (("web_sales", "ws"), ("catalog_sales", "cs")):
        drow = date_row(R, table, f"{pre}_sold_date_sk")
        ok = drow >= 0
        weeks.append(dcol(R, "d_week_seq", drow[ok]))
        dows.append(dcol(R, "d_dow", drow[ok]))
        vals.append(R.col(table, f"{pre}_ext_sales_price")[ok])
    week, dow = np.concatenate(weeks), np.concatenate(dows)
    val = np.concatenate(vals)
    uw, wi = np.unique(week, return_inverse=True)
    sums = R.gsum(wi * WEEKDAY_COLUMNS + dow, val,
                uw.size * WEEKDAY_COLUMNS).reshape(uw.size, WEEKDAY_COLUMNS)
    d_week, d_year = R.col("date_dim", "d_week_seq"), R.col("date_dim",
                                                           "d_year")

    def copies(year):
        c = np.zeros(uw.size, np.int64)
        m = d_year == year
        pos = np.searchsorted(uw, d_week[m])
        hit = (pos < uw.size) & (uw[np.minimum(pos, uw.size - 1)]
                                 == d_week[m])
        np.add.at(c, pos[hit], 1)
        return c

    c1, c2 = copies(y), copies(y + 1)
    rows = []
    for i, w in enumerate(uw):
        j = np.searchsorted(uw, w + 53)
        if c1[i] == 0 or j >= uw.size or uw[j] != w + 53 or c2[j] == 0:
            continue
        f = real(R)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            ratio = sums[i].astype(f) / sums[j].astype(f)
            r = sql_round(ratio * f(100)) / f(100.0)
        rows += [np.concatenate([[w], r.astype(np.float64)])] * int(
            c1[i] * c2[j])
    if not rows:
        return np.zeros((0, 8), np.float64)
    return np.stack(rows).astype(np.float64)


# -- Q12, Q98 ----------------------------------------------------------------
def item_report(R: Ref, p, table: str, pre: str, limit):
    it = R.t["item"]
    drow = date_row(R, table, f"{pre}_sold_date_sk")
    irow = R.row_of("item", "i_item_sk", R.col(table, f"{pre}_item_sk"))
    d0 = day(p["SDATE"])
    cats = [R.code_of("item", "i_category", p[f"CATEGORY{i}"])
            for i in (1, 2, 3)]
    ok = (drow >= 0) & (irow >= 0)
    rows = np.flatnonzero(ok)
    dd = dcol(R, "d_date", drow[rows])
    cat = R.codes("item", "i_category")[irow[rows]]
    keep = (dd >= d0) & (dd <= d0 + 30) & np.isin(cat, cats)
    rows = rows[keep]
    ir = irow[rows]
    # (i_item_id, i_item_desc, ...) is one item row: the descriptions are
    # distinct
    ui, g = np.unique(ir, return_inverse=True)
    rev = R.gsum(g, R.col(table, f"{pre}_ext_sales_price")[rows], ui.size)
    cls = R.codes("item", "i_class")[ui]
    uc, ci = np.unique(cls, return_inverse=True)
    class_total = R.gsum(ci, rev, uc.size)[ci]
    f = real(R)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ratio = (rev.astype(f) * f(100.0)) / class_total.astype(f)
    cols = [R.codes("item", "i_item_id")[ui], it["i_item_desc"][ui],
            R.codes("item", "i_category")[ui], cls,
            it["i_current_price"][ui], rev, ratio]
    order = order_rows(cols, [(2, False), (3, False), (0, False),
                              (1, False), (6, False)])
    if limit is not None:
        order = order[:limit]
    return matrix([c[order] for c in cols], np.float64)


def q12(R: Ref, p):
    return item_report(R, p, "web_sales", "ws", 100)


def q98(R: Ref, p):
    return item_report(R, p, "store_sales", "ss", None)


# -- Q38, Q87 ----------------------------------------------------------------
CUSTOMER_KEY = {"store_sales": ("ss", "ss_customer_sk"),
                "catalog_sales": ("cs", "cs_bill_customer_sk"),
                "web_sales": ("ws", "ws_bill_customer_sk")}


def name_days(R: Ref, p, table: str) -> np.ndarray:
    """The distinct (last name, first name, date) of a channel's sales in
    the twelve months, as one int64 each."""
    pre, ckey = CUSTOMER_KEY[table]
    drow = date_row(R, table, f"{pre}_sold_date_sk")
    crow = R.row_of("customer", "c_customer_sk", R.col(table, ckey))
    ok = (drow >= 0) & (crow >= 0)
    ms = dcol(R, "d_month_seq", np.maximum(drow, 0))
    ok &= (ms >= p["DMS"]) & (ms <= p["DMS"] + 11)
    last = R.codes("customer", "c_last_name")[crow[ok]].astype(np.int64)
    first = R.codes("customer", "c_first_name")[crow[ok]].astype(np.int64)
    dd = dcol(R, "d_date", drow[ok]).astype(np.int64) + (1 << 20)
    return np.unique((last << 42) | (first << 21) | dd)


def q38(R: Ref, p):
    s = name_days(R, p, "store_sales")
    s = np.intersect1d(s, name_days(R, p, "catalog_sales"))
    s = np.intersect1d(s, name_days(R, p, "web_sales"))
    return matrix([[s.size]], np.int64)


def q87(R: Ref, p):
    s = name_days(R, p, "store_sales")
    s = np.setdiff1d(s, name_days(R, p, "catalog_sales"))
    s = np.setdiff1d(s, name_days(R, p, "web_sales"))
    return matrix([[s.size]], np.int64)


# -- Q47, Q89 ----------------------------------------------------------------
def store_months(R: Ref, rows_ok):
    """Store sales joined to item, date and store, ``rows_ok(irow, drow)``
    choosing the rows: (rows, item rows, date rows, store rows)."""
    drow = date_row(R, "store_sales", "ss_sold_date_sk")
    irow = R.row_of("item", "i_item_sk", R.col("store_sales", "ss_item_sk"))
    srow = R.row_of("store", "s_store_sk", R.col("store_sales",
                                                 "ss_store_sk"))
    ok = (drow >= 0) & (irow >= 0) & (srow >= 0)
    rows = np.flatnonzero(ok)
    rows = rows[rows_ok(irow[rows], drow[rows])]
    return rows, irow[rows], drow[rows], srow[rows]


def q47(R: Ref, p):
    y = int(p["YEAR"])

    def pick(ir, dr):
        yr, moy = dcol(R, "d_year", dr), dcol(R, "d_moy", dr)
        return ((yr == y) | ((yr == y - 1) & (moy == 12))
                | ((yr == y + 1) & (moy == 1)))

    rows, ir, dr, sr = store_months(R, pick)
    cat = R.codes("item", "i_category")[ir]
    brand = R.codes("item", "i_brand")[ir]
    sname = R.codes("store", "s_store_name")[sr]
    comp = R.codes("store", "s_company_name")[sr]
    yr, moy = dcol(R, "d_year", dr), dcol(R, "d_moy", dr)
    g, uniq = group_ids(cat, brand, sname, comp, yr, moy)
    sums = R.gsum(g, R.col("store_sales", "ss_sales_price")[rows],
                uniq.shape[0])
    # the partition (category, brand, store name, company [, year])
    pg, _u = group_ids(*uniq[:, :5].T)
    f = real(R)
    avg = avg_over(f, pg, sums, int(pg.max()) + 1 if pg.size else 0)
    part, _u = group_ids(*uniq[:, :4].T)
    # rank by (year, month) within the partition: groups are in key order
    starts = np.r_[0, np.flatnonzero(np.diff(part)) + 1]
    rn = np.arange(part.size) - np.repeat(starts, np.diff(
        np.r_[starts, part.size]))
    prev_ok = (rn > 0)
    next_ok = np.r_[part[1:] == part[:-1], False]
    keep = (prev_ok & next_ok & (uniq[:, 4] == y) & (avg > 0))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        diff = sums.astype(f) - avg
        keep &= (np.abs(diff) / avg) > f(0.1)
    idx = np.flatnonzero(keep)
    psum, nsum = sums[idx - 1], sums[idx + 1]
    cols = [uniq[idx, 0], uniq[idx, 1], uniq[idx, 2], uniq[idx, 3],
            uniq[idx, 4], uniq[idx, 5], avg[idx], sums[idx], psum, nsum]
    by = {"avg_monthly_sales": 6, "sum_sales": 7, "psum": 8, "nsum": 9}
    cols.insert(10, diff[idx])
    order = order_rows(cols, [(10, False), (by[p["ORDERBY"]], False),
                              (0, False), (1, False), (2, False), (3, False),
                              (5, False)])[:100]
    return matrix([c[order] for c in cols[:10]], np.float64)


def q89(R: Ref, p):
    y = int(p["YEAR"])
    cat_codes = R.codes("item", "i_category")
    class_id = R.col("item", "i_class_id")

    def pick(ir, dr):
        ok = np.zeros(ir.size, bool)
        for i in range(1, 7):
            c = R.code_of("item", "i_category", p[f"CAT{i}"])
            ok |= (cat_codes[ir] == c) & (class_id[ir] == p[f"CLASS{i}"])
        return ok & (dcol(R, "d_year", dr) == y)

    rows, ir, dr, sr = store_months(R, pick)
    cat = cat_codes[ir]
    cls = R.codes("item", "i_class")[ir]
    brand = R.codes("item", "i_brand")[ir]
    sname = R.codes("store", "s_store_name")[sr]
    comp = R.codes("store", "s_company_name")[sr]
    moy = dcol(R, "d_moy", dr)
    g, uniq = group_ids(cat, cls, brand, sname, comp, moy)
    sums = R.gsum(g, R.col("store_sales", "ss_sales_price")[rows],
                uniq.shape[0])
    pg, _u = group_ids(uniq[:, 0], uniq[:, 2], uniq[:, 3], uniq[:, 4])
    f = real(R)
    avg = avg_over(f, pg, sums, int(pg.max()) + 1 if pg.size else 0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        diff = sums.astype(f) - avg
        keep = (avg != 0) & ((np.abs(diff) / avg) > f(0.1))
    idx = np.flatnonzero(keep)
    cols = [uniq[idx, 0], uniq[idx, 1], uniq[idx, 2], uniq[idx, 3],
            uniq[idx, 4], uniq[idx, 5], sums[idx], avg[idx], diff[idx]]
    order = order_rows(cols, [(8, False), (3, False), (0, False),
                              (1, False), (2, False), (4, False),
                              (5, False)])[:100]
    return matrix([c[order] for c in cols[:8]], np.float64)


# -- Q49 ---------------------------------------------------------------------
#: (channel code in the sorted dictionary of catalog, store, web; sales,
#: sales prefix, number column; returns, its number, quantity and amount)
CHANNELS49 = [
    (2, "web_sales", "ws", "ws_order_number", "web_returns",
     "wr_order_number", "wr_return_quantity", "wr_return_amt", "wr_item_sk"),
    (0, "catalog_sales", "cs", "cs_order_number", "catalog_returns",
     "cr_order_number", "cr_return_quantity", "cr_return_amount",
     "cr_item_sk"),
    (1, "store_sales", "ss", "ss_ticket_number", "store_returns",
     "sr_ticket_number", "sr_return_quantity", "sr_return_amt",
     "sr_item_sk"),
]
ITEM_BITS = 20


def q49(R: Ref, p):
    out = []
    for code, sales, s, snum, rets, rnum, rq, ramt, ritem in CHANNELS49:
        S, T = R.t[sales], R.t[rets]
        # a return is one sales line: (number, item) is unique on each side
        skey = (S[snum].astype(np.int64) << ITEM_BITS) | S[f"{s}_item_sk"]
        rkey = (T[rnum].astype(np.int64) << ITEM_BITS) | T[ritem]
        order = np.argsort(rkey, kind="stable")
        pos = np.searchsorted(rkey[order], skey)
        pos = np.minimum(pos, rkey.size - 1)
        hit = rkey[order][pos] == skey
        ret = np.where(hit, order[pos], -1)
        drow = date_row(R, sales, f"{s}_sold_date_sk")
        ok = (ret >= 0) & (drow >= 0)
        rows = np.flatnonzero(ok)
        rr = ret[rows]
        dr = drow[rows]
        keep = ((T[ramt][rr] > 1000000) & (S[f"{s}_net_profit"][rows] > 100)
                & (S[f"{s}_net_paid"][rows] > 0)
                & (S[f"{s}_quantity"][rows] > 0)
                & (dcol(R, "d_year", dr) == p["YEAR"])
                & (dcol(R, "d_moy", dr) == p["MONTH"]))
        rows, rr = rows[keep], rr[keep]
        items, g = np.unique(S[f"{s}_item_sk"][rows], return_inverse=True)
        n = items.size
        f = real(R)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            ret_ratio = (R.gsum(g, T[rq][rr], n).astype(f)
                         / R.gsum(g, S[f"{s}_quantity"][rows], n).astype(f))
            cur_ratio = (R.gsum(g, T[ramt][rr], n).astype(f)
                         / R.gsum(g, S[f"{s}_net_paid"][rows], n).astype(f))
        r1, r2 = rank_of(ret_ratio), rank_of(cur_ratio)
        k = (r1 <= 10) | (r2 <= 10)
        out.append([np.full(int(k.sum()), code), items[k], ret_ratio[k],
                    r1[k], r2[k]])
    cols = [np.concatenate([o[i] for o in out]) for i in range(5)]
    order = order_rows(cols, [(0, False), (3, False), (4, False),
                              (1, False)])[:100]
    return matrix([c[order] for c in cols], np.float64)


# -- Q51 ---------------------------------------------------------------------
def cume_by_item_day(R: Ref, p, table: str, pre: str):
    """(item, date) keys in ascending order and the running int32 sum of
    the day's sales price over each item's days."""
    drow = date_row(R, table, f"{pre}_sold_date_sk")
    ms = dcol(R, "d_month_seq", np.maximum(drow, 0))
    ok = (drow >= 0) & (ms >= p["DMS"]) & (ms <= p["DMS"] + 11)
    rows = np.flatnonzero(ok)
    item = R.col(table, f"{pre}_item_sk")[rows]
    dd = dcol(R, "d_date", drow[rows])
    g, uniq = group_ids(item, dd)
    s = R.gsum(g, R.col(table, f"{pre}_sales_price")[rows], uniq.shape[0])
    return uniq, running(uniq[:, 0], s.astype(np.int64), np.add)


def running(part: np.ndarray, x: np.ndarray, op) -> np.ndarray:
    """Inclusive running ``op`` (``np.add`` or ``np.maximum``) within each
    run of equal ``part``, rows in order; sums wrap to int32."""
    x = np.asarray(x, np.int64)
    if not x.size:
        return x
    seg = np.r_[0, np.cumsum(np.diff(part) != 0)]
    if op is np.add:
        cs = np.cumsum(x)
        starts = np.r_[0, np.flatnonzero(np.diff(seg)) + 1]
        before = np.r_[0, cs[starts[1:] - 1]]
        return wrap32(cs - before[seg]).astype(np.int64)
    # every value lies in int32: lift each run above the runs before it
    lift = seg << 33
    return np.maximum.accumulate(x + lift) - lift


def q51(R: Ref, p):
    wk, wc = cume_by_item_day(R, p, "web_sales", "ws")
    sk, sc = cume_by_item_day(R, p, "store_sales", "ss")

    def code(k):        # (item, date) as one int64: the dates are positive
        return (k[:, 0].astype(np.int64) << 32) | k[:, 1]

    # the FULL OUTER join's keys; a side's NULL reads 0 once out of x
    keys = np.union1d(code(wk), code(sk))
    web, store = np.zeros(keys.size, np.int64), np.zeros(keys.size, np.int64)
    web[np.searchsorted(keys, code(wk))] = wc
    store[np.searchsorted(keys, code(sk))] = sc
    item = keys >> 32
    web_cum = running(item, web, np.maximum)
    store_cum = running(item, store, np.maximum)
    keep = np.flatnonzero(web_cum > store_cum)[:100]
    cols = [item[keep], keys[keep] & 0xFFFFFFFF, web[keep], store[keep],
            web_cum[keep], store_cum[keep]]
    return matrix(cols, np.int64)


# -- Q71 ---------------------------------------------------------------------
def q71(R: Ref, p):
    prices, items, times = [], [], []
    for table, pre in (("web_sales", "ws"), ("catalog_sales", "cs"),
                       ("store_sales", "ss")):
        drow = date_row(R, table, f"{pre}_sold_date_sk")
        ok = drow >= 0
        ok[ok] = ((dcol(R, "d_moy", drow[ok]) == p["MONTH"])
                  & (dcol(R, "d_year", drow[ok]) == p["YEAR"]))
        prices.append(R.col(table, f"{pre}_ext_sales_price")[ok])
        items.append(R.col(table, f"{pre}_item_sk")[ok])
        times.append(R.col(table, f"{pre}_sold_time_sk")[ok])
    price = np.concatenate(prices)
    irow = R.row_of("item", "i_item_sk", np.concatenate(items))
    trow = R.row_of("time_dim", "t_time_sk", np.concatenate(times))
    ok = (irow >= 0) & (trow >= 0)
    meal = R.col("time_dim", "t_meal_time")
    ok[ok] = ((R.col("item", "i_manager_id")[irow[ok]] == 1)
              & np.isin(meal[trow[ok]], ["breakfast", "dinner"]))
    rows = np.flatnonzero(ok)
    ir, tr = irow[rows], trow[rows]
    g, uniq = group_ids(R.codes("item", "i_brand")[ir],
                           R.col("item", "i_brand_id")[ir],
                           R.col("time_dim", "t_hour")[tr],
                           R.col("time_dim", "t_minute")[tr])
    s = R.gsum(g, price[rows], uniq.shape[0])
    cols = [uniq[:, 1], uniq[:, 0], uniq[:, 2], uniq[:, 3], s]
    order = order_rows(cols, [(4, True), (0, False)])
    return matrix([c[order] for c in cols], np.int64)


# -- Q97 ---------------------------------------------------------------------
def customer_items(R: Ref, p, table: str, pre: str, ckey: str):
    drow = date_row(R, table, f"{pre}_sold_date_sk")
    ms = dcol(R, "d_month_seq", np.maximum(drow, 0))
    cust = R.col(table, ckey).astype(np.int64)
    ok = (drow >= 0) & (ms >= p["DMS"]) & (ms <= p["DMS"] + 11) & (cust != -1)
    return np.unique((cust[ok] << 32) | R.col(table, f"{pre}_item_sk")[ok])


def q97(R: Ref, p):
    s = customer_items(R, p, "store_sales", "ss", "ss_customer_sk")
    c = customer_items(R, p, "catalog_sales", "cs", "cs_bill_customer_sk")
    both = np.intersect1d(s, c).size
    return matrix([[s.size - both], [c.size - both], [both]], np.int64)
