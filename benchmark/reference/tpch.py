"""The TPC-H queries of the power mix in plain NumPy.

Each function takes a :class:`~reference.common.Ref` over the generated
tables and the parameters the template was drawn with (dates as
``datetime.date``), and returns the matrix the query's SQL text asks for:
string outputs as dictionary codes, sums wrapped to int32, averages and
ratios in float32 as the configuration states, rows in the ORDER BY's
order with ties in ascending group-key order.
"""

from __future__ import annotations

import numpy as np

from harness.tables import EPOCH
from reference.common import Ref, matrix, order_rows, radix_key


def day(d) -> int:
    return (d - EPOCH).days


def prepare(R: Ref) -> None:
    """Line -> order row and order -> customer row, made once."""
    line_order(R)
    order_cust(R)


def line_order(R: Ref) -> np.ndarray:
    k = ("#line", "order")
    if k not in R._rows:
        R._rows[k] = R.row_of("orders", "o_orderkey",
                              R.col("lineitem", "l_orderkey"))
    return R._rows[k]


def order_cust(R: Ref) -> np.ndarray:
    k = ("#order", "cust")
    if k not in R._rows:
        R._rows[k] = R.row_of("customer", "c_custkey",
                              R.col("orders", "o_custkey"))
    return R._rows[k]


def disc_price(R: Ref, rows) -> np.ndarray:
    li = R.t["lineitem"]
    return (li["l_extendedprice"][rows].astype(np.int64)
            * (100 - li["l_discount"][rows]))


def q1(R: Ref, p):
    li = R.t["lineitem"]
    rows = np.flatnonzero(li["l_shipdate"] <= day(p["SHIPDATE"]))
    flag, status = li["l_returnflag"][rows], li["l_linestatus"][rows]
    f0, s0 = int(li["l_returnflag"].min()), int(li["l_linestatus"].min())
    ns = int(li["l_linestatus"].max()) - s0 + 1
    key = radix_key([flag - f0, status - s0],
                    [int(li["l_returnflag"].max()) - f0 + 1, ns])
    uniq, g = np.unique(key, return_inverse=True)
    n = uniq.size
    dp = disc_price(R, rows)
    sq = R.gsum(g, li["l_quantity"][rows], n)
    sb = R.gsum(g, li["l_extendedprice"][rows], n)
    sd = R.gsum(g, dp, n)
    sc = R.gsum(g, dp * (100 + li["l_tax"][rows]), n)
    cnt = R.count(g, n)
    sdisc = R.gsum(g, li["l_discount"][rows], n)
    cols = [uniq // ns + f0, uniq % ns + s0, sq, sb, sd, sc,
            R.avg(sq, cnt), R.avg(sb, cnt), R.avg(sdisc, cnt), cnt]
    return matrix(cols, np.float64)


def q3(R: Ref, p):
    li, o = R.t["lineitem"], R.t["orders"]
    d = day(p["DATE"])
    seg = R.codes("customer", "c_mktsegment") == R.code_of(
        "customer", "c_mktsegment", p["SEGMENT"])
    oc = order_cust(R)
    o_ok = (o["o_orderdate"] < d) & (oc >= 0) & seg[np.maximum(oc, 0)]
    lo = line_order(R)
    rows = np.flatnonzero((li["l_shipdate"] > d) & (lo >= 0))
    rows = rows[o_ok[lo[rows]]]
    orow = lo[rows]
    uniq, g = np.unique(o["o_orderkey"][orow].astype(np.int64),
                        return_inverse=True)
    rev = R.gsum(g, disc_price(R, rows), uniq.size)
    first = np.zeros(uniq.size, np.int64)
    first[g] = orow
    cols = [uniq, rev, o["o_orderdate"][first], o["o_shippriority"][first]]
    order = order_rows(cols, [(1, True), (2, False)])[:10]
    return matrix([c[order] for c in cols], np.int32)


def q4(R: Ref, p):
    li, o = R.t["lineitem"], R.t["orders"]
    d0, d1 = day(p["DATE"]), day(p["DATE_3M"])
    late = li["l_commitdate"] < li["l_receiptdate"]
    lo = line_order(R)
    has = np.zeros(o["o_orderkey"].size, bool)
    has[lo[late & (lo >= 0)]] = True
    od = o["o_orderdate"]
    keep = has & (od >= d0) & (od < d1)
    prio = o["o_orderpriority"][keep].astype(np.int64)
    uniq, cnt = np.unique(prio, return_counts=True)
    return matrix([uniq, cnt], np.int32)


def q5(R: Ref, p):
    li, o = R.t["lineitem"], R.t["orders"]
    d0, d1 = day(p["DATE"]), day(p["DATE_1Y"])
    lo = line_order(R)
    rows = np.flatnonzero(lo >= 0)
    od = o["o_orderdate"][lo[rows]]
    rows = rows[(od >= d0) & (od < d1)]
    crow = order_cust(R)[lo[rows]]
    rows, crow = rows[crow >= 0], crow[crow >= 0]
    srow = R.row_of("supplier", "s_suppkey", li["l_suppkey"][rows])
    ok = srow >= 0
    rows, crow, srow = rows[ok], crow[ok], srow[ok]
    cn = R.col("customer", "c_nationkey")[crow]
    sn = R.col("supplier", "s_nationkey")[srow]
    nrow = R.row_of("nation", "n_nationkey", sn)
    rrow = R.row_of("region", "r_regionkey",
                    R.col("nation", "n_regionkey")[np.maximum(nrow, 0)])
    rname = R.col("region", "r_name")[np.maximum(rrow, 0)]
    keep = (cn == sn) & (nrow >= 0) & (rrow >= 0) & (rname == p["REGION"])
    name = R.codes("nation", "n_name")[nrow[keep]].astype(np.int64)
    uniq, g = np.unique(name, return_inverse=True)
    rev = R.gsum(g, disc_price(R, rows[keep]), uniq.size)
    cols = [uniq, rev]
    order = order_rows(cols, [(1, True)])
    return matrix([c[order] for c in cols], np.int32)


def q6(R: Ref, p):
    li = R.t["lineitem"]
    sd, dc, q = li["l_shipdate"], li["l_discount"], li["l_quantity"]
    keep = ((sd >= day(p["DATE"])) & (sd < day(p["DATE_1Y"]))
            & (dc >= p["DISCOUNT_LO"]) & (dc <= p["DISCOUNT_HI"])
            & (q < p["QUANTITY"]))
    rows = np.flatnonzero(keep)
    return matrix([[R.total(li["l_extendedprice"][rows].astype(np.int64)
                            * li["l_discount"][rows])]], np.int32)


def q10(R: Ref, p):
    li, o, c = R.t["lineitem"], R.t["orders"], R.t["customer"]
    d0, d1 = day(p["DATE"]), day(p["DATE_3M"])
    lo = line_order(R)
    rows = np.flatnonzero((li["l_returnflag"] == p["RETURNFLAG"]) & (lo >= 0))
    od = o["o_orderdate"][lo[rows]]
    rows = rows[(od >= d0) & (od < d1)]
    crow = order_cust(R)[lo[rows]]
    rows, crow = rows[crow >= 0], crow[crow >= 0]
    nrow = R.row_of("nation", "n_nationkey", c["c_nationkey"][crow])
    rows, crow, nrow = rows[nrow >= 0], crow[nrow >= 0], nrow[nrow >= 0]
    uniq, g = np.unique(c["c_custkey"][crow].astype(np.int64),
                        return_inverse=True)
    rev = R.gsum(g, disc_price(R, rows), uniq.size)
    first_c = np.zeros(uniq.size, np.int64)
    first_c[g] = crow
    first_n = np.zeros(uniq.size, np.int64)
    first_n[g] = nrow
    cols = [uniq, c["c_name"][first_c], rev, c["c_acctbal"][first_c],
            R.codes("nation", "n_name")[first_n], c["c_address"][first_c],
            c["c_phone"][first_c], c["c_comment"][first_c]]
    order = order_rows(cols, [(2, True)])[:20]
    return matrix([x[order] for x in cols], np.int32)


def q12(R: Ref, p):
    li, o = R.t["lineitem"], R.t["orders"]
    mode = li["l_shipmode"]
    rd = li["l_receiptdate"]
    lo = line_order(R)
    keep = (((mode == p["SHIPMODE1"]) | (mode == p["SHIPMODE2"]))
            & (li["l_commitdate"] < rd) & (li["l_shipdate"] < li["l_commitdate"])
            & (rd >= day(p["DATE"])) & (rd < day(p["DATE_1Y"])) & (lo >= 0))
    rows = np.flatnonzero(keep)
    prio = o["o_orderpriority"][lo[rows]]
    urgent = (prio == p["URGENT"]) | (prio == p["HIGH"])
    uniq, g = np.unique(mode[rows].astype(np.int64), return_inverse=True)
    high = R.gsum(g, urgent.astype(np.int64), uniq.size)
    low = R.gsum(g, (~urgent).astype(np.int64), uniq.size)
    return matrix([uniq, high, low], np.int32)


def q13(R: Ref, p):
    n_cust = R.col("customer", "c_custkey").size
    crow = order_cust(R)
    cnt = np.bincount(crow[crow >= 0], minlength=n_cust)
    uniq, custs = np.unique(cnt, return_counts=True)
    cols = [uniq, custs]
    order = order_rows(cols, [(1, True), (0, True)])
    return matrix([c[order] for c in cols], np.int32)


def q14(R: Ref, p):
    li = R.t["lineitem"]
    sd = li["l_shipdate"]
    rows = np.flatnonzero((sd >= day(p["DATE"])) & (sd < day(p["DATE_1M"])))
    prow = R.row_of("part", "p_partkey", li["l_partkey"][rows])
    rows, prow = rows[prow >= 0], prow[prow >= 0]
    promo = np.char.startswith(R.col("part", "p_type"), "PROMO")[prow]
    dp = disc_price(R, rows)
    num = R.total(np.where(promo, dp, 0))
    den = R.total(dp)
    val = np.float32(100.0) * np.float32(num) / np.float32(den)
    return matrix([[val]], np.float32)


def q17(R: Ref, p):
    li = R.t["lineitem"]
    pk = li["l_partkey"].astype(np.int64)
    n = int(pk.max()) + 1
    cnt = np.bincount(pk, minlength=n)
    s = R.gsum(pk, li["l_quantity"], n)
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = R.avg(s, cnt)
    limit = avg * np.float32(0.2)
    prow = R.row_of("part", "p_partkey", pk)
    part_ok = ((R.col("part", "p_brand") == p["BRAND"])
               & (R.col("part", "p_container") == p["CONTAINER"]))
    keep = ((prow >= 0) & part_ok[np.maximum(prow, 0)]
            & (li["l_quantity"].astype(np.float32) < limit[pk]))
    total = R.total(li["l_extendedprice"][keep])
    return matrix([[np.float32(total) / np.float32(7.0)]], np.float32)


def q18(R: Ref, p):
    li, o, c = R.t["lineitem"], R.t["orders"], R.t["customer"]
    lo = line_order(R)
    ok_line = lo >= 0
    qty_by_order = R.gsum(lo[ok_line], li["l_quantity"][ok_line],
                          o["o_orderkey"].size)
    # the IN list is over l_orderkey grouped over all lines
    all_keys, g_all = np.unique(li["l_orderkey"].astype(np.int64),
                                return_inverse=True)
    sum_all = R.gsum(g_all, li["l_quantity"], all_keys.size)
    big_key = all_keys[sum_all > p["QUANTITY"]]
    orow = R.row_of("orders", "o_orderkey", big_key)
    orow = orow[orow >= 0]
    crow = order_cust(R)[orow]
    orow, crow = orow[crow >= 0], crow[crow >= 0]
    q = qty_by_order[orow]
    # groups in ascending (c_name, c_custkey, o_orderkey) order
    srt = np.lexsort((o["o_orderkey"][orow], c["c_custkey"][crow],
                      c["c_name"][crow]))
    orow, crow, q = orow[srt], crow[srt], q[srt]
    cols = [c["c_name"][crow], c["c_custkey"][crow], o["o_orderkey"][orow],
            o["o_orderdate"][orow], o["o_totalprice"][orow], q]
    order = order_rows(cols, [(4, True), (3, False)])[:100]
    return matrix([x[order] for x in cols], np.int32)


def q19(R: Ref, p):
    li = R.t["lineitem"]
    prow = R.row_of("part", "p_partkey", li["l_partkey"])
    base = ((prow >= 0) & (li["l_shipmode"] == p["AIR"])
            & (li["l_shipinstruct"] == p["IN_PERSON"]))
    rows = np.flatnonzero(base)
    prow = prow[rows]
    brand = R.col("part", "p_brand")[prow]
    cont = R.col("part", "p_container")[prow]
    size = R.col("part", "p_size")[prow]
    qty = li["l_quantity"][rows]
    keep = np.zeros(rows.size, bool)
    for i, (kind, smax) in enumerate((("SM", 5), ("MED", 10), ("LG", 15)),
                                     start=1):
        conts = {"SM": ["SM CASE", "SM BOX", "SM PACK", "SM PKG"],
                 "MED": ["MED BAG", "MED BOX", "MED PKG", "MED PACK"],
                 "LG": ["LG CASE", "LG BOX", "LG PACK", "LG PKG"]}[kind]
        q0 = p[f"QUANTITY{i}"]
        keep |= ((brand == p[f"BRAND{i}"]) & np.isin(cont, conts)
                 & (qty >= q0) & (qty <= q0 + 10) & (size >= 1)
                 & (size <= smax))
    return matrix([[R.total(disc_price(R, rows[keep]))]], np.int32)
