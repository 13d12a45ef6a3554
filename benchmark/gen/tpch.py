"""TPC-H's tables (specification clause 4.2.3, dbgen's rules), generated
from a seed.

Keys and values follow dbgen: orders of 1-7 lines with sparse order keys
(8 of every 32), customer keys that are never a multiple of 3, a line's
supplier one of its part's four in ``partsupp``, ship date 1-121 days after
the order date, commit date 30-90 days after it, receipt date 1-30 days
after the ship date, return flag and line status from those dates against
1995-06-17, order status from its lines, total price from its lines.
Dates are int32 days since 1970-01-01; money is int32 cents; discount
and tax are int32 percents. The configuration file says which string
columns hold int32 codes (the codes a sorted dictionary gives the strings)
and which are strings.
"""

from __future__ import annotations

import numpy as np
import torch

from harness.tables import Draws, day_number, group_sizes, host, vocab
from gen.words import (CONTAINERS, NATIONS, PRIORITIES, REGIONS, SEGMENTS,
                       SHIP_INSTRUCT, SHIP_MODES, TYPES)

START = day_number("1992-01-01")
LAST_ORDER = day_number("1998-08-02")     # ENDDATE - 151 days
CURRENT = day_number("1995-06-17")


def code_map(words, device) -> torch.Tensor:
    """Generation order -> the code of the same word in sorted order."""
    s = sorted(words)
    return torch.tensor([s.index(w) for w in words], dtype=torch.int32,
                        device=device)


def make_tables(rows: dict, seed: int, device) -> dict:
    """Every TPC-H table from ``seed``: host numpy arrays by table and
    column. ``rows`` gives ``supplier``, ``part``, ``customer``, ``orders``
    and ``lineitem``; ``partsupp`` has four rows a part, ``nation`` 25 and
    ``region`` 5."""
    d = Draws(seed, device)
    dev = d.device
    n_supp, n_part, n_cust = rows["supplier"], rows["part"], rows["customer"]
    n_orders, n_lines = rows["orders"], rows["lineitem"]
    i32 = torch.int32

    def money(lo, hi, n):
        return d.ints(lo, hi, n)

    region = host({
        "r_regionkey": torch.arange(5, dtype=i32),
        "r_name": np.asarray(REGIONS),
        "r_comment": d.perm(5).to(i32),
    })
    nation = host({
        "n_nationkey": torch.arange(25, dtype=i32),
        "n_name": np.asarray([n for n, _r in NATIONS]),
        "n_regionkey": torch.tensor([r for _n, r in NATIONS], dtype=i32),
        "n_comment": d.perm(25).to(i32),
    })
    supplier = host({
        "s_suppkey": torch.arange(1, n_supp + 1, dtype=i32),
        "s_name": torch.arange(n_supp, dtype=i32),
        "s_address": d.perm(n_supp).to(i32),
        "s_nationkey": d.ints(0, 24, n_supp),
        "s_phone": d.perm(n_supp).to(i32),
        "s_acctbal": money(-99999, 999999, n_supp),
        "s_comment": d.perm(n_supp).to(i32),
    })

    pk = torch.arange(1, n_part + 1, dtype=i32, device=dev)
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    mfgr = d.ints(0, 4, n_part)
    brand = mfgr * 5 + d.ints(0, 4, n_part)
    part = host({
        "p_partkey": pk,
        "p_name": d.perm(n_part).to(i32),
        "p_mfgr": vocab([f"Manufacturer#{m}" for m in range(1, 6)], mfgr),
        "p_brand": vocab([f"Brand#{m}{n}" for m in range(1, 6)
                          for n in range(1, 6)], brand),
        "p_type": vocab(TYPES, d.ints(0, len(TYPES) - 1, n_part)),
        "p_size": d.ints(1, 50, n_part),
        "p_container": vocab(CONTAINERS, d.ints(0, len(CONTAINERS) - 1,
                                                n_part)),
        "p_retailprice": retail,
        "p_comment": d.perm(n_part).to(i32),
    })

    def supp_of(partkey: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """dbgen's i-th supplier (0-3) of a part."""
        p = partkey.long()
        return ((p + i * (n_supp // 4 + (p - 1) // n_supp)) % n_supp
                + 1).to(i32)

    ps_part = pk.repeat_interleave(4)
    ps_i = torch.arange(4, device=dev).repeat(n_part)
    partsupp = host({
        "ps_partkey": ps_part,
        "ps_suppkey": supp_of(ps_part, ps_i),
        "ps_availqty": d.ints(1, 9999, 4 * n_part),
        "ps_supplycost": money(100, 100000, 4 * n_part),
        "ps_comment": d.perm(4 * n_part).to(i32),
    })

    customer = host({
        "c_custkey": torch.arange(1, n_cust + 1, dtype=i32),
        "c_name": torch.arange(n_cust, dtype=i32),
        "c_address": d.perm(n_cust).to(i32),
        "c_nationkey": d.ints(0, 24, n_cust),
        "c_phone": d.perm(n_cust).to(i32),
        "c_acctbal": money(-99999, 999999, n_cust),
        "c_mktsegment": vocab(SEGMENTS, d.ints(0, 4, n_cust)),
        "c_comment": d.perm(n_cust).to(i32),
    })

    sizes = group_sizes(d, n_orders, n_lines, 1, 7)
    order = torch.repeat_interleave(torch.arange(n_orders, device=dev), sizes)
    starts = torch.cumsum(sizes, 0) - sizes
    line_no = (torch.arange(n_lines, device=dev) - starts[order] + 1).to(i32)
    o = torch.arange(n_orders, device=dev)
    orderkey = ((o // 8) * 32 + o % 8 + 1).to(i32)          # sparse keys
    r = d.ints(0, n_cust - n_cust // 3 - 1, n_orders).long()
    o_cust = ((r // 2) * 3 + r % 2 + 1).to(i32)              # never 3k
    o_date = d.ints(START, LAST_ORDER, n_orders)

    partkey = d.ints(1, n_part, n_lines)
    qty = d.ints(1, 50, n_lines)
    ext = qty * retail[partkey.long() - 1]
    disc = d.ints(0, 10, n_lines)
    tax = d.ints(0, 8, n_lines)
    odate = o_date[order]
    ship = odate + d.ints(1, 121, n_lines)
    commit = odate + d.ints(30, 90, n_lines)
    receipt = ship + d.ints(1, 30, n_lines)
    # codes in sorted order: return flag A 0, N 1, R 2; line status F 0, O 1
    returned = d.ints(0, 1, n_lines) * 2                     # A or R
    flag = torch.where(receipt <= CURRENT, returned, torch.ones_like(returned))
    status = (ship > CURRENT).to(i32)
    n_open = torch.zeros(n_orders, dtype=torch.int64, device=dev)
    n_open.index_add_(0, order, status.long())
    # order status in sorted codes: F 0 (no line open), O 1 (all), P 2
    o_status = torch.where(n_open == 0, 0, torch.where(n_open == sizes, 1, 2))
    total = torch.zeros(n_orders, dtype=torch.int64, device=dev)
    total.index_add_(0, order,
                     ext.long() * (100 + tax) * (100 - disc) // 10000)

    orders = host({
        "o_orderkey": orderkey,
        "o_custkey": o_cust,
        "o_orderstatus": o_status.to(i32),
        "o_totalprice": total.to(i32),
        "o_orderdate": o_date,
        "o_orderpriority": code_map(PRIORITIES, dev)[
            d.ints(0, len(PRIORITIES) - 1, n_orders).long()],
        "o_clerk": d.ints(0, max(1, n_orders // 1500) - 1, n_orders),
        "o_shippriority": torch.zeros(n_orders, dtype=i32),
        "o_comment": d.perm(n_orders).to(i32),
    })
    lineitem = host({
        "l_orderkey": orderkey[order],
        "l_partkey": partkey,
        "l_suppkey": supp_of(partkey, d.ints(0, 3, n_lines).long()),
        "l_linenumber": line_no,
        "l_quantity": qty,
        "l_extendedprice": ext,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": flag.to(i32),
        "l_linestatus": status,
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": code_map(SHIP_INSTRUCT, dev)[
            d.ints(0, len(SHIP_INSTRUCT) - 1, n_lines).long()],
        "l_shipmode": code_map(SHIP_MODES, dev)[
            d.ints(0, len(SHIP_MODES) - 1, n_lines).long()],
        "l_comment": d.perm(n_lines).to(i32),
    })
    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "part": part, "partsupp": partsupp, "supplier": supplier,
            "nation": nation, "region": region}
