"""The Star Schema Benchmark's tables (O'Neil, O'Neil, Chen, Revilak,
"Star Schema Benchmark", revision 3, 2009), generated from a seed.

``make_tables(rows, seed, device)`` follows the SSB generator's rules for
keys and values: one row a day in the date table over 1992-1998; orders of
1-7 lines; part, supplier, customer and order date drawn uniformly;
quantity 1-50, discount 0-10, tax 0-8; extended price = quantity x the
part's retail price; revenue = extended price x (100 - discount) / 100;
supply cost = 6 / 10 of the retail price; commit date 30-90 days after the
order date. Money is in cents. Where the configuration file lists a column
under ``codes``, the column holds the int32 code a sorted dictionary gives
its string; the dimension strings the queries read are strings.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np
import torch

from harness.tables import Draws, group_sizes, host, vocab
from gen.words import (COLORS, CONTAINERS, NATIONS, PRIORITIES, REGIONS,
                       SEGMENTS, SHIP_MODES, TYPES)

MONTHS = ["January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December"]
WEEKDAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
            "Saturday", "Sunday"]
SEASONS = {12: "Christmas", 1: "Winter", 2: "Winter", 3: "Spring",
           4: "Spring", 5: "Spring", 6: "Summer", 7: "Summer", 8: "Summer",
           9: "Fall", 10: "Fall", 11: "Fall"}
HOLIDAYS = {(1, 1), (7, 4), (12, 25)}
FIRST_DAY = _dt.date(1992, 1, 1)
N_DAYS = (_dt.date(1998, 12, 31) - FIRST_DAY).days + 1
# An order is placed on a day in [1992-01-01, 1998-08-02] (TPC-H's
# STARTDATE to ENDDATE - 151 days).
LAST_ORDER_DAY = (_dt.date(1998, 8, 2) - FIRST_DAY).days


def date_table() -> dict:
    """SSB's DATE table: one row a day, 1992-01-01 to 1998-12-31."""
    days = [FIRST_DAY + _dt.timedelta(i) for i in range(N_DAYS)]
    i32 = lambda xs: np.asarray(xs, np.int32)  # noqa: E731
    s = np.asarray
    last_of_month = [(d + _dt.timedelta(1)).month != d.month for d in days]
    return {
        "d_datekey": i32([d.year * 10000 + d.month * 100 + d.day
                          for d in days]),
        "d_date": s([f"{MONTHS[d.month - 1]} {d.day}, {d.year}"
                     for d in days]),
        "d_dayofweek": s([WEEKDAYS[d.weekday()] for d in days]),
        "d_month": s([MONTHS[d.month - 1] for d in days]),
        "d_year": i32([d.year for d in days]),
        "d_yearmonthnum": i32([d.year * 100 + d.month for d in days]),
        "d_yearmonth": s([f"{MONTHS[d.month - 1][:3]}{d.year}"
                          for d in days]),
        "d_daynuminweek": i32([(d.weekday() + 1) % 7 + 1 for d in days]),
        "d_daynuminmonth": i32([d.day for d in days]),
        "d_daynuminyear": i32([d.timetuple().tm_yday for d in days]),
        "d_monthnuminyear": i32([d.month for d in days]),
        "d_weeknuminyear": i32([(d.timetuple().tm_yday - 1) // 7 + 1
                                for d in days]),
        "d_sellingseason": s([SEASONS[d.month] for d in days]),
        "d_lastdayinweekfl": i32([d.weekday() == 5 for d in days]),
        "d_lastdayinmonthfl": i32(last_of_month),
        "d_holidayfl": i32([(d.month, d.day) in HOLIDAYS for d in days]),
        "d_weekdayfl": i32([d.weekday() < 5 for d in days]),
    }


def cities(nation_codes: torch.Tensor, digit: torch.Tensor) -> np.ndarray:
    """SSB's city: the nation's name cut or padded to 9 letters and a digit
    0-9 ("UNITED KI1")."""
    names = [f"{n[:9]:<9}{k}" for n, _r in NATIONS for k in range(10)]
    return vocab(names, nation_codes.long() * 10 + digit.long())


def label(numbers: np.ndarray) -> np.ndarray:
    """"MFGR#" and the number: the manufacturer (1-5), category (11-55)
    or brand (1101-5540: the category and 1-40 after it)."""
    uniq, inverse = np.unique(numbers, return_inverse=True)
    return np.asarray([f"MFGR#{n}" for n in uniq])[inverse]


def make_tables(rows: dict, seed: int, device) -> dict:
    """Every SSB table from ``seed``: host numpy arrays by table and column.
    ``rows`` gives ``customer``, ``supplier``, ``part``, ``orders`` and
    ``lineorder``; the date table has one row a day."""
    d = Draws(seed, device)
    n_cust, n_supp, n_part = rows["customer"], rows["supplier"], rows["part"]
    n_orders, n_lines = rows["orders"], rows["lineorder"]
    nation_names = [n for n, _r in NATIONS]
    region_of = torch.tensor([r for _n, r in NATIONS], device=d.device)

    def dim_geo(prefix: str, n: int) -> dict:
        nat = d.ints(0, 24, n)
        return {
            f"{prefix}_city": cities(nat, d.ints(0, 9, n)),
            f"{prefix}_nation": vocab(nation_names, nat),
            f"{prefix}_region": vocab(REGIONS, region_of[nat.long()]),
        }

    cust_geo = dim_geo("c", n_cust)
    customer = host({
        "c_custkey": torch.arange(1, n_cust + 1, dtype=torch.int32),
        "c_name": torch.arange(n_cust, dtype=torch.int32),
        "c_address": d.perm(n_cust).to(torch.int32),
        **cust_geo,
        "c_phone": d.perm(n_cust).to(torch.int32),
        "c_mktsegment": vocab(SEGMENTS, d.ints(0, 4, n_cust)),
    })
    supp_geo = dim_geo("s", n_supp)
    supplier = host({
        "s_suppkey": torch.arange(1, n_supp + 1, dtype=torch.int32),
        "s_name": torch.arange(n_supp, dtype=torch.int32),
        "s_address": d.perm(n_supp).to(torch.int32),
        **supp_geo,
        "s_phone": d.perm(n_supp).to(torch.int32),
    })

    pk = torch.arange(1, n_part + 1, dtype=torch.int32, device=d.device)
    mfgr = d.ints(1, 5, n_part).long()
    cat = mfgr * 10 + d.ints(1, 5, n_part)        # MFGR#12 -> 12
    brand = cat * 100 + d.ints(1, 40, n_part)      # MFGR#1221 -> 1221
    # TPC-H's retail price in cents: 90000 + (key / 10) % 20001 + 100 (key % 1000)
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    brand_np = brand.cpu().numpy()
    part = host({
        "p_partkey": pk,
        "p_name": d.ints(0, len(COLORS) ** 2 - 1, n_part),
        "p_mfgr": label(brand_np // 1000),
        "p_category": label(brand_np // 100),
        "p_brand1": label(brand_np),
        "p_color": vocab(COLORS, d.ints(0, len(COLORS) - 1, n_part)),
        "p_type": vocab(TYPES, d.ints(0, len(TYPES) - 1, n_part)),
        "p_size": d.ints(1, 50, n_part),
        "p_container": vocab(CONTAINERS, d.ints(0, len(CONTAINERS) - 1,
                                                n_part)),
    })

    dates = date_table()
    datekey = torch.from_numpy(dates["d_datekey"]).to(d.device)
    sizes = group_sizes(d, n_orders, n_lines, 1, 7)
    order = torch.repeat_interleave(
        torch.arange(n_orders, device=d.device), sizes)
    starts = torch.cumsum(sizes, 0) - sizes
    line_no = (torch.arange(n_lines, device=d.device) - starts[order] + 1)
    o = torch.arange(n_orders, device=d.device)
    orderkey = ((o // 8) * 32 + o % 8 + 1).to(torch.int32)   # sparse keys
    o_cust = d.ints(1, n_cust, n_orders)
    o_day = d.ints(0, LAST_ORDER_DAY, n_orders)
    o_prio = d.ints(0, len(PRIORITIES) - 1, n_orders)
    partkey = d.ints(1, n_part, n_lines)
    qty = d.ints(1, 50, n_lines)
    disc = d.ints(0, 10, n_lines)
    tax = d.ints(0, 8, n_lines)
    price = retail[partkey.long() - 1]
    ext = qty * price
    revenue = (ext.long() * (100 - disc) // 100).to(torch.int32)
    line_total = ext.long() * (100 - disc) * (100 + tax) // 10000
    ord_total = torch.zeros(n_orders, dtype=torch.int64, device=d.device)
    ord_total.index_add_(0, order, line_total)
    commit_day = o_day[order] + d.ints(30, 90, n_lines)
    prio_code = sorted(PRIORITIES)
    prio_map = torch.tensor([prio_code.index(p) for p in PRIORITIES],
                            dtype=torch.int32, device=d.device)
    mode_map = torch.tensor([sorted(SHIP_MODES).index(m) for m in SHIP_MODES],
                            dtype=torch.int32, device=d.device)
    lineorder = host({
        "lo_orderkey": orderkey[order],
        "lo_linenumber": line_no.to(torch.int32),
        "lo_custkey": o_cust[order],
        "lo_partkey": partkey,
        "lo_suppkey": d.ints(1, n_supp, n_lines),
        "lo_orderdate": datekey[o_day.long()][order],
        "lo_orderpriority": prio_map[o_prio.long()][order],
        "lo_shippriority": torch.zeros(n_lines, dtype=torch.int32,
                                       device=d.device),
        "lo_quantity": qty,
        "lo_extendedprice": ext,
        "lo_ordtotalprice": ord_total.to(torch.int32)[order],
        "lo_discount": disc,
        "lo_revenue": revenue,
        "lo_supplycost": (price.long() * 6 // 10).to(torch.int32),
        "lo_tax": tax,
        "lo_commitdate": datekey[commit_day.long()],
        "lo_shipmode": mode_map[d.ints(0, len(SHIP_MODES) - 1,
                                       n_lines).long()],
    })
    return {"lineorder": lineorder, "date": dates, "customer": customer,
            "supplier": supplier, "part": part}
