"""TPC-DS's tables that the channels mix reads (TPC-DS specification,
clause 3 and dsdgen's rules, as the configuration states them), generated
from a seed.

Every table has every column the specification defines for it. Surrogate
keys count from 1 (``t_time_sk`` from 0, ``d_date_sk`` from 2,415,022,
1900-01-02); dates are int32 days since 1970-01-01; money is int32 cents;
percentages are int32 percents. A sale is a line of a ticket (store) or an
order (catalog, web): the lines of one ticket share its date, time,
customer, store and promotion, and name distinct items. Prices follow
dsdgen's pricing: list price = wholesale cost x (100 + markup) / 100,
sales price = list price x (100 - discount) / 100, the ``ext_`` amounts
are the line's prices times its quantity. A return is one sales line,
chosen without repetition, with 1 to the line's quantity returned.

dsdgen writes NULL into the nullable foreign keys of the sales and returns
tables; the port's storage has no NULL, so a NULL key is stored as -1, a
key no dimension row holds (the configuration's ``assumed.null_keys``).
Where the configuration lists a column under ``codes``, it holds the int32
code a sorted dictionary gives its string; the strings the mixes read are
strings.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np
import torch

from harness.tables import Draws, group_sizes, host, vocab

#: d_date_sk of 1900-01-02, the date table's first row (dsdgen's
#: DATE_MINIMUM as a Julian day number).
FIRST_DATE_SK = 2415022
FIRST_DATE = _dt.date(1900, 1, 2)
#: The sales dates: 1998-01-02 to 2003-01-02, as dsdgen's sales run.
SALES_FIRST_SK = 2450816
SALES_LAST_SK = 2452642
#: date_dim's and time_dim's rows, the same at every scale factor.
DATE_ROWS = 73049
TIME_ROWS = 86400
#: A stored NULL foreign key.
NULL_KEY = -1
#: One row in ``NULL_ONE_IN`` of each nullable foreign key holds NULL.
NULL_ONE_IN = 25

DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]
#: dsdgen's categories, each with eight classes whose names no other
#: category uses (``i_class_id`` numbers them 1-8 in this order).
CATEGORIES = {
    "Books": ["arts", "business", "computers", "cooking", "fiction",
              "history", "mystery", "travel"],
    "Children": ["infants", "newborn", "school-uniforms", "toddlers",
                 "toys", "games", "nursery", "babywear"],
    "Electronics": ["audio", "cameras", "camcorders", "disk drives",
                    "monitors", "portable", "stereo", "televisions"],
    "Home": ["accent", "bathroom", "bedding", "decor", "flatware",
             "furniture", "glassware", "lighting"],
    "Jewelry": ["birdal", "bracelets", "costume", "diamonds", "earings",
                "gold", "pendants", "rings"],
    "Men": ["accessories", "pants", "shirts", "sports-apparel", "suits",
            "ties", "outerwear", "underwear"],
    "Music": ["classical", "country", "pop", "rock", "jazz", "blues",
              "folk", "soundtracks"],
    "Shoes": ["athletic", "kids", "mens", "womens", "boots", "sandals",
              "slippers", "work"],
    "Sports": ["archery", "baseball", "basketball", "camping", "fishing",
               "football", "golf", "tennis"],
    "Women": ["dresses", "fragrances", "maternity", "swimwear", "blouses",
              "skirts", "lingerie", "sleepwear"],
}
N_CLASSES = 8
#: Syllables of dsdgen's brand names: a brand is the syllables of its
#: category and class and a number, ``"<syllables> #<1-10>"``.
BRAND_SYLLABLES = ["amalg", "edu pack", "export", "import", "scholar",
                   "univ", "maxi", "corp", "brand", "nameless"]
STORE_NAMES = ["able", "anti", "ation", "bar", "cally", "eing", "ese",
               "n st", "ought", "pri"]
COMPANY_NAMES = ["Unknown", "able", "anti", "ation", "bar", "ought"]
#: Syllables of the customers' names (dsdgen draws from name lists; these
#: make 2,500 first and 2,500 last names).
NAME_SYLLABLES = [
    "al", "an", "ar", "be", "bo", "ca", "da", "de", "di", "el", "en", "er",
    "fa", "ga", "ha", "is", "ja", "ka", "la", "le", "li", "lo", "ma", "me",
    "mi", "na", "ne", "ni", "no", "ol", "pa", "ra", "re", "ri", "ro", "sa",
    "se", "so", "ta", "te", "ti", "to", "va", "vi", "wa", "ya", "za", "ze",
    "zo", "ul"]
MEALS = {**{h: "breakfast" for h in (6, 7, 8)},
         **{h: "lunch" for h in (11, 12, 13)},
         **{h: "dinner" for h in (17, 18, 19)}}

#: Rows of the dimensions the sales tables refer to and that no template
#: reads, at SF 10 (their keys are drawn in these ranges).
REFERENCED = {"customer_demographics": 1920800, "household_demographics":
              7200, "customer_address": 250000, "promotion": 500,
              "reason": 45, "call_center": 24, "catalog_page": 12000,
              "ship_mode": 20, "warehouse": 10, "web_page": 200,
              "web_site": 42}


def _names(prefix: str, text: str) -> list:
    return [f"{prefix}_{c}" for c in text.split()]


#: The returns tables' and the catalog and web sales tables' columns, in
#: the specification's order.
STORE_RETURNS = _names("sr", """returned_date_sk return_time_sk item_sk
    customer_sk cdemo_sk hdemo_sk addr_sk store_sk reason_sk ticket_number
    return_quantity return_amt return_tax return_amt_inc_tax fee
    return_ship_cost refunded_cash reversed_charge store_credit net_loss""")
CATALOG_RETURNS = _names("cr", """returned_date_sk returned_time_sk item_sk
    refunded_customer_sk refunded_cdemo_sk refunded_hdemo_sk
    refunded_addr_sk returning_customer_sk returning_cdemo_sk
    returning_hdemo_sk returning_addr_sk call_center_sk catalog_page_sk
    ship_mode_sk warehouse_sk reason_sk order_number return_quantity
    return_amount return_tax return_amt_inc_tax fee return_ship_cost
    refunded_cash reversed_charge store_credit net_loss""")
WEB_RETURNS = _names("wr", """returned_date_sk returned_time_sk item_sk
    refunded_customer_sk refunded_cdemo_sk refunded_hdemo_sk
    refunded_addr_sk returning_customer_sk returning_cdemo_sk
    returning_hdemo_sk returning_addr_sk web_page_sk reason_sk order_number
    return_quantity return_amt return_tax return_amt_inc_tax fee
    return_ship_cost refunded_cash reversed_charge account_credit
    net_loss""")
_PRICES = """quantity wholesale_cost list_price sales_price ext_discount_amt
    ext_sales_price ext_wholesale_cost ext_list_price ext_tax coupon_amt
    ext_ship_cost net_paid net_paid_inc_tax net_paid_inc_ship
    net_paid_inc_ship_tax net_profit"""
CHANNEL_COLUMNS = {
    "cs": _names("cs", """sold_date_sk sold_time_sk ship_date_sk
        bill_customer_sk bill_cdemo_sk bill_hdemo_sk bill_addr_sk
        ship_customer_sk ship_cdemo_sk ship_hdemo_sk ship_addr_sk
        call_center_sk catalog_page_sk ship_mode_sk warehouse_sk item_sk
        promo_sk order_number """ + _PRICES),
    "ws": _names("ws", """sold_date_sk sold_time_sk ship_date_sk item_sk
        bill_customer_sk bill_cdemo_sk bill_hdemo_sk bill_addr_sk
        ship_customer_sk ship_cdemo_sk ship_hdemo_sk ship_addr_sk
        web_page_sk web_site_sk ship_mode_sk warehouse_sk promo_sk
        order_number """ + _PRICES),
}


def first_names() -> list:
    s = NAME_SYLLABLES
    return [(a + b).capitalize() for a in s for b in s]


def last_names() -> list:
    s = NAME_SYLLABLES
    return [(a + b + "s").capitalize() for a in s for b in s]


def brand_name(cat_id: int, class_id: int, k: int) -> str:
    return (f"{BRAND_SYLLABLES[cat_id - 1]}"
            f"{BRAND_SYLLABLES[class_id % len(BRAND_SYLLABLES)]} #{k}")


def item_id(n: int) -> str:
    """dsdgen's 16-character business key: the number's 16 hex digits
    written with the letters A-P."""
    return "".join(chr(65 + (n >> (4 * (15 - i)) & 15)) for i in range(16))


def date_table(n_rows: int) -> dict:
    """``date_dim``: one row a day from 1900-01-02, ``n_rows`` days."""
    i = np.arange(n_rows, dtype=np.int64)
    day = np.datetime64(FIRST_DATE.isoformat()) + i
    ymd = day.astype("datetime64[D]")
    year = ymd.astype("datetime64[Y]").astype(np.int64) + 1970
    month = ymd.astype("datetime64[M]").astype(np.int64) % 12 + 1
    first_of_month = ymd.astype("datetime64[M]").astype("datetime64[D]")
    dom = (ymd - first_of_month).astype(np.int64) + 1
    epoch = (ymd - np.datetime64("1970-01-01")).astype(np.int64)
    dow = (epoch + 4) % 7                    # 0 on Sunday (1970-01-01: Thu)
    sk = FIRST_DATE_SK + i
    next_month = (ymd.astype("datetime64[M]") + 1).astype("datetime64[D]")
    first_sk = sk - (dom - 1)
    last_sk = first_sk + (next_month - first_of_month).astype(np.int64) - 1
    qoy = (month - 1) // 3 + 1
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    names = np.asarray(["Sunday"] + DAY_NAMES[:6])
    y_n = np.zeros(n_rows, np.int32)         # codes of 'N' (of N, Y)
    return {
        "d_date_sk": i32(sk),
        "d_date_id": i32(i),
        "d_date": i32(epoch),
        "d_month_seq": i32((year - 1900) * 12 + month - 1),
        "d_week_seq": i32((i + 2) // 7 + 1),       # weeks start on Sunday
        "d_quarter_seq": i32((year - 1900) * 4 + qoy),
        "d_year": i32(year),
        "d_dow": i32(dow),
        "d_moy": i32(month),
        "d_dom": i32(dom),
        "d_qoy": i32(qoy),
        "d_fy_year": i32(year),
        "d_fy_quarter_seq": i32((year - 1900) * 4 + qoy),
        "d_fy_week_seq": i32((i + 2) // 7 + 1),
        "d_day_name": names[dow],
        "d_quarter_name": i32((year - 1900) * 4 + qoy - 1),
        "d_holiday": i32(((month == 1) & (dom == 1))
                         | ((month == 12) & (dom == 25))),
        "d_weekend": i32((dow == 0) | (dow == 6)),
        "d_following_holiday": i32(((month == 1) & (dom == 2))
                                   | ((month == 12) & (dom == 26))),
        "d_first_dom": i32(first_sk),
        "d_last_dom": i32(last_sk),
        "d_same_day_ly": i32(sk - 365),
        "d_same_day_lq": i32(sk - 91),
        "d_current_day": y_n,
        "d_current_week": y_n,
        "d_current_month": y_n,
        "d_current_quarter": y_n,
        "d_current_year": y_n,
    }


def time_table(n_rows: int) -> dict:
    """``time_dim``: one row a second of the day."""
    t = np.arange(n_rows, dtype=np.int64)
    hour, minute, second = t // 3600, t // 60 % 60, t % 60
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    meal = np.asarray([MEALS.get(h, "") for h in range(24)])
    return {
        "t_time_sk": i32(t),
        "t_time_id": i32(t),
        "t_time": i32(t),
        "t_hour": i32(hour),
        "t_minute": i32(minute),
        "t_second": i32(second),
        "t_am_pm": i32(hour >= 12),                      # AM, PM
        "t_shift": i32(np.select([hour < 8, hour < 16], [0, 1], 2)),
        "t_sub_shift": i32(hour // 6),
        "t_meal_time": meal[hour],
    }


def make_tables(rows: dict, seed: int, device) -> dict:
    """Every table the channels mix reads, from ``seed``: host numpy
    arrays by table and column. ``rows`` gives the rows of every table
    but ``date_dim`` and ``time_dim``, whose sizes are fixed."""
    d = Draws(seed, device)
    dev = d.device
    i32 = torch.int32
    n_item, n_cust, n_store = rows["item"], rows["customer"], rows["store"]

    def ref_key(table: str, n: int) -> torch.Tensor:
        """A key of a dimension no template reads."""
        return d.ints(1, REFERENCED[table], n)

    def nullable(key: torch.Tensor) -> torch.Tensor:
        null = d.ints(0, NULL_ONE_IN - 1, key.numel()) == 0
        return torch.where(null, torch.full_like(key, NULL_KEY), key)

    # -- dimensions -----------------------------------------------------------
    date_dim = date_table(DATE_ROWS)
    time_dim = time_table(TIME_ROWS)

    cat_names = sorted(CATEGORIES)
    cat_id = d.ints(1, len(cat_names), n_item)
    class_id = d.ints(1, N_CLASSES, n_item)
    brand_k = d.ints(1, 10, n_item)
    cat_h, class_h, k_h = (x.cpu().numpy() for x in (cat_id, class_id,
                                                     brand_k))
    class_words = np.asarray([CATEGORIES[c][j] for c in cat_names
                              for j in range(N_CLASSES)])
    brands = {}
    brand_col = np.empty(n_item, dtype=object)
    for key in set(zip(cat_h.tolist(), class_h.tolist(), k_h.tolist())):
        brands[key] = brand_name(*key)
    brand_col[:] = [brands[k] for k in zip(cat_h.tolist(), class_h.tolist(),
                                           k_h.tolist())]
    isk = torch.arange(1, n_item + 1, dtype=i32)
    wholesale_i = d.ints(2, 8000, n_item)
    item = host({
        "i_item_sk": isk,
        # two revisions of an item share its business key
        "i_item_id": np.asarray([item_id((k + 1) // 2)
                                 for k in range(1, n_item + 1)]),
        "i_rec_start_date": d.ints(10162, 11253, n_item),  # 1997-10-27..
        "i_rec_end_date": d.ints(11254, 12345, n_item),
        "i_item_desc": d.perm(n_item).to(i32),
        "i_current_price": wholesale_i + d.ints(1, 2000, n_item),
        "i_wholesale_cost": wholesale_i,
        "i_brand_id": cat_id * 1000000 + class_id * 1000 + brand_k,
        "i_brand": brand_col.astype(str),
        "i_class_id": class_id,
        "i_class": class_words[(cat_h - 1) * N_CLASSES + class_h - 1],
        "i_category_id": cat_id,
        "i_category": np.asarray(cat_names)[cat_h - 1],
        "i_manufact_id": d.ints(1, 1000, n_item),
        "i_manufact": d.ints(0, 999, n_item),
        "i_size": d.ints(0, 6, n_item),
        "i_formulation": d.perm(n_item).to(i32),
        "i_color": d.ints(0, 91, n_item),
        "i_units": d.ints(0, 20, n_item),
        "i_container": torch.zeros(n_item, dtype=i32),
        "i_manager_id": d.ints(1, 100, n_item),
        "i_product_name": d.perm(n_item).to(i32),
    })

    ssk = torch.arange(1, n_store + 1, dtype=i32)
    store = host({
        "s_store_sk": ssk,
        "s_store_id": ((ssk + 1) // 2 - 1),
        "s_rec_start_date": d.ints(10162, 11253, n_store),
        "s_rec_end_date": d.ints(11254, 12345, n_store),
        "s_closed_date_sk": d.ints(2450816, 2452642, n_store),
        "s_store_name": vocab(STORE_NAMES, d.ints(0, len(STORE_NAMES) - 1,
                                                  n_store)),
        "s_number_employees": d.ints(200, 300, n_store),
        "s_floor_space": d.ints(5000000, 10000000, n_store),
        "s_hours": d.ints(0, 2, n_store),
        "s_manager": d.perm(n_store).to(i32),
        "s_market_id": d.ints(1, 10, n_store),
        "s_geography_class": torch.zeros(n_store, dtype=i32),
        "s_market_desc": d.perm(n_store).to(i32),
        "s_market_manager": d.perm(n_store).to(i32),
        "s_division_id": torch.ones(n_store, dtype=i32),
        "s_division_name": torch.zeros(n_store, dtype=i32),
        "s_company_id": d.ints(1, len(COMPANY_NAMES), n_store),
        "s_company_name": None,            # named from s_company_id below
        "s_street_number": d.ints(1, 999, n_store),
        "s_street_name": d.perm(n_store).to(i32),
        "s_street_type": d.ints(0, 19, n_store),
        "s_suite_number": d.ints(0, 99, n_store),
        "s_city": d.ints(0, 59, n_store),
        "s_county": d.ints(0, 29, n_store),
        "s_state": d.ints(0, 50, n_store),
        "s_zip": d.ints(10000, 99999, n_store),
        "s_country": torch.zeros(n_store, dtype=i32),
        "s_gmt_offset": d.ints(-10, -5, n_store),
        "s_tax_precentage": d.ints(0, 11, n_store),
    })
    store["s_company_name"] = np.asarray(COMPANY_NAMES)[
        store["s_company_id"] - 1]

    firsts, lasts = first_names(), last_names()

    def skewed(n_words: int, n: int) -> torch.Tensor:
        """Popular names first: the index of u^2 over the list."""
        u = d.ints(0, (1 << 20) - 1, n).double() / (1 << 20)
        return (u * u * n_words).long().clamp_max(n_words - 1)

    csk = torch.arange(1, n_cust + 1, dtype=i32)
    customer = host({
        "c_customer_sk": csk,
        "c_customer_id": csk - 1,
        "c_current_cdemo_sk": nullable(ref_key("customer_demographics",
                                               n_cust)),
        "c_current_hdemo_sk": nullable(ref_key("household_demographics",
                                               n_cust)),
        "c_current_addr_sk": ref_key("customer_address", n_cust),
        "c_first_shipto_date_sk": nullable(d.ints(2449028, 2452678,
                                                   n_cust)),
        "c_first_sales_date_sk": nullable(d.ints(2448998, 2452648, n_cust)),
        "c_salutation": d.ints(0, 5, n_cust),
        "c_first_name": vocab(firsts, skewed(len(firsts), n_cust)),
        "c_last_name": vocab(lasts, skewed(len(lasts), n_cust)),
        "c_preferred_cust_flag": d.ints(0, 1, n_cust),
        "c_birth_day": d.ints(1, 28, n_cust),
        "c_birth_month": d.ints(1, 12, n_cust),
        "c_birth_year": d.ints(1924, 1992, n_cust),
        "c_birth_country": d.ints(0, 211, n_cust),
        "c_login": torch.zeros(n_cust, dtype=i32),
        "c_email_address": d.perm(n_cust).to(i32),
        "c_last_review_date_sk": nullable(d.ints(2452283, 2452648, n_cust)),
    })

    # -- sales ---------------------------------------------------------------
    def lines(n: int, lo: int, hi: int):
        """Line -> its ticket / order (0-based), the line within it, and the
        number of tickets."""
        n_groups = max(1, int(round(n / ((lo + hi) / 2))))
        sizes = group_sizes(d, n_groups, n, lo, hi)
        grp = torch.repeat_interleave(torch.arange(n_groups, device=dev),
                                      sizes)
        starts = torch.cumsum(sizes, 0) - sizes
        within = torch.arange(n, device=dev) - starts[grp]
        return grp, within, n_groups

    def items_of(grp, within, n_groups):
        """Distinct items within a ticket: base + line x step, mod items."""
        base = d.ints(0, n_item - 1, n_groups).long()
        step = d.ints(1, max(1, n_item // 16), n_groups).long()
        return ((base[grp] + within * step[grp]) % n_item + 1).to(i32)

    def pricing(n: int, ship: bool):
        q = d.ints(1, 100, n)
        whole = d.ints(100, 10000, n)
        lst = whole * (100 + d.ints(0, 200, n)) // 100
        sale = lst * (100 - d.ints(0, 100, n)) // 100
        ext_sale = sale * q
        coupon = torch.where(d.ints(0, 4, n) == 0,
                             ext_sale * d.ints(0, 100, n) // 100,
                             torch.zeros_like(ext_sale))
        paid = ext_sale - coupon
        tax = paid * d.ints(0, 9, n) // 100
        p = {"quantity": q, "wholesale_cost": whole, "list_price": lst,
             "sales_price": sale, "ext_discount_amt": (lst - sale) * q,
             "ext_sales_price": ext_sale, "ext_wholesale_cost": whole * q,
             "ext_list_price": lst * q, "ext_tax": tax,
             "coupon_amt": coupon}
        if ship:
            p["ext_ship_cost"] = lst * q * d.ints(0, 50, n) // 100
        p["net_paid"] = paid
        p["net_paid_inc_tax"] = paid + tax
        if ship:
            p["net_paid_inc_ship"] = paid + p["ext_ship_cost"]
            p["net_paid_inc_ship_tax"] = paid + tax + p["ext_ship_cost"]
        p["net_profit"] = paid - whole * q
        return p

    def returns(prefix: str, n: int, sales: dict, s: str, number: str,
                keys: dict, order: list) -> dict:
        """``n`` returns of distinct lines of ``sales`` (columns of prefix
        ``s``): ``keys`` maps a return's foreign key to the sales column it
        copies (or to a tensor of its own), ``number`` is the ticket or
        order number's column; ``order`` the columns in the
        specification's order."""
        pick = d.perm(sales[f"{s}_item_sk"].numel())[:n].sort().values
        q = sales[f"{s}_quantity"][pick]
        rq = (d.ints(0, (1 << 20) - 1, n).long() * q.long() >> 20).to(
            i32) + 1
        amt = sales[f"{s}_sales_price"][pick] * rq
        tax = amt * d.ints(0, 9, n) // 100
        fee = d.ints(50, 10000, n)
        ship = sales[f"{s}_list_price"][pick] * rq * d.ints(0, 50, n) // 100
        cash = amt * d.ints(0, 100, n) // 100
        charge = (amt - cash) * d.ints(0, 100, n) // 100
        sold = sales[f"{s}_sold_date_sk"][pick]
        ret_date = torch.where(sold == NULL_KEY,
                               d.ints(SALES_FIRST_SK, SALES_LAST_SK, n),
                               sold + d.ints(1, 90, n))
        vals = [nullable(ret_date), nullable(d.ints(28800, 79199, n)),
                sales[f"{s}_item_sk"][pick]]
        for src in keys.values():
            vals.append(nullable(sales[src][pick] if isinstance(src, str)
                                 else src))
        # the ticket or order number is part of the return's key
        vals += [sales[number][pick], rq, amt, tax, amt + tax, fee, ship,
                 cash, charge, amt - cash - charge, ship + fee + tax - cash]
        assert len(vals) == len(order)
        return dict(zip(order, vals))

    n_ss = rows["store_sales"]
    grp, within, n_t = lines(n_ss, 8, 16)
    t_date = d.ints(SALES_FIRST_SK, SALES_LAST_SK, n_t)
    t_time = d.ints(28800, 79199, n_t)                 # 8:00 to 21:59
    t_cust = d.ints(1, n_cust, n_t)
    t_cdemo = ref_key("customer_demographics", n_t)
    t_hdemo = ref_key("household_demographics", n_t)
    t_addr = ref_key("customer_address", n_t)
    t_store = d.ints(1, n_store, n_t)
    t_promo = ref_key("promotion", n_t)
    g = grp
    ss = {
        "ss_sold_date_sk": nullable(t_date[g]),
        "ss_sold_time_sk": nullable(t_time[g]),
        "ss_item_sk": items_of(grp, within, n_t),
        "ss_customer_sk": nullable(t_cust[g]),
        "ss_cdemo_sk": nullable(t_cdemo[g]),
        "ss_hdemo_sk": nullable(t_hdemo[g]),
        "ss_addr_sk": nullable(t_addr[g]),
        "ss_store_sk": nullable(t_store[g]),
        "ss_promo_sk": nullable(t_promo[g]),
        "ss_ticket_number": (grp + 1).to(i32),
    }
    ss.update({f"ss_{k}": v for k, v in pricing(n_ss, ship=False).items()})
    del grp, within, g
    sr = returns("sr", rows["store_returns"], ss, "ss", "ss_ticket_number",
                 {"sr_customer_sk": "ss_customer_sk",
                  "sr_cdemo_sk": "ss_cdemo_sk", "sr_hdemo_sk": "ss_hdemo_sk",
                  "sr_addr_sk": "ss_addr_sk", "sr_store_sk": "ss_store_sk",
                  "sr_reason_sk": ref_key("reason", rows["store_returns"])},
                 STORE_RETURNS)
    store_sales = host(ss)
    del ss
    store_returns = host(sr)
    del sr

    def channel(prefix: str, n: int, lo: int, hi: int, page_key: dict):
        grp, within, n_o = lines(n, lo, hi)
        o_date = d.ints(SALES_FIRST_SK, SALES_LAST_SK, n_o)
        o = {
            "sold_date_sk": o_date,
            "sold_time_sk": d.ints(0, 86399, n_o),
            "ship_date_sk": o_date + d.ints(2, 90, n_o),
            "bill_customer_sk": d.ints(1, n_cust, n_o),
            "bill_cdemo_sk": ref_key("customer_demographics", n_o),
            "bill_hdemo_sk": ref_key("household_demographics", n_o),
            "bill_addr_sk": ref_key("customer_address", n_o),
        }
        ship_same = d.ints(0, 1, n_o) == 0
        o["ship_customer_sk"] = torch.where(
            ship_same, o["bill_customer_sk"], d.ints(1, n_cust, n_o))
        o["ship_cdemo_sk"] = ref_key("customer_demographics", n_o)
        o["ship_hdemo_sk"] = ref_key("household_demographics", n_o)
        o["ship_addr_sk"] = ref_key("customer_address", n_o)
        for k, table in page_key.items():
            o[k] = ref_key(table, n_o)
        o["ship_mode_sk"] = ref_key("ship_mode", n_o)
        o["warehouse_sk"] = ref_key("warehouse", n_o)
        item_col = items_of(grp, within, n_o)
        promo = ref_key("promotion", n)
        cols = {}
        order = CHANNEL_COLUMNS[prefix]
        for name in order:
            short = name[len(prefix) + 1:]
            if short == "item_sk":
                cols[name] = item_col
            elif short == "promo_sk":
                cols[name] = nullable(promo)
            elif short == "order_number":
                cols[name] = (grp + 1).to(i32)
            elif short in o:
                cols[name] = nullable(o[short][grp])
        cols.update({f"{prefix}_{k}": v
                     for k, v in pricing(n, ship=True).items()})
        return {name: cols[name] for name in order}

    cs = channel("cs", rows["catalog_sales"], 4, 14,
                 {"call_center_sk": "call_center",
                  "catalog_page_sk": "catalog_page"})
    cr = returns("cr", rows["catalog_returns"], cs, "cs", "cs_order_number",
                 {"cr_refunded_customer_sk": "cs_bill_customer_sk",
                  "cr_refunded_cdemo_sk": "cs_bill_cdemo_sk",
                  "cr_refunded_hdemo_sk": "cs_bill_hdemo_sk",
                  "cr_refunded_addr_sk": "cs_bill_addr_sk",
                  "cr_returning_customer_sk": "cs_ship_customer_sk",
                  "cr_returning_cdemo_sk": "cs_ship_cdemo_sk",
                  "cr_returning_hdemo_sk": "cs_ship_hdemo_sk",
                  "cr_returning_addr_sk": "cs_ship_addr_sk",
                  "cr_call_center_sk": "cs_call_center_sk",
                  "cr_catalog_page_sk": "cs_catalog_page_sk",
                  "cr_ship_mode_sk": "cs_ship_mode_sk",
                  "cr_warehouse_sk": "cs_warehouse_sk",
                  "cr_reason_sk": ref_key("reason",
                                          rows["catalog_returns"])},
                 CATALOG_RETURNS)
    catalog_sales = host(cs)
    del cs
    catalog_returns = host(cr)
    del cr

    ws = channel("ws", rows["web_sales"], 4, 14,
                 {"web_page_sk": "web_page", "web_site_sk": "web_site"})
    wr = returns("wr", rows["web_returns"], ws, "ws", "ws_order_number",
                 {"wr_refunded_customer_sk": "ws_bill_customer_sk",
                  "wr_refunded_cdemo_sk": "ws_bill_cdemo_sk",
                  "wr_refunded_hdemo_sk": "ws_bill_hdemo_sk",
                  "wr_refunded_addr_sk": "ws_bill_addr_sk",
                  "wr_returning_customer_sk": "ws_ship_customer_sk",
                  "wr_returning_cdemo_sk": "ws_ship_cdemo_sk",
                  "wr_returning_hdemo_sk": "ws_ship_hdemo_sk",
                  "wr_returning_addr_sk": "ws_ship_addr_sk",
                  "wr_web_page_sk": "ws_web_page_sk",
                  "wr_reason_sk": ref_key("reason", rows["web_returns"])},
                 WEB_RETURNS)
    web_sales = host(ws)
    del ws
    web_returns = host(wr)
    del wr

    return {"store_sales": store_sales, "store_returns": store_returns,
            "catalog_sales": catalog_sales,
            "catalog_returns": catalog_returns, "web_sales": web_sales,
            "web_returns": web_returns, "customer": customer, "item": item,
            "store": store, "date_dim": date_dim, "time_dim": time_dim}
