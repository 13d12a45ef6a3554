"""TPC-DS's channels mix and TPC-H's extract mix through the port on the CPU,
against the benchmark's plain NumPy references (``benchmark/reference/``,
which import neither package).

The tables come from the benchmark's generators at a small scale and a
fixed seed: every template of both mixes, over several parameter draws,
gives the reference's matrix whole (shape and every value, NaN equal to
NaN). Separate cases hold the join and set shapes the channels mix leans
on: an inner join on a key that an earlier LEFT join made nullable (the
join's NULL code), a two-key FULL OUTER join, a three-arm EXCEPT. The
control, the reference one precision below the configuration's (sums in
float32, ratios and averages in float16), gives other answers.
"""

import os
import sys

import numpy as np
import pytest

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import harkdb_tpu_torch as H  # noqa: E402
from harkdb_tpu_torch.plan import planner  # noqa: E402
from harness import check, registry  # noqa: E402
from harness.cell import scaled_rows  # noqa: E402
from harness.traffic import Mix  # noqa: E402
from reference import tpcds as ref_ds  # noqa: E402
from reference import tpch_extract as ref_x  # noqa: E402
from reference.common import Ref  # noqa: E402

SEED = 20261019
DRAWS = 3
CHANNELS = Mix(registry.mix_path("channels"))
EXTRACT = Mix(registry.mix_path("extract"))


def context(tables):
    ctx = H.Context(device="cpu")
    for name, cols in tables.items():
        ctx.create_table(name, cols)
    return ctx


@pytest.fixture(scope="module")
def tpcds():
    cfg = registry.config("tpcds-sf10")
    tables = registry.module("gen", "tpcds").make_tables(
        scaled_rows(cfg, 0.002), SEED, "cpu")
    R = Ref(tables)
    ref_ds.prepare(R)
    return context(tables), R


@pytest.fixture(scope="module")
def tpch():
    cfg = registry.config("tpch-sf10")
    tables = registry.module("gen", "tpch").make_tables(
        scaled_rows(cfg, 0.001), SEED, "cpu")
    return context({"lineitem": tables["lineitem"]}), Ref(tables)


def draws(mix, template, n=DRAWS):
    """The first ``n`` queries of ``template`` in the mix's loop."""
    queries = mix.queries(SEED)
    out = []
    while len(out) < n:
        q = next(queries)
        if q.template == template:
            out.append(q)
    return out


def same(got, want):
    return (got.shape == want.shape
            and check.digest(got) == check.digest(want))


@pytest.mark.parametrize("template", CHANNELS.names)
def test_channels_template_equals_the_reference(tpcds, template):
    ctx, R = tpcds
    for q in draws(CHANNELS, template):
        got = ctx.sql(q.sql)
        want = getattr(ref_ds, template)(R, q.param_dict)
        assert same(got, want), (template, q.params, got[:3], want[:3])


@pytest.mark.parametrize("template", EXTRACT.names)
def test_extract_template_equals_the_reference(tpch, template):
    ctx, R = tpch
    for q in draws(EXTRACT, template):
        got = ctx.sql(q.sql)
        want = getattr(ref_x, template)(R, q.param_dict)
        assert same(got, want), (template, q.params)


@pytest.fixture
def joins(monkeypatch):
    """The joins' count phases the planner asks for: (keys a side, NULL
    flags given, FULL OUTER)."""
    seen = []
    ranges = planner.compute_join_ranges

    def spy(l_key, n_l, r_key, n_r, *a, **kw):
        n = len(l_key) if isinstance(l_key, (list, tuple)) else 1
        nulls = kw.get("l_null") is not None or kw.get("r_null") is not None
        seen.append((n, nulls, bool(kw.get("need_full"))))
        return ranges(l_key, n_l, r_key, n_r, *a, **kw)

    monkeypatch.setattr(planner, "compute_join_ranges", spy)
    return seen


def test_an_inner_join_on_a_null_key(tpcds, joins):
    """Sales LEFT JOIN their returns, then the return's date: the date
    key is NULL on every sale that was not returned, and matches nothing."""
    ctx, R = tpcds
    got = ctx.sql(
        "select count(*), sum(sr_return_amt) from store_sales left join "
        "store_returns on ss_ticket_number = sr_ticket_number and "
        "ss_item_sk = sr_item_sk join date_dim on sr_returned_date_sk = "
        "d_date_sk where d_year = 2000")
    assert (2, False, False) in joins and (1, True, False) in joins
    sr = R.t["store_returns"]
    ss = R.t["store_sales"]
    sold = set(zip(ss["ss_ticket_number"].tolist(),
                   ss["ss_item_sk"].tolist()))
    ret = np.asarray([k in sold for k in zip(
        sr["sr_ticket_number"].tolist(), sr["sr_item_sk"].tolist())])
    drow = R.row_of("date_dim", "d_date_sk", sr["sr_returned_date_sk"])
    keep = ret & (drow >= 0)
    keep[keep] = R.col("date_dim", "d_year")[drow[keep]] == 2000
    assert keep.sum() > 0 and (drow < 0).sum() > 0
    want = [[int(keep.sum()), int(R.total(sr["sr_return_amt"][keep]))]]
    np.testing.assert_array_equal(got, want)


def test_a_two_key_full_outer_join(tpcds, joins):
    ctx, R = tpcds
    got = ctx.sql(
        "with a as (select ws_bill_customer_sk as c, ws_item_sk as i, "
        "sum(ws_quantity) as q from web_sales group by ws_bill_customer_sk,"
        " ws_item_sk), b as (select cs_bill_customer_sk as c, cs_item_sk "
        "as i, sum(cs_quantity) as q from catalog_sales group by "
        "cs_bill_customer_sk, cs_item_sk) select count(*), sum(a.q), "
        "sum(b.q), sum(case when a.c is null then 1 else 0 end) from a "
        "full outer join b on a.c = b.c and a.i = b.i")
    assert (2, False, True) in joins

    def keyed(table, pre, cust):
        t = R.t[table]
        k = (t[cust].astype(np.int64) << 32) | t[f"{pre}_item_sk"]
        return np.unique(k), t[f"{pre}_quantity"]

    a, qa = keyed("web_sales", "ws", "ws_bill_customer_sk")
    b, qb = keyed("catalog_sales", "cs", "cs_bill_customer_sk")
    both = np.union1d(a, b)
    assert np.intersect1d(a, b).size > 0
    want = [[both.size, int(R.total(qa)), int(R.total(qb)),
             np.setdiff1d(b, a).size]]
    np.testing.assert_array_equal(got, want)


def test_a_three_arm_except(tpcds):
    ctx, R = tpcds
    got = ctx.sql(
        "select ss_customer_sk from store_sales except select "
        "cs_bill_customer_sk from catalog_sales except select "
        "ws_bill_customer_sk from web_sales order by ss_customer_sk")
    want = np.setdiff1d(np.setdiff1d(
        R.t["store_sales"]["ss_customer_sk"],
        R.t["catalog_sales"]["cs_bill_customer_sk"]),
        R.t["web_sales"]["ws_bill_customer_sk"])
    assert 0 < want.size < np.unique(
        R.t["store_sales"]["ss_customer_sk"]).size
    np.testing.assert_array_equal(got[:, 0], want)
    assert ctx.last_metrics.setop_rows == sum(
        R.t[t][c].size for t, c in (
            ("store_sales", "ss_customer_sk"),
            ("catalog_sales", "cs_bill_customer_sk"),
            ("web_sales", "ws_bill_customer_sk")))


@pytest.mark.parametrize("template", ["q2", "q12", "q47", "q89", "q98"])
def test_the_control_differs(tpcds, template):
    """The reference one precision below the configuration's (sums in
    float32, ratios and averages in float16) returns other answers."""
    _ctx, R = tpcds
    low = Ref(R.t, control=True)
    for q in draws(CHANNELS, template, 2):
        a = getattr(ref_ds, template)(R, q.param_dict)
        b = getattr(ref_ds, template)(low, q.param_dict)
        assert a.shape[0] and not same(a, b), q.params
