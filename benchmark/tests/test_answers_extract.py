"""The extract mix's templates (``mixes/extract.json``) over TPC-H's
lineitem at a small scale: the port through ``Context(device="cpu")``
gives the plain reference's matrix (``reference/tpch_extract.py``), rows
and order included, over several cycles of draws."""

import pytest

from harness import check, registry
from harness.cell import scaled_rows
from harness.traffic import Mix
from reference.common import Ref
from reference import tpch_extract

CYCLES = 3


@pytest.fixture(scope="module")
def loaded():
    import harkdb_tpu_torch as H

    cfg = registry.config("tpch-sf10")
    tables = registry.module("gen", cfg["generator"]).make_tables(
        scaled_rows(cfg, 0.001), 20261019, "cpu")
    ctx = H.Context(device="cpu")
    ctx.create_table("lineitem", tables["lineitem"])
    return ctx, Ref(tables), Mix(registry.mix_path("extract"))


def test_every_template_equals_the_reference(loaded):
    ctx, R, mix = loaded
    queries = mix.queries(21)
    rows = {}
    for _ in range(CYCLES * len(mix.names)):
        q = next(queries)
        got = ctx.sql(q.sql)
        want = getattr(tpch_extract, q.template)(R, q.param_dict)
        assert got.shape == want.shape, (q.template, q.params)
        assert check.digest(got) == check.digest(want), q.params
        rows.setdefault(q.template, []).append(want.shape[0])
    assert set(rows) == set(mix.names)
    assert sum(max(r) > 0 for r in rows.values()) == len(mix.names)


def test_every_template_has_a_reference():
    mix = Mix(registry.mix_path("extract"))
    assert all(callable(getattr(tpch_extract, n)) for n in mix.names)
    assert mix.schema == registry.config("tpch-sf10")["schema"]
