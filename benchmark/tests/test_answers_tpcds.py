"""Every template of the channels mix, at a small scale, gives the same
matrix through ``harkdb_tpu_torch.Context(device="cpu")`` as through the
plain NumPy reference (``reference/tpcds.py``), over several cycles of
parameter draws; the answers hold rows, and the reference one precision
below the configuration's (sums in float32, ratios and averages in
float16) gives other answers."""

import pytest

from harness import check, registry
from harness.cell import scaled_rows
from harness.traffic import Mix
from reference.common import Ref

SCALE = 0.002
CYCLES = 2


@pytest.fixture(scope="module")
def loaded():
    import harkdb_tpu_torch as H

    cfg = registry.config("tpcds-sf10")
    tables = registry.module("gen", cfg["generator"]).make_tables(
        scaled_rows(cfg, SCALE), 20261019, "cpu")
    ctx = H.Context(device="cpu")
    for t, cols in tables.items():
        ctx.create_table(t, cols)
    ref_mod = registry.module("reference", cfg["reference"])
    R = Ref(tables)
    ref_mod.prepare(R)
    return ctx, R, ref_mod, Mix(registry.mix_path("channels"))


def answer(ref_mod, R, q):
    return getattr(ref_mod, q.template)(R, q.param_dict)


def test_every_template_equals_the_reference(loaded):
    ctx, R, ref_mod, mix = loaded
    queries = mix.queries(11)
    seen = set()
    for _ in range(CYCLES * len(mix.names)):
        q = next(queries)
        got, want = ctx.sql(q.sql), answer(ref_mod, R, q)
        assert got.shape == want.shape, (q.template, q.params)
        assert check.digest(got) == check.digest(want), (
            q.template, q.params, got[:3], want[:3])
        seen.add(q.template)
    assert seen == set(mix.names)


def test_answers_are_not_empty(loaded):
    _ctx, R, ref_mod, mix = loaded
    queries = mix.queries(12)
    empty = [q.template for q in (next(queries) for _ in mix.names)
             if answer(ref_mod, R, q).shape[0] == 0]
    assert len(empty) <= len(mix.names) // 4, empty


def test_control_differs_from_the_reference(loaded):
    """The reference one precision below the configuration's (sums in
    float32, ratios and averages in float16) gives other answers: the
    comparison tells them apart in at least half the templates."""
    _ctx, R, ref_mod, mix = loaded
    low = Ref(R.t, control=True)
    ref_mod.prepare(low)
    queries = mix.queries(13)
    differ = set()
    for _ in range(CYCLES * len(mix.names)):
        q = next(queries)
        if (check.digest(answer(ref_mod, R, q))
                != check.digest(answer(ref_mod, low, q))):
            differ.add(q.template)
    assert len(differ) >= len(mix.names) // 2, differ
