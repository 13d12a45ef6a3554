"""Every template of every mix, at a small scale, gives the same matrix
through ``harkdb_tpu_torch.Context(device="cpu")`` as through the plain
NumPy reference, over several cycles of parameter draws."""

import numpy as np
import pytest

from harness import check, registry
from harness.cell import scaled_rows
from harness.traffic import Mix
from reference.common import Ref

CONFIGS = {"ssb-sf20": ("flights", 0.0005), "tpch-sf10": ("power", 0.001)}
CYCLES = 3


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def loaded(request):
    import harkdb_tpu_torch as H

    name = request.param
    traffic, scale = CONFIGS[name]
    cfg = registry.config(name)
    tables = registry.module("gen", cfg["generator"]).make_tables(
        scaled_rows(cfg, scale), 20260917, "cpu")
    ctx = H.Context(device="cpu")
    for t, cols in tables.items():
        ctx.create_table(t, cols)
    ref_mod = registry.module("reference", cfg["reference"])
    R = Ref(tables)
    ref_mod.prepare(R)
    return ctx, R, ref_mod, Mix(registry.mix_path(traffic))


def test_every_template_equals_the_reference(loaded):
    ctx, R, ref_mod, mix = loaded
    queries = mix.queries(7)
    seen = set()
    for _ in range(CYCLES * len(mix.names)):
        q = next(queries)
        got = ctx.sql(q.sql)
        want = getattr(ref_mod, q.template.replace(".", "_"))(
            R, q.param_dict)
        assert got.shape == want.shape, (q.template, q.sql)
        assert check.digest(got) == check.digest(want), (
            q.template, q.params, got[:3], want[:3])
        seen.add(q.template)
    assert seen == set(mix.names)


def test_answers_are_not_empty(loaded):
    """The tables are big enough that most answers hold rows: a reference
    that returns nothing everywhere would agree with a broken engine."""
    ctx, R, ref_mod, mix = loaded
    queries = mix.queries(8)
    empty = 0
    for _ in mix.names:
        q = next(queries)
        want = getattr(ref_mod, q.template.replace(".", "_"))(
            R, q.param_dict)
        empty += want.shape[0] == 0
    assert empty <= len(mix.names) // 4


def test_control_differs_from_the_reference(loaded):
    """The reference one precision below the configuration's (sums in
    float32) gives other answers: the comparison can tell them apart."""
    _ctx, R, ref_mod, mix = loaded
    low = Ref(R.t, control=True)
    ref_mod.prepare(low)
    queries = mix.queries(9)
    differ = 0
    for _ in mix.names:
        q = next(queries)
        f = getattr(ref_mod, q.template.replace(".", "_"))
        differ += (check.digest(f(R, q.param_dict))
                   != check.digest(f(low, q.param_dict)))
    assert differ >= len(mix.names) // 2
