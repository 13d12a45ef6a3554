"""The one traffic generator: reads a mix file (``mixes/<traffic>.json``)
and yields the queries of a closed loop from a seed.

A mix holds query templates whose ``{NAME}`` fields are filled from
parameter draws. Each cycle sends every template once, in a permutation
drawn from the seed (as TPC-H permutes the queries of a stream), and each
query draws its parameters anew, from a stream of its template's own that
``PARAM_SEED`` fixes: the k-th query of a template has the same
parameters under every seed, so every seed runs the same set of queries in
another order, on tables of its own. Kinds of draw:

``{"name": N, "value": v}``            a constant
``{"name": N, "int": [lo, hi]}``       an integer, both ends included
``{"name": N, "choice": [...]}``       one of the values
``{"names": [N, M], "distinct": [...]}``  distinct values, one a name
``{"name": N, "day": [iso, iso]}``     a date, any day in the range
``{"name": N, "month": [iso, iso]}``   the first day of a month in range
``{"name": N, "year": [y0, y1]}``      January 1 of a year in range
``{"name": N, "add_months": [M, k]}``  date M plus k months
``{"name": N, "add": [M, k]}``         integer M plus k

A date renders in SQL as its day number since 1970-01-01.
"""

from __future__ import annotations

import datetime as dt
import json
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

from harness.tables import EPOCH, add_months

#: Seeds every template's parameter stream, the same under every ``--seed``.
PARAM_SEED = 20260917


@dataclass(frozen=True)
class Query:
    template: str
    sql: str
    params: tuple          # sorted (name, value) pairs: hashable

    @property
    def param_dict(self) -> dict:
        return dict(self.params)


def _date(iso: str) -> dt.date:
    return dt.date.fromisoformat(iso)


def draw(spec: dict, rng: np.random.Generator, got: Dict[str, object]):
    """Values of one draw, by name."""
    if "names" in spec:
        pool = spec["distinct"]
        idx = rng.choice(len(pool), size=len(spec["names"]), replace=False)
        return {n: pool[int(i)] for n, i in zip(spec["names"], idx)}
    name = spec["name"]
    if "value" in spec:
        v = spec["value"]
    elif "int" in spec:
        lo, hi = spec["int"]
        v = int(rng.integers(lo, hi + 1))
    elif "choice" in spec:
        v = spec["choice"][int(rng.integers(len(spec["choice"])))]
    elif "day" in spec:
        a, b = (_date(x) for x in spec["day"])
        v = a + dt.timedelta(int(rng.integers((b - a).days + 1)))
    elif "month" in spec:
        a, b = (_date(x + "-01") for x in spec["month"])
        n = (b.year - a.year) * 12 + b.month - a.month
        v = _date(add_months(a.isoformat(), int(rng.integers(n + 1))))
    elif "year" in spec:
        y0, y1 = spec["year"]
        v = dt.date(int(rng.integers(y0, y1 + 1)), 1, 1)
    elif "add_months" in spec:
        base, k = spec["add_months"]
        v = _date(add_months(got[base].isoformat(), k))
    elif "add" in spec:
        base, k = spec["add"]
        v = got[base] + k
    else:
        raise ValueError(f"unknown draw {spec}")
    return {name: v}


def render(value) -> str:
    if isinstance(value, dt.date):
        return str((value - EPOCH).days)
    return str(value)


class Mix:
    def __init__(self, path: str):
        with open(path) as f:
            self.spec = json.load(f)
        self.schema = self.spec["schema"]
        self.templates: List[dict] = self.spec["templates"]
        self.names = [t["name"] for t in self.templates]
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"{path}: template names repeat")

    def make(self, template: dict, rng: np.random.Generator) -> Query:
        got: Dict[str, object] = {}
        for spec in template.get("params", []):
            got.update(draw(spec, rng, got))
        sql = template["sql"]
        for k, v in got.items():
            sql = sql.replace("{" + k + "}", render(v))
        if "{" in sql:
            raise ValueError(f"{template['name']}: unfilled field in {sql}")
        return Query(template["name"], sql, tuple(sorted(got.items())))

    def queries(self, seed: int, stream: int = 0) -> Iterator[Query]:
        """The closed loop's queries: cycle after cycle, each a permutation
        of the templates drawn from ``seed``; each template's parameters
        from its own stream (``stream`` keeps the warm pass's draws apart
        from the window's)."""
        order = np.random.default_rng([int(seed) % (1 << 64), stream])
        params = [np.random.default_rng([PARAM_SEED, stream, i])
                  for i in range(len(self.templates))]
        while True:
            for i in order.permutation(len(self.templates)):
                yield self.make(self.templates[int(i)], params[int(i)])
