"""The extract mix's templates (``mixes/extract.json``) over TPC-H's
lineitem in plain NumPy: the rows whose ship date lies in the window, in
the table's order, or ordered by ship date where the template says so
(ties keep the table's order: the port's sorts are stable)."""

from __future__ import annotations

import numpy as np

from harness.tables import EPOCH
from reference.common import Ref, matrix

COLUMNS = {
    "x2": ["l_orderkey", "l_extendedprice"],
    "x3": ["l_orderkey", "l_partkey", "l_quantity"],
    "x4": ["l_orderkey", "l_linenumber", "l_shipdate", "l_extendedprice"],
    "x5": ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
           "l_discount"],
    "x6": ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
           "l_quantity", "l_extendedprice"],
}
ORDERED = {"x4", "x5"}


def prepare(R: Ref) -> None:
    """Nothing to make ahead."""


def extract(R: Ref, p, template: str) -> np.ndarray:
    li = R.t["lineitem"]
    d0 = (p["D"] - EPOCH).days
    sd = li["l_shipdate"]
    rows = np.flatnonzero((sd >= d0) & (sd <= d0 + p["W"]))
    if template in ORDERED:
        rows = rows[np.argsort(sd[rows], kind="stable")]
    return matrix([li[c][rows] for c in COLUMNS[template]], np.int32)


def x2(R: Ref, p):
    return extract(R, p, "x2")


def x3(R: Ref, p):
    return extract(R, p, "x3")


def x4(R: Ref, p):
    return extract(R, p, "x4")


def x5(R: Ref, p):
    return extract(R, p, "x5")


def x6(R: Ref, p):
    return extract(R, p, "x6")
