#!/usr/bin/env python3
"""Time the kernels of one checkout of harkdb_tpu_torch on the card.

    python3 tools/torch_kernel_times.py --root PATH [--label NAME] [--sweep]

imports ``harkdb_tpu_torch`` from the checkout at PATH (building its
kernels there), makes the inputs of chip_smoke.py's main shapes, and times
with chip_smoke.py's ``time_cuda`` (CUDA events over 20 calls after 3
warm-up, queued behind a device sleep):

  * kernel A, ``flat_compact`` on 16,777,216 rows x 2 int32, ``v > 0``;
  * kernel B, ``flat_segscan("max")`` under the group-by's ids, 2^23 rows;
  * ``prims.scan.running_max`` and ``running_min(reverse=True)`` on the
    same 2^23 values (kernel B over one segment, with whatever the
    checkout does around it);
  * kernel D, ``expand_fills`` at chip_smoke.py's star-join and Q3 shapes;
  * kernel C, ``onehot_groupby_sums`` at 2^23 rows: span 4096 with a mask,
    span 1, span 16384 with three sum columns;
  * end to end (chip_smoke.py's ``time_query``, median of 7 warm calls):
    the main query on the 2^24-row table, the window query with its
    result left on the card (``sql_batch``), the star join, and TPC-H Q3
    and Q4 at SF 1 row counts. Q3 is host-bound and its wall time wanders
    within a process, so it takes 15 calls, all of them reported; the star
    join's and Q3's device-busy time (one run under torch.profiler, the
    sum of its kernels' times) sits beside their wall time.

With ``--sweep`` it also times kernel C under each histogram shape
(chip_smoke.py's ``C_PLANS``), at the same shapes, for a checkout whose
``matmul_agg`` has ``shape_plan``.

Run it on two checkouts in turns (parent, change, change, parent) inside
one machine to compare them. It prints the card line and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_cd(torch, cs, dev, expand, agg, sweep) -> dict:
    """Kernels D and C at chip_smoke.py's shapes (its ``cd_shapes`` and
    ``check_cd_main``); with ``sweep``, C per histogram shape."""
    d_star, d_q3, c_main = cs.cd_shapes(torch, dev)
    _d, _c, (one_k, one_v, nv), (w_k, w_v, _nv) = cs.check_cd_main(
        torch, expand, agg, dev, d_star, d_q3, c_main)
    key, vals, _nv, kmin, span, mask = c_main
    c_shapes = {"": (key, vals, kmin, span, mask),
                "_span1": (one_k, one_v, 5, 1, None),
                "_span16384x3": (w_k, w_v, 0, 16384, None)}
    got = {"expand_star_ms": cs.time_cuda(
               torch, lambda: expand.expand_fills(*d_star)),
           "expand_q3_ms": cs.time_cuda(
               torch, lambda: expand.expand_fills(*d_q3))}
    for tag, (k, vs, km, sp, m) in c_shapes.items():
        got[f"dense_agg{tag}_ms"] = cs.time_cuda(
            torch, lambda: agg.onehot_groupby_sums(k, vs, nv, km, sp, mask=m))
    if not sweep or not hasattr(agg, "shape_plan"):
        return got
    for tag, (k, vs, km, sp, m) in c_shapes.items():
        for name, cluster in cs.C_PLANS:
            plan = agg.shape_plan(getattr(agg, name), cluster, sp, len(vs),
                                  agg.smem_optin())
            if plan is None:
                continue
            ref = agg.onehot_groupby_sums_reference(k, vs, nv, km, sp, m)
            out = agg._launch(k, vs, nv, km, sp, m, plan)
            if not all(torch.equal(a, b) for a, b in zip(
                    [out[0], *out[1]], [ref[0], *ref[1]])):
                raise AssertionError(f"kernel C differs under plan {plan}")
            label = f"sweep_dense_agg{tag}_{name.lower()}{cluster}_ms"
            got[label] = cs.time_cuda(
                torch, lambda: agg._launch(k, vs, nv, km, sp, m, plan))
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose harkdb_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="also time kernel C under each histogram shape")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from harkdb_tpu_torch.kernels import (
        _lib, compact, expand, matmul_agg, segscan,
    )
    from harkdb_tpu_torch.prims.scan import running_max, running_min

    _lib.build()
    dev = torch.device("cuda")
    (k, v, mask), (sid, vals) = cs.main_shapes(torch, dev)
    n_valid = torch.full((), k.shape[0], dtype=torch.int32, device=dev)
    cols = {"k": k, "v": v}
    got = {
        "compact_ms": cs.time_cuda(
            torch, lambda: compact.flat_compact(cols, mask, n_valid)),
        "segscan_max_ms": cs.time_cuda(
            torch, lambda: segscan.flat_segscan("max", sid, [vals], -2**31)),
        "running_max_ms": cs.time_cuda(torch, lambda: running_max(vals)),
        "running_min_reverse_ms": cs.time_cuda(
            torch, lambda: running_min(vals, reverse=True)),
    }
    rows = {"compact": k.shape[0], "segscan": sid.shape[0]}
    del k, v, mask, sid, vals, cols
    got.update(time_cd(torch, cs, dev, expand, matmul_agg, args.sweep))
    torch.cuda.empty_cache()
    import harkdb_tpu_torch as H

    k_np, v_np = cs.table_data(cs.N_MAIN)
    ctx = H.Context(device="cuda")
    ctx.create_table("t", {"k": k_np, "v": v_np})
    got["main_query_ms"] = cs.time_query(torch, ctx, cs.MAIN_QUERY, reps=7)[0]
    got["window_on_card_ms"] = cs.time_query(
        torch, ctx, cs.WINDOW_QUERY, reps=7, run=ctx.sql_batch)[0]
    del ctx
    facts, dims = cs.star_data()
    ctx = H.Context(device="cuda")
    ctx.create_table("facts", facts)
    ctx.create_table("dims", dims)
    got["star_join_ms"] = cs.time_query(torch, ctx, cs.STAR_QUERY, reps=7)[0]
    got["star_join_busy_ms"] = cs.profile_query(torch, ctx, cs.STAR_QUERY,
                                                top=0)
    del ctx, facts, dims
    ctx = H.Context(device="cuda")
    for name, cols_np in cs.q3_data().items():
        ctx.create_table(name, cols_np)
    got["tpch_q3_ms"], got["tpch_q3_all_ms"] = cs.time_query(
        torch, ctx, cs.Q3_QUERY, reps=15)
    got["tpch_q3_busy_ms"] = cs.profile_query(torch, ctx, cs.Q3_QUERY, top=0)
    got["tpch_q4_ms"] = cs.time_query(torch, ctx, cs.Q4_QUERY, reps=7)[0]
    print(cs.card_line(), flush=True)
    print(json.dumps({"label": args.label or args.root, "rows": rows,
                      **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
