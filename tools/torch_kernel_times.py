#!/usr/bin/env python3
"""Time kernels A and B of one checkout of harkdb_tpu_torch on the card.

    python3 tools/torch_kernel_times.py --root PATH [--label NAME]

imports ``harkdb_tpu_torch`` from the checkout at PATH (building its
kernels there), makes the inputs of chip_smoke.py's main shapes, and times
with chip_smoke.py's ``time_cuda`` (CUDA events over 20 calls after 3
warm-up, queued behind a device sleep):

  * kernel A, ``flat_compact`` on 16,777,216 rows x 2 int32, ``v > 0``;
  * kernel B, ``flat_segscan("max")`` under the group-by's ids, 2^23 rows;
  * ``prims.scan.running_max`` and ``running_min(reverse=True)`` on the
    same 2^23 values (kernel B over one segment, with whatever the
    checkout does around it);
  * end to end (chip_smoke.py's ``time_query``, median of 7 warm calls):
    the main query on the 2^24-row table, the window query with its
    result left on the card (``sql_batch``) and TPC-H Q4 at SF 1 row
    counts.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose harkdb_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from harkdb_tpu_torch.kernels import _lib, compact, segscan
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
    import harkdb_tpu_torch as H

    k_np, v_np = cs.table_data(cs.N_MAIN)
    ctx = H.Context(device="cuda")
    ctx.create_table("t", {"k": k_np, "v": v_np})
    got["main_query_ms"] = cs.time_query(torch, ctx, cs.MAIN_QUERY, reps=7)[0]
    got["window_on_card_ms"] = cs.time_query(
        torch, ctx, cs.WINDOW_QUERY, reps=7, run=ctx.sql_batch)[0]
    del ctx
    ctx = H.Context(device="cuda")
    for name, cols_np in cs.q3_data().items():
        ctx.create_table(name, cols_np)
    got["tpch_q4_ms"] = cs.time_query(torch, ctx, cs.Q4_QUERY, reps=7)[0]
    print(cs.card_line(), flush=True)
    print(json.dumps({"label": args.label or args.root, "rows": rows,
                      **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
