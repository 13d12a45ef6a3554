#!/usr/bin/env python3
"""Card memory query by query over one window of a benchmark cell.

    python3 tools/held_bytes_window.py --workload tpch-sf10.power --seed N \
        --seconds S [--scale 1.0] [--device cuda] [--out FILE]

Runs the cell once as ``benchmark/run.py --trace 0`` does (same set-up,
closed loop and reference check) and notes after every query of the window
its template, its host seconds, ``Context.last_metrics.held_bytes`` (card
memory allocated beyond the resident tables as the query returned; -1 for
a program without the counter), ``inner_plans_run``, ``cached_plan`` and
``torch.cuda.memory_allocated``. Prints one JSON object (also written to
``--out``): the run's checks, the median seconds of each template, those
numbers per query, and a summary of ``held_bytes``: first, last, largest,
and the least-squares slope over the window's queries in bytes a query.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from harness import registry
    from harness.cell import run_cell
    from harness.traffic import Mix

    cell = registry.cell(args.workload, registry.benchmark_json())
    on_card = torch.device(args.device).type == "cuda"
    rows = []

    def answer(ctx, q, _tables):
        t = time.perf_counter()
        out = ctx.sql(q.sql)
        t = time.perf_counter() - t
        m = ctx.last_metrics
        rows.append([q.template, t, getattr(m, "held_bytes", -1),
                     getattr(m, "inner_plans_run", -1), m.cached_plan,
                     torch.cuda.memory_allocated() if on_card else -1])
        return out

    run = run_cell(cell, args.seed, args.seconds, False, t0,
                   device=args.device, scale=args.scale, answer=answer)
    rows = rows[len(Mix(registry.mix_path(cell["traffic"])).names):]
    held = np.asarray([r[2] for r in rows], dtype=np.float64)
    seconds = {}
    for r in rows:
        seconds.setdefault(r[0], []).append(r[1])
    slope = (float(np.polyfit(np.arange(held.size), held, 1)[0])
             if held.size > 1 else None)
    out = {"workload": args.workload, "seed": args.seed,
           "correct": run.correct, "failed": run.failed,
           "checks": run.checks, "memory_peak_bytes": run.memory_peak_bytes,
           "data_bytes": run.data_bytes,
           "held_bytes": {"first": int(held[0]) if held.size else None,
                          "last": int(held[-1]) if held.size else None,
                          "max": int(held.max()) if held.size else None,
                          "mean": float(held.mean()) if held.size else None,
                          "slope_per_query": slope},
           "median_s": {k: float(np.median(v))
                        for k, v in sorted(seconds.items())},
           "columns": ["template", "seconds", "held_bytes",
                       "inner_plans_run", "cached_plan", "memory_allocated"],
           "queries": rows}
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({k: v for k, v in out.items() if k != "queries"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
