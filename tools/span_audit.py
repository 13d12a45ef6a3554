#!/usr/bin/env python3
"""Where a benchmark cell's device time, host reads and idle gaps go, by the
port's own spans (``hark.*``, ``harkdb_tpu_torch/utils/metrics.py``).

    python3 tools/span_audit.py --workload ssb-sf20.flights --seed N \
        --seconds S [--scale 1.0] [--device cuda] [--onoff K] [--out FILE]

Runs the cell once as ``benchmark/run.py --trace 1`` does (same set-up,
closed loop and reference check; ``--scale`` shrinks its tables) and keeps
the reduced trace, then prints one JSON object (also written to ``--out``):

* ``span_us``: the cost of one ``span()`` with no profiler active (``off``,
  less an empty loop's iteration) and under ``torch.profiler`` (``on``);
* ``per_layer``: the benchmark's per-layer metrics of that run;
* ``by_operator``: device ms per query by the operator span that enqueued
  it (``(none)``: outside every operator span), ``coverage`` the share of
  device time inside one, and each operator's largest device ops;
* ``syncs``: blocking runtime calls (``harness.trace.SYNC_CALLS``) per
  query inside query ranges, by the ``hark.sync.*`` site open around them;
  one outside every site is listed by the innermost host op open then;
* ``idle_after``: device idle ms per query in gaps opening inside each
  ``hark.sync.*`` site (``sync_idle_ms`` by site); ``idle_by_operator``:
  idle ms per query by the operator span open at each gap's middle;
  ``idle_gaps``: the benchmark's breakdown, gaps named by the host range
  open at their middle;
* ``leaked_annotations``: device events named ``hark.*`` in the trace's
  device activity (the spans' GPU-side twins must stay out of it);
* ``onoff``: with ``--onoff K``, K pairs of further traced windows of the
  cell (no reference check) with the spans on and off in turns (on, off,
  off, on, ...): each window's median latency and rate.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import types
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]


def span_cost(n: int, on_card: bool) -> dict:
    """Microseconds per ``with span(...)`` off and on, and per empty loop
    iteration (off: n times; on: n // 10 times under the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harkdb_tpu_torch.utils.metrics import span

    def per_iter(fn, k):
        t0 = time.perf_counter()
        fn(k)
        return (time.perf_counter() - t0) / k * 1e6

    def empty(k):
        for _ in range(k):
            pass

    def spans(k):
        for _ in range(k):
            with span("hark.audit"):
                pass

    base = min(per_iter(empty, n) for _ in range(3))
    off = min(per_iter(spans, n) for _ in range(3))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts):
        on = min(per_iter(spans, n // 10) for _ in range(3))
    if on_card:
        torch.cuda.synchronize()
    return {"empty_loop": base, "off": off - base, "on": on - base}


def summarize(tr, run) -> dict:
    from harness.spans import PREFIX, SYNC, innermost, owners
    from harness.trace import NAME_CHARS, SYNC_CALLS

    nq = tr.n_queries
    own = owners(tr)
    by_op = defaultdict(int)
    kernels = defaultdict(lambda: defaultdict(int))
    for d, o in zip(tr.device, own):
        name = o.name if o is not None else "(none)"
        by_op[name] += d.end - d.start
        kernels[name][d.name[:NAME_CHARS]] += d.end - d.start
    total = sum(by_op.values()) or 1
    ops = {k: {"ms_per_query": v / 1e6 / nq,
               "top": [[n, t / 1e6 / nq] for n, t in sorted(
                   kernels[k].items(), key=lambda kv: -kv[1])[:8]]}
           for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])}

    in_q = [s for s in tr.runtime if s.name in SYNC_CALLS]
    qs = innermost(tr.queries, [s.start for s in in_q])
    in_q = [s for s, q in zip(in_q, qs) if q is not None]
    sites = [s for s in tr.host_ops if s.name.startswith(SYNC)]
    plain = [s for s in tr.host_ops if not s.name.startswith("hark.")]
    site_of = innermost(sites, [s.start for s in in_q])
    host_of = innermost(plain, [s.start for s in in_q])
    syncs = defaultdict(int)
    outside = defaultdict(int)
    for s, site, host in zip(in_q, site_of, host_of):
        if site is not None:
            syncs[site.name] += 1
        else:
            outside[f"{s.name} in {host.name if host else '(python)'}"] += 1

    b = tr.busy_intervals()
    lo, hi = tr.window
    gaps = [(a, e) for a, e in zip([lo] + b[:, 1].tolist(),
                                   b[:, 0].tolist() + [hi]) if e > a]
    idle = defaultdict(int)
    for (a, e), s in zip(gaps, innermost(sites, [a for a, _e in gaps])):
        if s is not None:
            idle[s.name] += e - a
    ops_spans = [s for s in tr.host_ops
                 if s.name.startswith(PREFIX) and not s.name.startswith(SYNC)]
    mids = [(a + e) // 2 for a, e in gaps]
    idle_op = defaultdict(int)
    for (a, e), q, o in zip(gaps, innermost(tr.queries, mids),
                            innermost(ops_spans, mids)):
        where = "between queries" if q is None else (
            o.name if o is not None else "(no operator)")
        idle_op[where] += e - a

    lat = sorted(run.latencies)
    return {
        "queries": nq,
        "p50_ms": statistics.median(lat) * 1e3 if lat else None,
        "queries_per_s": len(lat) / run.window_s if run.window_s else None,
        "busy_s": tr.busy_s(), "window_s": tr.window_s(),
        "per_layer": run.per_layer,
        "coverage": 1 - by_op.get("(none)", 0) / total,
        "by_operator": ops,
        "syncs": {k: v / nq for k, v in sorted(syncs.items())},
        "syncs_outside_sites": {k: v / nq for k, v in sorted(outside.items())},
        "idle_after": {k: v / 1e6 / nq for k, v in sorted(idle.items())},
        "idle_by_operator": {k: v / 1e6 / nq for k, v in sorted(
            idle_op.items(), key=lambda kv: -kv[1])},
        "idle_gaps": tr.idle_gaps(),
        "leaked_annotations": sum(d.name.startswith("hark.")
                                  for d in tr.device),
    }


def traced(cell, seed, seconds, scale, device, spans_on, check):
    """One traced run of the cell: (Run, Trace)."""
    from harkdb_tpu_torch.utils import metrics
    from harness import cell as cell_mod
    from harness import trace as trace_mod

    kept = []
    reduce_events = trace_mod.reduce_events

    def keep(*a, **kw):
        kept.append(reduce_events(*a, **kw))
        return kept[-1]

    real = metrics._autograd_profiler
    trace_mod.reduce_events = keep
    if not spans_on:
        metrics._autograd_profiler = types.SimpleNamespace(
            _is_profiler_enabled=False)
    try:
        run = cell_mod.run_cell(cell, seed, seconds, True,
                                time.perf_counter(), device=device,
                                scale=scale, check_answers=check)
    finally:
        trace_mod.reduce_events = reduce_events
        metrics._autograd_profiler = real
    return run, kept[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--onoff", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import registry

    on_card = args.device.startswith("cuda")
    if on_card and not torch.cuda.is_available():
        print("span_audit: --device cuda needs a CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload, registry.benchmark_json())
    out = {"device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
           "workload": args.workload, "seed": args.seed,
           "seconds": args.seconds, "scale": args.scale,
           "span_us": span_cost(200000, on_card)}
    run, tr = traced(cell, args.seed, args.seconds, args.scale, args.device,
                     True, True)
    out["correct"] = run.correct
    out.update(summarize(tr, run))
    del tr
    onoff = []
    for i in range(2 * args.onoff):
        on = i % 4 in (0, 3)
        r, t = traced(cell, args.seed + 1 + i // 2, args.seconds, args.scale,
                      args.device, on, False)
        lat = sorted(r.latencies)
        onoff.append({"spans": on, "queries": len(lat),
                      "p50_ms": statistics.median(lat) * 1e3,
                      "queries_per_s": len(lat) / r.window_s,
                      "busy_s": t.busy_s(), "window_s": t.window_s(),
                      "per_layer": r.per_layer})
        del t
    out["onoff"] = onoff
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
