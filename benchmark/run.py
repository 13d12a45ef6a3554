"""Runs one cell of the benchmark of ``harkdb_tpu_torch`` once, on the
card(s) of this machine, and prints one JSON result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name from ``BENCHMARK.json`` (``harness/registry.py``). The run builds or
loads the port's kernel library (``harkdb_tpu_torch/build/``, inside the
checkout), makes the tables from ``--seed`` on the card, loads them
through ``Context(device="cuda").create_table``, sends every template once
to warm up, then runs a closed loop of ``Context.sql`` for ``--seconds``
and checks a sample of the answers against the plain NumPy reference.
With ``--trace 1`` the same window runs under ``torch.profiler`` and the
line carries the per-layer metrics instead of the end-to-end ones.

Without a CUDA card, or with fewer than the cell asks for, it exits with
code 2 and prints no result; if the process has loaded JAX or the JAX
package by the end, it exits with code 3 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# Caches of the program and of PyTorch stay inside the checkout, at fixed
# paths, so the runs after a cell's first find them.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "harkdb_tpu")


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``harkdb_tpu_torch`` is not ``harkdb_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def end_to_end_values(run) -> dict:
    """The end-to-end metrics: latencies of every query the window
    completed (the 95th percentile linear between closest ranks, as
    numpy's default), the rate over the window's seconds."""
    import numpy as np

    lat_ms = np.asarray(run.latencies) * 1e3
    if not lat_ms.size:
        return {"setup_s": run.setup_s}
    return {
        "query_p50_ms": float(np.median(lat_ms)),
        "query_p95_ms": float(np.percentile(lat_ms, 95)),
        "queries_per_s": len(lat_ms) / run.window_s,
        "device_mem_per_data_byte": run.memory_peak_bytes / run.data_bytes,
        "setup_s": run.setup_s,
    }


def result_line(run, bench: dict, cell_name: str, trace: bool,
                kind: str, count: int) -> dict:
    from harness import registry
    from harness.check import LIMITS

    if trace:
        wanted, values = registry.per_layer(bench, cell_name), run.per_layer
    else:
        wanted = registry.end_to_end(bench, cell_name)
        values = end_to_end_values(run)
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if m["name"] in values}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.traced_window_s
        line["breakdown"] = run.breakdown
    # a checkout's first run builds the kernel library inside ``setup_s``
    line["build_s"] = run.build_s
    line["checks"] = {k: {"value": run.checks.get(k), "limit": v}
                      for k, v in LIMITS.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import registry

    bench = registry.benchmark_json()
    cell = registry.cell(args.workload, bench)
    chips = int(cell["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"shows {n}. No result.", file=sys.stderr)
        return 2
    say = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    if chips > 1:
        from harness.launch import run_ranks

        run = run_ranks(cell, args.seed, args.seconds,
                        bool(args.trace), chips, T0)
    else:
        from harness.cell import run_cell

        run = run_cell(cell, args.seed, args.seconds,
                       bool(args.trace), T0, device="cuda", say=say)
    line = result_line(run, bench, args.workload, bool(args.trace),
                       torch.cuda.get_device_name(0), chips)

    bad = loaded_forbidden()
    if bad:
        print(f"this process loaded {bad}: the benchmark drives "
              f"harkdb_tpu_torch alone. No result.", file=sys.stderr)
        return 3
    for d in run.diffs or []:
        say(f"wrong answer: {d}")
    for e in run.errors or []:
        say(f"failed query: {e[:600]}")
    say(f"{run.attempted} queries in {run.window_s:.3f} s, "
        f"{run.failed} failed; memory peak {run.memory_peak_bytes} B over "
        f"{run.data_bytes} B of table data")
    say(f"run {time.perf_counter() - T0:.1f} s in all")
    for k, v in line["checks"].items():
        say(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
