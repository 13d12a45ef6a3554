"""CLI: run SQL against CSV/parquet tables from the shell.

    python -m harkdb_tpu_torch --table game_1=data.csv \
        "select col1, max(col3) from game_1 group by col1"

The arguments of ``python -m harkdb_tpu``: --table NAME=PATH (repeatable),
--mesh, --explain, --profile DIR, --cpu (run on the CPU; without it the
query runs on the CUDA device). The default output is a table printed
through pandas; --explain and --profile (which prints the raw matrix) need
no pandas.

--mesh runs the query distributed, one process per rank, under torchrun:

    python -m torch.distributed.run --nproc-per-node 4 -m harkdb_tpu_torch \
        --mesh --table t=data.csv "select ..."

Rank r runs on ``cuda:{LOCAL_RANK}`` (over NCCL when every rank has a card
of its own, else gloo), or on the CPU over gloo with --cpu. Rank 0 prints;
the other ranks run silently. Without a launcher --mesh raises.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="harkdb_tpu_torch")
    ap.add_argument("sql", help="SQL statement")
    ap.add_argument("--table", action="append", default=[],
                    metavar="NAME=PATH", help="register a table (repeatable)")
    ap.add_argument("--mesh", action="store_true",
                    help="run distributed, one rank per process (torchrun)")
    ap.add_argument("--explain", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)

    from harkdb_tpu_torch import Context

    if not args.mesh:
        return _run(ap, args, Context(device="cpu" if args.cpu else "cuda"),
                    True)
    import torch.distributed as dist

    from harkdb_tpu_torch.parallel.multihost import init_from_env

    mesh = init_from_env(cpu=args.cpu)
    try:
        return _run(ap, args, Context(mesh=mesh), mesh.rank == 0)
    finally:
        dist.destroy_process_group()


def _run(ap, args, ctx, speak: bool) -> int:
    """Load the tables into ``ctx`` and run the query; only a rank that
    ``speak``s prints."""
    def say(*a, **kw):
        if speak:
            print(*a, **kw)

    for spec in args.table:
        name, _, path = spec.partition("=")
        if not path:
            ap.error(f"--table expects NAME=PATH, got {spec!r}")
        ctx.create_table(name, path)

    if args.explain:
        say(ctx.explain(args.sql))
        return 0
    if args.profile:
        out = ctx.profile(args.sql, args.profile)
        say(f"(trace written to {args.profile})", file=sys.stderr)
        say(out)
        return 0
    if importlib.util.find_spec("pandas") is None:
        say("harkdb_tpu_torch: printing a result table needs pandas, "
            "which is not installed; --explain and --profile DIR (which "
            "prints the raw matrix) run without it", file=sys.stderr)
        return 1
    df = ctx.sql_df(args.sql)
    say(df.to_string(index=False))
    m = ctx.last_metrics
    say(f"({m.rows_out} rows, plan {m.plan_ms:.1f} ms, "
        f"exec {m.execute_ms:.1f} ms)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
