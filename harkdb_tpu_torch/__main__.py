"""CLI: run SQL against CSV/parquet tables from the shell.

    python -m harkdb_tpu_torch --table game_1=data.csv \
        "select col1, max(col3) from game_1 group by col1"

The arguments of ``python -m harkdb_tpu``: --table NAME=PATH (repeatable),
--mesh (distributed execution: not ported yet, raises), --explain,
--profile DIR, --cpu (run on the CPU; without it the query runs on the
CUDA device). The default output is a table printed through pandas;
--explain and --profile (which prints the raw matrix) need no pandas.
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
                    help="row-shard tables over all visible devices")
    ap.add_argument("--explain", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)

    from harkdb_tpu_torch import Context

    ctx = Context(device="cpu" if args.cpu else "cuda",
                  mesh=True if args.mesh else None)
    for spec in args.table:
        name, _, path = spec.partition("=")
        if not path:
            ap.error(f"--table expects NAME=PATH, got {spec!r}")
        ctx.create_table(name, path)

    if args.explain:
        print(ctx.explain(args.sql))
        return 0
    if args.profile:
        out = ctx.profile(args.sql, args.profile)
        print(f"(trace written to {args.profile})", file=sys.stderr)
        print(out)
        return 0
    if importlib.util.find_spec("pandas") is None:
        print("harkdb_tpu_torch: printing a result table needs pandas, "
              "which is not installed; --explain and --profile DIR (which "
              "prints the raw matrix) run without it", file=sys.stderr)
        return 1
    df = ctx.sql_df(args.sql)
    print(df.to_string(index=False))
    m = ctx.last_metrics
    print(
        f"({m.rows_out} rows, plan {m.plan_ms:.1f} ms, "
        f"exec {m.execute_ms:.1f} ms)", file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
