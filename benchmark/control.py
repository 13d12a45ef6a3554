"""The control of the comparison that decides ``correct``: a run of a cell
with the plain reference, computed one precision below the one the
configuration states (every sum accumulated in float32 instead of exact
int32 arithmetic), in the program's place. Its answers have to come out
as not correct; ``PERF.md`` keeps the numbers it reads.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s>

Prints the numbers compared, each beside its limit, and exits 0 when the
control came out as not correct. The benchmark's own runs never run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def control_answer(ref_module_name: str):
    """``answer(ctx, query, tables)`` for ``run_cell``: the reference in
    float32 sums, built once over the run's tables."""
    from harness import registry
    from reference.common import Ref

    mod = registry.module("reference", ref_module_name)
    state = {}

    def answer(_ctx, q, tables):
        if "R" not in state:
            state["R"] = Ref(tables, control=True)
            mod.prepare(state["R"])
        return getattr(mod, q.template.replace(".", "_"))(
            state["R"], q.param_dict)

    return answer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from harness import registry
    from harness.cell import run_cell

    cell = registry.cell(args.workload, registry.benchmark_json())
    cfg = registry.config(cell["config"])
    run = run_cell(cell, args.seed, args.seconds, False, T0,
                   device="cuda",
                   answer=control_answer(cfg["reference"]))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "control_correct": run.correct,
                      "attempted": run.attempted, "checks": run.checks}))
    return 0 if not run.correct else 1


if __name__ == "__main__":
    sys.exit(main())
