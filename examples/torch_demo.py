"""The reference's smoke driver on harkdb_tpu_torch (the counterpart of
examples/demo.py, reference test.py:1-9).

Run: python examples/torch_demo.py [--cpu]   (on the CUDA device unless
--cpu is given)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harkdb_tpu_torch import FutharkContext  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)
    fc = FutharkContext(device="cpu" if args.cpu else "cuda")
    fc.create_table(
        "game_1",
        os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                     "data.csv"),
    )
    result = fc.sql("select col1, col3 from game_1")           # test.py:6
    result2 = fc.sql("select col1, max(col3) from game_1 "
                     "group by col1")                           # test.py:7
    print(result)
    print(result2)


if __name__ == "__main__":
    main()
