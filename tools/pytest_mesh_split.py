"""A pytest plugin that splits the CPU mesh tests' time by side.

    PYTHONPATH=tools:tests python -m pytest -p pytest_mesh_split -p no:xdist \\
        tests/test_torch_parallel.py tests/test_torch_dist_tail.py \\
        tests/test_torch_skew.py tests/test_torch_dist_joins.py

wraps ``torch_mesh_pool.jax_sql`` (JAX's side: its 4-device mesh, or one
device when ``mesh`` is None) and ``MeshPool.run`` (the port's side: the
gloo ranks, a pool's start-up included in its first call) in every test
module, and prints the seconds of each at the end of the session.
"""

import collections
import sys
import time

SECONDS = collections.Counter()


def _timed(fn, key_of):
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            SECONDS[key_of(args)] += time.perf_counter() - t0
    return wrapped


def pytest_configure(config):
    import torch_mesh_pool as P

    P.jax_sql = _timed(P.jax_sql, lambda a: "jax_mesh" if a[0] is not None
                       else "jax_single")
    P.MeshPool.run = _timed(P.MeshPool.run, lambda a: "pool_run")


def pytest_collection_finish(session):
    import torch_mesh_pool as P

    for m in list(sys.modules.values()):
        if (getattr(m, "__name__", "").startswith("test_torch")
                and hasattr(m, "jax_sql")):
            m.jax_sql = P.jax_sql


def pytest_unconfigure(config):
    print("\nmesh test seconds by side:",
          {k: round(v, 3) for k, v in SECONDS.items()})
