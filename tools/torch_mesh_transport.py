#!/usr/bin/env python3
"""Time chip_smoke.py's mesh queries under two ways of giving CUDA tensors
to gloo's collectives.

    python3 tools/torch_mesh_transport.py [--order staged,direct,direct,staged]

``staged``: every collective of ``EngineMesh`` copies its CUDA tensors to
host tensors, runs gloo's host collective on them and copies the result
back to the card. ``direct``: the CUDA tensors go to ``dist.all_reduce`` /
``all_gather`` / ``all_to_all_single`` as they are, and gloo stages them
through the host itself (its CUDA work classes). Both variants are
installed here over ``EngineMesh``'s methods in each rank, whatever the
package ships, so the comparison holds for any checkout.

Each run in ``--order`` spawns chip_smoke.py's phase 10 (``run_mesh``): 4
gloo ranks sharing ``cuda:0`` run every case of ``MESH_SETS`` at full
width, each timed warm (median of 5 on rank 0, every run started after a
barrier) and profiled once on rank 0 (device-busy time, the host operators
with the most self time). Every rank's result must be the same in every
run, and rank 0's must equal chip_smoke.py's numpy oracle. 4 ranks share
one card: no figure here is a scaling figure. Prints the card line and one
JSON line. Needs a card and nvcc; builds the kernels first.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402


def _staged_methods():
    import torch
    import torch.distributed as dist

    def to_host(t):
        return t.cpu() if t.is_cuda else t.contiguous()

    def all_reduce(self, t, op="sum"):
        w = to_host(t).clone()
        dist.all_reduce(w, op=getattr(dist.ReduceOp, op.upper()),
                        group=self.group)
        return w.to(self.device)

    def all_gather(self, t):
        w = to_host(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return torch.stack(parts).to(self.device)

    def all_to_all(self, t, send_splits, recv_splits, out=None):
        w = to_host(t)
        r = torch.empty((int(sum(recv_splits)),) + tuple(w.shape[1:]),
                        dtype=w.dtype)
        dist.all_to_all_single(r, w, list(recv_splits), list(send_splits),
                               group=self.group)
        if out is None:
            return r.to(self.device)
        out.copy_(r)
        return out

    return {"all_reduce": all_reduce, "all_gather": all_gather,
            "all_to_all": all_to_all}


def _direct_methods():
    import torch
    import torch.distributed as dist

    def all_reduce(self, t, op="sum"):
        w = t.contiguous().clone()
        dist.all_reduce(w, op=getattr(dist.ReduceOp, op.upper()),
                        group=self.group)
        return w

    def all_gather(self, t):
        w = t.contiguous()
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return torch.stack(parts)

    def all_to_all(self, t, send_splits, recv_splits, out=None):
        w = t.contiguous()
        r = out if out is not None else torch.empty(
            (int(sum(recv_splits)),) + tuple(w.shape[1:]), dtype=w.dtype,
            device=w.device)
        dist.all_to_all_single(r, w, list(recv_splits), list(send_splits),
                               group=self.group)
        return r

    return {"all_reduce": all_reduce, "all_gather": all_gather,
            "all_to_all": all_to_all}


VARIANTS = {"staged": _staged_methods, "direct": _direct_methods}


def variant_rank(variant, rank, size, coordinator, backend, device,
                 results) -> None:
    """One rank of chip_smoke.py's phase 10 with ``variant``'s collectives
    installed over ``EngineMesh``'s."""
    sys.path.insert(0, ROOT)
    from harkdb_tpu_torch.parallel.mesh import EngineMesh

    for name, fn in VARIANTS[variant]().items():
        setattr(EngineMesh, name, fn)
    S.mesh_rank(rank, size, coordinator, backend, device, results,
                audit=False)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--order", default="staged,direct,direct,staged")
    args = ap.parse_args()
    order = args.order.split(",")
    if not torch.cuda.is_available():
        print("torch_mesh_transport: no CUDA device available",
              file=sys.stderr)
        return 2
    from harkdb_tpu_torch.kernels import _lib

    _lib.build()
    print(S.card_line(), flush=True)
    oracles = S.mesh_oracles()
    digests, runs = None, []
    for variant in order:
        t0 = time.perf_counter()
        ranks = S.run_mesh(torch, "gloo", S.MESH_RANKS,
                           ["cuda:0"] * S.MESH_RANKS, timeout_s=600,
                           target=functools.partial(variant_rank, variant))
        seconds = time.perf_counter() - t0
        got = {name: [rep["cases"][name]["digest"] for rep in ranks]
               for name in ranks[0]["cases"]}
        if digests is None:
            digests = got
        for name, ds in got.items():
            if set(ds) != {digests[name][0]}:
                raise AssertionError(f"{variant} {name}: a rank's result "
                                     f"differs from the first run's")
        cases = ranks[0]["cases"]
        for name, entry in cases.items():
            res = entry["result"]
            if res.shape != oracles[name].shape or not np.array_equal(
                    res, oracles[name]):
                raise AssertionError(f"{variant} {name} differs from the "
                                     f"numpy oracle")
        run = {"variant": variant, "seconds": seconds,
               "query_ms": {n: e["ms"] for n, e in cases.items()},
               "all_ms": {n: e["all_ms"] for n, e in cases.items()},
               "profiled_wall_ms": {n: e["profile"]["wall_ms"]
                                    for n, e in cases.items()},
               "device_busy_ms": {n: e["profile"]["device_busy_ms"]
                                  for n, e in cases.items()},
               "host_self_ms": {n: e["profile"]["host_self_ms"][:6]
                                for n, e in cases.items()}}
        runs.append(run)
        print(f"{variant}: {seconds:.1f} s; warm medians (ms, "
              f"{S.MESH_NOTE}): "
              + ", ".join(f"{n} {ms:.3f}" for n, ms in
                          run["query_ms"].items()), flush=True)
    summary = {}
    for variant in dict.fromkeys(order):
        mine = [r["query_ms"] for r in runs if r["variant"] == variant]
        summary[variant] = {n: statistics.median(m[n] for m in mine)
                            for n in mine[0]}
    print(json.dumps({"note": S.MESH_NOTE, "order": order, "runs": runs,
                      "median_of_runs_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
