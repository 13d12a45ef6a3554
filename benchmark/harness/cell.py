"""One run of one cell: set-up, the measured window, the reference check.

``run_cell`` is the whole run but the look for a card and the printing:
``run.py`` calls it on the card, the tests call it on the CPU at a small
scale, with ``answer`` standing in for the program where a test breaks the
timed path or puts the reference in its place.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import check, registry
from harness.tables import data_bytes
from harness.traffic import Mix, Query
from reference.common import Ref

#: The gloo group that carries the loop's go / stop decision and the
#: memory peak between the ranks of a mesh (set by ``harness.launch``).
CONTROL_GROUP = None


@dataclass
class Result:
    query: Query
    seconds: float
    digest: Optional[str]
    error: Optional[str]
    metrics: object = None


def scaled_rows(cfg: dict, scale: float) -> Dict[str, int]:
    return {k: max(1, int(round(v * scale))) for k, v in cfg["rows"].items()}


@dataclass
class Run:
    """What a run measured; ``run.py`` turns it into the result line."""
    setup_s: float                 # the kernel build included
    build_s: float
    latencies: List[float]
    window_s: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    data_bytes: int
    checks: Dict[str, int]
    correct: bool
    per_layer: Dict[str, float]
    busy_s: Optional[float] = None
    traced_window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    diffs: Optional[List[str]] = None
    digests: Optional[List[Optional[str]]] = None
    errors: Optional[List[str]] = None       # the first failed queries'


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", scale: float = 1.0,
             mesh=None, answer: Optional[Callable] = None,
             check_answers: bool = True,
             say: Callable[[str], None] = lambda s: None) -> Run:
    """Set up the cell's tables and Context, warm up, run the closed loop
    for ``seconds``, and check a sample of its answers against the plain
    reference. ``cell``: a ``workloads`` entry of ``BENCHMARK.json`` (or
    one of the same form); ``t0``: the process's start on
    ``time.perf_counter``; ``answer(ctx, query, tables)``, when given,
    replaces ``ctx.sql(query.sql)``; ``check_answers=False`` leaves the
    reference to another rank."""
    bench = registry.benchmark_json()
    cfg = registry.config(cell["config"])
    mix = Mix(registry.mix_path(cell["traffic"]))
    if mix.schema != cfg["schema"]:
        raise ValueError(f"mix {cell['traffic']} is for {mix.schema}, the "
                         f"configuration {cfg['name']} for {cfg['schema']}")
    gen = registry.module("gen", cfg["generator"])
    ref_mod = registry.module("reference", cfg["reference"])
    import harkdb_tpu_torch as H

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    build_s = 0.0
    if on_card:
        from harkdb_tpu_torch.kernels import _lib

        _path, _log, build_s = _lib.build()
        _lib.library()
    t_gen = time.perf_counter()
    tables = gen.make_tables(scaled_rows(cfg, scale), seed, dev)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    n_data = data_bytes(tables)
    t_load = time.perf_counter()
    ctx = H.Context(device=dev if mesh is None else None, mesh=mesh)
    for name, cols in tables.items():
        ctx.create_table(name, cols)
    t_warm = time.perf_counter()
    sql = ((lambda c, q: answer(c, q, tables)) if answer
           else (lambda c, q: c.sql(q.sql)))
    warm = mix.queries(seed, stream=1)
    for _ in mix.names:                      # one pass: every template once
        sql(ctx, next(warm))
    # what set-up made stays: the collector need not walk it in the window
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_end = time.perf_counter()
    setup_s = t_end - t0
    say(f"set-up {setup_s:.1f} s (kernel build {build_s:.1f} s, tables "
        f"made {t_load - t_gen:.1f} s, loaded {t_warm - t_load:.1f} s, warm "
        f"pass {t_end - t_warm:.1f} s), {n_data / 1e9:.3f} GB of table data")

    results: List[Result] = []
    first: Dict[tuple, np.ndarray] = {}
    recorder = None
    prof_cm = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from harness.recorder import KernelRecorder

        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        recorder = KernelRecorder()
        prof_cm = profile(activities=acts)
    queries = mix.queries(seed, stream=0)
    go = _go_flag(mesh)
    with prof_cm as prof, (recorder or contextlib.nullcontext()):
        start = time.perf_counter()
        deadline = start + seconds
        end = start
        while go(time.perf_counter() < deadline):
            q = next(queries)
            rf = (torch.profiler.record_function(f"bench.query#{len(results)}")
                  if trace else contextlib.nullcontext())
            t_q = time.perf_counter()
            err = None
            out = None
            try:
                with rf:
                    out = sql(ctx, q)
            except Exception as e:          # a failed query is counted
                err = f"{type(e).__name__}: {e}"
            end = time.perf_counter()
            res = Result(q, end - t_q, None, err, ctx.last_metrics)
            if out is not None:
                res.digest = check.digest(out)
                first.setdefault((q.template, q.params), out)
            results.append(res)
    window_s = end - start
    gc.unfreeze()
    peak = _peak_bytes(mesh) if on_card else 0
    del ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    per_layer: Dict[str, float] = {}
    busy_s = traced_window_s = breakdown = None
    if trace:
        from harness.trace import reduce_events

        tr = reduce_events(prof.profiler.kineto_results.events(),
                           [r.query.template for r in results],
                           [r.metrics for r in results],
                           recorder.call_bytes())
        del prof
        for m in registry.per_layer(bench, cell["name"]):
            v = registry.metric_reader(m["name"]).read(tr)
            if v is not None:
                per_layer[m["name"]] = float(v)
        busy_s, traced_window_s = tr.busy_s(), tr.window_s()
        breakdown = {"device_ops": tr.top_device_ops(),
                     "idle_gaps": tr.idle_gaps()}

    numbers, diffs = {}, None
    t_check = time.perf_counter()
    if check_answers:
        keys = check.sample(results, mix.names, seed)
        R = Ref(tables)
        ref_mod.prepare(R)

        def reference(template: str, params: dict):
            return getattr(ref_mod, template.replace(".", "_"))(R, params)

        numbers = check.compare(results, mix.names, keys, reference)
        if numbers["wrong_answers"]:
            diffs = _diffs(results, keys, first, reference)
    say(f"reference check {time.perf_counter() - t_check:.1f} s")
    done = [r.seconds for r in results if r.error is None]
    return Run(setup_s=setup_s, build_s=build_s, latencies=done,
               window_s=window_s,
               attempted=len(results),
               failed=sum(r.error is not None for r in results),
               memory_peak_bytes=peak, data_bytes=n_data, checks=numbers,
               correct=bool(numbers) and check.verdict(numbers),
               per_layer=per_layer,
               busy_s=busy_s, traced_window_s=traced_window_s,
               breakdown=breakdown, diffs=diffs,
               digests=[r.digest for r in results],
               errors=[f"{r.query.template}: {r.error}" for r in results
                       if r.error is not None][:3])


def _diffs(results, keys, first, reference, n: int = 3) -> List[str]:
    """A few wrong answers beside the reference's, for the run's log."""
    out = []
    for key in sorted(keys, key=repr):
        got = first.get(key)
        if got is None:
            continue
        want = reference(key[0], dict(key[1]))
        if check.digest(got) == check.digest(want):
            continue
        out.append(f"{key[0]} {dict(key[1])}: got shape {got.shape} "
                   f"{np.asarray(got)[:3].tolist()}, reference shape "
                   f"{want.shape} {np.asarray(want)[:3].tolist()}")
        if len(out) >= n:
            break
    return out


def _go_flag(mesh):
    """On a mesh every rank runs the same queries: rank 0's clock decides
    whether the next one starts, and the others follow its decision."""
    if mesh is None or mesh.size <= 1:
        return lambda go: go
    import torch.distributed as dist

    flag = torch.zeros(1, dtype=torch.int32)

    def go(local: bool) -> bool:
        flag[0] = int(local)
        dist.broadcast(flag, src=0, group=CONTROL_GROUP)
        return bool(flag[0])

    return go


def _peak_bytes(mesh) -> int:
    peak = max(torch.cuda.max_memory_allocated(d)
               for d in range(torch.cuda.device_count()))
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        t = torch.tensor([peak], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=CONTROL_GROUP)
        peak = int(t[0])
    return peak
