"""The traced run's reduction: ``torch.profiler`` (CPU and CUDA activities)
around the measured window, its events kept in memory and read once into
a :class:`Trace` that the per-layer metric readers take numbers from.

Every query of the window runs inside a ``record_function`` range named
``bench.query#<i>``, so device work and runtime calls can be counted per
query and named by the template that caused them. Device activity is the
kernels, copies and sets on the card; the ranges the benchmark opens are
left out of it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

QUERY = "bench.query#"
KERNEL = "bench.kernel#"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
NAME_CHARS = 160        # a device op's name in the breakdown, cut to this
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


@dataclass
class Span:
    name: str
    start: int          # ns, the profiler's clock
    end: int
    corr: int = 0


@dataclass
class Trace:
    """What the readers need from one traced window."""
    templates: List[str]                 # the template of each query
    query_metrics: List[object]          # Context.last_metrics per query
    device: List[Span] = field(default_factory=list)
    runtime: List[Span] = field(default_factory=list)
    host_ops: List[Span] = field(default_factory=list)
    queries: List[Span] = field(default_factory=list)
    kernel_calls: List[Span] = field(default_factory=list)
    call_bytes: List[Tuple[str, int]] = field(default_factory=list)
    window: Tuple[int, int] = (0, 0)

    @property
    def n_queries(self) -> int:
        return len(self.templates)

    # -- sums the readers share -----------------------------------------------
    def device_ms(self, match) -> float:
        """Device ms of the activity whose name ``match`` accepts."""
        return sum(s.end - s.start for s in self.device
                   if match(s.name)) / 1e6

    def device_ms_per_query(self, match) -> Optional[float]:
        if not self.n_queries:
            return None
        return self.device_ms(match) / self.n_queries

    def runtime_count(self, names) -> int:
        return sum(1 for s in self.runtime if s.name in names)

    def busy_intervals(self) -> np.ndarray:
        """The union of device activity inside the window, as sorted
        disjoint [start, end) rows."""
        lo, hi = self.window
        iv = sorted((max(s.start, lo), min(s.end, hi)) for s in self.device
                    if s.end > lo and s.start < hi)
        out: List[List[int]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.asarray(out, np.int64).reshape(-1, 2)

    def busy_s(self) -> float:
        b = self.busy_intervals()
        return float((b[:, 1] - b[:, 0]).sum()) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    # -- breakdown --------------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, int] = defaultdict(int)
        for s in self.device:
            tot[s.name[:NAME_CHARS]] += s.end - s.start
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, t / 1e9] for name, t in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time inside the window, summed by what the
        host was doing in the middle of each gap: the query's template and
        the innermost host operation or runtime call open then."""
        b = self.busy_intervals()
        lo, hi = self.window
        starts = np.concatenate([[lo], b[:, 1]])
        ends = np.concatenate([b[:, 0], [hi]])
        keep = ends > starts
        gaps = list(zip(starts[keep].tolist(), ends[keep].tolist()))
        host = sorted(self.host_ops + self.runtime,
                      key=lambda s: (s.start, -(s.end - s.start)))
        by_end = sorted(host, key=lambda s: s.end)
        ends = [s.end for s in by_end]
        q_starts = [q.start for q in self.queries]
        tot: Dict[str, int] = defaultdict(int)
        stack: List[Span] = []
        i = 0
        for a, e in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
            mid = (a + e) // 2
            while i < len(host) and host[i].start <= mid:
                while stack and stack[-1].end < host[i].start:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1].end < mid:
                stack.pop()
            if stack:
                what = stack[-1].name
            else:
                # Python between two calls: name the call it follows
                j = bisect.bisect_right(ends, mid) - 1
                what = f"after {by_end[j].name}" if j >= 0 else "idle"
            qi = bisect.bisect_right(q_starts, mid) - 1
            q = self.queries[qi] if qi >= 0 else None
            tmpl = (self.templates[qi] if q is not None and q.end >= mid
                    else "between queries")
            tot[f"{tmpl}: {what}"[:NAME_CHARS]] += e - a
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, t / 1e9] for name, t in top]


def reduce_events(events, templates, query_metrics, call_bytes) -> Trace:
    """A :class:`Trace` from the profiler's kineto events."""
    from torch.autograd import DeviceType

    t = Trace(templates=list(templates), query_metrics=list(query_metrics),
              call_bytes=list(call_bytes))
    annotations = set()
    cuda_events = []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            cuda_events.append((name, start, end, ev.correlation_id()))
            continue
        span = Span(name, start, end, ev.correlation_id())
        if name.startswith(QUERY):
            t.queries.append(span)
            annotations.add(name)
        elif name.startswith(KERNEL):
            t.kernel_calls.append(span)
            annotations.add(name)
        elif name.startswith(("cuda", "cu")) and not name.startswith("cuda::"):
            t.runtime.append(span)
        else:
            if ev.is_user_annotation():
                annotations.add(name)
            t.host_ops.append(span)
    t.device = [Span(n, s, e, c) for n, s, e, c in cuda_events
                if n not in annotations and not n.startswith("bench.")]
    t.queries.sort(key=lambda s: int(s.name[len(QUERY):]))
    if len(t.queries) != len(t.templates):
        raise RuntimeError(f"the trace holds {len(t.queries)} query ranges "
                           f"for {len(t.templates)} queries")
    t.kernel_calls.sort(key=lambda s: int(s.name[len(KERNEL):]))
    if t.queries:
        t.window = (t.queries[0].start, t.queries[-1].end)
    return t


def kernel_call_times(t: Trace, kernel_names: Dict[str, tuple]
                      ) -> Dict[int, Tuple[str, int]]:
    """Device ns of each recorded kernel-wrapper call: every device kernel
    whose name belongs to a wrapper is traced to the runtime launch with
    its correlation id, and that launch to the ``bench.kernel#<i>`` range
    around it. A kernel that no recorded call launched raises."""
    launches = {s.corr: s for s in t.runtime if s.name in LAUNCH_CALLS}
    starts = [c.start for c in t.kernel_calls]
    out: Dict[int, Tuple[str, int]] = {}
    for d in t.device:
        owner = next((w for w, subs in kernel_names.items()
                      if any(sub in d.name for sub in subs)), None)
        if owner is None:
            continue
        launch = launches.get(d.corr)
        call = None
        if launch is not None:
            i = bisect.bisect_right(starts, launch.start) - 1
            # ranges nest only by recursion, which the wrappers do not do
            if i >= 0 and t.kernel_calls[i].end >= launch.end:
                call = int(t.kernel_calls[i].name[len(KERNEL):])
        if call is None:
            raise RuntimeError(
                f"device kernel {d.name!r} ran outside every recorded "
                f"{owner} call: a launch site the recorder does not cover")
        name, ns = out.get(call, (owner, 0))
        out[call] = (name, ns + d.end - d.start)
    return out
