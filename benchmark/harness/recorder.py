"""Records each call of the four hand-written kernels' wrappers during a
traced window, so the kernel metrics can pair a call's bytes with its
device time.

The wrappers are imported into their callers by name (``ops/groupby``,
``ops/join``, ``prims/scan``, ``parallel/shuffle`` and others), so every
attribute of every loaded module under ``harkdb_tpu_torch`` that *is* one
of them is replaced, and put back afterwards. Each call runs inside a
``torch.profiler.record_function`` range named ``bench.kernel#<i>``; the
sizes it needs from the card are 0-d tensors the call made anyway, read
after the window.
"""

from __future__ import annotations

import inspect
import sys
from typing import List, Tuple

import torch

from harness import roofline

PACKAGE = "harkdb_tpu_torch"
PREFIX = "bench.kernel#"


def _originals() -> dict:
    from harkdb_tpu_torch.kernels import compact, expand, matmul_agg, segscan

    return {"flat_compact": compact.flat_compact,
            "flat_segscan": segscan.flat_segscan,
            "expand_fills": expand.expand_fills,
            "onehot_groupby_sums": matmul_agg.onehot_groupby_sums}


class KernelRecorder:
    def __init__(self):
        self.calls: List[Tuple[str, tuple]] = []
        self._patched: List[Tuple[object, str, object]] = []

    def _wrap(self, name: str, fn):
        sig = inspect.signature(fn)
        calls = self.calls

        def recorded(*args, **kwargs):
            idx = len(calls)
            with torch.profiler.record_function(f"{PREFIX}{idx}"):
                out = fn(*args, **kwargs)
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            calls.append((name, _sizes(name, a.arguments, out)))
            return out

        recorded.__wrapped__ = fn
        return recorded

    def __enter__(self):
        originals = _originals()
        by_id = {id(f): (n, f) for n, f in originals.items()}
        wrappers = {n: self._wrap(n, f) for n, f in originals.items()}
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or mod_name.split(".")[0] != PACKAGE:
                continue
            for attr, val in list(vars(mod).items()):
                hit = by_id.get(id(val))
                if hit is not None and hit[1] is val:
                    self._patched.append((mod, attr, val))
                    setattr(mod, attr, wrappers[hit[0]])
        return self

    def __exit__(self, *exc):
        for mod, attr, val in reversed(self._patched):
            setattr(mod, attr, val)
        self._patched.clear()
        return False

    def call_bytes(self) -> List[Tuple[str, int]]:
        """(wrapper name, bytes) of each call, by call index; reads the
        0-d tensors the calls kept."""
        return [(name, _bytes(name, s)) for name, s in self.calls]


def _sizes(name: str, a: dict, out) -> tuple:
    """What a call's byte count needs, without waiting for the card."""
    if name == "flat_compact":
        return (a["n_valid"], len(a["cols"]), out[1])
    if name == "flat_segscan":
        cols = list(a["cols"])
        return (cols[0].shape[0], len(cols), cols[0].element_size(),
                a["sid"] is not None)
    if name == "expand_fills":
        return (a["n_src"], int(a["out_capacity"]), len(a["extra_values"]))
    if name == "onehot_groupby_sums":
        return (a["key"].shape[0], len(a["value_cols"]),
                a["mask"] is not None, int(a["span"]))
    raise KeyError(name)


def _int(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def _bytes(name: str, s: tuple) -> int:
    if name == "flat_compact":
        return roofline.compact_bytes(_int(s[0]), s[1], _int(s[2]))
    if name == "flat_segscan":
        return roofline.segscan_bytes(*s)
    if name == "expand_fills":
        return roofline.expand_bytes(_int(s[0]), s[1], s[2])
    return roofline.dense_agg_bytes(*s)
