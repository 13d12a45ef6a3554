"""The comparison that decides ``correct``.

After the window, a sample of the queries it completed is compared with
the plain reference: for every template, one parameter set drawn from the
seed among those the window ran, and the set of the slowest query. Every answer the window returned for a sampled set is
compared, whole, with the reference's answer for that set.

The numbers compared, each with its limit (an exact comparison):

* ``wrong_answers``: answers whose matrix differs from the reference's in
  shape or in any value (NaN equal to NaN), limit 0;
* ``failed_queries``: queries that raised, limit 0;
* ``templates_unchecked``: templates of the mix with no answer compared,
  limit 0.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List

import numpy as np

LIMITS = {"wrong_answers": 0, "failed_queries": 0, "templates_unchecked": 0}


def digest(a: np.ndarray) -> str:
    """Shape and values of a result matrix (float64 bits, so an int32 and a
    float64 matrix of equal values agree)."""
    a = np.asarray(a)
    v = np.ascontiguousarray(a.astype(np.float64))
    v[np.isnan(v)] = np.nan                  # one NaN bit pattern
    v += 0.0                                 # -0.0 and 0.0 alike
    h = hashlib.sha256(repr(a.shape).encode())
    h.update(v.tobytes())
    return h.hexdigest()


def sample(results, names: List[str], seed: int) -> set:
    """(template, params) keys to compare: per template, one of the
    parameter sets the window ran, drawn from ``seed``, and the slowest
    query's."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    keys = set()
    for name in names:
        sets = sorted({r.query.params for r in results
                       if r.query.template == name and r.error is None},
                      key=repr)
        if sets:
            keys.add((name, sets[int(rng.integers(len(sets)))]))
    done = [r for r in results if r.error is None]
    if done:
        slow = max(done, key=lambda r: r.seconds)
        keys.add((slow.query.template, slow.query.params))
    return keys


def compare(results, names: List[str], keys: set,
            reference: Callable[[str, dict], np.ndarray]) -> Dict[str, int]:
    """Run the reference once per sampled key (in threads: NumPy releases
    the interpreter lock in its loops) and count the numbers compared."""
    keys = sorted(keys, key=repr)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        want = dict(zip(keys, pool.map(
            lambda k: digest(reference(k[0], dict(k[1]))), keys)))
    wrong = 0
    checked = set()
    for r in results:
        key = (r.query.template, r.query.params)
        if r.error is not None or key not in want:
            continue
        checked.add(r.query.template)
        if r.digest != want[key]:
            wrong += 1
    return {
        "wrong_answers": wrong,
        "failed_queries": sum(r.error is not None for r in results),
        "templates_unchecked": len(set(names) - checked),
    }


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
