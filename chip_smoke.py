#!/usr/bin/env python3
"""On-card smoke test of harkdb_tpu_torch, the PyTorch + CUDA port.

Run from the root of a checkout, on a machine with one NVIDIA card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, each printing its results on lines of its own:

  1. require a CUDA device; print the card (nvidia-smi name and power
     limit) and the torch / CUDA versions;
  2. build the kernels from ``harkdb_tpu_torch/csrc`` with nvcc for sm_90a
     (one nvcc per source, all started together) and print the build time
     and ``-Xptxas -v`` report;
  3. hold each kernel against its plain PyTorch version on the card, on
     edge cases (lengths around the 4096-row tiles, tiles wholly past
     n_valid, 41 columns for kernel A, 8 and 9 for kernel B, kernel B's
     one-segment and reversed forms), where a decoupled look-back can go
     wrong (one segment over 2048 tiles in both directions, all and no
     rows kept, 2^26 rows, 50 repeats at 2^24 rows) and at the main paths'
     shapes (kernel A: 16,777,216 rows x 2 int32 columns; kernel B: the
     group-by's 8,388,608-row max scan, the window query's running sum
     under the same ids and its running max / reversed min over one
     segment; kernel D: the star join's 8.4M unit segments into 2^23 slots
     and Q3's segments of about 4; kernel C: 2^23 rows at span 4096, span
     16384 with three sum columns, and span 1), all bit-exact;
  4. run the main query through ``Context(device="cuda").sql`` on a
     2^24-row table and check it row for row against an independent numpy
     oracle, with every kernel launch counted;
  5. the same at 100,000,000 rows with a HAVING clause;
  6. the star join (2^24 facts joined to 2^20 dims, dense GROUP BY over
     span 4096) and TPC-H Q3's shape at scale factor 1 row counts (a 3-way
     join, then a sort-path GROUP BY and a top 10), each against a numpy
     oracle with its kernel launches counted;
  7. nested queries: TPC-H Q1 (a sort-path GROUP BY over ten keys with
     AVG and a sum of a product), Q4 (EXISTS), Q5 (a CTE), Q13 (a derived
     table over a LEFT JOIN) and Q17 (a correlated scalar subquery) at SF 1
     row counts, a window query (row_number, rank and a running sum over about
     1M partitions) and an INTERSECT on the 2^24-row table, each against a
     numpy oracle with its kernel launches counted, then timed warm; the
     window query is profiled;
  8. time phases 4-6 end to end (warm-up, then the median of 5), break the
     main query, the star join and Q3 down by device kernel with
     torch.profiler, time each kernel against its plain version, its
     bound (the bytes its work must move at 3.35 TB/s) and, where one
     PyTorch call computes the same function or its core, that call
     (kernel A: ``x2[:, mask]``; kernel B over one segment:
     ``torch.cummax``; kernel D: ``torch.searchsorted`` for the seg ids
     alone; kernel C: ``index_add_`` of one sum column over keys already
     rebased, no mask) with CUDA events, and time kernel C against the
     sort path's group-by at spans 1024, 4096 and 16384 on 2^24 rows;
     phases 4 and 6 also run the main query, the star join and Q3 under
     ``EngineConfig(debug_checks=True)``: the same rows, timed beside the
     default config;
  9. write phase 4's table as a CSV into ``harkdb_tpu_torch/build/``, load
     it onto the card with ``create_table`` (the native loader; host time
     and rows/s logged), check the main query on it against the oracle and
     the dict-loaded table, then run the CLI in-process with ``--profile``
     (its trace must name kernels A and B) and ``--explain``;
 10. the mesh: spawn 4 ranks sharing ``cuda:0`` over gloo
     (``parallel/multihost.init_multihost``) and run in every rank, at full
     width, the main query on 2^24 rows, the star join, TPC-H Q3 at SF 1, a
     star join whose facts have 90% of their rows on one key (salted), a
     ``median`` + ``count(distinct)`` GROUP BY, an ORDER BY ... LIMIT
     under ``dist_tail`` True and False, windows on 2^24 rows (the
     partitioned window query, a global running window with lag on the
     carry path, a global ROWS frame on the rank-0 route, a window over
     grouped output), set operations (UNION ALL under ORDER BY and UNION
     on the sharded tail, the INTERSECT on the gather path), the star
     join as a CTE's body (kernel C inside it) and TPC-H Q5 (a CTE) and
     Q13 (a derived table) at SF 1; every rank's whole result
     must equal the numpy oracle and the single-device port's bit for
     bit, each case must launch the kernels it needs on every rank, and
     kernels A, B, C and D must launch on every rank. Each query is timed
     warm (median of 5; 4 ranks share one card: not a scaling figure). With
     more than one card the same runs on NCCL, one rank per card; else one
     line says it was skipped. The exchange's stable partition is timed
     as four launches of kernel A (the port's form) against a sort;
 11. the public primitives (``harkdb_tpu_torch.prims``) at 2^24 rows:
     ``segmented_scan`` and ``segmented_reduce`` with add, max, min and
     mul over int32 and float32 in seeded segments of 1-64 rows,
     ``expand``, ``expand_reduce`` and ``expand_outer_reduce`` over 2^20
     sizes (about 2^24 outputs) gathering from two planes, ``compact`` at
     50% and 1%: each equal to the same call on the CPU (the plain
     versions), each raising the counts of its kernels (A, B or D), no
     plain version run on the card, each timed; then the top-k LIMIT path
     on bench-2^24's table and on a float32 table with NaN of both signs,
     ±0.0 and ±inf: five queries at their LIMIT (one top-k selection
     each, counted by a spy) and at 1025 (the sort, none), each against
     a numpy oracle (and the JAX package's written-down rows for the NaN
     table), timed warm (median of 5) and profiled (device-busy share);
 12. the public ``ops`` and ``kernels`` entry points at full width on
     bench-2^24's facts and star-join-2^24's dims (the last 2^16 dims rows
     past n_valid), on batches and a ``Table`` built with no device
     argument (the entry points' default, the card): the entry step
     (``__graft_entry__.entry()``'s ``query_step`` through
     ``prims.compact_batch`` and ``ops.groupby_batch``), ``join_match_count``,
     ``join_indices`` and ``join_batches`` (inner and LEFT) and
     ``inner_join_indices`` between facts ``k`` and dims ``j``,
     ``onehot_groupby_sums`` at span 4096 over the joined ``g`` with and
     without a mask, ``matmul_agg_applicable`` at the gate's edges, and
     ``sort_permutation`` / ``sort_batch`` on ``(k, v)``: each equal to the
     same call on the CPU (the plain versions) and to a numpy oracle, bit
     for bit, each raising the counts of the kernels it needs, no plain
     version run on the card, each timed (CUDA events, median of 5) and
     the entry step profiled (device-busy share);
 13. the radix pair sort under the sorted operators (``ops/sort.py``,
     ``csrc/radix_sort.cu``): ``sort_pairs`` on one 32-bit and one 40-bit
     word and ``lexsort_permutation`` over two words, at 0, 1, 4095, 4097,
     2^20 + 3 and 2^25 rows, each equal to its plain twin on the CPU bit
     for bit; then each at 120,000,000 rows timed by CUDA events beside
     its bound (histogram read plus digit passes of key and value, read
     and written, at 3.35 TB/s) and ``torch.sort`` over the same words
     widened to int64 (the port's sort before), whose order it equals;
 14. the join's count phase around the pair sort (``kernels/join_runs.py``,
     ``csrc/join_runs.cu``): the words kernel and the runs kernel against
     their plain versions on the CPU, bit for bit (``total_approx`` within
     1e-5 relative), at lengths around the 2048-row tiles, runs over many
     tiles, one run over the whole array (a 65536² CROSS JOIN, whose totals
     wrap to 0), NULL codes and 120,000,000 + 2,557 rows; then each kernel
     at SSB SF 20's lineorder against date (120,000,000 + 2,557 rows) and
     TPC-H SF 10's lineitem against orders (60,000,000 + 15,000,000), timed
     by CUDA events beside its bound (each byte its work needs read once
     and written once, at 3.35 TB/s) and its plain version on the card,
     and the whole count phase (``compute_join_ranges``) timed.

Then it prints one JSON line describing the kernels, the card line again,
and as its last line ``{"ok": true, "device": {...}}``. Any failure raises
and the script exits non-zero without that line; so does a machine with no
CUDA device, and a directory holding this script without the package.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_QUERY = ("select k, sum(v) as s, max(v) as m, count(*) as c from t "
              "where v > 0 group by k order by s desc")
HAVING_QUERY = ("select k, sum(v) as s, max(v) as m, count(*) as c from t "
                "where v > 0 group by k having count(*) >= 48 "
                "order by s desc")
STAR_QUERY = ("select g, sum(v) as s, count(*) as c from facts join dims "
              "on facts.k = dims.j where v > 0 group by g order by g")
Q3_QUERY = (
    "select orders.orderkey, sum(lineitem.price * lineitem.qty) as rev "
    "from customer join orders on customer.custkey = orders.custkey "
    "join lineitem on orders.orderkey = lineitem.orderkey "
    "where customer.nation < 10 and orders.odate < 180 "
    "group by orders.orderkey order by rev desc, orders.orderkey "
    "limit 10"
)
# TPC-H Q1, Q4, Q5, Q13 and Q17's shapes, verbatim from
# tests/test_tpch_mini.py.
Q1_QUERY = (
    "select discount, sum(qty) as sq, sum(price * qty) as sp, "
    "avg(price) as ap, count(*) as n from lineitem "
    "where ship <= 300 group by discount order by discount"
)
Q4_QUERY = (
    "select prio, count(*) as n from orders "
    "where exists (select 1 from lineitem "
    "where lineitem.orderkey = orders.orderkey and lineitem.qty > 40) "
    "group by prio order by prio"
)
Q5_QUERY = (
    "with rev as (select orders.custkey as ck, "
    "sum(lineitem.price * lineitem.qty) as r from orders "
    "join lineitem on orders.orderkey = lineitem.orderkey "
    "group by orders.custkey) "
    "select customer.nation, sum(rev.r) as vol from customer "
    "join rev on customer.custkey = rev.ck "
    "group by customer.nation having sum(rev.r) > 0 "
    "order by vol desc, customer.nation limit 8"
)
Q13_QUERY = (
    "select cnt, count(*) as custs from "
    "(select customer.custkey as k, count(orders.orderkey) as cnt "
    "from customer left join orders "
    "on customer.custkey = orders.custkey group by customer.custkey) d "
    "group by cnt order by custs desc, cnt limit 10"
)
Q17_QUERY = (
    "select sum(price) as total from lineitem l "
    "where l.qty < (select avg(l2.qty) from lineitem l2 "
    "where l2.partkey = l.partkey)"
)
WINDOW_QUERY = (
    "select k, v, row_number() over (partition by k order by v) as rn, "
    "rank() over (partition by k order by v) as rk, "
    "sum(v) over (partition by k order by v) as rs from t where v > 0"
)
SETOP_QUERY = ("select k from t where v > 900 intersect "
               "select k from t where v < -900 order by k")
N_MAIN = 1 << 24
N_LARGE = 100_000_000
N_KEYS = 1 << 20
DIM_SPAN = 4096               # dims.g in [0, 4096): the dense GROUP BY span
# TPC-H row counts at scale factor 1.
N_LINEITEM, N_ORDERS, N_CUSTOMER = 6_001_215, 1_500_000, 150_000
# Float add combines in another order on the kernel than in the plain
# doubling scan; both are within float32 rounding of the exact sum, so the
# difference is bounded relative to the scan of |x| over the segment.
FLOAT_ADD_RTOL = 1e-4
# Device-memory rate of an H100 SXM (HBM3, NVIDIA's data sheet): a
# kernel's bound is the bytes its work must move over this rate.
HBM_BYTES_PER_MS = 3.35e12 / 1e3
# About 10 ms of device sleep (at up to 1.98 GHz) ahead of a timed run:
# longer than the host needs to queue 20 wrapper calls.
SLEEP_CYCLES = 20_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def table_data(n: int):
    """The JAX package bench's table: k in [0, 2^20), v in [-1000, 1000),
    int32, from np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, N_KEYS, n).astype(np.int32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    return k, v


def oracle(k: np.ndarray, v: np.ndarray, min_count: int = 0) -> np.ndarray:
    """The main query in numpy: stable argsort + reduceat, written apart
    from the engine. Rows: (k, sum(v), max(v), count), s desc, ties by k."""
    keep = v > 0
    ks, vs = k[keep], v[keep]
    order = np.argsort(ks, kind="stable")
    ks, vs = ks[order], vs[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    keys = ks[starts]
    sums = np.add.reduceat(vs.astype(np.int64), starts)
    sums = sums.astype(np.uint32).astype(np.int32)        # int32 wrap
    maxs = np.maximum.reduceat(vs, starts)
    counts = np.diff(np.r_[starts, ks.shape[0]])
    rows = np.stack([keys, sums, maxs, counts], axis=1).astype(np.int32)
    rows = rows[counts >= min_count]
    return rows[np.argsort(-rows[:, 1].astype(np.int64), kind="stable")]


def ptxas_summary(build_log: str):
    """One line per compiled kernel: its name with its template arguments
    (segscan: op code 0 add / 1 max / 2 min / 3 mul, i int32 / f float32,
    columns held; compact: 1 for the look-back launch) and what
    ``-Xptxas -v`` reported for registers, shared memory and spills."""
    name, spills = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d([a-z][a-z_]*_kernel)(I[^v]*)?", m.group(1))
            args = re.findall(r"L[ib](\d+)E|([if])(?=L|E)",
                              k.group(2) or "") if k else []
            name = (k.group(1) + (f"<{','.join(a or b for a, b in args)}>"
                                  if args else "")) if k else m.group(1)
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spills}"
            name = None


# -- phase 3: kernels against their plain versions ---------------------------

def check_compact(compact, torch, dev, rng, n, sel, nv, ncols, floats):
    cols = {}
    for c in range(ncols):
        if floats and c % 2:
            x = rng.standard_normal(n).astype(np.float32)
            x[rng.random(n) < 0.05] = np.nan
            x[rng.random(n) < 0.05] = -0.0
        else:
            x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
            x = x.astype(np.int32)
        cols[f"c{c}"] = torch.from_numpy(x).to(dev)
    mask = torch.from_numpy(rng.random(n) < sel).to(dev)
    n_valid = torch.full((), nv, dtype=torch.int32, device=dev)
    got, cnt = compact.flat_compact(cols, mask, n_valid)
    ref, rcnt = compact.flat_compact_reference(cols, mask, n_valid)
    torch.cuda.synchronize()
    c = int(rcnt)
    if int(cnt) != c:
        raise AssertionError(f"compact count {int(cnt)} != {c} "
                             f"(n={n}, sel={sel}, n_valid={nv})")
    for name in cols:
        a = got[name][:c].view(torch.int32)      # bit patterns: NaN, -0.0
        b = ref[name][:c].view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"compact column {name} differs "
                                 f"(n={n}, sel={sel}, n_valid={nv})")


def scan_neutral(op, dtype):
    ne = {"add": 0, "mul": 1}.get(op)
    if ne is not None:
        return ne
    if dtype == "int32":
        return -2**31 if op == "max" else 2**31 - 1
    info = np.finfo(np.float32)
    return float(info.min) if op == "max" else float(info.max)


def check_segscan(segscan, torch, dev, rng, op, dtype, sid_np, ncols=1,
                  nan=False, n=None, reverse=False):
    """Kernel B against its plain version; ``sid_np=None`` is the
    one-segment form (then ``n`` gives the length)."""
    n = sid_np.shape[0] if sid_np is not None else n
    cols = []
    for _ in range(ncols):
        if dtype == "int32":
            lo, hi = (-9, 9) if op == "mul" else (-2**31, 2**31 - 1)
            x = rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)
        elif op == "mul":
            x = rng.uniform(0.5, 1.5, n).astype(np.float32)
        else:
            x = rng.standard_normal(n).astype(np.float32)
            if nan:
                x[rng.random(n) < 0.01] = np.nan
        cols.append(torch.from_numpy(x).to(dev))
    sid = None if sid_np is None else torch.from_numpy(sid_np).to(dev)
    ne = scan_neutral(op, dtype)
    got = segscan.flat_segscan(op, sid, cols, ne, reverse=reverse)
    ref = segscan.flat_segscan_reference(op, sid, cols, ne, reverse=reverse)
    torch.cuda.synchronize()
    for g, r, x in zip(got, ref, cols):
        if dtype == "int32":
            same = g == r
        elif op in ("max", "min"):
            same = (g == r) | (torch.isnan(g) & torch.isnan(r))
        else:
            bound = (r.abs() if op == "mul" else
                     segscan.flat_segscan_reference(
                         "add", sid, [x.abs()], 0.0, reverse=reverse)[0])
            diff = torch.where(g == r, torch.zeros_like(g), (g - r).abs())
            same = (diff <= FLOAT_ADD_RTOL * bound + 1e-6) | (
                torch.isnan(g) & torch.isnan(r))
        if not bool(same.all()):
            raise AssertionError(f"segscan {op}/{dtype} differs from its "
                                 f"plain version (n={n}, {ncols} columns, "
                                 f"sid {'none' if sid is None else 'given'}, "
                                 f"reverse={reverse})")


# Lengths around the kernels' 4096-row tiles and the Pallas kernels' 16384.
EDGE_LENGTHS = (1, 1000, 4095, 4096, 4097, 16384, 16385, 40000)


def phase_kernels(torch, compact, segscan, dev):
    rng = np.random.default_rng(1)
    cases = 0
    for n in EDGE_LENGTHS:
        for sel in (0.0, 0.5, 1.0):
            for nv in sorted({n, max(0, n - 7), n // 2}):
                check_compact(compact, torch, dev, rng, n, sel, nv, 3, True)
                cases += 1
    # Tiles wholly past n_valid still publish their status.
    for nv in (0, 1, 4096 + 5):
        check_compact(compact, torch, dev, rng, 10 * 4096 + 3, 0.5, nv, 2,
                      False)
        cases += 1
    # 41 columns: a second column group reuses the first one's offsets.
    check_compact(compact, torch, dev, rng, 40000, 0.5, 39000, 41, False)
    cases += 1
    log(f"kernel A edge cases: {cases} passed (bit-exact live rows)")

    cases = 0
    for n in EDGE_LENGTHS:
        sid_sorted = np.sort(rng.integers(0, max(1, n // 50), n)).astype(
            np.int32)
        layouts = {
            "many": (sid_sorted, False),
            "many, reversed": (sid_sorted[::-1].copy(), True),
            "one": (np.zeros(n, np.int32), False),     # spans every tile
            "none": (np.full(n, -1, np.int32), False),  # no live row
        }
        for name, (sid, rev) in layouts.items():
            for op in ("add", "max", "min", "mul"):
                for dtype in ("int32", "float32"):
                    check_segscan(segscan, torch, dev, rng, op, dtype, sid,
                                  ncols=2, nan=name.startswith("many"),
                                  reverse=rev)
                    cases += 1
        for rev in (False, True):                       # sid=None
            for op in ("add", "max", "min", "mul"):
                for dtype in ("int32", "float32"):
                    check_segscan(segscan, torch, dev, rng, op, dtype, None,
                                  n=n, reverse=rev)
                    cases += 1
    # 8 columns share one launch; 9 take two.
    for ncols in (8, 9):
        for dtype in ("int32", "float32"):
            check_segscan(segscan, torch, dev, rng, "max", dtype,
                          np.sort(rng.integers(0, 300, 40000)).astype(
                              np.int32), ncols=ncols, nan=True)
            cases += 1
    log(f"kernel B edge cases: {cases} passed (integers and float "
        f"max/min exact; float add within {FLOAT_ADD_RTOL} of the |x| "
        f"scan, float mul within {FLOAT_ADD_RTOL} relative)")


def _random_words(torch, dev, gen, n):
    return torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                         device=dev, generator=gen)


def _check_compact_pair(torch, compact, cols, mask, nv, what):
    got, cnt = compact.flat_compact(cols, mask, nv)
    ref, rcnt = compact.flat_compact_reference(cols, mask, nv)
    c = int(rcnt)
    if int(cnt) != c or not all(torch.equal(got[k][:c], ref[k][:c])
                                for k in cols):
        raise AssertionError(f"kernel A differs from its plain version "
                             f"({what})")
    return ref, c


def phase_lookback(torch, compact, segscan, dev):
    """Kernels A and B where a decoupled look-back can go wrong: one
    segment over 2048 tiles (the longest wait chain) in both directions,
    all and no rows kept, 2^26 rows (the having-10^8 shrink), and 50
    repeats of the 2^24-row cases, each compared with the plain version
    (a race shows as a rare mismatch). Data is made on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n = 1 << 23
    x = _random_words(torch, dev, gen, n)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    for op in ("max", "min", "add"):
        ne = scan_neutral(op, "int32")
        for sid in (None, zeros):
            for rev in (False, True):
                got = segscan.flat_segscan(op, sid, [x], ne, reverse=rev)[0]
                ref = segscan.flat_segscan_reference(op, sid, [x], ne,
                                                     reverse=rev)[0]
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"kernel B differs over one segment of {n:,} rows "
                        f"({op}, sid {'none' if sid is None else 'zeros'}, "
                        f"reverse={rev})")
    del x, zeros

    n = 1 << 24
    cols = {"a": _random_words(torch, dev, gen, n),
            "b": _random_words(torch, dev, gen, n)}
    for fill in (True, False):
        mask = torch.full((n,), fill, dtype=torch.bool, device=dev)
        for nv in (n, n - 3 * 4096 - 5):
            nvt = torch.full((), nv, dtype=torch.int32, device=dev)
            _check_compact_pair(torch, compact, cols, mask, nvt,
                                f"{n:,} rows, all {'kept' if fill else 'dropped'}"
                                f", n_valid {nv:,}")
    mask = torch.rand(n, device=dev, generator=gen) < 0.5
    nvt = torch.full((), n, dtype=torch.int32, device=dev)
    ref, c = _check_compact_pair(torch, compact, cols, mask, nvt,
                                 f"{n:,} rows")
    for _ in range(50):
        got, cnt = compact.flat_compact(cols, mask, nvt)
        if int(cnt) != c or not all(torch.equal(got[k][:c], ref[k][:c])
                                    for k in cols):
            raise AssertionError(f"kernel A differs on a repeat at {n:,} "
                                 f"rows")
    sid = torch.sort(torch.randint(0, n // 8, (n,), dtype=torch.int32,
                                   device=dev, generator=gen)).values
    vals = cols["a"]
    for s in (sid, None):
        ref = segscan.flat_segscan_reference("max", s, [vals], -2**31)[0]
        for _ in range(50):
            got = segscan.flat_segscan("max", s, [vals], -2**31)[0]
            if not torch.equal(got, ref):
                raise AssertionError(f"kernel B differs on a repeat at "
                                     f"{n:,} rows")
    del cols, mask, sid, vals, ref, got

    n = 1 << 26
    cols = {"a": _random_words(torch, dev, gen, n),
            "b": _random_words(torch, dev, gen, n)}
    mask = torch.rand(n, device=dev, generator=gen) < 0.5
    nvt = torch.full((), n - 12345, dtype=torch.int32, device=dev)
    _check_compact_pair(torch, compact, cols, mask, nvt, f"{n:,} rows")
    sid = torch.sort(torch.randint(0, n // 8, (n,), dtype=torch.int32,
                                   device=dev, generator=gen)).values
    got = segscan.flat_segscan("max", sid, [cols["a"]], -2**31)[0]
    ref = segscan.flat_segscan_reference("max", sid, [cols["a"]], -2**31)[0]
    if not torch.equal(got, ref):
        raise AssertionError(f"kernel B differs at {n:,} rows")
    del cols, mask, sid, got, ref
    torch.cuda.empty_cache()
    log("look-back cases: one segment over 2048 tiles (max/min/add, no sid "
        "and zeros, both directions), all/none kept at 2^24 rows, 2^26 rows "
        "(A and B), 50 repeats of A, B and one-segment B at 2^24 rows: "
        "bit-exact")


def check_main_compact(torch, compact, k, v, mask, n_valid) -> int:
    cols = {"k": k, "v": v}
    got, cnt = compact.flat_compact(cols, mask, n_valid)
    ref, rcnt = compact.flat_compact_reference(cols, mask, n_valid)
    torch.cuda.synchronize()
    c = int(rcnt)
    if int(cnt) != c:
        raise AssertionError("kernel A count differs at the main shape")
    err = 0
    for name in cols:
        err = max(err, int((got[name][:c] - ref[name][:c]).abs().max()))
    if err:
        raise AssertionError("kernel A differs at the main path's shape")
    return err


def main_shapes(torch, dev):
    """Kernel inputs at the main path's shapes, built on the card the way
    the query builds them."""
    k_np, v_np = table_data(N_MAIN)
    k = torch.from_numpy(k_np).to(dev)
    v = torch.from_numpy(v_np).to(dev)
    mask = v > 0
    ks, vs = k[mask], v[mask]
    cap = 1 << 23                      # the shrunk capacity of the group-by
    if ks.shape[0] > cap:
        raise AssertionError("filtered rows exceed the 2^23 capacity")
    order = torch.sort(ks, stable=True).indices
    ks, vs = ks[order], vs[order]
    start = torch.ones_like(ks, dtype=torch.bool)
    start[1:] = ks[1:] != ks[:-1]
    sid = torch.cumsum(start, 0, dtype=torch.int32) - 1
    pad = cap - sid.shape[0]
    sid = torch.cat([sid, sid[-1:].expand(pad)])       # padding extends
    vals = torch.cat([vs, torch.zeros(pad, dtype=vs.dtype, device=dev)])
    return (k, v, mask), (sid.contiguous(), vals)


# -- phase 3, kernels C and D ------------------------------------------------

def check_expand(torch, expand, dev, offsets, n_src, out_cap, extras) -> int:
    """Kernel D against its plain version on every slot (both give the
    same values past the live region too); returns the max abs error."""
    offs = torch.from_numpy(np.ascontiguousarray(offsets, np.int32)).to(dev)
    ex = [torch.from_numpy(np.ascontiguousarray(e, np.int32)).to(dev)
          for e in extras]
    nv = torch.full((), n_src, dtype=torch.int32, device=dev)
    got = expand.expand_fills(offs, nv, out_cap, ex)
    ref = expand.expand_fills_reference(offs, nv, out_cap, ex)
    torch.cuda.synchronize()
    err = 0
    for g, r in zip([got[0], got[1], *got[2]], [ref[0], ref[1], *ref[2]]):
        if g.shape != r.shape or g.dtype != torch.int32:
            raise AssertionError("expand output shape or dtype differs")
        err = max(err, int((g.to(torch.int64) - r.to(torch.int64))
                           .abs().max()))
    if err:
        raise AssertionError(f"kernel D differs from its plain version "
                             f"(n_src={n_src}, out_capacity={out_cap})")
    return err


def check_dense(torch, agg, dev, key, cols, n_valid, key_min, span,
                mask=None, plan=None, skew=0) -> int:
    """Kernel C against its plain version; returns the max abs error.
    ``plan`` forces a histogram shape (matmul_agg.dense_agg_plan's tuple);
    ``skew`` > 0 passes views that start ``skew`` words into their
    buffers, so the kernel takes its scalar loads."""
    def dev_t(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        if skew:
            t = torch.cat([torch.zeros(skew, dtype=t.dtype), t])
        return t.to(dev)[skew:]

    k = dev_t(key, np.int32)
    vs = [dev_t(c, np.int32) for c in cols]
    m = None if mask is None else dev_t(mask, np.bool_)
    nv = torch.full((), n_valid, dtype=torch.int32, device=dev)
    if plan is None:
        got = agg.onehot_groupby_sums(k, vs, nv, key_min, span, mask=m)
    else:
        got = agg._launch(k, vs, nv, key_min, span, m, plan)
    ref = agg.onehot_groupby_sums_reference(k, vs, nv, key_min, span, mask=m)
    torch.cuda.synchronize()
    err = 0
    for g, r in zip([got[0], *got[1], got[2]], [ref[0], *ref[1], ref[2]]):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError("dense aggregation shape or dtype differs")
        err = max(err, int((g.to(torch.int64) - r.to(torch.int64))
                           .abs().max()))
    if err:
        raise AssertionError(f"kernel C differs from its plain version "
                             f"(n={key.shape[0]}, span={span}, "
                             f"{len(cols)} sum columns, plan {plan}, "
                             f"skew {skew})")
    return err


def _segments(sizes: np.ndarray):
    offsets = (np.cumsum(sizes) - sizes).astype(np.int32)
    return offsets, (offsets + sizes).astype(np.int32)


def _planes(rng, offsets, n_planes):
    """``n_planes`` non-decreasing, non-negative planes over the segments."""
    return [np.cumsum(rng.integers(0, 5, offsets.shape[0])).astype(np.int32)
            for _ in range(n_planes)]


# Histogram shapes every kernel C edge case runs under (matmul_agg's shape
# names): (a) replicated in clusters of 1-8 CTAs, (b) the keys split over
# 2-8 CTAs, (c) the columns split over a pair. The wrapper's own pick runs
# too.
C_PLANS = (("REPLICATED", 1), ("REPLICATED", 2), ("REPLICATED", 4),
           ("REPLICATED", 8), ("SPLIT_KEYS", 2), ("SPLIT_KEYS", 4),
           ("SPLIT_KEYS", 8), ("SPLIT_COLUMNS", 2))


def phase_kernels_cd(torch, expand, agg, dev) -> None:
    """Kernels D and C on the CPU tests' cases (tests/test_torch_kernels.py,
    after the JAX package's tests/test_kernels.py), and at the edges of
    their tiles, clusters and histogram shapes."""
    rng = np.random.default_rng(2)
    block = 16384                       # the TPU kernel's slot block
    out_cap = 3 * block + 1000
    cases = 0
    for sizes in (rng.integers(1, 9, 9000), np.ones(out_cap - 5),
                  np.array([out_cap + 7]), np.full(6, block)):
        offsets, ends = _segments(sizes.astype(np.int32))
        check_expand(torch, expand, dev, offsets, len(sizes), out_cap, [ends])
        cases += 1
    sizes = rng.integers(1, 30, 500).astype(np.int32)
    offsets, _ends = _segments(sizes)
    padded = np.concatenate([offsets, np.zeros(2048, np.int32)])
    check_expand(torch, expand, dev, padded, 300,
                 int(offsets[299] + sizes[299]) + 77, [])
    check_expand(torch, expand, dev, padded, 0, 128, [padded])   # no source
    cases += 2
    for _trial in range(8):
        n_seg = int(rng.integers(1, 200))
        sizes = rng.integers(1, 400, n_seg).astype(np.int32)
        offsets, _ends = _segments(sizes)
        mono = np.minimum(offsets // 2, 1 << 20).astype(np.int32)
        check_expand(torch, expand, dev, offsets, n_seg,
                     int(sizes.sum()) + int(rng.integers(0, 300)), [mono])
        cases += 1
    # The tile's edges (T slots a block).
    t = expand.TILE
    for cap in (t - 1, t, t + 1, 3 * t + 5):
        sizes = rng.integers(1, 9, cap // 4 + 3).astype(np.int32)
        offsets, ends = _segments(sizes)
        check_expand(torch, expand, dev, offsets, len(sizes), cap,
                     [ends, offsets])
        cases += 1
    layouts = {
        "one segment over tiles": np.array([7, 3 * t + 100, 9], np.int32),
        "unit segments, full windows": np.ones(2 * t, np.int32),
        "empty runs": np.where(rng.random(3 * t) < 0.3, 0,
                               rng.integers(1, 4, 3 * t)).astype(np.int32),
        "empty run over a tile": np.concatenate(
            [np.ones(t // 2), np.zeros(2 * t + 1), np.ones(t)]).astype(
                np.int32),
    }
    for name, sizes in layouts.items():
        offsets, ends = _segments(sizes)
        for n_planes in (0, 2, 8):
            check_expand(torch, expand, dev, offsets, len(sizes),
                         int(sizes.sum()) + t // 3,
                         [ends, *_planes(rng, offsets, n_planes - 1)]
                         if n_planes else [])
            cases += 1
    sizes = rng.integers(1, 9, 3 * t).astype(np.int32)
    offsets, ends = _segments(sizes)
    late = offsets + 1000                         # offsets[0] > 0
    check_expand(torch, expand, dev, late, len(sizes), 2 * t + 3, [ends])
    check_expand(torch, expand, dev, offsets[:t], t, 5 * t,     # n_src = cap
                 _planes(rng, offsets[:t], 8))
    check_expand(torch, expand, dev, offsets, 0, 2 * t + 1,     # no source
                 _planes(rng, offsets, 8))
    cases += 3
    log(f"kernel D edge cases: {cases} passed at tile {t} (bit-exact on "
        f"every slot)")

    cases = 0
    n = 6000
    check_dense(torch, agg, dev, rng.integers(10, 200, n),
                [rng.integers(-10**6, 10**6, n)], n, 10, 191)
    n = 3000
    check_dense(torch, agg, dev, rng.integers(0, 50, n), [np.ones(n)], 2000,
                0, 50, mask=rng.random(n) < 0.5)
    check_dense(torch, agg, dev, np.zeros(4), [np.full(4, 1 << 30)], 4, 0, 1)
    check_dense(torch, agg, dev, rng.integers(0, 3, n),
                [rng.integers(-99, 99, n)], n, 1, 1)
    check_dense(torch, agg, dev, rng.integers(-40, 40, n),
                [rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64),
                 rng.integers(0, 9, n)], n - 1, -30, 1024,
                mask=rng.random(n) < 0.7)
    check_dense(torch, agg, dev, rng.integers(0, 50, n), [], n, 0, 64)
    check_dense(torch, agg, dev, np.zeros(0), [np.zeros(0)], 0, -7, 100)
    cases += 7
    # Cluster and row edges: kernel C starts a CTA per 8192 rows, up to 8
    # a cluster, and loads 4 rows a thread.
    for n in (1, 5, 8191, 8192, 8193, 65535, 65536, 65537, 200_003):
        key = rng.integers(-3000, 3000, n)
        vals = [rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64)]
        mask = rng.random(n) < 0.8
        for nv in sorted({0, n - 1, n}):
            check_dense(torch, agg, dev, key, vals, nv, -1000, 1024, mask)
            cases += 1
        check_dense(torch, agg, dev, key, vals, n, -1000, 1024, mask, skew=1)
        check_dense(torch, agg, dev, key, vals, n, -1000, 1024,
                    np.zeros(n, bool))                   # all rows masked
        cases += 2
    n = 300_001
    hot = np.where(rng.random(n) < 0.9, 77, rng.integers(0, 4096, n))
    wide = [rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64)
            for _ in range(32)]
    shapes = [(hot, wide[:1], 0, 4096, rng.random(n) < 0.9),   # 90% one key
              (rng.integers(0, 16384, n), wide[:3], 0, 16384, None),
              (rng.integers(-5, 16390, n), wide, 0, 16384, None),
              (rng.integers(-2000, 2000, n), wide[:2], -1024, 1024, None)]
    for key, vals, kmin, span, mask in shapes:
        check_dense(torch, agg, dev, key, vals, n, kmin, span, mask)
        cases += 1
        for name, cluster in C_PLANS:
            plan = agg.shape_plan(getattr(agg, name), cluster, span,
                                  len(vals), agg.smem_optin())
            if plan is None:
                continue
            check_dense(torch, agg, dev, key, vals, n, kmin, span, mask,
                        plan=plan)
            cases += 1
    log(f"kernel C edge cases: {cases} passed (bit-exact counts, sums and "
        f"keys, under every histogram shape)")


def cd_shapes(torch, dev):
    """Kernel C and D inputs at the slice's shapes, on the card:
    ``(d_star, d_q3, c_main)`` as argument tuples for the wrappers."""
    rng = np.random.default_rng(3)
    k_np, v_np = table_data(N_MAIN)
    n_src = int((v_np > 0).sum())              # the star join's left rows
    offs = torch.arange(N_MAIN, dtype=torch.int32, device=dev)
    lo = torch.from_numpy(np.sort(rng.integers(0, N_KEYS, N_MAIN)).astype(
        np.int32)).to(dev)
    d_star = (offs, torch.full((), n_src, dtype=torch.int32, device=dev),
              1 << 23, [lo, lo + 1])
    sizes = rng.integers(1, 8, 1 << 18).astype(np.int32)   # ~4 per order
    offsets, _ends = _segments(sizes)
    cap = 1 << 19
    pad = np.zeros(cap - sizes.shape[0], np.int32)
    q3_offs = torch.from_numpy(np.concatenate([offsets, pad])).to(dev)
    q3_lo = torch.from_numpy(np.concatenate([offsets * 2, pad])).to(dev)
    d_q3 = (q3_offs,
            torch.full((), sizes.shape[0], dtype=torch.int32, device=dev),
            1 << int(np.ceil(np.log2(sizes.sum()))),
            [q3_lo, q3_lo + torch.from_numpy(
                np.concatenate([sizes, pad])).to(dev)])
    n = 1 << 23
    key = torch.from_numpy(k_np[:n] & (DIM_SPAN - 1)).to(dev)
    val = torch.from_numpy(v_np[:n]).to(dev)
    c_main = (key, [val], torch.full((), n, dtype=torch.int32, device=dev),
              0, DIM_SPAN, val > 0)
    return d_star, d_q3, c_main


def check_cd_main(torch, expand, agg, dev, d_star, d_q3, c_main):
    """Kernels D and C at the slice's shapes; returns the max abs errors."""
    d_err = 0
    for offs, n_src, out_cap, extras in (d_star, d_q3):
        got = expand.expand_fills(offs, n_src, out_cap, extras)
        ref = expand.expand_fills_reference(offs, n_src, out_cap, extras)
        torch.cuda.synchronize()
        for g, r in zip([got[0], got[1], *got[2]],
                        [ref[0], ref[1], *ref[2]]):
            d_err = max(d_err, int((g.to(torch.int64) - r.to(torch.int64))
                                   .abs().max()))
    if d_err:
        raise AssertionError("kernel D differs at the slice's shapes")
    key, vals, nv, kmin, span, mask = c_main
    c_err = 0
    rng = np.random.default_rng(4)
    n = key.shape[0]
    three = [torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, n,
                                           dtype=np.int64).astype(np.int32))
             .to(dev) for _ in range(3)]
    k16 = torch.from_numpy(rng.integers(0, 16384, n).astype(np.int32)).to(dev)
    one = torch.full_like(key, 5)
    for args in ((key, vals, nv, kmin, span, mask),
                 (k16, three, nv, 0, 16384, None),
                 (one, vals, nv, 5, 1, None)):
        got = agg.onehot_groupby_sums(*args[:5], mask=args[5])
        ref = agg.onehot_groupby_sums_reference(*args[:5], mask=args[5])
        torch.cuda.synchronize()
        for g, r in zip([got[0], *got[1], got[2]],
                        [ref[0], *ref[1], ref[2]]):
            c_err = max(c_err, int((g.to(torch.int64) - r.to(torch.int64))
                                   .abs().max()))
    if c_err:
        raise AssertionError("kernel C differs at the slice's shapes")
    return d_err, c_err, (one, vals, nv), (k16, three, nv)


# -- phase 6: the star join and TPC-H Q3 -------------------------------------

def star_data(n: int = N_MAIN, n_keys: int = N_KEYS):
    """The JAX package bench's join inputs: facts (k, v) exactly as
    bench.py draws them, dims (j, g): j a permutation of [0, 2^20) (every
    fact key matches one dims row), g uniform in [0, 4096), next from the
    same generator. ``n`` facts over ``n_keys`` keys (smaller in the card
    tests)."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, n_keys, n).astype(np.int32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    j = rng.permutation(n_keys).astype(np.int32)
    g = rng.integers(0, DIM_SPAN, n_keys).astype(np.int32)
    return {"k": k, "v": v}, {"j": j, "g": g}


def star_oracle(facts, dims) -> np.ndarray:
    """The star join in numpy: g per fact key by direct lookup, bincount
    sums (int64, wrapped to int32) and counts; rows (g, s, c) by g."""
    g_of_k = np.empty(N_KEYS, np.int32)
    g_of_k[dims["j"]] = dims["g"]
    keep = facts["v"] > 0
    gk = g_of_k[facts["k"][keep]]
    counts = np.bincount(gk, minlength=DIM_SPAN)
    sums = np.bincount(gk, weights=facts["v"][keep].astype(np.int64),
                       minlength=DIM_SPAN).astype(np.int64)
    sums = sums.astype(np.uint32).astype(np.int32)
    groups = np.flatnonzero(counts > 0)
    return np.stack([groups, sums[groups], counts[groups]],
                    axis=1).astype(np.int32)


def q3_data():
    """TPC-H Q3's tables at scale factor 1 row counts, with the columns and
    value ranges of tests/test_tpch_mini.py scaled by row count: custkey
    drawn from [0, 175,000) so one order in seven has no customer, partkey
    from TPC-H's 200,000 parts."""
    rng = np.random.default_rng(42)
    orders = {
        "orderkey": np.arange(N_ORDERS, dtype=np.int32),
        "custkey": rng.integers(0, N_CUSTOMER * 7 // 6, N_ORDERS).astype(
            np.int32),
        "odate": rng.integers(0, 365, N_ORDERS).astype(np.int32),
        "prio": rng.integers(1, 6, N_ORDERS).astype(np.int32),
    }
    lineitem = {
        "orderkey": rng.integers(0, N_ORDERS, N_LINEITEM).astype(np.int32),
        "partkey": rng.integers(0, 200_000, N_LINEITEM).astype(np.int32),
        "qty": rng.integers(1, 50, N_LINEITEM).astype(np.int32),
        "price": rng.integers(100, 10000, N_LINEITEM).astype(np.int32),
        "discount": rng.integers(0, 10, N_LINEITEM).astype(np.int32),
        "ship": rng.integers(0, 365, N_LINEITEM).astype(np.int32),
    }
    customer = {
        "custkey": np.arange(N_CUSTOMER, dtype=np.int32),
        "nation": rng.integers(0, 25, N_CUSTOMER).astype(np.int32),
    }
    return {"lineitem": lineitem, "orders": orders, "customer": customer}


def q3_oracle(t) -> np.ndarray:
    """Q3 in numpy: boolean masks, direct indexing on orderkey / custkey,
    bincount revenue (wrapped to int32), lexsort for rev desc, orderkey."""
    o, li, cu = t["orders"], t["lineitem"], t["customer"]
    ck = o["custkey"]
    ok = (ck < N_CUSTOMER) & (o["odate"] < 180)
    ok[ok] &= cu["nation"][ck[ok]] < 10
    sel = ok[li["orderkey"]]
    lk = li["orderkey"][sel]
    rev = np.bincount(lk, weights=li["price"][sel].astype(np.int64)
                      * li["qty"][sel], minlength=N_ORDERS).astype(np.int64)
    rev = rev.astype(np.uint32).astype(np.int32)
    keys = np.flatnonzero(np.bincount(lk, minlength=N_ORDERS) > 0)
    order = np.lexsort((keys, -rev[keys].astype(np.int64)))[:10]
    return np.stack([keys[order], rev[keys][order]], axis=1).astype(np.int32)


# -- phase 7 oracles: nested queries ------------------------------------------
# q3_data's keys are row positions: orders.orderkey and customer.custkey are
# aranges, so a key indexes its table directly.

def wrap32(x) -> np.ndarray:
    """Exact integers (int64, or float64 below 2^53) wrapped to int32 as
    the engine's int32 sums wrap."""
    x = np.asarray(x).astype(np.int64)
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def q1_oracle(t) -> np.ndarray:
    """Q1: per discount over the lines shipped by day 300, sum(qty) and
    sum(price * qty) wrapped to int32 as the engine's int32 sums wrap,
    avg(price) as float32(the wrapped int32 sum) / float32(count), and
    count; by discount. float64, as ``sql`` stacks int32 with float32."""
    li = t["lineitem"]
    keep = li["ship"] <= 300
    d = li["discount"][keep]
    qty = li["qty"][keep].astype(np.int64)
    price = li["price"][keep].astype(np.int64)
    n = np.bincount(d)
    keys = np.flatnonzero(n)
    sq = wrap32(np.bincount(d, weights=qty))[keys]
    sp = wrap32(np.bincount(d, weights=price * qty))[keys]
    sprice = wrap32(np.bincount(d, weights=price))[keys]
    ap = sprice.astype(np.float32) / n[keys].astype(np.float32)
    return np.stack([keys, sq, sp, ap, n[keys]], axis=1).astype(np.float64)


def q4_oracle(t) -> np.ndarray:
    """Q4: orders with a line of qty > 40, counted by prio."""
    o, li = t["orders"], t["lineitem"]
    has = np.zeros(o["orderkey"].shape[0], bool)
    has[li["orderkey"][li["qty"] > 40]] = True
    counts = np.bincount(o["prio"][has])
    prios = np.flatnonzero(counts)
    return np.stack([prios, counts[prios]], axis=1).astype(np.int32)


def q5_oracle(t) -> np.ndarray:
    """Q5: revenue per customer (the CTE; customers without a line are not
    in it), summed per nation of the customers that exist, wrapped to int32
    before HAVING > 0; vol desc, nation; top 8."""
    o, li, cu = t["orders"], t["lineitem"], t["customer"]
    ck = o["custkey"][li["orderkey"]]
    n_ck = int(o["custkey"].max()) + 1
    r = wrap32(np.bincount(ck, weights=li["price"].astype(np.int64)
                           * li["qty"], minlength=n_ck))
    in_rev = np.bincount(ck, minlength=n_ck) > 0
    cks = cu["custkey"]
    m = in_rev[cks]                        # every custkey is < n_ck here
    nation = cu["nation"][m]
    n_nat = int(cu["nation"].max()) + 1
    vol = wrap32(np.bincount(nation, weights=r[cks[m]].astype(np.int64),
                             minlength=n_nat))
    nats = np.flatnonzero((np.bincount(nation, minlength=n_nat) > 0)
                          & (vol > 0))
    order = np.lexsort((nats, -vol[nats].astype(np.int64)))[:8]
    return np.stack([nats[order], vol[nats][order]], axis=1).astype(np.int32)


def q13_oracle(t) -> np.ndarray:
    """Q13: orders per customer (0 for a customer without one), then
    customers per count; custs desc, cnt; top 10."""
    ck, n_cust = t["orders"]["custkey"], t["customer"]["custkey"].shape[0]
    cnt = np.bincount(ck[ck < n_cust], minlength=n_cust)
    custs = np.bincount(cnt)
    vals = np.flatnonzero(custs)
    order = np.lexsort((vals, -custs[vals]))[:10]
    return np.stack([vals[order], custs[vals][order]], axis=1).astype(
        np.int32)


def q17_oracle(t) -> np.ndarray:
    """Q17: sum(price) of the lines whose qty is below their part's average
    qty, the average float32(sum) / float32(count) as the engine computes
    it; the sum wrapped to int32."""
    li = t["lineitem"]
    pk = li["partkey"]
    s = np.bincount(pk, weights=li["qty"].astype(np.int64))
    c = np.bincount(pk)
    avg = np.zeros(c.shape[0], np.float32)
    avg[c > 0] = (s[c > 0].astype(np.float32)
                  / c[c > 0].astype(np.float32))
    keep = li["qty"].astype(np.float32) < avg[pk]
    return wrap32([[li["price"][keep].astype(np.int64).sum()]])


def window_oracle(k, v) -> np.ndarray:
    """The window query: rows of ``v > 0`` in table order with their
    row_number, rank and running sum (the default RANGE frame, so peers
    with an equal v share the sum) within partition k ordered by v, ties
    by table position."""
    keep = v > 0
    ks, vs = k[keep], v[keep]
    n = ks.shape[0]
    order = np.lexsort((vs, ks))                  # stable: ties by position
    sk, sv = ks[order], vs[order]
    idx = np.arange(n)
    p_start = np.r_[True, sk[1:] != sk[:-1]]
    t_start = p_start | np.r_[True, sv[1:] != sv[:-1]]
    first_p = np.maximum.accumulate(np.where(p_start, idx, 0))
    first_t = np.maximum.accumulate(np.where(t_start, idx, 0))
    cum = np.cumsum(sv.astype(np.int64))
    run_sum = cum - (cum - sv)[first_p]
    t_end = np.r_[np.flatnonzero(t_start)[1:], n] - 1
    peer_last = t_end[np.cumsum(t_start) - 1]
    out = np.empty((n, 5), np.int32)
    out[order] = np.stack([sk, sv, idx - first_p + 1, first_t - first_p + 1,
                           wrap32(run_sum[peer_last])], axis=1)
    return out


def setop_oracle(k, v) -> np.ndarray:
    return np.intersect1d(k[v > 900], k[v < -900])[:, None].astype(np.int32)


def load_context(torch, H, tables):
    """A ``Context(device="cuda")`` holding ``tables``; and the seconds the
    load took."""
    ctx = H.Context(device="cuda")
    t0 = time.perf_counter()
    for tname, cols in tables.items():
        ctx.create_table(tname, cols)
    torch.cuda.synchronize()
    return ctx, time.perf_counter() - t0


def reset_launches(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_launches(counters) -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def check_query(ctx, counters, query, expect, need, name):
    """Run ``query`` through ``ctx.sql`` with every launch count set to 0
    just before; check it against ``expect`` and that each kernel in
    ``need`` launched at least that often. Returns the launch counts."""
    reset_launches(counters)
    got = ctx.sql(query)
    launches = read_launches(counters)
    if got.shape != expect.shape or not np.array_equal(got, expect):
        raise AssertionError(f"{name} differs from its numpy oracle: shape "
                             f"{got.shape} vs {expect.shape}")
    short = {k: (launches[k], n) for k, n in need.items() if launches[k] < n}
    if short:
        raise AssertionError(f"{name} skipped a kernel (launched, needed): "
                             f"{short}")
    log(f"{name}: {got.shape[0]:,} rows equal the numpy oracle; launches "
        f"{launches}")
    return launches


def run_join_check(torch, H, counters, tables, query, expect, need, name):
    """Load ``tables`` into a new Context and run :func:`check_query`."""
    ctx, load_s = load_context(torch, H, tables)
    log(f"{name}: tables load {load_s:.2f} s")
    return ctx, check_query(ctx, counters, query, expect, need, name)


def time_cuda(torch, fn, iters=20, warmup=3, host=False):
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    calls after ``warmup``. The calls are queued behind a device sleep, so
    the wrapper's host work overlaps the sleep and the events measure the
    device alone (a call that waits for the device, such as a boolean-mask
    index, still pays its waits). With ``host``, also returns the host ms
    per call spent queueing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    return (ms, host_ms) if host else ms


def kernel_only_ms(torch, fn, name, iters=10):
    """Mean device time in ms of the kernels whose name holds ``name``
    over ``iters`` calls of ``fn``, from torch.profiler: the kernel alone,
    without the wrapper's zero fill and the gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(times) / max(1, len(times)) / 1e3


def time_query(torch, ctx, query, reps=5, run=None):
    """Warm-up, then the median of ``reps`` timed calls of ``run`` (by
    default ``ctx.sql``, which returns numpy) ending synchronised."""
    run = ctx.sql if run is None else run
    run(query)                                         # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(query)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def run_query_check(torch, H, counters, n, query, min_count):
    k_np, v_np = table_data(n)
    ctx = H.Context(device="cuda")
    t0 = time.perf_counter()
    ctx.create_table("t", {"k": k_np, "v": v_np})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    expect = oracle(k_np, v_np, min_count)
    reset_launches(counters)
    got = ctx.sql(query)
    launches = read_launches(counters)
    if got.shape != expect.shape or not np.array_equal(got, expect):
        raise AssertionError(
            f"{n}-row query differs from the numpy oracle: shape "
            f"{got.shape} vs {expect.shape}"
        )
    if launches["flat_compact"] < 2 or launches["flat_segscan"] < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    log(f"query at {n:,} rows: {got.shape[0]:,} rows equal the numpy "
        f"oracle; launches {launches}; table load {load_s:.2f} s")
    return ctx, launches


def profile_query(torch, ctx, query, top=20):
    """One warm run of ``query`` under torch.profiler: see
    :func:`profile_call`."""
    return profile_call(torch, lambda: ctx.sql(query), top)


def profile_call(torch, fn, top=20):
    """One warm run of ``fn`` under torch.profiler: device time by kernel
    (the ``top`` longest), and the device's busy share of the wall time.
    Returns the device-busy ms and the wall ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy_us = sum(t for t, _c in by_name.values())
    log(f"profile: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%; one "
        f"stream, so kernel times do not overlap)")
    longest = sorted(by_name.items(), key=lambda x: -x[1][0])[:top]
    for name, (tot, cnt) in longest:
        log(f"  {tot / 1e3:9.3f} ms  x{cnt:<4d} {name[:100]}")
    return busy_us / 1e3, wall_us / 1e3


def phase_nested(torch, H, counters):
    """Phase 7: TPC-H Q1, Q4, Q5, Q13 and Q17 at SF 1 row counts, the window
    query and the INTERSECT query on the 2^24-row table, each against its
    numpy oracle with its launches counted, then timed warm; the window
    query profiled. Returns ``(query_ms, launches)``."""
    tpch = q3_data()
    cases = [
        ("tpch_q1_sf1", Q1_QUERY, q1_oracle(tpch), {"flat_compact": 2}),
        ("tpch_q4_sf1", Q4_QUERY, q4_oracle(tpch),
         {"flat_compact": 1, "onehot_groupby_sums": 1}),
        ("tpch_q5_sf1", Q5_QUERY, q5_oracle(tpch),
         {"flat_compact": 1, "expand_fills": 1}),
        ("tpch_q13_sf1", Q13_QUERY, q13_oracle(tpch),
         {"flat_compact": 1, "expand_fills": 1}),
        ("tpch_q17_sf1", Q17_QUERY, q17_oracle(tpch),
         {"flat_compact": 1, "expand_fills": 1}),
    ]
    ctx, load_s = load_context(torch, H, tpch)
    del tpch
    log(f"TPC-H tables at SF 1 row counts: load {load_s:.2f} s")
    query_ms, launches = {}, {}
    for name, query, expect, need in cases:
        launches[name] = check_query(ctx, counters, query, expect, need, name)
    for name, query, _expect, _need in cases:
        query_ms[name], times = time_query(torch, ctx, query)
        log(f"{name}: median {query_ms[name]:.3f} ms of {times}")
    log("tpch_q1_sf1:")
    profile_query(torch, ctx, Q1_QUERY)
    del ctx, cases
    torch.cuda.empty_cache()
    for form, ms in cumsum_forms(torch).items():
        query_ms[f"q1_cumsum_{form}"] = ms

    k_np, v_np = table_data(N_MAIN)
    cases = [
        (f"window_{N_MAIN}", WINDOW_QUERY, window_oracle(k_np, v_np),
         {"flat_compact": 1, "flat_segscan": 2,
          "flat_segscan_one_segment": 1}),
        (f"intersect_{N_MAIN}", SETOP_QUERY, setop_oracle(k_np, v_np),
         {"flat_compact": 3}),
    ]
    ctx, load_s = load_context(torch, H, {"t": {"k": k_np, "v": v_np}})
    del k_np, v_np
    log(f"table t ({N_MAIN:,} rows): load {load_s:.2f} s")
    for name, query, expect, need in cases:
        launches[name] = check_query(ctx, counters, query, expect, need, name)
    for name, query, _expect, _need in cases:
        query_ms[name], times = time_query(torch, ctx, query)
        log(f"{name}: median {query_ms[name]:.3f} ms of {times}")
    # The window query returns 8.4M rows: split its time into the engine's
    # (sql_batch, the result left on the card) and the readback's.
    batch_ms, times = time_query(torch, ctx, WINDOW_QUERY,
                                 run=ctx.sql_batch)
    log(f"window_{N_MAIN} without the readback (sql_batch, synchronised): "
        f"median {batch_ms:.3f} ms of {times}")
    query_ms[f"window_{N_MAIN}_on_card"] = batch_ms
    profile_query(torch, ctx, WINDOW_QUERY)
    del ctx, cases
    torch.cuda.empty_cache()
    return query_ms, launches


def cumsum_forms(torch, n=6_001_664, cols=3) -> dict:
    """Q1's three telescoped int32 sums at its group-by capacity
    (lineitem's rows padded to 1024, not shrunk: the power-of-two bucket of
    its live rows is larger): one
    ``torch.cumsum`` along dim 0 of an [n, 3] stack against three 1-D
    cumsums, CUDA events; both must agree."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(-1000, 1000, (n, cols), dtype=torch.int32,
                      device="cuda", generator=gen)
    split = [x[:, j].contiguous() for j in range(cols)]
    got = torch.stack([torch.cumsum(c, 0, dtype=torch.int32) for c in split],
                      dim=1)
    if not torch.equal(got, torch.cumsum(x, 0, dtype=torch.int32)):
        raise AssertionError("the two cumsum forms differ")
    out = {
        "stacked_ms": time_cuda(torch, lambda: torch.cumsum(
            x, 0, dtype=torch.int32), iters=3, warmup=1),
        "per_column_ms": time_cuda(torch, lambda: [torch.cumsum(
            c, 0, dtype=torch.int32) for c in split], iters=3, warmup=1),
    }
    log(f"cumsum of {n:,} x {cols} int32 along dim 0: stacked "
        f"{out['stacked_ms']:.3f} ms, one 1-D cumsum per column "
        f"{out['per_column_ms']:.3f} ms (the group-by's form)")
    return out


def debug_checks_overhead(torch, H, ctx, query, name, base_ms) -> dict:
    """``query`` under ``EngineConfig(debug_checks=True)`` over ``ctx``'s
    tables: the same result as ``ctx`` gives, and its time beside the
    default config's (``base_ms``, then again after the checked runs)."""
    checked = H.Context(H.EngineConfig(debug_checks=True), device="cuda")
    checked.tables.update(ctx.tables)
    if not np.array_equal(checked.sql(query), ctx.sql(query)):
        raise AssertionError(f"{name} differs under debug_checks")
    on_ms, on_all = time_query(torch, checked, query)
    off_ms, off_all = time_query(torch, ctx, query)
    log(f"{name} under debug_checks: equal; median {on_ms:.3f} ms of "
        f"{on_all} vs {base_ms:.3f} ms, then {off_ms:.3f} ms of {off_all} "
        f"without")
    return {"on_ms": on_ms, "off_ms": [base_ms, off_ms]}


def write_csv(path: str, cols) -> None:
    """Write int32 columns as a CSV (header, then ``%d,%d`` rows) with
    numpy alone: each value's decimal digits are laid into a fixed-width
    byte matrix, and the filler bytes are then dropped."""
    names = list(cols)
    n = len(cols[names[0]])
    widths = [max(len(str(int(a.min()))), len(str(int(a.max()))))
              for a in cols.values()]
    fill = ord(" ")
    buf = np.full((n, sum(widths) + len(widths)), fill, np.uint8)
    pos = 0
    for i, (a, w) in enumerate(zip(cols.values(), widths)):
        m = np.abs(a.astype(np.int64))
        neg = a < 0
        for d in range(w):
            at = pos + w - 1 - d
            live = (m > 0) if d else np.ones(n, bool)
            buf[live, at] = ord("0") + (m[live] % 10).astype(np.uint8)
            m //= 10
            sign = neg & live & (m == 0)
            buf[sign, at - 1] = ord("-")
        buf[:, pos + w] = ord("\n") if i == len(names) - 1 else ord(",")
        pos += w + 1
    flat = buf.ravel()
    with open(path, "wb") as f:
        f.write((",".join(names) + "\n").encode())
        f.write(flat[flat != fill].tobytes())


def phase_csv_cli(torch, H, counters, build_dir):
    """Phase 9: bench-2^24's table written as a CSV, loaded onto the card
    by ``create_table`` (the native loader, which reads an all-numeric CSV
    whether pandas is installed or not; its parse alone timed too) and
    queried against the numpy oracle and the dict-loaded table; then
    the CLI in-process with ``--profile`` (a trace naming kernels A and B)
    and ``--explain``. Returns the numbers for the report."""
    import contextlib
    import importlib.util
    import io

    from harkdb_tpu_torch.__main__ import main as cli_main
    from harkdb_tpu_torch.io import native_csv

    out = {"pandas_present": importlib.util.find_spec("pandas") is not None}
    t0 = time.perf_counter()
    native_csv.build()
    out["loader_build_s"] = time.perf_counter() - t0
    k_np, v_np = table_data(N_MAIN)
    path = os.path.join(build_dir, f"bench_{N_MAIN}.csv")
    t0 = time.perf_counter()
    write_csv(path, {"k": k_np, "v": v_np})
    out["write_s"] = time.perf_counter() - t0
    out["csv_bytes"] = os.path.getsize(path)
    log(f"CSV of bench-2^24 ({N_MAIN:,} rows, {out['csv_bytes']:,} bytes) "
        f"written in {out['write_s']:.2f} s; native loader built in "
        f"{out['loader_build_s']:.2f} s; pandas present: "
        f"{out['pandas_present']}")
    ctx = H.Context(device="cuda")
    t0 = time.perf_counter()
    ctx.create_table("t", path)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_rows_per_s"] = N_MAIN / out["load_s"]
    log(f"create_table from the CSV onto the card (host time, native "
        f"loader, parse + dtype policy + copy to the card): "
        f"{out['load_s']:.3f} s, {out['load_rows_per_s'] / 1e6:.2f} M rows/s, "
        f"{out['csv_bytes'] / out['load_s'] / 1e6:.1f} MB/s")
    t0 = time.perf_counter()
    parsed = native_csv.native_read_csv(path, H.EngineConfig())
    out["native_parse_s"] = time.perf_counter() - t0
    if parsed is None or parsed[1] != ["k", "v"]:
        raise AssertionError("the native loader did not read the CSV")
    del parsed
    log(f"native_read_csv alone (host time, threads over newline-split "
        f"chunks, then the int / float decision per column): "
        f"{out['native_parse_s']:.3f} s")
    out["launches"] = check_query(
        ctx, counters, MAIN_QUERY, oracle(k_np, v_np),
        {"flat_compact": 2, "flat_segscan": 1}, "main query on the CSV table")
    from_dict, _load = load_context(torch, H, {"t": {"k": k_np, "v": v_np}})
    if not np.array_equal(ctx.sql(MAIN_QUERY), from_dict.sql(MAIN_QUERY)):
        raise AssertionError("the CSV table and the dict table differ")
    log("main query on the CSV table: equal to the dict-loaded table's")
    del ctx, from_dict

    trace_dir = os.path.join(build_dir, "cli_trace")
    if os.path.isdir(trace_dir):
        for f in os.listdir(trace_dir):
            os.remove(os.path.join(trace_dir, f))
    argv = ["--table", f"t={path}", "--profile", trace_dir, MAIN_QUERY]
    stdout, stderr = io.StringIO(), io.StringIO()
    reset_launches(counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(stderr):
        rc = cli_main(argv)
    out["cli_profile_s"] = time.perf_counter() - t0
    out["cli_launches"] = read_launches(counters)
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}: {stderr.getvalue()}")
    traces = sorted(os.listdir(trace_dir))
    if len(traces) != 1:
        raise AssertionError(f"expected one trace file, found {traces}")
    with open(os.path.join(trace_dir, traces[0])) as f:
        text = f.read()
    names = sorted(set(re.findall(r"([a-z_]+_kernel)", text)))
    missing = {n for n in ("compact_kernel", "segscan_kernel")
               if n not in text}
    if missing:
        raise AssertionError(f"the CLI's trace lacks {missing}: {names}")
    if (out["cli_launches"]["flat_compact"] < 2
            or out["cli_launches"]["flat_segscan"] < 1):
        raise AssertionError(f"the CLI skipped a kernel: "
                             f"{out['cli_launches']}")
    out["trace_kernels"] = names
    log(f"CLI --profile: {out['cli_profile_s']:.2f} s (CSV load included), "
        f"trace {traces[0]} ({len(text):,} bytes) names {names}; launches "
        f"{out['cli_launches']}; stderr {stderr.getvalue().strip()!r}; "
        f"stdout starts {stdout.getvalue()[:60]!r}")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        rc = cli_main(["--table", f"t={path}", "--explain", MAIN_QUERY])
    if rc != 0 or "Aggregate keys=[t.k]" not in stdout.getvalue():
        raise AssertionError(f"the CLI's --explain failed: {rc}, "
                             f"{stdout.getvalue()!r}")
    log("CLI --explain: " + " | ".join(stdout.getvalue().strip().splitlines()))
    os.remove(path)
    torch.cuda.empty_cache()
    return out


# -- phase 10: the mesh ---------------------------------------------------------

MESH_RANKS = 4
MESH_NOTE = "4 ranks share one card: not a scaling figure"
SKEW_KEY = 7                      # the skewed join's hot probe key
MEDIAN_QUERY = ("select k % 64 as b, median(v) as md, count(distinct v) "
                "as d from t group by k % 64 order by b")
TOPK_QUERY = ("select k, v from t where v > 990 order by v desc, k "
              "limit 1000")
GLOBAL_WINDOW_QUERY = (
    "select k, v, row_number() over (order by v, k) as rn, "
    "sum(v) over (order by v, k) as rs, "
    "lag(v, 1) over (order by v, k) as pv from t where v > 500")
FRAME_WINDOW_QUERY = (
    "select k, v, sum(v) over (order by v, k rows between 3 preceding and "
    "current row) as s3 from t where v > 990")
GROUPED_WINDOW_QUERY = (
    "select k % 64 as b, sum(v) as s, rank() over (order by sum(v) desc) "
    "as rk from t group by k % 64")
STAR_CTE_QUERY = ("with sj as (select g, sum(v) as s, count(*) as c from "
                  "facts join dims on facts.k = dims.j where v > 0 group by "
                  "g) select sj.g, sj.s, sj.c from sj order by sj.g")
UNION_ALL_QUERY = ("select k, v from t where v > 990 union all "
                   "select k, v from t where v < -990 order by v, k")
UNION_QUERY = ("select k from t where v > 900 union "
               "select k from t where v < -900")
# Phase 10's cases per table set: (name, query, EngineConfig overrides).
MESH_SETS = [
    ("bench", [("main_query", MAIN_QUERY, {}),
               ("median_countd", MEDIAN_QUERY, {}),
               ("orderby_limit", TOPK_QUERY, {}),
               ("orderby_limit_gather", TOPK_QUERY, {"dist_tail": False}),
               ("window_partitioned", WINDOW_QUERY, {}),
               ("window_global", GLOBAL_WINDOW_QUERY, {}),
               ("window_frame_rank0", FRAME_WINDOW_QUERY, {}),
               ("window_grouped", GROUPED_WINDOW_QUERY, {}),
               ("union_all_sharded", UNION_ALL_QUERY, {}),
               ("union_distinct", UNION_QUERY, {}),
               ("intersect_gather", SETOP_QUERY, {})]),
    ("star", [("star_join", STAR_QUERY, {}),
              ("star_join_cte", STAR_CTE_QUERY, {})]),
    ("skew", [("skewed_join", STAR_QUERY, {})]),
    ("tpch", [("tpch_q3_sf1", Q3_QUERY, {}),
              ("tpch_q5_cte_sf1", Q5_QUERY, {}),
              ("tpch_q13_derived_sf1", Q13_QUERY, {})]),
]
# The kernels a case must launch on every rank (at least once each): the
# call sites of the distributed windows, set operations and derived
# tables (kernel C inside a CTE: the star join's GROUP BY as its body;
# Q5's outer GROUP BY sums a derived column, which has no host stats, so
# the dense path stays off there, as in the JAX package). Every rank's blocks hold rows in these cases; the rank-0 route
# of window_frame_rank0 leaves the other ranks without window rows.
MESH_NEEDS = {
    "window_partitioned": ("flat_compact", "flat_segscan",
                           "flat_segscan_one_segment"),
    "window_global": ("flat_compact", "flat_segscan_one_segment"),
    "window_frame_rank0": ("flat_compact",),
    "window_grouped": ("flat_compact",),
    "union_all_sharded": ("flat_compact",),
    "union_distinct": ("flat_compact",),
    "intersect_gather": ("flat_compact",),
    "star_join_cte": ("flat_compact", "expand_fills",
                      "onehot_groupby_sums"),
    "tpch_q5_cte_sf1": ("flat_compact", "expand_fills"),
    "tpch_q13_derived_sf1": ("flat_compact", "expand_fills"),
}


def skew_data():
    """The star join's tables with 90% of the facts on one key
    (``SKEW_KEY``): salting spreads its probe rows over every rank and
    copies its one dims row to each."""
    facts, dims = star_data()
    rng = np.random.default_rng(1)
    hot = rng.random(N_MAIN) < 0.9
    facts["k"] = np.where(hot, SKEW_KEY, facts["k"]).astype(np.int32)
    return {"facts": facts, "dims": dims}


def mesh_tables(name: str):
    if name == "bench":
        k, v = table_data(N_MAIN)
        return {"t": {"k": k, "v": v}}
    if name == "star":
        facts, dims = star_data()
        return {"facts": facts, "dims": dims}
    if name == "skew":
        return skew_data()
    return q3_data()


def median_oracle(k, v) -> np.ndarray:
    """MEDIAN_QUERY in numpy: per k % 64, the median (the mean of the two
    middle values for an even count, as float32) and the distinct count."""
    b = k % 64
    order = np.lexsort((v, b))
    sb, sv = b[order], v[order]
    starts = np.searchsorted(sb, np.arange(64))
    ends = np.r_[starts[1:], sb.shape[0]]
    n = ends - starts
    lo = sv[starts + (n - 1) // 2].astype(np.float32)
    hi = sv[starts + n // 2].astype(np.float32)
    md = lo * np.float32(0.5) + hi * np.float32(0.5)
    new = np.r_[True, (sv[1:] != sv[:-1]) | (sb[1:] != sb[:-1])]
    d = np.add.reduceat(new.astype(np.int64), starts)
    return np.stack([np.arange(64), md, d], axis=1).astype(np.float64)


def topk_oracle(k, v) -> np.ndarray:
    keep = v > 990
    ks, vs = k[keep], v[keep]
    order = np.lexsort((ks, -vs.astype(np.int64)))[:1000]
    return np.stack([ks[order], vs[order]], axis=1).astype(np.int32)


def global_window_oracle(k, v) -> np.ndarray:
    """GLOBAL_WINDOW_QUERY: rows of ``v > 500`` in table order with their
    row number, running sum (peers, equal (v, k), share the sum at the
    last of them; int32 wrap) and the previous row's v (0 for the first)
    in the order (v, k, table position)."""
    keep = v > 500
    ks, vs = k[keep], v[keep]
    n = ks.shape[0]
    order = np.lexsort((ks, vs))
    sk, sv = ks[order], vs[order]
    t_start = np.r_[True, (sv[1:] != sv[:-1]) | (sk[1:] != sk[:-1])]
    t_end = np.r_[np.flatnonzero(t_start)[1:], n] - 1
    peer_last = t_end[np.cumsum(t_start) - 1]
    rs = wrap32(np.cumsum(sv.astype(np.int64))[peer_last])
    out = np.empty((n, 5), np.int32)
    out[order] = np.stack([sk, sv, np.arange(1, n + 1), rs,
                           np.r_[0, sv[:-1]]], axis=1)
    return out


def frame_window_oracle(k, v) -> np.ndarray:
    """FRAME_WINDOW_QUERY: rows of ``v > 990`` in table order with the sum
    of v over the row and the 3 before it in the order (v, k, table
    position)."""
    keep = v > 990
    ks, vs = k[keep], v[keep]
    order = np.lexsort((ks, vs))
    sv = vs[order].astype(np.int64)
    cum = np.r_[0, np.cumsum(sv)]
    i = np.arange(sv.shape[0])
    s3 = cum[i + 1] - cum[np.maximum(i - 3, 0)]
    out = np.empty((ks.shape[0], 3), np.int32)
    out[order] = np.stack([ks[order], vs[order], wrap32(s3)], axis=1)
    return out


def grouped_window_oracle(k, v) -> np.ndarray:
    """GROUPED_WINDOW_QUERY: per k % 64 (ascending), sum(v) (int32 wrap)
    and its rank, 1 + the groups with a larger sum."""
    b = k % 64
    s = wrap32(np.bincount(b, weights=v.astype(np.int64), minlength=64))
    rk = 1 + (s[None, :] > s[:, None]).sum(1)
    return np.stack([np.arange(64), s, rk], axis=1).astype(np.int32)


def union_all_oracle(k, v) -> np.ndarray:
    """UNION_ALL_QUERY: both arms' rows in table order, concatenated, then
    stably sorted by (v, k)."""
    a, b = v > 990, v < -990
    ks, vs = np.r_[k[a], k[b]], np.r_[v[a], v[b]]
    order = np.lexsort((ks, vs))
    return np.stack([ks[order], vs[order]], axis=1).astype(np.int32)


def union_oracle(k, v) -> np.ndarray:
    """UNION_QUERY: the distinct keys of both arms, ascending (the order a
    dedupe leaves)."""
    return np.union1d(k[v > 900], k[v < -900])[:, None].astype(np.int32)


def mesh_oracles() -> dict:
    k, v = table_data(N_MAIN)
    out = {"main_query": oracle(k, v), "median_countd": median_oracle(k, v),
           "orderby_limit": topk_oracle(k, v),
           "window_partitioned": window_oracle(k, v),
           "window_global": global_window_oracle(k, v),
           "window_frame_rank0": frame_window_oracle(k, v),
           "window_grouped": grouped_window_oracle(k, v),
           "union_all_sharded": union_all_oracle(k, v),
           "union_distinct": union_oracle(k, v),
           "intersect_gather": setop_oracle(k, v)}
    out["orderby_limit_gather"] = out["orderby_limit"]
    facts, dims = star_data()
    out["star_join"] = out["star_join_cte"] = star_oracle(facts, dims)
    skew = skew_data()
    out["skewed_join"] = star_oracle(skew["facts"], skew["dims"])
    tpch = q3_data()
    out["tpch_q3_sf1"] = q3_oracle(tpch)
    out["tpch_q5_cte_sf1"] = q5_oracle(tpch)
    out["tpch_q13_derived_sf1"] = q13_oracle(tpch)
    return out


def _digest(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(f"{a.shape}{a.dtype}".encode()
                          + np.ascontiguousarray(a).tobytes()).hexdigest()


def _clone(x):
    """``x`` with every tensor in it (in lists, tuples, dicts) cloned."""
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x.clone() if hasattr(x, "clone") else x


def _word_err(torch, got, ref) -> int:
    """Largest difference of the two tensors' 32-bit words (0: bit for
    bit equal)."""
    if got.shape != ref.shape:
        raise AssertionError(f"shapes differ: {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    if got.numel() == 0:
        return 0
    a = got.contiguous().view(torch.int32).to(torch.int64)
    b = ref.contiguous().view(torch.int32).to(torch.int64)
    return int((a - b).abs().max())


class MeshAudit:
    """Kernels A-D at the shapes the mesh path gives them, on one rank of
    phase 10. While installed, every call of ``flat_compact``,
    ``flat_segscan``, ``onehot_groupby_sums`` and ``expand_fills`` (and so
    ``expand_ids``) made by the port also runs the wrapper's plain version
    on the same inputs, which must equal it bit for bit (a float add or mul
    scan within FLOAT_ADD_RTOL of the sum of |x|, as phase 3 holds it). It
    counts each form's calls and launches (``flat_segscan`` with segment
    ids and over one segment apart) and keeps the inputs of each form's
    largest call, which :meth:`report` then times against the plain
    version and the library call. The wrappers are replaced wherever a
    module of the port holds them, so every import form is caught; a plan
    that kept a reference to a replaced wrapper past :meth:`remove` calls
    straight through to the kernel, unchecked and uncounted."""

    FORMS = ("flat_compact", "flat_segscan", "flat_segscan_one_segment",
             "onehot_groupby_sums", "expand_fills")

    def __init__(self, torch):
        from harkdb_tpu_torch.kernels import (
            compact, expand, matmul_agg, segscan,
        )

        self.torch = torch
        self.mods = {"flat_compact": compact, "flat_segscan": segscan,
                     "onehot_groupby_sums": matmul_agg,
                     "expand_fills": expand}
        self.forms = {}
        self.case = None
        self.armed = False
        self._patched = []

    def install(self, case: str) -> None:
        self.case, self.armed = case, True
        for name, mod in self.mods.items():
            orig = getattr(mod, name)
            audited = getattr(self, f"_audit_{name}")(orig, mod)
            for m in list(sys.modules.values()):
                if (getattr(m, "__name__", "").startswith("harkdb_tpu_torch")
                        and vars(m).get(name) is orig):
                    setattr(m, name, audited)
                    self._patched.append((m, name, orig))

    def remove(self) -> None:
        self.armed = False
        for m, name, orig in reversed(self._patched):
            setattr(m, name, orig)
        self._patched = []

    def _record(self, form, mod, before, work, err, args, shape) -> None:
        f = self.forms.setdefault(form, {"calls": 0, "launches": 0,
                                         "max_abs_err": 0, "work": -1})
        f["calls"] += 1
        f["launches"] += mod.LAUNCHES - before
        f["max_abs_err"] = max(f["max_abs_err"], err)
        if work > f["work"]:
            f.update(work=work, case=self.case, shape=shape,
                     args=_clone(args))

    def _audit_flat_compact(self, orig, mod):
        torch = self.torch

        def flat_compact(cols, mask, n_valid):
            before = mod.LAUNCHES
            out, cnt = orig(cols, mask, n_valid)
            if not self.armed or mask.device.type != "cuda":
                return out, cnt
            ref, rcnt = mod.flat_compact_reference(cols, mask, n_valid)
            c = int(rcnt)
            err = abs(int(cnt) - c)
            for k in cols:
                err = max(err, _word_err(torch, out[k][:c], ref[k][:c]))
            if err:
                raise AssertionError(f"{self.case}: kernel A differs from "
                                     f"its plain version at {mask.shape[0]} "
                                     f"rows x {len(cols)} columns")
            self._record("flat_compact", mod, before,
                         mask.shape[0] * len(cols), err, (cols, mask, n_valid),
                         f"{mask.shape[0]} rows x {len(cols)} columns, "
                         f"{c} kept")
            return out, cnt
        return flat_compact

    def _audit_flat_segscan(self, orig, mod):
        torch = self.torch

        def flat_segscan(op_name, sid, cols, neutral, reverse=False):
            cols = list(cols)
            before = mod.LAUNCHES
            got = orig(op_name, sid, cols, neutral, reverse)
            if not self.armed or cols[0].device.type != "cuda":
                return got
            ref = mod.flat_segscan_reference(op_name, sid, cols, neutral,
                                             reverse)
            err = 0
            for g, r, x in zip(got, ref, cols):
                if g.dtype.is_floating_point and op_name in ("add", "mul"):
                    bound = (r.abs() if op_name == "mul" else
                             mod.flat_segscan_reference(
                                 "add", sid, [x.abs()], 0.0, reverse)[0])
                    diff = torch.where(g == r, torch.zeros_like(g),
                                       (g - r).abs())
                    ok = bool((diff <= FLOAT_ADD_RTOL * bound + 1e-6).all())
                    e = float(diff.max()) if diff.numel() else 0.0
                else:
                    same = g == r
                    if g.dtype.is_floating_point:
                        same |= torch.isnan(g) & torch.isnan(r)
                    ok, e = bool(same.all()), 0
                if not ok:
                    raise AssertionError(
                        f"{self.case}: kernel B ({op_name}, {g.dtype}, sid "
                        f"{'given' if sid is not None else 'none'}) differs "
                        f"from its plain version")
                err = max(err, e)
            n = cols[0].shape[0]
            form = ("flat_segscan" if sid is not None
                    else "flat_segscan_one_segment")
            self._record(form, mod, before, n * len(cols), err,
                         (op_name, sid, cols, neutral, reverse),
                         f"{op_name} over {n} rows x {len(cols)} "
                         f"{cols[0].dtype} columns"
                         f"{', reversed' if reverse else ''}")
            return got
        return flat_segscan

    def _audit_onehot_groupby_sums(self, orig, mod):
        torch = self.torch

        def onehot_groupby_sums(key, value_cols, n_valid, key_min, span,
                                mask=None):
            value_cols = list(value_cols)
            before = mod.LAUNCHES
            got = orig(key, value_cols, n_valid, key_min, span, mask)
            if not self.armed or key.device.type != "cuda":
                return got
            ref = mod.onehot_groupby_sums_reference(
                key, value_cols, n_valid, key_min, span, mask)
            err = max(_word_err(torch, g, r) for g, r in zip(
                [got[0], *got[1], got[2]], [ref[0], *ref[1], ref[2]]))
            if err:
                raise AssertionError(f"{self.case}: kernel C differs from "
                                     f"its plain version at span {span}")
            self._record("onehot_groupby_sums", mod, before,
                         key.shape[0] * (1 + len(value_cols)), err,
                         (key, value_cols, n_valid, key_min, span, mask),
                         f"{key.shape[0]} rows, span {span}, "
                         f"{len(value_cols)} sum columns, "
                         f"{'a' if mask is not None else 'no'} mask")
            return got
        return onehot_groupby_sums

    def _audit_expand_fills(self, orig, mod):
        torch = self.torch

        def expand_fills(offsets, n_src, out_capacity, extra_values=()):
            extra_values = list(extra_values)
            before = mod.LAUNCHES
            got = orig(offsets, n_src, out_capacity, extra_values)
            if not self.armed or offsets.device.type != "cuda":
                return got
            ref = mod.expand_fills_reference(offsets, n_src, out_capacity,
                                             extra_values)
            err = max(_word_err(torch, g, r) for g, r in zip(
                [got[0], got[1], *got[2]], [ref[0], ref[1], *ref[2]]))
            if err:
                raise AssertionError(f"{self.case}: kernel D differs from "
                                     f"its plain version")
            self._record("expand_fills", mod, before,
                         out_capacity * (2 + len(extra_values)), err,
                         (offsets, n_src, out_capacity, extra_values),
                         f"{int(n_src)} segments of {offsets.shape[0]} into "
                         f"{out_capacity} slots, {len(extra_values)} extra "
                         f"planes")
            return got
        return expand_fills

    def report(self) -> dict:
        """Each form seen: its calls and launches over the audited runs,
        the largest error, and its largest call's shape, case, kernel time
        (and host time a call, and the kernel alone), plain-version time,
        bytes and library-call time. Every form must have been seen."""
        torch = self.torch
        missing = [f for f in self.FORMS if f not in self.forms]
        if missing:
            raise AssertionError(f"the mesh path made no call of {missing}")
        compact, segscan = self.mods["flat_compact"], self.mods["flat_segscan"]
        agg, expand = self.mods["onehot_groupby_sums"], self.mods["expand_fills"]
        out = {}
        for form, f in self.forms.items():
            args = f.pop("args")
            if form == "flat_compact":
                cols, mask, nv = args
                kernel = lambda: compact.flat_compact(cols, mask, nv)
                plain = lambda: compact.flat_compact_reference(cols, mask, nv)
                keep = mask & (torch.arange(mask.shape[0],
                                            device=mask.device) < nv)
                stacked = torch.stack(list(cols.values()))
                library = lambda: stacked[:, keep]
                nbytes = compact_bytes(torch, len(cols), mask, nv)
                name = "compact_kernel"
            elif form.startswith("flat_segscan"):
                op, sid, cols, ne, rev = args
                kernel = lambda: segscan.flat_segscan(op, sid, cols, ne, rev)
                plain = lambda: segscan.flat_segscan_reference(
                    op, sid, cols, ne, rev)
                lib_op = {"add": torch.cumsum, "mul": torch.cumprod,
                          "max": torch.cummax, "min": torch.cummin}[op]

                def library():
                    for c in cols:
                        x = torch.flip(c, [0]) if rev else c
                        lib_op(x, 0)
                library = library if sid is None else None
                nbytes = 4 * cols[0].shape[0] * (2 * len(cols)
                                                 + (sid is not None))
                name = "segscan_kernel"
            elif form == "onehot_groupby_sums":
                key, vals, nv, kmin, span, mask = args
                kernel = lambda: agg.onehot_groupby_sums(key, vals, nv, kmin,
                                                         span, mask)
                plain = lambda: agg.onehot_groupby_sums_reference(
                    key, vals, nv, kmin, span, mask)
                library = None
                nbytes = dense_agg_bytes(key, vals, mask, span)
                name = "dense_agg"
            else:
                offs, n_src, cap, extras = args
                kernel = lambda: expand.expand_fills(offs, n_src, cap, extras)
                plain = lambda: expand.expand_fills_reference(offs, n_src,
                                                              cap, extras)
                library = None
                nbytes = expand_bytes(offs, n_src, cap, extras)
                name = "expand_kernel"
            f["ms"], f["host_ms"] = time_cuda(torch, kernel, host=True)
            f["plain_ms"] = time_cuda(torch, plain)
            f["kernel_ms"] = kernel_only_ms(torch, kernel, name)
            if form == "onehot_groupby_sums":
                f["library_ms"] = library_index_add(
                    torch, time_cuda, key, vals[0], kmin, span, log)
            elif form == "expand_fills":
                f["library_ms"] = library_searchsorted(torch, time_cuda, offs,
                                                       n_src, cap)
            else:
                f["library_ms"] = (None if library is None
                                   else time_cuda(torch, library))
            f["bytes"] = nbytes
            del args
            out[form] = f
        return out


def mesh_rank(rank, size, coordinator, backend, device, results,
              audit=True) -> None:
    """One rank of phase 10 (a spawned process): every case of MESH_SETS
    through ``Context(mesh=...)`` with its launches counted (on rank 0,
    with ``audit``, every kernel call held against its plain version:
    :class:`MeshAudit`), then timed warm (each run starts after a
    barrier). Puts ``(rank, True, report)`` or ``(rank, False,
    traceback)``."""
    import traceback

    try:
        results.put((rank, True, _mesh_rank(rank, size, coordinator,
                                            backend, device, audit)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def _mesh_rank(rank, size, coordinator, backend, device, audit) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    import harkdb_tpu_torch as H
    # every module of the mesh path loaded before the audit first replaces
    # the wrappers wherever a module holds them
    import harkdb_tpu_torch.parallel.executor  # noqa: F401
    import harkdb_tpu_torch.plan.derived  # noqa: F401
    import harkdb_tpu_torch.plan.union_plan  # noqa: F401
    from harkdb_tpu_torch.kernels import compact, expand, matmul_agg, segscan
    from harkdb_tpu_torch.parallel.multihost import init_multihost
    from harkdb_tpu_torch.parallel.skew import detect_hot_keys

    counters = {"flat_compact": (compact, "LAUNCHES"),
                "flat_segscan": (segscan, "LAUNCHES"),
                "flat_segscan_one_segment": (segscan,
                                             "ONE_SEGMENT_LAUNCHES"),
                "onehot_groupby_sums": (matmul_agg, "LAUNCHES"),
                "expand_fills": (expand, "LAUNCHES")}
    # the card does the work; more host threads than cores per rank only
    # make the ranks' collectives wait on each other
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    mesh = init_multihost(coordinator, size, rank, backend=backend,
                          device=device, timeout_s=600)
    one = torch.ones(1, dtype=torch.int64, device=mesh.device)
    out = {"cases": {}, "launches": {k: 0 for k in counters}}
    auditor = MeshAudit(torch) if audit and rank == 0 else None
    try:
        for set_name, cases in MESH_SETS:
            tables = mesh_tables(set_name)
            for name, query, cfg in cases:
                ctx = H.Context(H.EngineConfig(**cfg), mesh=mesh)
                for tname, cols in tables.items():
                    ctx.create_table(tname, cols)
                if auditor is not None:
                    auditor.install(name)
                reset_launches(counters)
                try:
                    got = ctx.sql(query)
                    launches = read_launches(counters)
                finally:
                    if auditor is not None:
                        auditor.remove()
                short = [k for k in MESH_NEEDS.get(name, ())
                         if launches[k] == 0]
                if short:
                    raise AssertionError(f"{name}: rank {rank} never "
                                         f"launched {short}: {launches}")
                for k, n in launches.items():
                    out["launches"][k] += n
                times = []
                for _ in range(5):
                    mesh.all_reduce(one)               # start together
                    torch.cuda.synchronize(mesh.device)
                    t0 = time.perf_counter()
                    ctx.sql(query)
                    torch.cuda.synchronize(mesh.device)
                    times.append((time.perf_counter() - t0) * 1e3)
                entry = {"digest": _digest(got), "launches": launches,
                         "ms": statistics.median(times), "all_ms": times,
                         "last_fast_span": getattr(ctx._plan(query),
                                                   "last_fast_span", None),
                         "profile": mesh_profile(torch, ctx, query,
                                                 rank == 0)}
                if rank == 0:
                    entry["result"] = got
                if name == "skewed_join":
                    sb = ctx._shard_cache[("facts", "facts", None)]
                    H_, HV = detect_hot_keys(sb.columns["facts.k"], sb.count,
                                             mesh.size, 0.25, mesh)
                    entry["hot_keys"] = sorted(H_[HV].tolist())
                out["cases"][name] = entry
                del ctx
            del tables
            torch.cuda.empty_cache()
        if auditor is not None:
            out["audit"] = auditor.report()
        mesh.all_reduce(one)          # the others wait while rank 0 times
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return out


def mesh_profile(torch, ctx, query, on: bool, top: int = 12) -> dict:
    """One more run of ``query`` on every rank (the collectives need them
    all), under torch.profiler where ``on``: wall time, the device's busy
    time, and the host operators with the most self time (the
    collectives and the card-to-host copies of a gloo mesh among them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not on:
        ctx.sql(query)
        return {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.sql(query)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA) / 1e3
    host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                   for a in prof.key_averages()),
                  key=lambda x: -x[1])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "host_self_ms": host}


def run_mesh(torch, backend: str, n_ranks: int, devices, timeout_s=900,
             target=None):
    """Spawn ``n_ranks`` processes of ``target`` (:func:`mesh_rank` by
    default; rank r on ``devices[r]``) and collect their reports; a failing
    or silent rank kills them all and raises."""
    import multiprocessing
    import queue
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target or mesh_rank, args=(
        r, n_ranks, coordinator, backend, devices[r], results))
        for r in range(n_ranks)]
    for p in procs:
        p.start()
    reports, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(reports) < n_ranks:
            try:
                rank, ok, value = results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(
                    f"mesh phase: ranks {sorted(set(range(n_ranks)) - set(reports))}"
                    f" gave no answer in {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"mesh phase: rank {rank} failed:\n{value}")
            reports[rank] = value
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [reports[r] for r in range(n_ranks)]


def single_device_results(torch, H) -> dict:
    """Every phase 10 case through ``Context(device="cuda")``."""
    out = {}
    for set_name, cases in MESH_SETS:
        tables = mesh_tables(set_name)
        for name, query, cfg in cases:
            ctx = H.Context(H.EngineConfig(**cfg), device="cuda")
            for tname, cols in tables.items():
                ctx.create_table(tname, cols)
            out[name] = ctx.sql(query)
            del ctx
        del tables
        torch.cuda.empty_cache()
    return out


def bucketize_forms(torch, n=N_MAIN // MESH_RANKS) -> dict:
    """The exchange's stable partition by destination rank at a rank's
    share of bench-2^24 (2^22 rows, three int32 words a row, 4 buckets):
    four launches of kernel A, one per bucket (``parallel/shuffle.
    bucketize``, the port's form) against one stable sort of the
    destinations and a gather of the word matrix; the same rows in the
    same order, CUDA events."""
    from harkdb_tpu_torch.parallel.shuffle import bucketize, hash_to_bucket

    gen = torch.Generator(device="cuda").manual_seed(0)
    words = torch.randint(-2**31, 2**31 - 1, (n, 3), dtype=torch.int32,
                          device="cuda", generator=gen)
    cols = [words[:, j].contiguous() for j in range(3)]
    dest = hash_to_bucket(cols[0], MESH_RANKS)
    nv = torch.full((), n, dtype=torch.int32, device="cuda")

    def by_kernel_a():
        return bucketize(cols, dest, nv, MESH_RANKS)

    def by_sort():
        order = torch.sort(dest.to(torch.uint8), stable=True).indices
        return words[order]

    buckets, counts = by_kernel_a()
    sorted_rows, start = by_sort(), 0
    for j, c in enumerate(counts.tolist()):
        if not torch.equal(torch.stack([w[:c] for w in buckets[j]], 1),
                           sorted_rows[start:start + c]):
            raise AssertionError(f"bucket {j}: the two partitions differ")
        start += c
    out = {"kernel_a_ms": time_cuda(torch, by_kernel_a),
           "sort_ms": time_cuda(torch, by_sort)}
    log(f"exchange partition of {n:,} rows x 3 words into {MESH_RANKS} "
        f"buckets: {MESH_RANKS} launches of kernel A (the port's form) "
        f"{out['kernel_a_ms']:.4f} ms, stable sort + gather "
        f"{out['sort_ms']:.4f} ms; the same rows")
    return out


def check_mesh_audit(rank0: dict, label: str) -> dict:
    """Rank 0's :class:`MeshAudit` report: it must have seen every launch
    the counters saw (so every kernel call of the mesh path was held
    against its plain version); logs each form's row."""
    audit, seen = rank0["audit"], rank0["launches"]
    by_form = {f: a["launches"] for f, a in audit.items()}
    want = dict(seen)
    want["flat_segscan"] -= seen["flat_segscan_one_segment"]
    if by_form != want:
        raise AssertionError(f"{label}: the audit saw launches {by_form}, "
                             f"the counters {want}")
    for form, a in audit.items():
        log(f"{label} rank 0, {form} at the mesh path's shapes: {a['calls']} "
            f"calls, {a['launches']} launches, each equal to its plain "
            f"version (max abs err {a['max_abs_err']}); largest call "
            f"({a['case']}: {a['shape']}) {a['ms']:.4f} ms (host "
            f"{a['host_ms']:.4f}, kernel alone {a['kernel_ms']:.4f}) vs "
            f"plain {a['plain_ms']:.4f} ms vs library {a['library_ms']} ms, "
            f"bound {a['bytes'] / HBM_BYTES_PER_MS:.4f} ms")
    return audit


def phase_mesh(torch, H) -> dict:
    """Phase 10: MESH_SETS' queries on MESH_RANKS gloo ranks sharing
    ``cuda:0``, every rank's whole result against the numpy oracle and
    the single-device port's, bit for bit; kernels A-D launched on every
    rank; each query timed warm. Then the same on NCCL, one rank per card,
    where more than one card is visible."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    oracles = mesh_oracles()
    single = single_device_results(torch, H)
    for name, expect in oracles.items():
        if not np.array_equal(single[name], expect):
            raise AssertionError(f"{name}: the single-device port differs "
                                 f"from its numpy oracle")
    log(f"phase 10 oracles and single-device results: "
        f"{time.perf_counter() - t0:.1f} s")
    report = {"note": MESH_NOTE, "runs": {}}
    runs = [("gloo", MESH_RANKS, ["cuda:0"] * MESH_RANKS)]
    cards = torch.cuda.device_count()
    if cards > 1:
        n = min(cards, MESH_RANKS)
        runs.append(("nccl", n, [f"cuda:{r}" for r in range(n)]))
    else:
        log(f"NCCL mesh run skipped: {cards} card visible, NCCL needs a "
            f"card per rank")
    for backend, n_ranks, devices in runs:
        t0 = time.perf_counter()
        ranks = run_mesh(torch, backend, n_ranks, devices)
        wall = time.perf_counter() - t0
        for r, rep in enumerate(ranks):
            for name, entry in rep["cases"].items():
                if entry["digest"] != ranks[0]["cases"][name]["digest"]:
                    raise AssertionError(f"{backend} {name}: rank {r}'s "
                                         f"result differs from rank 0's")
            short = [k for k in ("flat_compact", "flat_segscan",
                                 "onehot_groupby_sums", "expand_fills")
                     if rep["launches"][k] == 0]
            if short:
                raise AssertionError(f"{backend}: rank {r} never launched "
                                     f"{short}: {rep['launches']}")
        cases = ranks[0]["cases"]
        for name, entry in cases.items():
            got = entry.pop("result")
            entry["rows"] = got.shape[0]
            for what, expect in (("numpy oracle", oracles[name]),
                                 ("single-device port", single[name])):
                if got.shape != expect.shape or not np.array_equal(got,
                                                                   expect):
                    raise AssertionError(f"{backend} {name} differs from "
                                         f"the {what}")
        if cases["star_join"]["last_fast_span"] != DIM_SPAN:
            raise AssertionError("the distributed star join skipped the "
                                 "dense path (kernel C)")
        if SKEW_KEY not in cases["skewed_join"]["hot_keys"]:
            raise AssertionError("the skewed join's hot key was not "
                                 "nominated for salting")
        label = (MESH_NOTE if backend == "gloo"
                 else f"{n_ranks} ranks, one card each")
        for name, entry in cases.items():
            log(f"mesh {backend} x{n_ranks} {name}: {entry['rows']:,} rows "
                f"equal to the numpy oracle and the single-device port on "
                f"every rank; median {entry['ms']:.3f} ms of "
                f"{[round(t, 3) for t in entry['all_ms']]} ({label}); rank 0 "
                f"launches {entry['launches']}")
        for name, entry in cases.items():
            prof = entry.pop("profile")
            log(f"mesh {backend} x{n_ranks} {name} profiled on rank 0: wall "
                f"{prof['wall_ms']:.3f} ms, device busy "
                f"{prof['device_busy_ms']:.3f} ms "
                f"({100 * prof['device_busy_ms'] / prof['wall_ms']:.1f}%); "
                f"host self time (ms, calls): "
                + "; ".join(f"{k[:40]} {ms:.2f} x{c}"
                            for k, ms, c in prof["host_self_ms"]))
            entry["device_busy_ms"] = prof["device_busy_ms"]
        log(f"mesh {backend} x{n_ranks}: launches per rank over the phase "
            f"{[rep['launches'] for rep in ranks]}; hot keys of the skewed "
            f"join {cases['skewed_join']['hot_keys']}; {wall:.1f} s")
        audit = check_mesh_audit(ranks[0], f"mesh {backend} x{n_ranks}")
        report["runs"][backend] = {
            "ranks": n_ranks, "devices": devices, "seconds": wall,
            "query_ms": {n: e["ms"] for n, e in cases.items()},
            "device_busy_ms": {n: e["device_busy_ms"]
                               for n, e in cases.items()},
            "launches_per_rank": [rep["launches"] for rep in ranks],
            "audit": audit,
            "launches_by_case": {
                n: [rep["cases"][n]["launches"] for rep in ranks]
                for n in cases},
        }
    report["bucketize"] = bucketize_forms(torch)
    return report


# -- phase 11: the public primitives and the top-k LIMIT path --------------------

# The plain versions phase 11 must never run on a CUDA tensor: (module of
# the port, name).
PLAIN_VERSIONS = (
    ("kernels.segscan", "flat_segscan_reference"),
    ("kernels.segscan", "doubling_segmented_scan"),
    ("kernels.compact", "flat_compact_reference"),
    ("kernels.expand", "expand_fills_reference"),
    ("prims.segmented", "doubling_segmented_scan"),
    ("prims.segmented", "_pair_scan"),
    ("kernels.radix_sort", "sort_pairs_reference"),
    ("kernels.join_runs", "join_words_reference"),
    ("kernels.join_runs", "join_runs_reference"),
)


class PlainGuard:
    """While installed, a plain version (``PLAIN_VERSIONS``) called with a
    CUDA tensor raises; CPU tensors pass, so the CPU plain results can be
    computed under it."""

    def __init__(self, torch):
        import importlib

        self.torch = torch
        self.saved = []
        for mod_name, name in PLAIN_VERSIONS:
            mod = importlib.import_module(f"harkdb_tpu_torch.{mod_name}")
            self.saved.append((mod, name, getattr(mod, name)))

    def _on_card(self, x) -> bool:
        if isinstance(x, self.torch.Tensor):
            return x.is_cuda
        if isinstance(x, (list, tuple)):
            return any(self._on_card(y) for y in x)
        if isinstance(x, dict):
            return any(self._on_card(y) for y in x.values())
        return False

    def __enter__(self):
        for mod, name, fn in self.saved:
            def guarded(*args, _fn=fn, _name=name, **kw):
                if self._on_card(args) or self._on_card(kw):
                    raise AssertionError(f"plain version {_name} ran on "
                                         f"the card")
                return _fn(*args, **kw)
            setattr(mod, name, guarded)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def prims_data(n: int):
    """Phase 11's inputs on the host: segment flags over ``n`` rows with
    segment sizes in [1, 64] from a seed, one value column per (op, dtype),
    expand's ``n / 16`` sizes in [0, 32) (about ``n`` outputs) and two
    gather planes, compaction masks."""
    rng = np.random.default_rng(11)
    ends = np.cumsum(rng.integers(1, 65, n // 16 + 1))
    flags = np.zeros(n, bool)
    flags[0] = True
    flags[ends[ends < n]] = True
    vals = {}
    for dtype in ("int32", "float32"):
        for op in ("add", "max", "min", "mul"):
            if dtype == "int32":
                lo, hi = (-9, 9) if op == "mul" else (-2**31, 2**31 - 1)
                x = rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)
            elif op == "mul":
                x = rng.uniform(0.5, 1.5, n).astype(np.float32)
            else:
                x = rng.standard_normal(n).astype(np.float32)
                if op != "add":
                    x[rng.random(n) < 0.01] = np.nan
            vals[op, dtype] = x
    m = n // 16
    sizes = rng.integers(0, 32, m).astype(np.int32)
    planes = (rng.integers(-2**20, 2**20, m).astype(np.int32),
              rng.integers(-8, 8, m).astype(np.int32))
    masks = {sel: rng.random(n) < sel for sel in (0.5, 0.01)}
    return flags, vals, sizes, planes, masks


def _same(torch, got, ref, op, bound=None) -> bool:
    """Phase 3's rule: integers bit for bit; float max / min equal or NaN
    in both; float add within FLOAT_ADD_RTOL of the |x| scan ``bound``,
    float mul within FLOAT_ADD_RTOL of the value."""
    got = got.cpu()
    if not got.dtype.is_floating_point:
        return torch.equal(got, ref)
    both_nan = torch.isnan(got) & torch.isnan(ref)
    if op in ("max", "min"):
        return bool(((got == ref) | both_nan).all())
    scale = ref.abs() if op == "mul" else bound
    diff = torch.where(got == ref, torch.zeros_like(got), (got - ref).abs())
    return bool(((diff <= FLOAT_ADD_RTOL * scale + 1e-6) | both_nan).all())


def phase_prims(torch, counters, dev, n: int = N_MAIN) -> dict:
    """Phase 11 (a): ``harkdb_tpu_torch.prims`` at ``n`` rows on ``dev``.
    Each call runs with the launch counts set to 0 just before and read
    just after: it must launch the kernels it should (A, B or D) and equal
    the same call on the CPU (the plain versions); no plain version may
    run on the card (``PlainGuard``). Then each call is timed (CUDA
    events, mean of 5 after 1 warm-up)."""
    import harkdb_tpu_torch.prims as P

    ops = {"add": torch.add, "max": torch.maximum, "min": torch.minimum,
           "mul": torch.mul}
    flags, vals, sizes, planes, masks = prims_data(n)
    cpu = torch.device("cpu")
    on = {d: {"flags": torch.from_numpy(flags).to(d),
              "sizes": torch.from_numpy(sizes).to(d),
              "planes": [torch.from_numpy(p).to(d) for p in planes]}
          for d in (dev, cpu)}
    cases = []           # (name, fn(device) -> tuple, need, op, bound)
    n_valid = n - 12345
    for (op, dtype), x in vals.items():
        xs = {d: torch.from_numpy(x).to(d) for d in (dev, cpu)}
        ne = scan_neutral(op, dtype)
        scan_bound = reduce_bound = None
        if (op, dtype) == ("add", "float32"):
            absx = xs[cpu].abs()
            scan_bound = P.segmented_scan(torch.add, 0, on[cpu]["flags"],
                                          absx)
            reduce_bound = P.segmented_reduce(torch.add, 0, on[cpu]["flags"],
                                              absx, n_valid)[0]
        cases.append((
            f"segmented_scan {op} {dtype}",
            lambda d, f=ops[op], ne=ne, xs=xs: (
                P.segmented_scan(f, ne, on[d]["flags"], xs[d]),),
            {"flat_segscan": 1}, op, scan_bound))
        cases.append((
            f"segmented_reduce {op} {dtype}",
            lambda d, f=ops[op], ne=ne, xs=xs: P.segmented_reduce(
                f, ne, on[d]["flags"], xs[d], n_valid),
            {"flat_segscan": 1, "flat_compact": 1}, op, reduce_bound))
    out_cap = int(sizes.sum())

    def get_for(d):
        a, b = on[d]["planes"]
        return lambda s, loc: a[s] + b[s] * loc

    expand_need = {"expand_fills": 1, "flat_segscan_one_segment": 1}
    cases += [
        ("expand", lambda d: P.expand(on[d]["sizes"], get_for(d), out_cap),
         expand_need, "get", None),
        ("expand_reduce add", lambda d: P.expand_reduce(
            on[d]["sizes"], get_for(d), torch.add, 0, out_cap),
         dict(expand_need, flat_segscan=2), "add", None),
        ("expand_outer_reduce max", lambda d: P.expand_outer_reduce(
            on[d]["sizes"], get_for(d), torch.maximum, 0, out_cap),
         dict(expand_need, flat_segscan=2), "max", None),
    ]
    words = {d: torch.from_numpy(vals["max", "int32"]).to(d)
             for d in (dev, cpu)}
    for sel, m in masks.items():
        ms = {d: torch.from_numpy(m).to(d) for d in (dev, cpu)}
        cases.append((f"compact {sel:.0%}", lambda d, ms=ms: P.compact(
            words[d], ms[d]), {"flat_compact": 1}, "get", None))

    log(f"phase 11 prims: {n:,} rows, segments of 1-64 rows; expand: "
        f"{sizes.shape[0]:,} sizes into {out_cap:,} slots")
    report = {}
    with PlainGuard(torch):
        for name, fn, need, op, bound in cases:
            reset_launches(counters)
            got = fn(dev)
            torch.cuda.synchronize()
            launches = read_launches(counters)
            short = {k: (launches[k], v) for k, v in need.items()
                     if launches[k] < v}
            if short:
                raise AssertionError(f"prims {name} skipped a kernel "
                                     f"(launched, needed): {short}")
            ref = fn(cpu)
            for g, r in zip(got, ref):
                if not _same(torch, g, r, op, bound):
                    raise AssertionError(f"prims {name} differs from the "
                                         f"CPU plain result")
            ms = time_cuda(torch, lambda: fn(dev), iters=5, warmup=1)
            report[name] = {"ms": ms, "launches": launches}
            log(f"prims {name}: equal to the CPU plain result; launches "
                f"{launches}; {ms:.4f} ms")
    return report


# Phase 11 (b): (name, query with {} for the LIMIT, its LIMIT). Each runs
# at its LIMIT (top-k, at most 1024 with the OFFSET) and at 1025 (the
# sort); a query over ``tf`` reads the NaN table.
TOPK_CASES = [
    ("v_desc", "select k, v from t order by v desc limit {}", 10),
    ("v_asc", "select k, v from t order by v limit {}", 1024),
    ("where_k_desc", "select k, v from t where v > 0 order by k desc "
                     "limit {} offset 20", 100),
    ("f_nan_asc", "select k, f from tf order by f limit {}", 10),
    ("f_nan_desc", "select k, f from tf order by f desc limit {}", 10),
]
# The JAX package's rows (the k column) for the NaN table's two top-10
# queries, from ``harkdb_tpu.Context`` on the CPU over the table's first
# 4096 rows, which hold every planted NaN: both answers are NaNs alone,
# so they are the answers over all 2^24 rows too.
JAX_NAN_TOP10 = {
    "f_nan_asc": [11, 642, 695, 924, 1623, 1828, 1902, 2178, 2448, 2451],
    "f_nan_desc": [257, 462, 1269, 1680, 1883, 1888, 2332, 2457, 2691, 3221],
}
NAN_PREFIX = 4096


def nan_table(n: int):
    """The NaN table: k = 0..n-1, f = bench-2^24's v / 8 as float32 (many
    ties), with 16 each of -NaN, +NaN, -inf, +inf, -0.0 and 0.0 planted at
    seeded positions among the first ``NAN_PREFIX`` rows."""
    _k, v = table_data(n)
    f = (v / 8).astype(np.float32)
    rng = np.random.default_rng(12)
    pos = rng.choice(NAN_PREFIX, 96, replace=False)
    nan = np.float32(np.nan)
    specials = np.array([-nan, nan, -np.inf, np.inf, -0.0, 0.0],
                        np.float32)
    specials[0] = np.copysign(nan, np.float32(-1))
    f[pos] = np.repeat(specials, 16)
    return {"k": np.arange(n, dtype=np.int32), "f": f}


def route_view(key: np.ndarray) -> np.ndarray:
    """``ops.sort.ieee_order_view``'s ascending order in numpy (int64):
    floats by their IEEE bits, negative patterns mapped below the positive
    ones."""
    if key.dtype == np.float32:
        bits = key.view(np.int32).astype(np.int64)
        return np.where(bits < 0, -(1 << 31) - bits, bits)
    return key.astype(np.int64)


def topk_oracle_rows(tables, query: str, limit: int) -> np.ndarray:
    """A TOPK_CASES query in numpy. At a LIMIT + OFFSET of at most 1024,
    a stable sort on the view (the reference's top-k order: ties by the
    lowest index); above, a stable sort on the key itself (-0.0 equal to
    0.0, every NaN last)."""
    cols = tables["tf"] if " tf " in query else tables["t"]
    key = "f" if " tf " in query else ("k" if "order by k" in query else "v")
    desc = " desc " in query
    offset = 20 if "offset 20" in query else 0
    out = ["k", key] if key != "k" else ["k", "v"]
    idx = np.arange(cols["k"].shape[0])
    if "where v > 0" in query:
        idx = idx[cols["v"] > 0]
    kv = cols[key][idx]
    if limit + offset <= 1024:
        order_key = route_view(kv)
    else:
        order_key = kv.astype(np.float64 if kv.dtype == np.float32
                              else np.int64)
    order = np.argsort(-order_key if desc else order_key, kind="stable")
    sel = idx[order][offset:offset + limit]
    return np.stack([cols[c][sel] for c in out], axis=1)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint64) if a.dtype == np.float64 else a


def phase_topk(torch, H, counters) -> dict:
    """Phase 11 (b): TOPK_CASES on bench-2^24's table and the NaN table,
    each at its LIMIT and at 1025, against its numpy oracle (and the JAX
    package's written-down rows for the NaN table). A spy on the planner's
    ``top_k_indices`` must count one selection for each query at most 1024
    and none at 1025. Each query is then timed warm (median of 5) and
    profiled (device-busy share)."""
    from harkdb_tpu_torch.plan import planner

    k_np, v_np = table_data(N_MAIN)
    tables = {"t": {"k": k_np, "v": v_np}, "tf": nan_table(N_MAIN)}
    ctx, load_s = load_context(torch, H, tables)
    log(f"phase 11 tables t and tf ({N_MAIN:,} rows each): load "
        f"{load_s:.2f} s")
    calls = []
    real = planner.top_k_indices

    def spy(view, k):
        calls.append(k)
        return real(view, k)

    report = {}
    for name, query, limit in TOPK_CASES:
        for lim in (limit, 1025):
            q = query.format(lim)
            expect = topk_oracle_rows(tables, q, lim)
            calls.clear()
            planner.top_k_indices = spy
            try:
                reset_launches(counters)
                got = ctx.sql(q)
                launches = read_launches(counters)
            finally:
                planner.top_k_indices = real
            if got.shape != expect.shape or not np.array_equal(
                    _bits(got), _bits(expect)):
                raise AssertionError(f"top-k {name} at limit {lim} differs "
                                     f"from its numpy oracle")
            jax_rows = JAX_NAN_TOP10.get(name)
            if lim == limit and jax_rows is not None and (
                    got[:, 0].astype(np.int64).tolist() != jax_rows):
                raise AssertionError(f"top-k {name} differs from the JAX "
                                     f"package's rows")
            want_calls = [lim + (20 if "offset 20" in q else 0)] \
                if lim == limit else []
            if calls != want_calls:
                raise AssertionError(f"top-k {name} at limit {lim}: "
                                     f"selections {calls}, expected "
                                     f"{want_calls}")
            ms, times = time_query(torch, ctx, q)
            busy_ms, wall_ms = profile_query(torch, ctx, q, top=6)
            report[f"{name}_{lim}"] = {
                "ms": ms, "times": times, "busy_ms": busy_ms,
                "busy_share": busy_ms / wall_ms, "selections": len(calls),
                "launches": launches}
            log(f"top-k {name} limit {lim}: {got.shape[0]:,} rows equal "
                f"the oracle; selections {len(calls)}; launches "
                f"{launches}; median {ms:.3f} ms of {times}; device busy "
                f"{100 * busy_ms / wall_ms:.1f}%")
        a, b = report[f"{name}_{limit}"], report[f"{name}_1025"]
        log(f"top-k {name}: limit {limit} {a['ms']:.3f} ms "
            f"({100 * a['busy_share']:.1f}% busy) vs limit 1025 (sort) "
            f"{b['ms']:.3f} ms ({100 * b['busy_share']:.1f}% busy)")
    del ctx
    torch.cuda.empty_cache()
    return report


def phase_11(torch, H, counters) -> dict:
    """Phase 11: the public primitives (a) and the top-k path (b)."""
    out = {"prims": phase_prims(torch, counters, torch.device("cuda")),
           "topk": phase_topk(torch, H, counters)}
    torch.cuda.empty_cache()
    log("phase 11: " + json.dumps(out))
    return out


# -- phase 12: the public ops on the card at full width ------------------------

# Phase 12's dims keep their last 2^16 rows past n_valid, so about one fact
# in sixteen finds no match and the LEFT join differs from the inner one.
DIMS_PAST_VALID = 1 << 16
ENTRY_AGGS = [("v", "sum", "s"), ("v", "max", "m"), ("v", "count", "c")]


def entry_step(batch):
    """The port's form of ``__graft_entry__.entry()``'s ``query_step``: the
    rows of ``batch`` with ``v > 0`` compacted (kernel A), then grouped by
    ``k`` with sum, max and count (kernel B for the max, kernel A for the
    segment ends), groups in ascending key order. Returns ``query_step``'s
    tuple ``(k, s, m, c, n_valid)``."""
    from harkdb_tpu_torch.ops import groupby_batch
    from harkdb_tpu_torch.prims import compact_batch

    mask = (batch.column("v") > 0) & batch.valid_mask()
    out = groupby_batch(compact_batch(batch, mask), "k", ENTRY_AGGS)
    return (out.column("k"), out.column("s"), out.column("m"),
            out.column("c"), out.n_valid)


def join_oracle(k, j, n_dims: int, kind: str):
    """The join of facts ``k`` with the first ``n_dims`` dims rows in numpy
    (``j`` a permutation of [0, len(j)) holding every fact key): facts in
    stable key order, each with the dims row of its key. Returns ``(l_idx,
    r_idx, matched)`` as int32, int32, bool; LEFT keeps the unmatched facts
    with ``r_idx`` 0."""
    pos = np.full(j.shape[0], -1, np.int64)
    pos[j[:n_dims]] = np.arange(n_dims)
    order = np.argsort(k, kind="stable")
    r = pos[k[order]]
    hit = r >= 0
    if kind == "inner":
        order, r, hit = order[hit], r[hit], hit[hit]
    return (order.astype(np.int32), np.where(hit, r, 0).astype(np.int32),
            hit)


def _host(out) -> dict:
    """A public op's result as named host arrays: a ColumnBatch's live rows
    and count; a dict's tensors whole; a tuple ending in a count, the first
    ``count`` rows of the other tensors and the count as an int."""
    from harkdb_tpu_torch.columnar.batch import ColumnBatch

    if isinstance(out, dict):
        return {name: t.cpu().numpy() for name, t in out.items()}
    if isinstance(out, ColumnBatch):
        cols, n_name, n = out.columns.items(), "n_valid", int(out.n_valid)
    else:
        cols, n_name, n = enumerate(out[:-1]), str(len(out) - 1), int(out[-1])
    res = {str(name): t[:n].cpu().numpy() for name, t in cols}
    res[n_name] = n
    return res


def _equal(a, b) -> bool:
    """Every output of phase 12 is an integer or bool: equal bit for bit."""
    if isinstance(a, int) or isinstance(b, int):
        return a == b
    return a.dtype == b.dtype and np.array_equal(a, b)


def median_event_ms(torch, fn, reps=5):
    """Median of ``reps`` CUDA-event times (ms), one call of ``fn`` each,
    after one warm-up. The queue is empty before each call, so a call whose
    host work outlasts its device work is timed with that host work."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


# matmul_agg_applicable's answers at the edges of the dense GROUP BY's gate
# (sum and count only, span at most 16384).
DENSE_GATE_EDGES = {
    (("sum", "count"), 16384): True, (("sum",), 16385): False,
    (("count",), 1): True, (("sum", "max"), 4096): False,
    (("min",), 1): False, ((), 16384): True,
}


def public_ops_oracles(facts, dims, n_dims: int) -> dict:
    """Phase 12's expected results in numpy, by case name, in ``_host``'s
    form."""
    k, v = facts["k"], facts["v"]
    rows = oracle(k, v)
    rows = rows[np.argsort(rows[:, 0], kind="stable")]    # by key
    out = {"entry_step": {**{str(i): rows[:, i] for i in range(4)},
                          "4": rows.shape[0]}}
    for kind in ("inner", "left"):
        li, ri, hit = join_oracle(k, dims["j"], n_dims, kind)
        n = li.shape[0]
        out[f"join_match_count {kind}"] = {"0": n}
        out[f"join_indices {kind}"] = {"0": li, "1": ri, "2": hit, "3": n}
        out[f"join_batches {kind}"] = {
            "k": k[li], "v": v[li],
            "g": np.where(hit, dims["g"][ri], 0).astype(np.int32),
            "matched": hit.astype(np.int32), "n_valid": n}
        if kind == "inner":
            out["inner_join_indices"] = {"0": li, "1": ri, "2": n}
            g_in, v_in = dims["g"][ri], v[li]
    for name, keep in (("onehot_groupby_sums", slice(None)),
                       ("onehot_groupby_sums mask", v_in > 0)):
        sums = np.bincount(g_in[keep], weights=v_in[keep].astype(np.int64),
                           minlength=DIM_SPAN).astype(np.int64)
        out[name] = {
            "counts": np.bincount(g_in[keep],
                                  minlength=DIM_SPAN).astype(np.int32),
            "sums": sums.astype(np.uint32).astype(np.int32),
            "keys": np.arange(DIM_SPAN, dtype=np.int32)}
    order = np.lexsort((-v.astype(np.int64), k))     # k asc, then v desc
    out["sort_permutation"] = {"perm": order.astype(np.int32)}
    out["sort_batch"] = {"k": k[order], "v": v[order],
                         "n_valid": k.shape[0]}
    return out


def public_ops_cases(torch, n: int):
    """Phase 12's calls: (name, call(batches) -> result, the launches it
    needs). ``batches`` holds the ``facts`` and ``dims`` batches and the
    inner join's output ``joined`` (kernel C's input) on one device."""
    from harkdb_tpu_torch.kernels import onehot_groupby_sums
    import harkdb_tpu_torch.ops as O

    def keys(b):
        f, d = b["facts"], b["dims"]
        return f.column("k"), f.n_valid, d.column("j"), d.n_valid

    def onehot(b, masked):
        j = b["joined"]
        v = j.column("v")
        counts, sums, axis = onehot_groupby_sums(
            j.column("g"), [v], j.n_valid, 0, DIM_SPAN,
            mask=(v > 0) if masked else None)
        return {"counts": counts, "sums": sums[0], "keys": axis}

    def sort_perm(b):
        f = b["facts"]
        perm, _keys = O.sort_permutation([f.column("k"), f.column("v")],
                                         f.n_valid, [False, True])
        return {"perm": perm}

    ranges = {"join_words": 1, "join_runs": 1}
    pairs = dict(ranges, flat_compact=1, expand_fills=1)
    cases = [("entry_step", lambda b: entry_step(b["facts"]),
              {"flat_compact": 2, "flat_segscan": 1})]
    for kind in ("inner", "left"):
        cases += [
            (f"join_match_count {kind}", lambda b, kind=kind: (
                O.join_match_count(*keys(b), kind=kind),), ranges),
            (f"join_indices {kind}", lambda b, kind=kind: O.join_indices(
                *keys(b), n, kind=kind), pairs),
            (f"join_batches {kind}", lambda b, kind=kind: O.join_batches(
                b["facts"], b["dims"], "k", "j", n,
                l_out={"k": "k", "v": "v"}, r_out={"g": "g"}, kind=kind,
                matched_out="matched"), pairs),
        ]
    cases += [
        ("inner_join_indices", lambda b: O.inner_join_indices(*keys(b), n),
         pairs),
        ("onehot_groupby_sums", lambda b: onehot(b, False),
         {"onehot_groupby_sums": 1}),
        ("onehot_groupby_sums mask", lambda b: onehot(b, True),
         {"onehot_groupby_sums": 1}),
        ("sort_permutation", sort_perm, {}),
        ("sort_batch", lambda b: O.sort_batch(b["facts"], ["k", "v"],
                                              [False, True]), {}),
    ]
    return cases


def phase_public_ops(torch, H, counters, n: int = N_MAIN,
                     n_keys: int = N_KEYS) -> dict:
    """Phase 12: the public ``ops`` and ``kernels`` entry points on the card
    at bench-2^24's facts and star-join-2^24's dims (``n`` facts over
    ``n_keys`` keys): the entry step, the join ops between facts ``k`` and
    dims ``j`` (inner and LEFT), kernel C's ``onehot_groupby_sums`` over the
    joined ``g`` with and without a mask, and ``sort_permutation`` /
    ``sort_batch`` on ``(k, v)``. The card's batches and a ``Table`` are
    built with no device argument, so the entry points' default must put
    them on the card. Each call runs with the launch counts set to 0 just
    before and read just after, under ``PlainGuard``: it must launch the
    kernels it needs and equal both the same call on CPU tensors (the plain
    versions) and its numpy oracle. Each is then timed (CUDA events, median
    of 5), the entry step also profiled (device-busy share)."""
    from harkdb_tpu_torch.columnar.batch import ColumnBatch
    from harkdb_tpu_torch.kernels import matmul_agg_applicable
    import harkdb_tpu_torch.ops as O

    facts, dims = star_data(n, n_keys)
    n_dims = n_keys - min(DIMS_PAST_VALID, n_keys // 16)
    table = H.Table("t", facts)
    if table.device.type != "cuda" or not all(
            c.is_cuda for c in table.columns.values()):
        raise AssertionError("Table with no device argument left its "
                             "columns off the card")
    del table
    on_card = {"facts": ColumnBatch.from_numpy(facts),
               "dims": ColumnBatch.from_numpy(dims)}
    on_cpu = {"facts": ColumnBatch.from_numpy(facts, device="cpu"),
              "dims": ColumnBatch.from_numpy(dims, device="cpu")}
    if not all(c.is_cuda for b in on_card.values()
               for c in (*b.columns.values(), b.n_valid)):
        raise AssertionError("ColumnBatch.from_numpy with no device "
                             "argument left a tensor off the card")
    for b in (on_card, on_cpu):
        d = b["dims"]
        b["dims"] = ColumnBatch(d.columns, torch.full(
            (), n_dims, dtype=torch.int32, device=d.device))
    for (ops, span), want in DENSE_GATE_EDGES.items():
        if matmul_agg_applicable(list(ops), span) != want:
            raise AssertionError(f"matmul_agg_applicable({list(ops)}, "
                                 f"{span}) is not {want}")
    expect = public_ops_oracles(facts, dims, n_dims)
    log(f"phase 12: {n:,} facts, {n_keys:,} dims ({n_dims:,} live); Table "
        f"and batches on the card with no device argument; "
        f"matmul_agg_applicable right at {len(DENSE_GATE_EDGES)} gate edges")
    report = {}
    with PlainGuard(torch):
        for b in (on_card, on_cpu):
            b["joined"] = O.join_batches(b["facts"], b["dims"], "k", "j", n,
                                         l_out={"v": "v"}, r_out={"g": "g"})
        for name, call, need in public_ops_cases(torch, n):
            reset_launches(counters)
            got = call(on_card)
            torch.cuda.synchronize()
            launches = read_launches(counters)
            short = {k: (launches[k], v) for k, v in need.items()
                     if launches[k] < v}
            if short:
                raise AssertionError(f"{name} skipped a kernel (launched, "
                                     f"needed): {short}")
            got, ref = _host(got), _host(call(on_cpu))
            for key, want in expect[name].items():
                if not _equal(got[key], ref[key]):
                    raise AssertionError(f"{name} {key}: the card differs "
                                         f"from the CPU plain result")
                if not _equal(got[key], want):
                    raise AssertionError(f"{name} {key} differs from its "
                                         f"numpy oracle")
            ms, times = median_event_ms(torch, lambda: call(on_card))
            report[name] = {"ms": ms, "times": times, "launches": launches}
            log(f"ops {name}: equal to the CPU plain result and the "
                f"oracle; launches {launches}; median {ms:.4f} ms of "
                f"{[round(t, 4) for t in times]}")
        busy_ms, wall_ms = profile_call(
            torch, lambda: entry_step(on_card["facts"]), top=8)
    report["entry_step"].update(busy_ms=busy_ms, wall_ms=wall_ms,
                                busy_share=busy_ms / wall_ms)
    del on_card, on_cpu
    torch.cuda.empty_cache()
    log("phase 12: " + json.dumps(report))
    return report


# -- phase 13: the radix pair sort under the sorted operators ----------------

# SSB SF 20's lineorder: the rows of a join's concat sort of the fact side.
PAIR_SORT_N = 120_000_000
PAIR_SORT_EDGE_N = (0, 1, 4095, 4097, (1 << 20) + 3, 1 << 25)
# One 32-bit word (an int32 key), one 40-bit word (an int32 key and a uint8
# NULL code, as the join packs them) and two 32-bit words (two int32 keys).
PAIR_SORT_CLASSES = ("word32", "word40", "two_words")


def pair_sort_inputs(torch, n: int, cls: str, seed: int, dev):
    """``(keys, values)`` on ``dev`` for a word class: int32 keys over all
    32 bits, half of them folded to 16 values (ties), INT32_MIN and
    INT32_MAX among them; for ``word40`` a uint8 code of 0-2 after the key;
    int32 values over all 32 bits."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def int32(m):
        return torch.randint(-2**31, 2**31, (m,), dtype=torch.int32,
                             device=dev, generator=g)

    def key():
        k = int32(n)
        k = torch.where(torch.rand(n, device=dev, generator=g) < 0.5,
                        k & 15, k)
        k[: min(n, 2)] = torch.tensor([-2**31, 2**31 - 1], dtype=torch.int32,
                                      device=dev)[: min(n, 2)]
        return k

    keys = [key()]
    if cls == "word40":
        keys.append(torch.randint(0, 3, (n,), dtype=torch.uint8, device=dev,
                                  generator=g))
    elif cls == "two_words":
        keys.append(key())
    return keys, int32(n)


def check_pair_sort(torch, S, dev, n: int, cls: str, seed: int) -> None:
    """The card's pair sort against its plain twin on the CPU, bit for bit
    in sorted words and values: ``sort_pairs`` on the class's one word, or
    ``lexsort_permutation`` over two words (as the permutation, and as the
    last word with values carried). Raises on any difference."""
    from harkdb_tpu_torch.kernels import radix_sort as R

    keys, values = pair_sort_inputs(torch, n, cls, seed, dev)
    cpu_keys = [k.cpu() for k in keys]
    words = S.order_words(keys)
    want_bits = {"word32": [32], "word40": [40], "two_words": [32, 32]}[cls]
    if [b for _w, b in words] != want_bits:
        raise AssertionError(f"{cls}: words of {[b for _w, b in words]} bits")
    before = R.LAUNCHES
    if cls == "two_words":
        got = [S.lexsort_permutation(keys)]
        got += S.lexsort_permutation(keys, values.clone())
        want = [S.lexsort_permutation(cpu_keys)]
        want += S.lexsort_permutation(cpu_keys, values.cpu())
    else:
        (w, bits), = words
        got = R.sort_pairs(w.clone(), bits, values.clone())
        want = R.sort_pairs_reference(w.cpu(), bits, values.cpu())
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
            raise AssertionError(f"pair sort {cls} at {n:,} rows: output "
                                 f"{i} differs from the plain twin")
    if n and R.LAUNCHES == before:
        raise AssertionError(f"pair sort {cls} at {n:,} rows: no launch")


def pair_sort_bytes(n: int, key_bytes: int, bits: int) -> int:
    """The least bytes a stable LSD radix sort of n keys with 4-byte values
    moves: one read of the keys for the digit histograms, then per 8-bit
    digit pass one read and one write of every key and value."""
    passes = -(-bits // 8)
    return n * key_bytes + passes * n * (key_bytes + 4) * 2


def _fresh_event_ms(torch, fn, inputs, reps=5):
    """Median CUDA-event ms of ``fn(*copies)`` over ``reps`` calls after
    one warm-up, each on fresh copies of ``inputs`` made before its events
    (the sort hands its inputs over), with an empty queue before each."""
    times = []
    for i in range(reps + 1):
        copies = [x.clone() for x in inputs]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*copies)
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
        del copies
    return statistics.median(times), times


def _library_lexsort(torch, words64):
    """The sort as the port ran it before the pair sort: one stable
    ``torch.sort`` per int64 word, least significant first, composing
    int64 permutations."""
    perm = None
    for w in words64:
        if perm is not None:
            w = w[perm]
        order = torch.sort(w, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def phase_pair_sort(torch, dev, n: int = PAIR_SORT_N) -> list:
    """Phase 13: the pair sort against its plain twin at the edge lengths,
    then each word class at ``n`` rows: the sort alone (``sort_pairs``; for
    two words ``lexsort_permutation``, its gather and both sorts), the
    whole ``lexsort_permutation`` from the keys, the bytes the sort needs at
    the card's rate, and ``torch.sort`` over the same words widened to
    int64 (the port's sort before) as the library yardstick, whose order
    the pair sort must equal."""
    from harkdb_tpu_torch.kernels import radix_sort as R
    from harkdb_tpu_torch.ops import sort as S

    for cls in PAIR_SORT_CLASSES:
        for m in PAIR_SORT_EDGE_N:
            check_pair_sort(torch, S, dev, m, cls, seed=m + 7)
    log(f"phase 13 pair sort: {', '.join(PAIR_SORT_CLASSES)} at "
        f"{PAIR_SORT_EDGE_N} rows: bit-exact against the plain twin")
    rows = []
    for cls in PAIR_SORT_CLASSES:
        keys, values = pair_sort_inputs(torch, n, cls, 13, dev)
        words = S.order_words(keys)
        if cls == "two_words":
            ms, times = median_event_ms(
                torch, lambda: S.lexsort_permutation(keys))
            lex_ms = ms
            # both sorts, the second word's gather and the index fill
            nbytes = sum(pair_sort_bytes(n, w.element_size(), b)
                         for w, b in words) + 12 * n + 4 * n
            got = S.lexsort_permutation(keys)
        else:
            (w, bits), = words
            ms, times = _fresh_event_ms(
                torch, lambda a, b: R.sort_pairs(a, bits, b), [w, values])
            lex_ms, _ = _fresh_event_ms(
                torch, lambda v: S.lexsort_permutation(keys, v), [values])
            nbytes = pair_sort_bytes(n, w.element_size(), bits)
            got = S.lexsort_permutation(keys)
        words64 = [(w.to(torch.int64) & 0xFFFFFFFF) if w.dtype == torch.int32
                   else w for w, _b in words]
        lib_ms, lib_times = median_event_ms(
            torch, lambda: _library_lexsort(torch, words64))
        same = torch.equal(got.to(torch.int64), _library_lexsort(torch,
                                                                 words64))
        if not same:
            raise AssertionError(f"pair sort {cls} at {n:,} rows: order "
                                 f"differs from torch.sort's")
        bound = nbytes / HBM_BYTES_PER_MS
        rows.append({
            "name": f"sort_pairs_{cls}", "route": "cub",
            "source": "harkdb_tpu_torch/csrc/radix_sort.cu", "rows": n,
            "bits": [b for _w, b in words], "ms": ms, "times": times,
            "lexsort_ms": lex_ms, "bytes": nbytes, "bound_ms": bound,
            "bound_by": "bytes", "bound_share": bound / ms,
            "library_ms": lib_ms, "library_times": lib_times,
            "library": "torch.sort over int64 words, stable",
            "equal_to_library": same})
        log(f"phase 13 pair sort {cls} at {n:,} rows, words of "
            f"{[b for _w, b in words]} bits: {ms:.3f} ms (whole lexsort "
            f"{lex_ms:.3f} ms), bound {bound:.3f} ms ({bound / ms:.3f} of "
            f"it), torch.sort over int64 words {lib_ms:.3f} ms")
        del keys, values, words, words64, got
        torch.cuda.empty_cache()
    return rows


# -- phase 14: the join's count phase around the pair sort (kernels E) -------

# (left capacity, right capacity, live left, live right, key span, NULL
# flags): lengths around the runs kernel's 2048-row tiles, sides without
# rows, runs over many tiles, the whole array one run (a 65536² CROSS JOIN:
# 2^32 pairs, so both int32 totals wrap to 0), NULL codes, and SSB SF 20's
# lineorder against date.
JOIN_RUNS_EDGES = (
    (0, 1, 0, 1, 4, False),
    (1, 0, 1, 0, 4, False),
    (1000, 1047, 1000, 1047, 50, False),
    (1025, 1024, 1000, 1024, 50, False),
    (4097, 0, 4000, 0, 8, False),
    (3000, 1097, 3000, 1000, 8, True),
    (0, 5000, 0, 0, 8, True),
    ((1 << 20) + 3, 5000, (1 << 20) - 7, 4990, 3, False),
    ((1 << 20) + 3, 5000, 1 << 19, 0, 100, True),
    (65536, 65536, 65536, 65536, 1, False),
    (PAIR_SORT_N, 2_557, PAIR_SORT_N - 5, 2_557, 2_557, False),
)
# SSB SF 20's lineorder against date, and TPC-H SF 10's lineitem against
# orders: the count phases of the cells' largest joins (facts left, every
# fact key a live dimension key).
JOIN_RUNS_SHAPES = ((PAIR_SORT_N, 2_557), (60_000_000, 15_000_000))
JOIN_APPROX_RTOL = 1e-5


def join_runs_inputs(torch, dev, nl, nr, n_l, n_r, span, nulls, seed):
    """``(l_key, n_l, r_key, n_r, l_null, r_null)`` on ``dev``: int32 keys
    over ``[0, span)`` (INT32_MAX and INT32_MIN among them where the span
    is over 2), live counts as 0-d int32 tensors, NULL flags on 5% of the
    rows of each side or None."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def key(n):
        k = torch.randint(0, span, (n,), dtype=torch.int32, device=dev,
                          generator=g)
        if span > 2:
            k[::97] = 2**31 - 1
            k[1::101] = -2**31
        return k

    def flags(n):
        return (torch.rand(n, device=dev, generator=g) < 0.05
                if nulls else None)

    def count(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    return key(nl), count(n_l), key(nr), count(n_r), flags(nl), flags(nr)


def check_join_runs(torch, dev, nl, nr, n_l, n_r, span, nulls, seed) -> dict:
    """The words kernel, the pair sort and the runs kernel on the card
    against the plain versions of both kernels on the CPU (fed the card's
    sorted word and tag), bit for bit but ``total_approx`` (within
    ``JOIN_APPROX_RTOL``): the words and tags, the live rows of
    ``l_orig``, ``lo`` and ``r_orig``, the counts whole, the live lefts and
    both int32 totals. Returns the card's totals; raises on a difference
    or a missing launch."""
    from harkdb_tpu_torch.kernels import join_runs as K
    from harkdb_tpu_torch.kernels import radix_sort as R

    what = f"join runs {nl:,} + {nr:,} rows, span {span}, nulls {nulls}"
    args = join_runs_inputs(torch, dev, nl, nr, n_l, n_r, span, nulls, seed)
    cpu = [None if a is None else a.cpu() for a in args]
    before = (K.WORDS_LAUNCHES, K.RUNS_LAUNCHES)
    word, bits, tag = K.join_words(*args)
    want = K.join_words_reference(*cpu)
    if (bits != want[1] or not torch.equal(word.cpu(), want[0])
            or not torch.equal(tag.cpu(), want[2])):
        raise AssertionError(f"{what}: words or tags differ from the plain "
                             f"version")
    sword, stag = R.sort_pairs(word, bits, tag)
    got = K.join_runs(sword, stag, nl, args[1])
    ref = K.join_runs_reference(sword.cpu(), stag.cpu(), nl, cpu[1])
    torch.cuda.synchronize()
    if nl + nr and (K.WORDS_LAUNCHES, K.RUNS_LAUNCHES) != (before[0] + 1,
                                                          before[1] + 1):
        raise AssertionError(f"{what}: the kernels did not launch")
    n_lefts, n_rights = min(n_l, nl), min(n_r, nr)
    for name, live in (("l_orig", n_lefts), ("counts", nl), ("lo", n_lefts),
                       ("r_orig", n_rights)):
        a, b = getattr(got, name), getattr(ref, name)
        if not torch.equal(a[:live].cpu(), b[:live]):
            raise AssertionError(f"{what}: {name} differs from the plain "
                                 f"version")
    for name in ("n_lefts", "total", "total_left"):
        a, b = getattr(got, name), getattr(ref, name)
        if a.dtype != torch.int32 or int(a) != int(b):
            raise AssertionError(f"{what}: {name} {int(a)} against "
                                 f"{int(b)}")
    if int(got.n_lefts) != n_lefts:
        raise AssertionError(f"{what}: {int(got.n_lefts)} live lefts")
    approx, want_approx = float(got.total_approx), float(ref.total_approx)
    if abs(approx - want_approx) > JOIN_APPROX_RTOL * max(1.0, want_approx):
        raise AssertionError(f"{what}: total_approx {approx} against "
                             f"{want_approx}")
    return {"total": int(got.total), "total_left": int(got.total_left),
            "total_approx": approx}


def join_words_bytes(nl, nr, n_l, n_r, nulls) -> int:
    """The words kernel's work: each live key read (a pad's is not), the
    NULL flags read, a word and a tag written for every row."""
    n = nl + nr
    return 4 * (n_l + n_r) + (n if nulls else 0) + n * ((8 if nulls else 4)
                                                        + 4)


def join_runs_bytes(nl, nr, n_l, n_r, word_bytes) -> int:
    """The runs kernel's work: every sorted word and tag read; per live
    left its row, count and first match written, per live right its row,
    a zero count for every left row past the live ones, the four totals."""
    n = nl + nr
    return n * (word_bytes + 4) + 12 * n_l + 4 * n_r + 4 * (nl - n_l) + 16


def phase_join_runs(torch, dev) -> list:
    """Phase 14: both kernels against their plain versions at
    ``JOIN_RUNS_EDGES``, then at each of ``JOIN_RUNS_SHAPES``: each wrapper
    timed by CUDA events (mean of 20 calls behind a device sleep) and by
    torch.profiler (the kernel alone), its bound (``join_*_bytes`` at the
    card's rate), its plain version on the card, the pair sort between
    them, and ``compute_join_ranges`` whole."""
    from harkdb_tpu_torch.kernels import join_runs as K
    from harkdb_tpu_torch.kernels import radix_sort as R
    from harkdb_tpu_torch.ops import join as J

    for i, case in enumerate(JOIN_RUNS_EDGES):
        totals = check_join_runs(torch, dev, *case, seed=1400 + i)
        if case[4] == 1:                     # the CROSS JOIN
            pairs = float(case[2]) * case[3]
            if (totals["total"], totals["total_left"]) != (0, 0) or abs(
                    totals["total_approx"] - pairs) > JOIN_APPROX_RTOL * pairs:
                raise AssertionError(f"CROSS JOIN totals {totals}")
        torch.cuda.empty_cache()
    log(f"phase 14 join runs: {len(JOIN_RUNS_EDGES)} edge cases up to "
        f"{PAIR_SORT_N:,} + 2,557 rows, the 65536² CROSS JOIN's totals "
        f"wrapping to 0: bit-exact against the plain versions")
    rows = []
    for nl, nr in JOIN_RUNS_SHAPES:
        g = torch.Generator(device=dev)
        g.manual_seed(14)
        l_key = torch.randint(0, nr, (nl,), dtype=torch.int32, device=dev,
                              generator=g)
        r_key = torch.randperm(nr, dtype=torch.int32, device=dev,
                               generator=g)
        n_l, n_r = (torch.full((), v, dtype=torch.int32, device=dev)
                    for v in (nl, nr))
        word, bits, tag = K.join_words(l_key, n_l, r_key, n_r)
        sword, stag = R.sort_pairs(word.clone(), bits, tag.clone())
        entry = {"rows": [nl, nr], "bits": bits}
        for name, call, plain, nbytes, kernel in (
                ("join_words",
                 lambda: K.join_words(l_key, n_l, r_key, n_r),
                 lambda: K.join_words_reference(l_key, n_l, r_key, n_r),
                 join_words_bytes(nl, nr, nl, nr, False),
                 "join_words_kernel"),
                ("join_runs", lambda: K.join_runs(sword, stag, nl, n_l),
                 lambda: K.join_runs_reference(sword, stag, nl, n_l),
                 join_runs_bytes(nl, nr, nl, nr, 4), "join_runs_kernel")):
            ms = time_cuda(torch, call)
            # None where the profiler recorded no such kernel (seen late
            # in a whole run of this script, after many profiled phases)
            alone = kernel_only_ms(torch, call, kernel) or None
            plain_ms = time_cuda(torch, plain, iters=3, warmup=1)
            bound = nbytes / HBM_BYTES_PER_MS
            entry[name] = {"ms": ms, "kernel_ms": alone, "bytes": nbytes,
                           "bound_ms": bound, "bound_share": bound / ms,
                           "kernel_bound_share": alone and bound / alone,
                           "plain_ms": plain_ms}
            log(f"phase 14 {name} at {nl:,} + {nr:,} rows: {ms:.4f} ms, "
                f"bound {bound:.4f} ms ({bound / ms:.3f} of it); kernel "
                f"alone {alone} ms; plain version on the card "
                f"{plain_ms:.4f} ms")
        entry["sort_ms"], _ = _fresh_event_ms(
            torch, lambda w, t: R.sort_pairs(w, bits, t), [word, tag])
        entry["count_phase_ms"], _ = median_event_ms(
            torch, lambda: J.compute_join_ranges(l_key, n_l, r_key, n_r))
        log(f"phase 14 count phase at {nl:,} + {nr:,} rows: "
            f"compute_join_ranges {entry['count_phase_ms']:.4f} ms, of "
            f"which the pair sort {entry['sort_ms']:.4f} ms")
        rows.append(entry)
        del l_key, r_key, word, tag, sword, stag
        torch.cuda.empty_cache()
    return rows


def compact_bytes(torch, n_cols, mask, n_valid) -> int:
    """Bytes kernel A's work must move: the mask, each 32-byte sector (8
    rows) of each column that holds a kept row, and each kept word out."""
    n = mask.shape[0]
    keep = mask & (torch.arange(n, device=mask.device) < n_valid)
    kept = int(keep.sum())
    padded = torch.cat([keep, keep.new_zeros(-n % 8)])
    sectors = int(padded.view(-1, 8).any(1).sum())
    return n + n_cols * (32 * sectors + 4 * kept)


def dense_agg_bytes(key, vals, mask, span) -> int:
    """Bytes kernel C's work must move: key, mask and value columns in,
    counts, sums and the key axis out."""
    n = key.shape[0]
    return (4 * n * (1 + len(vals)) + (0 if mask is None else n)
            + 4 * span * (2 + len(vals)))


def expand_bytes(offsets, n_src, out_cap, extras) -> int:
    """Bytes kernel D's work must move: offsets and each extra plane over
    the live segments in, seg, the offset fill and each plane's fill out."""
    return (4 * int(n_src) * (1 + len(extras))
            + 4 * out_cap * (2 + len(extras)))


def library_searchsorted(torch, timer, offsets, n_src, out_cap) -> float:
    """Time of ``torch.searchsorted`` of every slot into the live offsets:
    kernel D's seg ids alone (a part of its function), inputs built
    outside the timed region."""
    live = offsets[:int(n_src)].contiguous()
    slots = torch.arange(out_cap, dtype=torch.int32, device=offsets.device)
    return timer(torch, lambda: torch.searchsorted(live, slots, right=True))


def library_index_add(torch, timer, key, vals, key_min, span, say) -> float:
    """Time of one ``index_add_`` of one value column over the keys
    already rebased and inside the span (no mask, no n_valid): kernel C's
    sums of one column alone, inputs built outside the timed region. int32
    where the card's build takes it, else int64."""
    k = key.to(torch.int64) - key_min
    keep = (k >= 0) & (k < span)
    idx, src = k[keep], vals[keep]
    for dtype in (torch.int32, torch.int64):
        acc = torch.zeros(span, dtype=dtype, device=key.device)
        s = src.to(dtype)
        try:
            acc.index_add_(0, idx, s)
        except RuntimeError as e:       # this build's index_add_ refuses it
            say(f"index_add_ in {dtype}: {e}")
            continue
        return timer(torch, lambda: torch.zeros(
            span, dtype=dtype, device=key.device).index_add_(0, idx, s))
    raise RuntimeError("index_add_ ran in neither int32 nor int64")


def kernel_entry(name, source, replaces, launches, main_launches, err, ms,
                 host_ms, plain_ms, nbytes, library_ms) -> dict:
    """One kernel's row of the report; its bound is ``nbytes`` at the
    card's memory rate."""
    bound = nbytes / HBM_BYTES_PER_MS
    return {"name": name, "route": "cuda",
            "source": f"harkdb_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "bound_share": bound / ms,
            "main_launches": main_launches, "library_ms": library_ms,
            "bytes": nbytes, "host_ms": host_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import harkdb_tpu_torch as H
    from harkdb_tpu_torch.kernels import (
        _lib, compact, expand, join_runs, matmul_agg, segscan,
    )
    from harkdb_tpu_torch.columnar.batch import ColumnBatch
    from harkdb_tpu_torch.ops.groupby import groupby_batch

    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    # -- phase 2: build ----------------------------------------------------------
    path, build_log, secs = _lib.build()
    log(f"build: {os.path.relpath(path, ROOT)} in {secs:.1f} s (nvcc "
        f"{' '.join(_lib.NVCC_FLAGS)}, one process per source)")
    for line in ptxas_summary(build_log):
        log(f"  {line}")
    dev = torch.device("cuda")

    # -- phase 3: kernels vs plain versions --------------------------------------
    phase_kernels(torch, compact, segscan, dev)
    phase_lookback(torch, compact, segscan, dev)
    (k, v, mask), (sid, vals) = main_shapes(torch, dev)
    n_valid = torch.full((), k.shape[0], dtype=torch.int32, device=dev)
    a_err = check_main_compact(torch, compact, k, v, mask, n_valid)
    got_b = segscan.flat_segscan("max", sid, [vals], -2**31)[0]
    ref_b = segscan.flat_segscan_reference("max", sid, [vals], -2**31)[0]
    torch.cuda.synchronize()
    b_err = int((got_b - ref_b).abs().max())
    # The window query's shapes: its running sum under the same partition
    # ids, and the running max / min (prims/scan) over one segment.
    one_err = 0
    for op, seg, ne, rev in (("add", sid, 0, False),
                             ("max", None, -2**31, False),
                             ("min", None, 2**31 - 1, True)):
        got_w = segscan.flat_segscan(op, seg, [vals], ne, reverse=rev)[0]
        ref_w = segscan.flat_segscan_reference(op, seg, [vals], ne,
                                               reverse=rev)[0]
        torch.cuda.synchronize()
        err = int((got_w.to(torch.int64) - ref_w.to(torch.int64)).abs().max())
        if seg is None:
            one_err = max(one_err, err)
        else:
            b_err = max(b_err, err)
    if b_err or one_err:
        raise AssertionError("kernel B differs at the main path's shapes")
    log(f"kernel A at {k.shape[0]:,} rows x 2 int32: bit-exact; kernel B "
        f"max and add under the group ids, max and reversed min over one "
        f"segment, at {sid.shape[0]:,} rows: bit-exact")
    phase_kernels_cd(torch, expand, matmul_agg, dev)
    d_star, d_q3, c_main = cd_shapes(torch, dev)
    d_err, c_err, c_one, c_wide = check_cd_main(
        torch, expand, matmul_agg, dev, d_star, d_q3, c_main)
    log(f"kernel D at the star join ({int(d_star[1]):,} unit segments into "
        f"{d_star[2]:,} slots, 2 extra planes) and Q3 ({int(d_q3[1]):,} "
        f"segments of 1-7 into {d_q3[2]:,} slots): bit-exact; kernel C at "
        f"{c_main[0].shape[0]:,} rows, span 4096 + mask, span 16384 x 3 sum "
        f"columns, span 1: bit-exact")

    # -- phases 4 and 5: the main path ------------------------------------------
    counters = {"flat_compact": (compact, "LAUNCHES"),
                "flat_segscan": (segscan, "LAUNCHES"),
                "flat_segscan_one_segment": (segscan,
                                             "ONE_SEGMENT_LAUNCHES"),
                "onehot_groupby_sums": (matmul_agg, "LAUNCHES"),
                "expand_fills": (expand, "LAUNCHES"),
                "join_words": (join_runs, "WORDS_LAUNCHES"),
                "join_runs": (join_runs, "RUNS_LAUNCHES")}
    ctx, launches = run_query_check(torch, H, counters, N_MAIN, MAIN_QUERY,
                                    0)
    main_ms, main_all = time_query(torch, ctx, MAIN_QUERY)
    profile_query(torch, ctx, MAIN_QUERY)
    debug_ms = {"main_query": debug_checks_overhead(
        torch, H, ctx, MAIN_QUERY, f"query {N_MAIN:,} rows", main_ms)}
    del ctx
    torch.cuda.empty_cache()
    big, big_launches = run_query_check(torch, H, counters, N_LARGE,
                                        HAVING_QUERY, 48)
    big_ms, big_all = time_query(torch, big, HAVING_QUERY)
    del big
    torch.cuda.empty_cache()
    log(f"query {N_MAIN:,} rows: median {main_ms:.3f} ms "
        f"({N_MAIN / main_ms / 1e3:.1f} M rows/s) of {main_all}")
    log(f"query {N_LARGE:,} rows: median {big_ms:.3f} ms "
        f"({N_LARGE / big_ms / 1e3:.1f} M rows/s) of {big_all}")

    # -- phase 6: the star join and TPC-H Q3 ------------------------------------
    facts, dims = star_data()
    star, star_launches = run_join_check(
        torch, H, counters, {"facts": facts, "dims": dims}, STAR_QUERY,
        star_oracle(facts, dims),
        {"flat_compact": 3, "onehot_groupby_sums": 1, "expand_fills": 1,
         "join_words": 1, "join_runs": 1},
        f"star join ({N_MAIN:,} facts x {N_KEYS:,} dims)")
    plan = star._plan(STAR_QUERY)
    if plan.last_fast_span != DIM_SPAN:
        raise AssertionError(f"star join took span {plan.last_fast_span}, "
                             f"expected the dense path at {DIM_SPAN}")
    log(f"star join plan: fast_candidate {plan.fast_candidate}, fast_agg "
        f"{plan.fast_agg}, last_fast_span {plan.last_fast_span}")
    del facts, dims
    star_ms, star_all = time_query(torch, star, STAR_QUERY)
    profile_query(torch, star, STAR_QUERY)
    debug_ms["star_join"] = debug_checks_overhead(
        torch, H, star, STAR_QUERY, "star join", star_ms)
    del star
    torch.cuda.empty_cache()
    tpch = q3_data()
    q3, q3_launches = run_join_check(
        torch, H, counters, tpch, Q3_QUERY, q3_oracle(tpch),
        {"flat_compact": 1, "expand_fills": 2, "join_words": 2,
         "join_runs": 2},
        f"TPC-H Q3 ({N_LINEITEM:,} lineitem, {N_ORDERS:,} orders, "
        f"{N_CUSTOMER:,} customer)")
    del tpch
    q3_ms, q3_all = time_query(torch, q3, Q3_QUERY)
    profile_query(torch, q3, Q3_QUERY)
    debug_ms["tpch_q3_sf1"] = debug_checks_overhead(
        torch, H, q3, Q3_QUERY, "TPC-H Q3", q3_ms)
    del q3
    torch.cuda.empty_cache()
    log(f"star join: median {star_ms:.3f} ms of {star_all}")
    log(f"TPC-H Q3: median {q3_ms:.3f} ms of {q3_all}")

    # -- phase 7: nested queries, windows and set operations --------------------
    nested_ms, nested_launches = phase_nested(torch, H, counters)

    # -- phase 9: a CSV onto the card, the CLI and Context.profile ----------
    csv_cli = phase_csv_cli(torch, H, counters, _lib.BUILD_DIR)

    # -- phase 10: the mesh, 4 gloo ranks sharing this card -----------------
    mesh = phase_mesh(torch, H)

    # -- phase 11: the public primitives and the top-k LIMIT path -----------
    phase_11(torch, H, counters)

    # -- phase 12: the public ops and kernel C's entry points at full width --
    phase_public_ops(torch, H, counters)

    # -- phase 13: the radix pair sort under the sorted operators ------------
    pair_sort = phase_pair_sort(torch, dev)

    # -- phase 14: the join's count phase around the pair sort ---------------
    join_count = phase_join_runs(torch, dev)

    # -- phase 8: kernels against their plain versions, bounds, library calls ---
    cols = {"k": k, "v": v}
    a_ms, a_host = time_cuda(
        torch, lambda: compact.flat_compact(cols, mask, n_valid), host=True)
    a_plain = time_cuda(
        torch, lambda: compact.flat_compact_reference(cols, mask, n_valid))
    x2 = torch.stack([k, v])            # built outside the timed region
    a_lib = time_cuda(torch, lambda: x2[:, mask])
    del x2
    b_ms, b_host = time_cuda(
        torch, lambda: segscan.flat_segscan("max", sid, [vals], -2**31),
        host=True)
    b_plain = time_cuda(
        torch,
        lambda: segscan.flat_segscan_reference("max", sid, [vals], -2**31))
    o_ms, o_host = time_cuda(
        torch, lambda: segscan.flat_segscan("max", None, [vals], -2**31),
        host=True)
    o_plain = time_cuda(
        torch,
        lambda: segscan.flat_segscan_reference("max", None, [vals], -2**31))
    o_lib = time_cuda(torch, lambda: torch.cummax(vals, 0))
    log(f"kernel A {a_ms:.4f} ms (host {a_host:.4f} ms a call) vs plain "
        f"{a_plain:.4f} ms vs x2[:, mask] {a_lib:.4f} ms; kernel B "
        f"{b_ms:.4f} ms (host {b_host:.4f}) vs plain {b_plain:.4f} ms; "
        f"kernel B over one segment {o_ms:.4f} ms (host {o_host:.4f}) vs "
        f"plain {o_plain:.4f} ms vs torch.cummax {o_lib:.4f} ms")
    d_ms, d_host = time_cuda(torch, lambda: expand.expand_fills(*d_star),
                             host=True)
    d_plain = time_cuda(torch, lambda: expand.expand_fills_reference(*d_star))
    dq_ms, dq_host = time_cuda(torch, lambda: expand.expand_fills(*d_q3),
                               host=True)
    dq_plain = time_cuda(torch,
                         lambda: expand.expand_fills_reference(*d_q3))
    d_lib, dq_lib = (library_searchsorted(torch, time_cuda, *args[:3])
                     for args in (d_star, d_q3))
    log(f"kernel D star join {d_ms:.4f} ms (host {d_host:.4f}) vs plain "
        f"{d_plain:.4f} ms vs torch.searchsorted (seg ids alone) "
        f"{d_lib:.4f} ms; Q3 shape {dq_ms:.4f} ms (host {dq_host:.4f}) vs "
        f"plain {dq_plain:.4f} ms vs torch.searchsorted {dq_lib:.4f} ms")
    ckey, cvals, cnv, ckmin, cspan, cmask = c_main
    c_ms, c_host = time_cuda(torch, lambda: matmul_agg.onehot_groupby_sums(
        ckey, cvals, cnv, ckmin, cspan, mask=cmask), host=True)
    c_plain = time_cuda(torch, lambda: matmul_agg.onehot_groupby_sums_reference(
        ckey, cvals, cnv, ckmin, cspan, mask=cmask))
    one_k, one_v, one_nv = c_one
    c1_ms, c1_host = time_cuda(torch, lambda: matmul_agg.onehot_groupby_sums(
        one_k, one_v, one_nv, 5, 1), host=True)
    c1_plain = time_cuda(
        torch, lambda: matmul_agg.onehot_groupby_sums_reference(
            one_k, one_v, one_nv, 5, 1))
    w_k, w_v, w_nv = c_wide
    cw_ms, cw_host = time_cuda(torch, lambda: matmul_agg.onehot_groupby_sums(
        w_k, w_v, w_nv, 0, 16384), host=True)
    cw_plain = time_cuda(
        torch, lambda: matmul_agg.onehot_groupby_sums_reference(
            w_k, w_v, w_nv, 0, 16384))
    c_lib, c1_lib, cw_lib = (
        library_index_add(torch, time_cuda, k_, v_[0], kmin_, span_, log)
        for k_, v_, kmin_, span_ in ((ckey, cvals, ckmin, cspan),
                                     (one_k, one_v, 5, 1),
                                     (w_k, w_v, 0, 16384)))
    cw_bound = dense_agg_bytes(w_k, w_v, None, 16384) / HBM_BYTES_PER_MS
    log(f"kernel C at {ckey.shape[0]:,} rows: span 4096 + mask {c_ms:.4f} "
        f"ms (host {c_host:.4f}) vs plain {c_plain:.4f} ms vs index_add_ "
        f"(one sum, no mask) {c_lib:.4f} ms; span 1 {c1_ms:.4f} ms vs plain "
        f"{c1_plain:.4f} ms vs index_add_ {c1_lib:.4f} ms; span 16384 x 3 "
        f"sum columns {cw_ms:.4f} ms vs plain {cw_plain:.4f} ms vs "
        f"index_add_ {cw_lib:.4f} ms (bound {cw_bound:.4f} ms, "
        f"{cw_bound / cw_ms:.3f} of it)")
    # Kernel C against the sort path's group-by (sum + count) on 2^24 rows:
    # the measurement a later PR needs to re-derive MAX_KEY_SPAN.
    n24 = torch.full((), N_MAIN, dtype=torch.int32, device=dev)
    vs_sort = {}
    for span in (1024, 4096, 16384):
        key = k & (span - 1)
        batch = ColumnBatch({"k": key, "v": v}, n24)
        dense_ms = time_cuda(torch, lambda: matmul_agg.onehot_groupby_sums(
            key, [v], n24, 0, span), iters=10)
        sort_ms = time_cuda(torch, lambda: groupby_batch(
            batch, ["k"], [("v", "sum", "s"), ("v", "count", "c")]),
            iters=10)
        vs_sort[str(span)] = {"dense_ms": dense_ms, "sort_ms": sort_ms}
        log(f"GROUP BY sum+count at {N_MAIN:,} rows, span {span}: kernel C "
            f"{dense_ms:.4f} ms vs sort path {sort_ms:.4f} ms")

    kernel_ms = {
        "flat_compact": kernel_only_ms(
            torch, lambda: compact.flat_compact(cols, mask, n_valid),
            "compact_kernel"),
        "flat_segscan": kernel_only_ms(
            torch, lambda: segscan.flat_segscan("max", sid, [vals], -2**31),
            "segscan_kernel"),
        "flat_segscan_one_segment": kernel_only_ms(
            torch, lambda: segscan.flat_segscan("max", None, [vals], -2**31),
            "segscan_kernel"),
        "onehot_groupby_sums": kernel_only_ms(
            torch, lambda: matmul_agg.onehot_groupby_sums(
                ckey, cvals, cnv, ckmin, cspan, mask=cmask),
            "dense_agg"),
        "onehot_groupby_sums_span1": kernel_only_ms(
            torch, lambda: matmul_agg.onehot_groupby_sums(
                one_k, one_v, one_nv, 5, 1), "dense_agg"),
        "onehot_groupby_sums_span16384x3": kernel_only_ms(
            torch, lambda: matmul_agg.onehot_groupby_sums(
                w_k, w_v, w_nv, 0, 16384), "dense_agg"),
        "expand_fills": kernel_only_ms(
            torch, lambda: expand.expand_fills(*d_star), "expand_kernel"),
        "expand_fills_q3": kernel_only_ms(
            torch, lambda: expand.expand_fills(*d_q3), "expand_kernel"),
    }
    log(f"kernels alone (torch.profiler, ms): {kernel_ms}")
    n_b = sid.shape[0]
    # Kernel C at span 1 and at span 16384 x 3 is a shape that no query of
    # this script runs: its rows carry 0 launches.
    report = {"kernels": [
        kernel_entry("flat_compact", "compact.cu",
                     "harkdb_tpu/kernels/compact.py:199",
                     launches["flat_compact"], launches["flat_compact"],
                     a_err, a_ms, a_host, a_plain,
                     compact_bytes(torch, 2, mask, n_valid), a_lib),
        kernel_entry("flat_segscan", "segscan.cu",
                     "harkdb_tpu/kernels/segscan.py:143",
                     launches["flat_segscan"], launches["flat_segscan"],
                     b_err, b_ms, b_host, b_plain, 4 * n_b * 3, None),
        kernel_entry("flat_segscan_one_segment", "segscan.cu",
                     "harkdb_tpu/kernels/segscan.py:143",
                     star_launches["flat_segscan_one_segment"],
                     launches["flat_segscan_one_segment"],
                     one_err, o_ms, o_host, o_plain, 4 * n_b * 2, o_lib),
        kernel_entry("onehot_groupby_sums", "dense_agg.cu",
                     "harkdb_tpu/kernels/matmul_agg.py:134",
                     star_launches["onehot_groupby_sums"],
                     launches["onehot_groupby_sums"], c_err, c_ms, c_host,
                     c_plain, dense_agg_bytes(ckey, cvals, cmask, cspan),
                     c_lib),
        kernel_entry("onehot_groupby_sums_span1", "dense_agg.cu",
                     "harkdb_tpu/kernels/matmul_agg.py:134", 0, 0, c_err,
                     c1_ms, c1_host, c1_plain,
                     dense_agg_bytes(one_k, one_v, None, 1), c1_lib),
        kernel_entry("onehot_groupby_sums_span16384x3", "dense_agg.cu",
                     "harkdb_tpu/kernels/matmul_agg.py:134", 0, 0, c_err,
                     cw_ms, cw_host, cw_plain,
                     dense_agg_bytes(w_k, w_v, None, 16384), cw_lib),
        kernel_entry("expand_fills", "expand.cu",
                     "harkdb_tpu/kernels/expand.py:177",
                     star_launches["expand_fills"], launches["expand_fills"],
                     d_err, d_ms, d_host, d_plain, expand_bytes(*d_star),
                     d_lib),
        kernel_entry("expand_fills_q3", "expand.cu",
                     "harkdb_tpu/kernels/expand.py:177",
                     q3_launches["expand_fills"], launches["expand_fills"],
                     d_err, dq_ms, dq_host, dq_plain, expand_bytes(*d_q3),
                     dq_lib),
    ], "query_ms": {"rows_16777216": main_ms, "rows_100000000": big_ms,
                    "star_join": star_ms, "tpch_q3_sf1": q3_ms, **nested_ms},
        "launches": {"rows_16777216": launches,
                     "rows_100000000": big_launches,
                     "star_join": star_launches, "tpch_q3_sf1": q3_launches,
                     **nested_launches},
        "dense_vs_sort_ms": vs_sort, "debug_checks_ms": debug_ms,
        "csv_cli": csv_cli, "mesh": mesh, "pair_sort": pair_sort,
        "join_runs": join_count}
    # Each row's launches on every rank of phase 10 (4 gloo ranks): over
    # all its queries for a kernel's main row, in the query of the row's
    # shape for D (the star join, Q3); C at span 1 and 16384 x 3 runs in no
    # query there either.
    gloo = mesh["runs"]["gloo"]
    by_case = {"expand_fills": ("star_join", "expand_fills"),
               "expand_fills_q3": ("tpch_q3_sf1", "expand_fills")}
    for entry in report["kernels"]:
        name = entry["name"]
        entry["kernel_ms"] = kernel_ms[name]
        if name in by_case:
            case, key = by_case[name]
            entry["mesh_launches"] = [
                r[key] for r in gloo["launches_by_case"][case]]
        elif "_span" in name:
            entry["mesh_launches"] = [0] * len(gloo["launches_per_rank"])
        else:
            entry["mesh_launches"] = [
                r[name] for r in gloo["launches_per_rank"]]
    # Rank 0's rows at the mesh path's own shapes (MeshAudit): each form's
    # largest call of phase 10, its launches there, and every rank's.
    sources = {"flat_compact": ("compact.cu", "compact.py:199"),
               "flat_segscan": ("segscan.cu", "segscan.py:143"),
               "flat_segscan_one_segment": ("segscan.cu", "segscan.py:143"),
               "onehot_groupby_sums": ("dense_agg.cu", "matmul_agg.py:134"),
               "expand_fills": ("expand.cu", "expand.py:177")}
    for form, a in gloo["audit"].items():
        src, line = sources[form]
        entry = kernel_entry(
            f"{form}_mesh", src, f"harkdb_tpu/kernels/{line}", a["launches"],
            None, a["max_abs_err"], a["ms"], a["host_ms"], a["plain_ms"],
            a["bytes"], a["library_ms"])
        entry.update(
            kernel_ms=a["kernel_ms"], calls=a["calls"], case=a["case"],
            shape=a["shape"], mesh_rank=0, mesh_launches=[
                r[form] - (r["flat_segscan_one_segment"]
                           if form == "flat_segscan" else 0)
                for r in gloo["launches_per_rank"]])
        report["kernels"].append(entry)
    report["launches"]["csv_main_query"] = csv_cli.pop("launches")
    report["launches"]["cli_profile"] = csv_cli.pop("cli_launches")
    log(json.dumps(report))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
