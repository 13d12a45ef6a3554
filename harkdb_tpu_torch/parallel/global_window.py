"""Distributed global window functions (empty PARTITION BY).

Counterpart of ``harkdb_tpu.parallel.global_window``. ``dist_window``
would send every row of a global window to rank 0, but a global running
SUM / COUNT / rank is parallel: it is kernel B's carry chain lifted one
level, from tiles to ranks.

  1. ``dist_orderby`` puts the rows in the window's global order (ORDER BY
     keys, then the row ids, or the grouped caller's ``tie_names``, as the
     single-device sort breaks ties); rank i then holds the i-th
     contiguous range, and a run of ties never spans ranks (rows equal on
     the first key land on one rank).
  2. One local pass computes each rank's window values with the
     single-device machinery (position arithmetic, kernel B's running
     scans, run-end gathers for the peers), and small all_gathers of
     per-rank scalars (row count, run count, value totals, first and last
     value) give the carry: their prefix over the lower ranks.

Each rank keeps about live/D rows; the collectives are the order-by's
exchange and a few (D,)-sized all_gathers. Integer results are bit for bit
the single device's; float running sums add in another order and may
differ in their last bits (the JAX package documents the same).

Supported: row_number / rank / dense_rank / count / sum / min / max /
prod / avg / first_value / last_value / ntile / percent_rank / cume_dist,
and lag / lead through a halo of each rank's edge rows up to
``_HALO_MAX`` wide. Wider offsets and explicit ROWS frames take
``dist_window``'s rank-0 route (``supports_global`` says which).

Every host decision reads the plan's specs, never a rank-local value, so
all ranks enter the same collectives.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu_torch.kernels.segscan import agg_neutral, agg_segscan
from harkdb_tpu_torch.ops.sort import descending_transform
from harkdb_tpu_torch.parallel.dist_ops import dist_orderby
from harkdb_tpu_torch.parallel.sharded import ShardedBatch
from harkdb_tpu_torch.plan.expr import eval_expr
from harkdb_tpu_torch.plan.windows import run_last
from harkdb_tpu_torch.prims.scan import running_max

GLOBAL_FUNCS = {
    "row_number", "rank", "dense_rank", "count", "sum", "min", "max",
    "prod", "avg", "first_value", "last_value", "lag", "lead",
    "ntile", "percent_rank", "cume_dist",
}

_COMBINE = {"sum": torch.add, "prod": torch.mul,
            "max": torch.maximum, "min": torch.minimum}

# lag / lead cross rank boundaries through a (D, off) halo of each rank's
# edge rows; wider offsets take the rank-0 route.
_HALO_MAX = 1024


def supports_global(specs: Sequence[Tuple]) -> bool:
    """Carry-path eligibility: explicit ROWS frames take the rank-0 route
    (a bounded frame spans rank boundaries), and so do lag / lead offsets
    beyond the halo's width."""
    for s in specs:
        if s[1] not in GLOBAL_FUNCS:
            return False
        if len(s) > 7 and s[7] is not None:
            return False
        if s[1] in ("lag", "lead"):
            off = s[6][0] if s[6] else 1
            if off > _HALO_MAX:
                return False
    return True


def _reduce(op: str, t: torch.Tensor) -> torch.Tensor:
    """``t``'s sum / prod / max / min as a 0-d tensor of its dtype (int32
    sums and products wrap, as ``jnp.sum`` / ``jnp.prod`` do)."""
    if op == "sum":
        return t.sum(dtype=t.dtype)
    if op == "prod":
        return t.prod(dtype=t.dtype)
    return t.max() if op == "max" else t.min()


def dist_global_window(
    work: ShardedBatch,
    specs: Sequence[Tuple],
    mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    tie_names: Sequence[str] | None = None,
) -> ShardedBatch:
    """One empty-PARTITION BY window shape's outputs, rows left sharded in
    the window's global order.

    ``specs`` are the planner's window specs ``(out, func, arg, parts,
    oexprs, descs, params)`` with ``parts`` empty and the same
    ``(oexprs, descs)`` in every entry.
    """
    cfg = config
    D, me = mesh.size, mesh.rank
    _out0, _f0, _a0, _p0, oexprs, descs, *_rest0 = specs[0]
    oexprs, descs = list(oexprs), list(descs)

    # ---- stage 1: the global order (ORDER BY keys + a total tie) --------
    rid_names = (list(tie_names) if tie_names is not None
                 else [n for n in work.names if n.startswith("#rid.")])
    if oexprs or rid_names:
        def keys_fn(cols, cap):
            ks = [eval_expr(oe, cols, cap, cfg) for oe in oexprs]
            return ks + [cols[n] for n in rid_names]

        work = dist_orderby(work, keys_fn, descs + [False] * len(rid_names),
                            mesh)

    # ---- stage 2: local windows + the carry -----------------------------
    cols = work.columns
    C = work.local_capacity
    n_local = work.count
    dev = n_local.device
    idx = torch.arange(C, dtype=torch.int32, device=dev)
    valid = idx < n_local

    o_changed = torch.zeros(C, dtype=torch.bool, device=dev)
    for oe, d in zip(oexprs, descs):
        k = eval_expr(oe, cols, C, cfg)
        k = descending_transform(k) if d else k
        o_changed = o_changed | (k != torch.cat([k[:1], k[:-1]]))
    is_tstart = valid & ((idx == 0) | o_changed)
    # padding rows form a run of their own, so no peer broadcast reads them
    t_starts = is_tstart | (idx == n_local)

    def peers_last(S):
        return run_last(S, t_starts)

    def pscan(op, x):
        # one segment: the padding rows come after every live row
        return agg_segscan(op, None, [x])[0]

    # Per-rank (rows, runs) → (D, 2); the sums over ranks < me are the carry.
    g = mesh.all_gather(torch.stack([n_local.to(torch.int32),
                                     is_tstart.sum(dtype=torch.int32)]))
    rows_g, runs_g = g[:, 0], g[:, 1]
    carry_rows = rows_g[:me].sum(dtype=torch.int32)
    carry_runs = runs_g[:me].sum(dtype=torch.int32)
    total_rows = rows_g.sum(dtype=torch.int32)

    def rank_combine(x, op: str, all_ranks: bool):
        """``op`` over the live ``x`` of the ranks below this one (the
        carry) or of every rank (a window without ORDER BY)."""
        ne = torch.full((), agg_neutral(op, x.dtype), dtype=x.dtype,
                        device=dev)
        local = _reduce(op, torch.where(valid, x, ne))
        gv = mesh.all_gather(local.reshape(1)).reshape(D)
        return _reduce(op, gv if all_ranks else torch.cat([gv[:me],
                                                           ne.reshape(1)]))

    def global_edge(x, last: bool):
        """The first (last) live value over every rank."""
        at = torch.clamp(n_local - 1, min=0) if last else n_local * 0
        eg = mesh.all_gather(x[at.long()].reshape(1)).reshape(D)
        ng = (rows_g > 0).to(torch.int32)
        pick = ((D - 1) - torch.argmax(torch.flip(ng, [0])) if last
                else torch.argmax(ng))
        return eg[pick]

    def bcast(v):
        return v.reshape(1).expand(C).contiguous()

    has_order = bool(oexprs)
    out = dict(cols)
    for (out_name, func, arg, _p, _oe, _ds, params, *_r) in specs:
        x = None if arg is None else eval_expr(arg, cols, C, cfg)
        # Without ORDER BY every row is a peer of every row: values are
        # totals over all ranks, rank degenerates to 1 (tie runs then span
        # ranks, so the carry formulas hold only with an ORDER BY).
        if func in ("lag", "lead"):
            # The global positions within ``off`` of this block's edge lie
            # in other ranks' first / last ``off`` rows (a rank with fewer
            # rows sends them all), so a (D, off) halo covers any offset
            # up to _HALO_MAX. Never clamp ``off`` to the capacity: that
            # would compute a smaller lag.
            off = int(params[0]) if params else 1
            dflt = torch.tensor(params[1] if len(params) > 1 else 0,
                                device=dev).to(x.dtype)
            t = torch.arange(off, dtype=torch.int32, device=dev)
            ranks = torch.arange(D, dtype=torch.int32, device=dev)[:, None]
            prefixes = torch.cumsum(rows_g, 0, dtype=torch.int32) - rows_g
            gp = carry_rows + idx
            if func == "lag":
                edge_idx = n_local - off + t            # my tail rows
                evalid = edge_idx >= 0
                pos_mat = (prefixes[:, None] + rows_g[:, None] - off
                           + t[None, :])
                rank_ok = ranks < me
                targets = carry_rows - off + t
            else:
                edge_idx = t                            # my head rows
                evalid = edge_idx < n_local
                pos_mat = prefixes[:, None] + t[None, :]
                rank_ok = ranks > me
                targets = carry_rows + n_local + t
            ev = x[torch.clamp(edge_idx, 0, C - 1).long()]
            EV = mesh.all_gather(ev).reshape(1, D * off)
            EVal = mesh.all_gather(evalid.to(torch.int32)) > 0
            ok = (EVal & rank_ok).reshape(1, -1)
            eqm = (pos_mat.reshape(1, -1) == targets[:, None]) & ok
            halo = torch.where(eqm, EV, torch.zeros((), dtype=x.dtype,
                                                    device=dev))
            halo = halo.sum(1).to(x.dtype)              # (off,) edge values
            if func == "lag":
                # concat-then-slice fits any off against C
                shifted = torch.cat([halo, x])[:C]
                o = torch.where(gp >= off, shifted, dflt)
            else:
                base = torch.cat([x, x.new_zeros(off)])[off:off + C]
                hal_idx = torch.clamp(idx - (n_local - off), 0, off - 1)
                val = torch.where(idx >= n_local - off, halo[hal_idx.long()],
                                  base)
                o = torch.where(gp + off < total_rows, val, dflt)
        elif func == "row_number":
            o = carry_rows + idx + 1
        elif func == "ntile":
            # the bucket formula over the global position and row count,
            # the big buckets first
            nb = int(params[0])
            gp = carry_rows + idx
            q, r = total_rows // nb, total_rows % nb
            bigb = r * (q + 1)
            o = torch.where(
                gp < bigb,
                gp // torch.clamp(q + 1, min=1),
                r + (gp - bigb) // torch.clamp(q, min=1),
            ) + 1
        elif func == "percent_rank":
            if has_order:
                tstart_idx = running_max(torch.where(is_tstart, idx, 0))
                rk0 = (carry_rows + tstart_idx).to(torch.float32)
            else:
                rk0 = torch.zeros(C, dtype=torch.float32, device=dev)
            nf = total_rows.to(torch.float32)
            o = torch.where(nf > 1.0, rk0 / torch.clamp(nf - 1.0, min=1.0),
                            0.0)
        elif func == "cume_dist":
            if has_order:
                nf = torch.clamp(total_rows.to(torch.float32), min=1.0)
                o = (carry_rows + peers_last(idx + 1)).to(torch.float32) / nf
            else:                       # every row is a peer of the last
                o = torch.ones(C, dtype=torch.float32, device=dev)
        elif func == "rank":
            if has_order:
                tstart_idx = running_max(torch.where(is_tstart, idx, 0))
                o = carry_rows + tstart_idx + 1
            else:
                o = torch.ones(C, dtype=torch.int32, device=dev)
        elif func == "dense_rank":
            if has_order:
                o = carry_runs + torch.cumsum(is_tstart, 0, dtype=torch.int32)
            else:
                o = torch.ones(C, dtype=torch.int32, device=dev)
        elif func == "count":
            o = (carry_rows + peers_last(idx + 1) if has_order
                 else bcast(total_rows))
        elif func == "avg":
            xf = x.to(torch.float32)
            if has_order:
                s = (rank_combine(xf, "sum", False)
                     + peers_last(pscan("sum", xf)))
                c = (carry_rows + peers_last(idx + 1)).to(torch.float32)
            else:
                s = bcast(rank_combine(xf, "sum", True))
                c = bcast(total_rows.to(torch.float32))
            o = s / torch.clamp(c, min=1.0)
        elif func == "first_value":
            o = bcast(global_edge(x, last=False))
        elif func == "last_value":
            o = peers_last(x) if has_order else bcast(global_edge(x, True))
        else:                                   # sum / prod / min / max
            if has_order:
                o = _COMBINE[func](rank_combine(x, func, False),
                                   peers_last(pscan(func, x)))
            else:
                o = bcast(rank_combine(x, func, True))
        out[out_name] = o
    return ShardedBatch(out, work.count)
