"""SQL → physical plan lowering and execution, on torch tensors.

Counterpart of ``harkdb_tpu.plan.planner`` for the ported slice: name
resolution against the table registry (several bindings joined left to
right), aggregate extraction and rewriting, and lowering to a pipeline of
the operators in ``harkdb_tpu_torch.ops``. Error contracts preserved
verbatim from the reference:

  * unknown table        → "{name} is not in tables"                (parse.py:33)
  * unknown column       → "{col} is not in the schema of table {t}" (parse.py:54,69,87)
  * bad grouped select   → "{col} is not an aggregation function or the
                            columns thats grouped on"               (parse.py:78)

Execution model (the JAX planner's, run eagerly — torch needs no jit):

  * WHERE pushdown compacts each binding's batch (kernel A on a card);
  * phase A, per join step: one ranges pass (the concat sort) gives every
    join total; one total readback sizes the output to its power-of-two
    bucket and the same ranges materialize it (kernel D on a card);
  * single-table queries without the dense path: one ``n_live`` readback
    shrinks the working capacity to the survivors' bucket (large inputs);
  * GROUP BY: the dense-key path (kernel C on a card) when the key is a
    small-span int column and every aggregate is a sum or count — the span
    from table statistics, or from one on-device probe per plan — else the
    sort + scan + pack pipeline (``ops.groupby``);
  * for grouped queries with ORDER BY/DISTINCT one ``n_groups`` readback
    buckets the tail's capacity down to the group count;
  * ``run_tail``: post-computes, HAVING, projection, DISTINCT, ORDER BY,
    OFFSET and LIMIT.

  * window functions run after WHERE (ungrouped) or after HAVING
    (grouped) — ``plan/windows.py``;
  * derived tables / CTEs / views materialize once per execution, lazily
    (``plan/derived.py``); set operations are ``plan/union_plan.py``.

A plan keeps what its parse, binding and lowering give, and host statistics
of its tables (the probed key span), never a result: the subqueries' values
and the derived tables' materializations live for one ``execute``
(``one_execution``), so the card holds nothing for a cached plan.

These readbacks (and the join-total wrap guard) are the only host
synchronisations before the result is read, apart from those the JAX
package makes as well: each subquery's result is read back on every
execution and substituted as literals (``_bind_subqueries``), and the
set-operation tail reads its row counts (``UnionPlan``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.columnar.table import Table
from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu_torch.kernels.matmul_agg import (
    MAX_KEY_SPAN, onehot_groupby_sums, pad_span,
)
from harkdb_tpu_torch.ops.groupby import groupby_batch
from harkdb_tpu_torch.ops.join import compute_join_ranges, join_batches
from harkdb_tpu_torch.ops.sort import (
    ieee_order_view, lexsort_permutation, sort_batch,
)
from harkdb_tpu_torch.ops.topk import top_k_indices
from harkdb_tpu_torch.plan.aggregates import apply_post_computes
from harkdb_tpu_torch.plan.errors import PlanError
from harkdb_tpu_torch.plan.expr import eval_expr
from harkdb_tpu_torch.plan.nulls import (
    NullSemantics, null_extreme_sub, valid_mask,
)
from harkdb_tpu_torch.plan.strings import StringLowering
from harkdb_tpu_torch.plan.windows import compute_windows
from harkdb_tpu_torch.prims.compaction import compact_batch
from harkdb_tpu_torch.sql.ast_nodes import (
    Agg, BinOp, Case, Col, DerivedRef, ExistsSub, InSub, Lit, LutMember,
    OrderItem, SelectItem, SelectStmt, Star, SubQuery, UnionStmt, UnOp,
    WindowFn, walk,
)
from harkdb_tpu_torch.sql.parser import parse_sql
from harkdb_tpu_torch.utils.checks import debug_validate
from harkdb_tpu_torch.utils.metrics import host_read, inner_plan, span


def _next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def _check_join_total(ranges) -> None:
    """int32 wrap guard: the exact pair total wraps past 2^31 (a 65536²
    CROSS JOIN wraps to exactly 0) — the approximate float32 total turns
    that into a clear error instead of a silently empty/truncated
    result. The threshold is far beyond any materializable capacity."""
    if ranges.total_approx is not None:
        with host_read("join_guard"):
            approx = float(ranges.total_approx)
        if approx > 1.8e9:
            raise PlanError(
                f"Join result would exceed ~1.8e9 pairs "
                f"(≈{approx:.3g}) — beyond the engine's "
                f"2^31-row capacity; add join keys or filters"
            )


def _expr_name(expr) -> str:
    """Human-readable name for an unaliased select item."""
    if isinstance(expr, Col):
        return expr.name.split(".", 1)[-1] if "." in expr.name else expr.name
    if isinstance(expr, Agg):
        arg = "*" if isinstance(expr.arg, Star) else _expr_name(expr.arg)
        if expr.distinct:
            return f"{expr.func}(distinct {arg})"
        return f"{expr.func}({arg})"
    if isinstance(expr, BinOp):
        return f"({_expr_name(expr.left)} {expr.op} {_expr_name(expr.right)})"
    if isinstance(expr, UnOp):
        return f"({expr.op} {_expr_name(expr.operand)})"
    if isinstance(expr, Lit):
        return str(expr.value)
    if isinstance(expr, Case):
        return "case"
    from harkdb_tpu_torch.sql.ast_nodes import StrFunc as _StrFunc

    if isinstance(expr, _StrFunc):
        return f"{expr.func}({_expr_name(expr.arg)})"
    from harkdb_tpu_torch.sql.ast_nodes import Coalesce as _Coal

    if isinstance(expr, _Coal):
        return "coalesce(" + ", ".join(_expr_name(a) for a in expr.args) + ")"
    if isinstance(expr, SubQuery):
        return "(subquery)"
    if isinstance(expr, InSub):
        return f"({_expr_name(expr.expr)} in (subquery))"
    if isinstance(expr, WindowFn):
        arg = ("" if expr.arg is None
               else "*" if isinstance(expr.arg, Star)
               else _expr_name(expr.arg))
        return f"{expr.func}({arg}) over (...)"
    return "expr"


class _Resolver:
    """Name environment: (binding, column) → internal column key."""

    def __init__(self, bindings: Sequence[Tuple[str, str, List[str]]]):
        # bindings: (binding_name, table_name, schema columns)
        self.bindings = list(bindings)
        self.by_binding: Dict[str, Dict[str, str]] = {}
        for b, _tname, cols in self.bindings:
            self.by_binding[b] = {c: f"{b}.{c}" for c in cols}

    def resolve_col(self, col: Col) -> str:
        if col.table is not None:
            env = self.by_binding.get(col.table)
            if env is None:
                raise PlanError(f"{col.table} is not in tables",
                                "table", col.table)
            internal = env.get(col.name)
            if internal is None:
                tname = next(t for b, t, _ in self.bindings if b == col.table)
                raise PlanError(
                    f"{col.name} is not in the schema of table {tname}",
                    "column", col.name,
                )
            return internal
        matches = [
            (b, env[col.name]) for b, env in self.by_binding.items()
            if col.name in env
        ]
        if not matches:
            # Reference message names the (single) table (parse.py:54).
            tname = self.bindings[0][1]
            raise PlanError(
                f"{col.name} is not in the schema of table {tname}",
                "column", col.name,
            )
        if len(matches) > 1:
            raise PlanError(
                f"Column {col.name} is ambiguous across tables "
                f"{[b for b, _ in matches]}; qualify it"
            )
        return matches[0][1]

    def rewrite(self, expr):
        """Recursively replace Col nodes with internal-keyed Col nodes.
        Subquery bodies are self-contained (non-correlated) — they resolve
        against their own plan, not this environment."""
        if isinstance(expr, Col):
            return Col(self.resolve_col(expr))
        if isinstance(expr, SubQuery):
            return expr
        if isinstance(expr, ExistsSub):
            # the planner lowers EXISTS in WHERE/HAVING before resolution;
            # one reaching the resolver sits somewhere unsupported
            raise PlanError(
                "EXISTS is only supported in WHERE and HAVING"
            )
        if isinstance(expr, InSub):
            return InSub(self.rewrite(expr.expr), expr.sub, expr.negate)
        if isinstance(expr, WindowFn):
            arg = expr.arg
            if arg is not None and not isinstance(arg, Star):
                arg = self.rewrite(arg)
            return WindowFn(
                expr.func, arg,
                tuple(Col(self.resolve_col(p)) for p in expr.partition_by),
                tuple(OrderItem(self.rewrite(o.expr), o.descending)
                      for o in expr.order_by),
                expr.params, expr.frame,
            )
        from harkdb_tpu_torch.sql.ast_nodes import Coalesce, StrFunc

        if isinstance(expr, Coalesce):
            return Coalesce(tuple(self.rewrite(a) for a in expr.args))
        if isinstance(expr, StrFunc):
            return StrFunc(expr.func, self.rewrite(expr.arg), expr.params)
        if isinstance(expr, BinOp):
            return BinOp(expr.op, self.rewrite(expr.left), self.rewrite(expr.right))
        if isinstance(expr, UnOp):
            return UnOp(expr.op, self.rewrite(expr.operand))
        if isinstance(expr, Agg):
            if isinstance(expr.arg, Star):
                return expr
            return Agg(expr.func, self.rewrite(expr.arg), expr.distinct)
        if isinstance(expr, Case):
            return Case(
                tuple((self.rewrite(c), self.rewrite(r))
                      for c, r in expr.whens),
                self.rewrite(expr.else_) if expr.else_ is not None else None,
            )
        return expr

    def all_columns(self) -> List[Tuple[str, str]]:
        """(internal, bare display name) for every column, binding order."""
        out = []
        for b, _t, cols in self.bindings:
            for c in cols:
                out.append((f"{b}.{c}", c))
        return out

    def binding_columns(self, binding: str) -> List[Tuple[str, str]]:
        b_env = self.by_binding.get(binding)
        if b_env is None:
            raise PlanError(f"{binding} is not in tables")
        _, _t, cols = next(x for x in self.bindings if x[0] == binding)
        return [(b_env[c], c) for c in cols]


def _substitute_wins(expr, win_map):
    """Replace WindowFn nodes with their computed output columns."""
    from harkdb_tpu_torch.sql.ast_nodes import Coalesce as _Coalesce
    from harkdb_tpu_torch.sql.ast_nodes import CodeMap as _CM, NullTag as _NT

    if isinstance(expr, WindowFn):
        return Col(win_map[expr])
    if isinstance(expr, _Coalesce):
        return _Coalesce(tuple(
            _substitute_wins(a, win_map) for a in expr.args
        ))
    if isinstance(expr, _CM):
        return _CM(_substitute_wins(expr.col, win_map), expr.lut,
                   expr.out_dict)
    if isinstance(expr, _NT):
        return _NT(_substitute_wins(expr.expr, win_map), expr.flags)
    if isinstance(expr, BinOp):
        return BinOp(
            expr.op, _substitute_wins(expr.left, win_map),
            _substitute_wins(expr.right, win_map),
        )
    if isinstance(expr, UnOp):
        return UnOp(expr.op, _substitute_wins(expr.operand, win_map))
    if isinstance(expr, LutMember):
        return LutMember(_substitute_wins(expr.col, win_map), expr.lut)
    if isinstance(expr, InSub):
        return InSub(
            _substitute_wins(expr.expr, win_map), expr.sub, expr.negate
        )
    if isinstance(expr, Case):
        return Case(
            tuple((_substitute_wins(c, win_map), _substitute_wins(r, win_map))
                  for c, r in expr.whens),
            _substitute_wins(expr.else_, win_map)
            if expr.else_ is not None else None,
        )
    return expr


def _substitute_aggs(expr, agg_map):
    """Replace Agg nodes with their computed output columns."""
    from harkdb_tpu_torch.sql.ast_nodes import Coalesce as _Coalesce
    from harkdb_tpu_torch.sql.ast_nodes import CodeMap as _CodeMap

    if isinstance(expr, Agg):
        return Col(agg_map[expr])
    if isinstance(expr, _Coalesce):
        # pass-1 NULL lowering defers aggregate-containing COALESCE to the
        # post-substitution pass (plan/nulls.py) — substitute inside it
        return _Coalesce(tuple(
            _substitute_aggs(a, agg_map) for a in expr.args
        ))
    if isinstance(expr, _CodeMap):
        # string function over an aggregate (upper(min(s)) etc.)
        return _CodeMap(
            _substitute_aggs(expr.col, agg_map), expr.lut, expr.out_dict
        )
    if isinstance(expr, WindowFn):
        # windows over grouped output: their argument / ORDER BY may
        # reference aggregates (rank() over (order by sum(v) desc))
        arg = expr.arg
        if arg is not None and not isinstance(arg, Star):
            arg = _substitute_aggs(arg, agg_map)
        return WindowFn(
            expr.func, arg, expr.partition_by,
            tuple(OrderItem(_substitute_aggs(o.expr, agg_map),
                            o.descending) for o in expr.order_by),
            expr.params, expr.frame,
        )
    if isinstance(expr, BinOp):
        return BinOp(
            expr.op, _substitute_aggs(expr.left, agg_map),
            _substitute_aggs(expr.right, agg_map),
        )
    if isinstance(expr, UnOp):
        return UnOp(expr.op, _substitute_aggs(expr.operand, agg_map))
    if isinstance(expr, LutMember):
        return LutMember(_substitute_aggs(expr.col, agg_map), expr.lut)
    if isinstance(expr, InSub):
        return InSub(
            _substitute_aggs(expr.expr, agg_map), expr.sub, expr.negate
        )
    if isinstance(expr, Case):
        return Case(
            tuple((_substitute_aggs(c, agg_map), _substitute_aggs(r, agg_map))
                  for c, r in expr.whens),
            _substitute_aggs(expr.else_, agg_map)
            if expr.else_ is not None else None,
        )
    return expr


class QueryPlan(StringLowering, NullSemantics):
    """A planned query: phase-A join steps + the phase-B pipeline,
    executed eagerly on torch tensors."""

    def __init__(self, stmt: SelectStmt, tables: Dict[str, Table],
                 config: EngineConfig = DEFAULT_CONFIG):
        self.stmt = stmt
        self.config = config
        self._build(stmt, tables)

    # -- planning -------------------------------------------------------------
    def _build(self, stmt: SelectStmt, tables: Dict[str, Table]):
        # Correlated scalar-aggregate subqueries rewrite into LEFT JOINs
        # against grouped derived tables BEFORE any resolution
        # (plan/decorrelate.py); unrecognized shapes fall through to the
        # named correlated-subquery error below.
        from harkdb_tpu_torch.plan.decorrelate import decorrelate_aggregates

        stmt = decorrelate_aggregates(stmt, tables)
        self.stmt = stmt
        # FROM / JOIN resolution (reference contract parse.py:29-33).
        refs = [stmt.table] + [j.table for j in stmt.joins]
        bindings = []
        seen = set()
        # Derived tables (FROM (SELECT ...) alias): the inner SELECT plans
        # now (resolution errors surface at plan time) and materializes
        # lazily at first execution — plan/derived.py.
        self._derived: Dict[str, object] = {}
        self._derived_by_stmt: Dict[int, object] = {}
        for ref in refs:
            b = ref.binding
            if b in seen:
                raise PlanError(f"Duplicate table binding {b!r}; use aliases")
            seen.add(b)
            if isinstance(ref, DerivedRef):
                from harkdb_tpu_torch.plan.derived import DerivedSource

                # CTE references share the SAME statement object (parser
                # substitution) — share one DerivedSource per body so the
                # inner query materializes once however many times the
                # CTE is named. Set-operation bodies plan as UnionPlans.
                src = self._derived_by_stmt.get(id(ref.stmt))
                if src is None:
                    src = DerivedSource(
                        _plan_for_stmt(ref.stmt, tables, self.config)
                    )
                    self._derived_by_stmt[id(ref.stmt)] = src
                self._derived[ref.name] = src
                bindings.append((b, ref.name, src.get_schema()))
                continue
            if ref.name not in tables:
                raise PlanError(f"{ref.name} is not in tables",
                                "table", ref.name)
            bindings.append((b, ref.name, tables[ref.name].get_schema()))
        self.bindings = bindings
        res = _Resolver(bindings)
        self.resolver = res

        # Joins: resolve keys; joins fold left-to-right (left side = the
        # accumulated working relation). Keys per step are LISTS — ``ON``
        # accepts a conjunction of column equalities (multi-key equi-join).
        self.join_steps = []
        #: per step: flag columns guarding the accumulated-side join keys
        #: (a nullable key — from an earlier outer join — must match
        #: nothing: SQL NULL = NULL is UNKNOWN, not a match).
        self.join_key_flags: List[List[str]] = []
        # ---- outer-join NULL model -------------------------------------------
        # Each LEFT (and RIGHT/FULL) join emits hidden 0/1 matched-flag
        # column(s) (ops/join.py matched_out); 0 marks the rows SQL would
        # fill with NULL on that side. The flags drive IS [NOT] NULL,
        # three-valued predicates, NULL-skipping aggregates,
        # NULL-as-its-own-group grouping, and sql_df's None/NaN decode.
        self.binding_flags: Dict[str, List[str]] = {}
        self.null_flags: Dict[str, str] = {}     # left-join rb → matched col
        avail = {bindings[0][0]}
        for j, ref in zip(stmt.joins, refs[1:]):
            rb = ref.binding
            lks, rks = [], []
            for a_raw, b_raw in j.conds:
                a = res.rewrite(a_raw)
                b = res.rewrite(b_raw)
                # Decide which side of ON belongs to the incoming table.
                a_side = a.name.split(".", 1)[0]
                b_side = b.name.split(".", 1)[0]
                if b_side == rb and a_side in avail:
                    lk, rk = a.name, b.name
                elif a_side == rb and b_side in avail:
                    lk, rk = b.name, a.name
                else:
                    raise PlanError(
                        f"JOIN ON must relate the joined table {rb} to an "
                        f"already-joined table"
                    )
                lks.append(lk)
                rks.append(rk)
            kflags: List[str] = []
            for lk in lks:
                for f in self.binding_flags.get(lk.split(".", 1)[0], ()):
                    if f not in kflags:
                        kflags.append(f)
            self.join_steps.append((rb, tuple(lks), tuple(rks), j.kind))
            self.join_key_flags.append(kflags)
            avail.add(rb)
            flag = f"#matched.{rb}"
            if j.kind == "left":
                self.null_flags[rb] = flag
                self.binding_flags[rb] = [flag]
            elif j.kind in ("right", "full"):
                # RIGHT/FULL: the ACCUMULATED side becomes nullable — every
                # already-joined binding gains this step's left-side flag.
                lflag = f"#lmatched.{rb}"
                for b2 in list(avail - {rb}):
                    self.binding_flags.setdefault(b2, []).append(lflag)
                if j.kind == "full":
                    self.null_flags[rb] = flag
                    self.binding_flags.setdefault(rb, []).append(flag)

        # ---- string columns (dictionary-encoded at ingest) -------------------
        # str_dicts: internal column → its current sorted dictionary. Codes are
        # lexicographic ranks within the dictionary, so every comparison /
        # ORDER BY / MIN / MAX / GROUP BY runs on plain int32 — the device
        # never sees a string. Cross-dictionary col-vs-col comparisons merge
        # dictionaries at plan time and record a per-column code-remap LUT
        # applied at load.
        self.str_dicts: Dict[str, np.ndarray] = {}
        self._remap: Dict[str, np.ndarray] = {}   # internal → orig→current LUT
        for b, tname, cols_ in bindings:
            t = self._source(tables, tname)
            for c in cols_:
                d = t.column_dict(c)
                if d is not None:
                    self.str_dicts[f"{b}.{c}"] = d
        for _rb, lks, rks, _k in self.join_steps:
            for lk, rk in zip(lks, rks):
                ld = self.str_dicts.get(lk)
                rd = self.str_dicts.get(rk)
                if (ld is None) != (rd is None):
                    raise PlanError(
                        f"Cannot join string column to numeric column "
                        f"({lk} = {rk})"
                    )
                if ld is not None:
                    self._merge_dicts(lk, rk)

        # Select list: expand stars, resolve, classify.
        items: List[Tuple[object, str]] = []       # (resolved expr, display)
        for it in stmt.items:
            if isinstance(it.expr, Star):
                cols = (
                    res.binding_columns(it.expr.table)
                    if it.expr.table else res.all_columns()
                )
                for internal, bare in cols:
                    items.append((Col(internal), bare))
            else:
                e = res.rewrite(it.expr)
                items.append((e, it.alias or _expr_name(it.expr)))
        self.select_items = items

        where_ast = stmt.where
        # Non-equi ON residuals: for INNER joins they are equivalent to
        # WHERE conjuncts (relational algebra); outer joins reject them —
        # an outer-join ON residual changes which rows count as MATCHED
        # (NULL-extended vs filtered), which the matched-flag machinery
        # does not model.
        for j in stmt.joins:
            if not j.residuals:
                continue
            if j.kind != "inner":
                raise PlanError(
                    "Non-equi ON conditions are only supported on INNER "
                    "joins (an outer join's ON residual changes matched-"
                    "row semantics); filter in WHERE instead"
                )
            for r_ast in j.residuals:
                where_ast = (r_ast if where_ast is None
                             else BinOp("and", where_ast, r_ast))
        having_ast = stmt.having
        # EXISTS lowers pre-resolution: a single correlated column equality
        # becomes the semi-join form `outer_col IN (SELECT inner_col ...)`;
        # uncorrelated becomes `(SELECT count(*) ...) > offset`.
        if where_ast is not None:
            where_ast = self._lower_exists(where_ast, tables)
        if having_ast is not None:
            having_ast = self._lower_exists(having_ast, tables)
        self.where = res.rewrite(where_ast) if where_ast is not None else None
        group_items_raw = [res.rewrite(g) for g in stmt.group_by]

        # ORDER BY may reference select-list aliases (standard SQL output-name
        # resolution). Real columns win; an alias is tried only when the bare
        # identifier resolves to no table column.
        alias_map = {
            it.alias: it.expr for it in stmt.items
            if it.alias and not isinstance(it.expr, Star)
        }

        def _order_expr(e):
            try:
                return res.rewrite(e)
            except PlanError:
                if (isinstance(e, Col) and e.table is None
                        and e.name in alias_map):
                    return res.rewrite(alias_map[e.name])
                raise

        order_items = [
            (_order_expr(o.expr), o.descending) for o in stmt.order_by
        ]
        having = res.rewrite(having_ast) if having_ast is not None else None

        # ---- string lowering -------------------------------------------------
        # Two passes over every resolved expression: (1) merge dictionaries
        # for cross-dictionary string col-vs-col comparisons, so literal
        # translation below sees FINAL dictionaries;
        # (2) translate string-literal comparisons / LIKE patterns into
        # integer code comparisons and validate string typing (no string
        # arithmetic, no SUM/PROD/AVG over strings).
        if self.str_dicts:
            for e in (
                [e for e, _ in items]
                + ([self.where] if self.where is not None else [])
                + [e for e, _ in order_items]
                + ([having] if having is not None else [])
                + group_items_raw
            ):
                self._collect_merges(e)
        items = [(self._lower_strings(e), name) for e, name in items]
        self.select_items = items
        if self.where is not None:
            self.where = self._lower_strings(self.where)
        order_items = [(self._lower_strings(e), d) for e, d in order_items]
        if having is not None:
            having = self._lower_strings(having)

        # ---- NULL lowering, pass 1 (pre-GROUP BY) ----------------------------
        # isnull(e) → flag tests; COALESCE → flag-guarded CASE; CASE
        # conditions → Kleene is-true form; WHERE → full three-valued
        # lowering (plan/nulls.py). Aggregate-containing isnull/COALESCE
        # subtrees defer to pass 2 (post-substitution, where aggregate
        # outputs carry their own validity flags).
        self.agg_null_flags: Dict[str, str] = {}
        #: derived flag name → validity expression (OR over matched
        #: conditions; COALESCE over several nullable args — plan/nulls.py)
        self.derived_flag_cols: Dict[str, object] = {}
        items = [
            (self._rewrite_case_conds(self._lower_isnull(e, defer_aggs=True)),
             name)
            for e, name in items
        ]
        self.select_items = items
        if self.where is not None:
            self.where = self._lower_pred_3vl(
                self._lower_isnull(self.where)
            )
        order_items = [
            (self._rewrite_case_conds(self._lower_isnull(e, defer_aggs=True)),
             d)
            for e, d in order_items
        ]
        if having is not None:
            having = self._lower_isnull(having, defer_aggs=True)

        # ---- GROUP BY expressions --------------------------------------------
        # Non-column group keys (engine extension; the reference is
        # single-column, parse.py:66-69) materialize as hidden computed
        # columns `#gexprN` evaluated just before the group-by (they ride
        # its sort like aggregate arguments). Occurrences of the same
        # expression in the select list / HAVING / ORDER BY substitute to
        # the hidden column — which both satisfies the bare-column
        # validation and makes post-group evaluation read the surviving
        # key column instead of consumed base columns.
        group_keys: List[str] = []
        self.group_key_exprs: List[Tuple[str, object]] = []
        self.expr_col_flags: Dict[str, List[str]] = {}
        for g in group_items_raw:
            g2 = self._rewrite_case_conds(
                self._lower_isnull(self._lower_strings(g))
            )
            if isinstance(g2, Col):
                group_keys.append(g2.name)
                continue
            name = f"#gexpr{len(self.group_key_exprs)}"
            self.group_key_exprs.append((name, g2))
            d = self._expr_str_dict(g2)
            if d is not None:
                self.str_dicts[name] = d
            fl = self._nullable_flags_in(g2)
            if fl:
                self.expr_col_flags[name] = fl
            group_keys.append(name)

        if self.group_key_exprs:
            def subst_g(e):
                for name, g2 in self.group_key_exprs:
                    if e == g2:
                        return Col(name)
                from harkdb_tpu_torch.sql.ast_nodes import (
                    Coalesce as _Coal, CodeMap as _CM, StrFunc as _SF,
                )

                if isinstance(e, BinOp):
                    return BinOp(e.op, subst_g(e.left), subst_g(e.right))
                if isinstance(e, UnOp):
                    return UnOp(e.op, subst_g(e.operand))
                if isinstance(e, Agg) and not isinstance(e.arg, Star):
                    return Agg(e.func, subst_g(e.arg), e.distinct)
                if isinstance(e, Case):
                    return Case(
                        tuple((subst_g(c), subst_g(r))
                              for c, r in e.whens),
                        subst_g(e.else_) if e.else_ is not None else None,
                    )
                if isinstance(e, _Coal):
                    return _Coal(tuple(subst_g(a) for a in e.args))
                if isinstance(e, LutMember):
                    return LutMember(subst_g(e.col), e.lut)
                if isinstance(e, _CM):
                    return _CM(subst_g(e.col), e.lut, e.out_dict)
                from harkdb_tpu_torch.sql.ast_nodes import NullTag as _NT

                if isinstance(e, _NT):
                    return _NT(subst_g(e.expr), e.flags)
                if isinstance(e, _SF):
                    return _SF(e.func, subst_g(e.arg), e.params)
                if isinstance(e, InSub):
                    return InSub(subst_g(e.expr), e.sub, e.negate)
                if isinstance(e, WindowFn):
                    arg = e.arg
                    if arg is not None and not isinstance(arg, Star):
                        arg = subst_g(arg)
                    return WindowFn(
                        e.func, arg, e.partition_by,
                        tuple(OrderItem(subst_g(o.expr), o.descending)
                              for o in e.order_by),
                        e.params, e.frame,
                    )
                return e

            items = [(subst_g(e), name) for e, name in items]
            self.select_items = items
            order_items = [(subst_g(e), d) for e, d in order_items]
            if having is not None:
                having = subst_g(having)

        # A string literal surviving lowering was used outside a comparison
        # (e.g. selected bare, or added to a number) — reject at plan time
        # rather than failing inside the evaluator.
        for e in (
            [e for e, _ in items]
            + ([self.where] if self.where is not None else [])
            + [e for e, _ in order_items]
            + ([having] if having is not None else [])
        ):
            nodes = walk(e)
            if any(isinstance(nd, (SubQuery, InSub)) for nd in nodes):
                # Comparisons against a subquery defer lowering to first
                # execution ('x' = (select max(name) ...) is legitimate);
                # _bind_subqueries re-validates post-substitution.
                continue
            for node in nodes:
                if isinstance(node, Lit) and isinstance(node.value, str):
                    raise PlanError(
                        "String literals are only supported in comparisons, "
                        "IN, BETWEEN and LIKE"
                    )

        # Per-binding code-remap LUTs (original codes → merged-dictionary
        # codes), applied at table load on both execution paths.
        self.load_remaps: Dict[str, Dict[str, np.ndarray]] = {}
        for internal, lut in self._remap.items():
            self.load_remaps.setdefault(
                internal.split(".", 1)[0], {}
            )[internal] = lut

        # ---- filter pushdown -------------------------------------------------
        # Split WHERE into top-level AND conjuncts; a conjunct referencing a
        # single binding is evaluated on that table BEFORE its join (never
        # past a LEFT join's right side: zero-filled unmatched rows must still
        # be eliminated by the post-join residual). A conjunct may be pushed
        # below the joins only when its binding's rows are never
        # NULL-extended: inner/cross-joined bindings that do not later sit on
        # the nullable side of an outer join (RIGHT/FULL make the whole
        # accumulated side nullable — binding_flags).
        inner_bindings = {bindings[0][0]}
        for j, ref in zip(stmt.joins, refs[1:]):
            if j.kind in ("inner", "cross"):
                inner_bindings.add(ref.binding)
        inner_bindings -= set(self.binding_flags)

        def conjuncts(e):
            if isinstance(e, BinOp) and e.op == "and":
                return conjuncts(e.left) + conjuncts(e.right)
            return [e]

        self.pushdown: Dict[str, object] = {}
        residual = []
        if self.where is not None:
            for c in conjuncts(self.where):
                bset = {
                    node.name.split(".", 1)[0]
                    for node in walk(c) if isinstance(node, Col)
                }
                if len(bset) == 1 and (b0 := next(iter(bset))) in inner_bindings:
                    prev = self.pushdown.get(b0)
                    self.pushdown[b0] = (
                        c if prev is None else BinOp("and", prev, c)
                    )
                else:
                    residual.append(c)
            w = None
            for c in residual:
                w = c if w is None else BinOp("and", w, c)
            self.where_residual = w
        else:
            self.where_residual = None

        # Aggregate extraction across select/having/order-by.
        post_exprs = [e for e, _ in items]
        if having is not None:
            post_exprs.append(having)
        post_exprs += [e for e, _ in order_items]
        agg_nodes: List[Agg] = []
        for e in post_exprs:
            for node in walk(e):
                if isinstance(node, Agg) and node not in agg_nodes:
                    agg_nodes.append(node)
        for node in agg_nodes:
            if not isinstance(node.arg, Star):
                for inner in walk(node.arg):
                    if isinstance(inner, Agg):
                        raise PlanError("Nested aggregates are not allowed")

        grouped = bool(group_keys) or bool(agg_nodes)
        self.grouped = grouped
        self.group_keys = group_keys
        # NULL is its own group: a nullable (LEFT-JOIN right side) group key
        # adds its hidden matched flag as a secondary grouping key, so the
        # no-match group separates from the real value-0 group (the flag
        # then survives grouping and drives sql_df's None decode).
        extra_keys: List[str] = []
        for k in group_keys:
            for f in self._col_null_flags(k):
                if f not in extra_keys:
                    extra_keys.append(f)
        self.group_exec_keys = group_keys + extra_keys

        # Validation (reference contract parse.py:73-78): in a grouped query a
        # bare column outside an aggregate must be a group key.
        if grouped:
            def check(e, inside_agg=False):
                if isinstance(e, Col):
                    if not inside_agg and e.name not in self.group_exec_keys:
                        bare = e.name.split(".", 1)[-1]
                        raise PlanError(
                            f"{bare} is not an aggregation function or the "
                            f"columns thats grouped on"
                        )
                elif isinstance(e, BinOp):
                    check(e.left, inside_agg)
                    check(e.right, inside_agg)
                elif isinstance(e, UnOp):
                    check(e.operand, inside_agg)
                elif isinstance(e, Agg) and not isinstance(e.arg, Star):
                    check(e.arg, True)
                elif isinstance(e, LutMember):
                    check(e.col, inside_agg)
                elif isinstance(e, InSub):
                    check(e.expr, inside_agg)
                elif isinstance(e, WindowFn):
                    # windows evaluate over the GROUPED output: their
                    # argument / partition / order expressions obey the
                    # same rule (group key or aggregate)
                    if e.arg is not None and not isinstance(e.arg, Star):
                        check(e.arg, inside_agg)
                    for p in e.partition_by:
                        check(p, inside_agg)
                    for o in e.order_by:
                        check(o.expr, inside_agg)
                elif isinstance(e, Case):
                    for c, r in e.whens:
                        check(c, inside_agg)
                        check(r, inside_agg)
                    if e.else_ is not None:
                        check(e.else_, inside_agg)
                else:
                    from harkdb_tpu_torch.sql.ast_nodes import (
                        Coalesce as _Co, CodeMap as _CM2, NullTag as _NT2,
                        StrFunc as _SF2,
                    )

                    if isinstance(e, _NT2):
                        check(e.expr, inside_agg)
                    elif isinstance(e, _CM2):
                        check(e.col, inside_agg)
                    elif isinstance(e, _SF2):
                        check(e.arg, inside_agg)
                    elif isinstance(e, _Co):
                        for a in e.args:
                            check(a, inside_agg)
            for e in post_exprs:
                check(e)

        # Aggregate slots — plan/aggregates.py (round-5 split): each Agg
        # lowers to argument columns + groupby specs + post-computes +
        # NULL-result flags (SQL: SUM/AVG/MIN/MAX/PROD of an all-NULL or
        # empty group is NULL, COUNT is 0).
        from harkdb_tpu_torch.plan.aggregates import lower_aggregates

        agg_map = lower_aggregates(self, agg_nodes, tables, bindings)

        # Rewrite post-groupby expressions: aggs → their output columns,
        # then NULL lowering pass 2 — the isnull/COALESCE/CASE-condition
        # subtrees deferred in pass 1 now see the aggregate outputs as
        # columns carrying agg_null_flags; HAVING additionally gets the
        # full three-valued predicate lowering.
        def _lower2(e):
            return self._rewrite_case_conds(self._lower_isnull(e))

        self.final_items = [
            (_lower2(_substitute_aggs(e, agg_map)), name)
            for e, name in items
        ]
        self.having = (
            self._lower_pred_3vl(
                self._lower_isnull(_substitute_aggs(having, agg_map))
            )
            if having is not None else None
        )
        self.order_items = [
            (_lower2(_substitute_aggs(e, agg_map)), d) for e, d in order_items
        ]
        # NULLS FIRST/LAST per order item (None = SQL default: LAST for
        # ASC, FIRST for DESC). Only meaningful for nullable (LEFT-JOIN
        # right side) expressions — see _null_adjusted_key.
        self.order_nulls = [o.nulls for o in stmt.order_by]

        # ---- window functions ------------------------------------------------
        # Computed over the post-WHERE rows (ungrouped) or the GROUPED
        # output (standard SQL: windows evaluate after GROUP BY/HAVING —
        # their arguments reference aggregates, already substituted to
        # their output columns above). One payload sort per distinct
        # (PARTITION BY, ORDER BY) shape + a single shared restore
        # (plan/windows.py). Only in the select list / ORDER BY. Grouped
        # queries tie-break window sorts on the exec group keys (unique
        # per row) instead of the row positions grouping consumed.
        win_nodes: List[WindowFn] = []
        for e in ([e for e, _ in self.final_items]
                  + [e for e, _ in self.order_items]):
            for node in walk(e):
                if isinstance(node, WindowFn) and node not in win_nodes:
                    win_nodes.append(node)
        for container in (
            list(self.pushdown.values())
            + ([self.where_residual] if self.where_residual is not None
               else [])
            + ([self.having] if self.having is not None else [])
        ):
            if any(isinstance(n, WindowFn) for n in walk(container)):
                raise PlanError(
                    "Window functions are only allowed in the select list "
                    "and ORDER BY"
                )
        if win_nodes and grouped and not group_keys:
            raise PlanError(
                "Window functions over an ungrouped aggregate (a single "
                "implicit group) are not meaningful"
            )
        self.window_specs: List[Tuple] = []
        self.win_out_dicts: Dict[str, np.ndarray] = {}
        win_map: Dict[WindowFn, str] = {}
        for i, node in enumerate(win_nodes):
            out = f"#win{i}"
            arg_is_str = (
                node.arg is not None and not isinstance(node.arg, Star)
                and self._expr_str_dict(node.arg) is not None
            )
            # code-preserving funcs keep the argument's dictionary
            if node.func in ("min", "max", "lag", "lead", "first_value",
                             "last_value", "nth_value") and arg_is_str:
                self.win_out_dicts[out] = self._expr_str_dict(node.arg)
            if node.func in ("lag", "lead"):
                if node.params and (
                    not isinstance(node.params[0], int)
                    or node.params[0] < 0
                ):
                    raise PlanError(
                        f"{node.func} offset must be a non-negative integer"
                    )
                if arg_is_str and len(node.params) > 1:
                    raise PlanError(
                        f"{node.func} over a string column does not "
                        f"support an explicit default"
                    )
            if node.frame is not None:
                # frame = ("rows", lo, hi): signed offsets from the
                # current row (negative = PRECEDING), None = unbounded.
                lo_f, hi_f = node.frame[1], node.frame[2]
                if node.func == "prod" and lo_f is not None:
                    raise PlanError(
                        "PROD does not support a bounded ROWS frame "
                        "(no inverse for the sliding combine)"
                    )
                if node.func in ("min", "max") and not (
                    (lo_f is None or lo_f <= 0)
                    and (hi_f is None or hi_f >= 0)
                ):
                    raise PlanError(
                        "Bounded MIN/MAX frames must include the current "
                        "row (no inverse for the sliding combine)"
                    )
                if node.func != "count" and (
                    (lo_f is not None and lo_f > 0)
                    or (hi_f is not None and hi_f < 0)
                ):
                    # frame can be empty → NULL result rows (hidden
                    # validity column emitted by plan/windows.py)
                    self.agg_null_flags[out] = f"#winvalid{i}"
            if node.func == "nth_value":
                # all-frame-shorter-than-n rows are NULL — a hidden
                # validity column computed alongside the value drives the
                # output NULL indicators (plan/windows.py)
                self.agg_null_flags[out] = f"#winvalid{i}"
            self.window_specs.append((
                out, node.func,
                None if (node.arg is None or isinstance(node.arg, Star))
                else node.arg,
                tuple(p.name for p in node.partition_by),
                tuple(o.expr for o in node.order_by),
                tuple(o.descending for o in node.order_by),
                tuple(node.params),
                node.frame,
            ))
            win_map[node] = out
        if win_nodes:
            self.final_items = [
                (_substitute_wins(e, win_map), n) for e, n in self.final_items
            ]
            self.order_items = [
                (_substitute_wins(e, win_map), d) for e, d in self.order_items
            ]

        self.limit = stmt.limit
        self.offset = stmt.offset
        self.distinct = stmt.distinct

        # ---- sort-order tracking ---------------------------------------------
        # When the final ORDER BY is EXACTLY one window shape's
        # (PARTITION BY asc..., ORDER BY ...) sort — same expressions,
        # same directions, default NULL placement, no nullable keys (their
        # extreme substitution would reorder), no DISTINCT — that shape's
        # own sort already produces the requested order: compute_windows
        # schedules it last and both the restore and run_tail's ORDER BY
        # sort are skipped (plan/windows.py).
        self.window_skip_shape = None
        if (self.window_specs and self.order_items and not self.distinct
                and all(nu is None for nu in self.order_nulls)):
            shapes = {(s[3], s[4], s[5]) for s in self.window_specs}
            for parts, oexprs, descs in shapes:
                target = (
                    [(Col(p), False) for p in parts]
                    + list(zip(oexprs, descs))
                )
                if (len(self.order_items) == len(target)
                        and all(e == te and d == td
                                for (e, d), (te, td)
                                in zip(self.order_items, target))
                        and all(not self._nullable_flags_in(e)
                                for e, _d in self.order_items)):
                    self.window_skip_shape = (parts, oexprs, descs)
                    break
        if self.distinct:
            # With DISTINCT the row set changes before ORDER BY, so order
            # keys must be select-list expressions (standard SQL rule).
            self.order_out_idx = []
            for e, _d in self.order_items:
                matches = [
                    j for j, (fe, _n) in enumerate(self.final_items) if fe == e
                ]
                if not matches:
                    raise PlanError(
                        "ORDER BY expressions must appear in the select list "
                        "when SELECT DISTINCT is used"
                    )
                self.order_out_idx.append(matches[0])
        self.output_names = [name for _, name in items]
        # Per-output string dictionary (None = numeric): a select output that
        # is a string column (or MIN/MAX of one) decodes host-side in sql_df;
        # the device-result matrix itself always holds the int32 codes.
        self.output_dicts = []
        from harkdb_tpu_torch.sql.ast_nodes import CodeMap as _CodeMap

        for e, _name in self.final_items:
            d = None
            if isinstance(e, Col):
                d = self.str_dicts.get(e.name)
                if d is None:
                    d = self.agg_out_dicts.get(e.name)
                if d is None:
                    d = self.win_out_dicts.get(e.name)
            elif isinstance(e, _CodeMap):
                d = e.out_dict          # string function output (UPPER/...)
            self.output_dicts.append(d)

        # Per-output nullable flags: an output whose expression references a
        # nullable (LEFT-JOIN right side) column is NULL — None/NaN in
        # sql_df — on rows where any referenced flag is 0. run_tail
        # materializes a hidden trailing #nullflag{i} column per such
        # output; api.sql drops them, api.sql_df decodes through them.
        self.output_null_flags: List[List[str]] = [
            self._nullable_flags_in(e) for e, _n in self.final_items
        ]

        # Dense-key GROUP BY (kernels/matmul_agg.py, kernel C on a card):
        # single int key with a small span, aggregates all sum/count over
        # direct int columns. Eligibility is STRUCTURAL at plan time
        # (fast_candidate); the key range comes from host table stats when
        # the key is a no-join base column (free, fast_agg proven here), and
        # otherwise from a one-time on-device min/max probe at first
        # execution (post-join / post-WHERE keys) — see _resolve_fast.
        self.fast_candidate = None      # key internal name when structural
        self.fast_agg = None            # (key, key_min, span_p) when proven
        self._probed_fast = None        # execute-time probe cache
        self.last_fast_span = None      # introspection: span used, or None
        if (
            self.grouped
            and not self.group_key_exprs
            and len(self.group_keys) == 1
            # a nullable key grows exec keys with its matched flag — the
            # dense kernel is single-key, and NULL-as-its-own-group needs
            # the general path
            and len(self.group_exec_keys) == 1
            and self.agg_specs
            and not self.agg_arg_cols
            and all(op in ("sum", "count") for _s, op, _o in self.agg_specs)
        ):
            def _int_col(internal: str) -> bool:
                if "." not in internal:
                    return False
                bb, col = internal.split(".", 1)
                tname2 = next(t for b2, t, _ in bindings if b2 == bb)
                a = self._source(tables, tname2).host_columns.get(col)
                return a is not None and np.issubdtype(a.dtype, np.integer)

            key_internal = self.group_keys[0]
            int_srcs = all(
                op == "count" or _int_col(src)   # count ignores values
                for src, op, _out in self.agg_specs
            )
            if int_srcs and _int_col(key_internal):
                self.fast_candidate = key_internal
                # Host table stats describe ORIGINAL codes; a remapped
                # (merged-dictionary) key must go through the on-device
                # probe instead.
                if not self.join_steps and key_internal not in self._remap:
                    b, col = key_internal.split(".", 1)
                    tname = next(t for bb, t, _ in bindings if bb == b)
                    rng = self._source(tables, tname).column_range(col)
                    # u32-compat key order with negative keys must take the
                    # sort path (keys_axis is emitted signed-ascending).
                    compat_blocks = (
                        self.config.compat_u32_key_order
                        and rng is not None and rng[0] < 0
                    )
                    if rng is not None and not compat_blocks:
                        span = rng[1] - rng[0] + 1
                        if span <= MAX_KEY_SPAN:
                            self.fast_agg = (
                                key_internal, rng[0], pad_span(span)
                            )

        # ---- projection pushdown ---------------------------------------------
        # Only load columns the query actually touches (select/where/having/
        # order/group/agg-args).
        used = set()
        for e, _n in self.final_items:
            used |= {n.name for n in walk(e) if isinstance(n, Col)}
        for e in ([self.where] if self.where is not None else []):
            used |= {n.name for n in walk(e) if isinstance(n, Col)}
        if self.having is not None:
            used |= {n.name for n in walk(self.having) if isinstance(n, Col)}
        for e, _d in self.order_items:
            used |= {n.name for n in walk(e) if isinstance(n, Col)}
        for _i, e in self.agg_arg_cols:
            used |= {n.name for n in walk(e) if isinstance(n, Col)}
        for src, _o, _x in self.agg_specs:
            for s in (src if isinstance(src, tuple) else (src,)):
                if "." in s:
                    used.add(s)
        used |= set(self.group_keys)
        for _n, e in self.group_key_exprs:
            used |= {n.name for n in walk(e) if isinstance(n, Col)}
        for _rb, lks, rks, _k in self.join_steps:
            used |= set(lks) | set(rks)
        for _out, _f, arg, parts, oexprs, _ds, *_rest in self.window_specs:
            used |= set(parts)
            if arg is not None:
                used |= {n.name for n in walk(arg) if isinstance(n, Col)}
            for oe in oexprs:
                used |= {n.name for n in walk(oe) if isinstance(n, Col)}
        self.used_columns = used

        # ---- subqueries ------------------------------------------------------
        # Plan every (self-contained) subquery now so resolution errors
        # surface at plan time; each runs on every execution and its value
        # is substituted into that execution's expressions only
        # (one_execution): the plan keeps the unbound expressions.
        self._subplans: Dict[object, object] = {}
        self._unbound = (self._expr_state()
                         if self._collect_subqueries(tables) else None)

    # -- EXISTS lowering -------------------------------------------------------
    def _lower_exists(self, e, tables):
        """Replace ExistsSub nodes (WHERE/HAVING only) with their semi-join
        or scalar-count forms — see ``_rewrite_exists``."""
        if isinstance(e, ExistsSub):
            return self._rewrite_exists(e.stmt, tables)
        if isinstance(e, BinOp):
            return BinOp(e.op, self._lower_exists(e.left, tables),
                         self._lower_exists(e.right, tables))
        if isinstance(e, UnOp):
            return UnOp(e.op, self._lower_exists(e.operand, tables))
        if isinstance(e, Case):
            return Case(
                tuple((self._lower_exists(c, tables),
                       self._lower_exists(r, tables)) for c, r in e.whens),
                self._lower_exists(e.else_, tables)
                if e.else_ is not None else None,
            )
        return e

    def _rewrite_exists(self, sub, tables):
        """EXISTS (SELECT ...):

        * exactly one correlated COLUMN equality in the inner WHERE
          (``... r.k = t.k``) → ``t.k IN (SELECT r.k FROM ... WHERE rest)``
          — exact semi-join semantics (membership of the outer key in the
          filtered inner key set); inner ORDER BY/LIMIT are irrelevant to
          emptiness and drop;
        * no correlation → ``(SELECT count(*) ...) > offset`` (LIMIT ≥ 1
          cannot change emptiness; LIMIT 0 folds to false);
        * anything more correlated raises the standard message.
        """
        if sub.group_by or sub.having is not None or sub.distinct:
            raise PlanError(
                "EXISTS subqueries with GROUP BY/HAVING/DISTINCT are not "
                "supported"
            )
        if sub.limit == 0:
            return BinOp("<", Lit(1), Lit(0))          # always false
        inner_bind: Dict[str, set] = {}
        for ref in [sub.table] + [j.table for j in sub.joins]:
            if isinstance(ref, DerivedRef):
                body = ref.stmt
                if not isinstance(body, SelectStmt):
                    body = body.arms[0]   # set-op body: first arm's schema
                inner_bind[ref.binding] = {
                    it.alias or _expr_name(it.expr) for it in body.items
                }
            elif ref.name in tables:
                inner_bind[ref.binding] = set(tables[ref.name].get_schema())
            else:
                raise PlanError(f"{ref.name} is not in tables")
        outer_bind = {b: set(cols) for b, _t, cols in self.bindings}

        def scope(col: Col) -> str:
            if col.table is not None:
                if col.table in inner_bind:
                    return "inner"
                if col.table in outer_bind:
                    return "outer"
                return "unknown"
            # bare name: inner scope shadows outer (standard SQL)
            if any(col.name in cs for cs in inner_bind.values()):
                return "inner"
            if any(col.name in cs for cs in outer_bind.values()):
                return "outer"
            return "unknown"

        def conjuncts(x):
            if isinstance(x, BinOp) and x.op == "and":
                return conjuncts(x.left) + conjuncts(x.right)
            return [x]

        corr = None
        rest = []
        for c in (conjuncts(sub.where) if sub.where is not None else []):
            if (corr is None and isinstance(c, BinOp) and c.op == "="
                    and isinstance(c.left, Col) and isinstance(c.right, Col)):
                sl, sr = scope(c.left), scope(c.right)
                if {sl, sr} == {"inner", "outer"}:
                    inner_col = c.left if sl == "inner" else c.right
                    outer_col = c.right if sl == "inner" else c.left
                    corr = (inner_col, outer_col)
                    continue
            for nd in walk(c):
                if isinstance(nd, Col) and scope(nd) == "outer":
                    raise PlanError(
                        "correlated subqueries are not supported beyond a "
                        "single EXISTS column equality"
                    )
            rest.append(c)
        w = None
        for c in rest:
            w = c if w is None else BinOp("and", w, c)
        if corr is None:
            cnt_stmt = SelectStmt(
                items=(SelectItem(Agg("count", Star())),),
                table=sub.table, joins=sub.joins, where=w,
                group_by=(), having=None, order_by=(), limit=None,
                offset=None, distinct=False,
            )
            return BinOp(">", SubQuery(cnt_stmt), Lit(sub.offset or 0))
        if sub.offset:
            raise PlanError(
                "EXISTS with both OFFSET and a correlation is not supported"
            )
        in_stmt = SelectStmt(
            items=(SelectItem(corr[0]),), table=sub.table, joins=sub.joins,
            where=w, group_by=(), having=None, order_by=(), limit=None,
            offset=None, distinct=False,
        )
        return InSub(corr[1], SubQuery(in_stmt), False)

    # -- NULL machinery: plan/nulls.py (NullSemantics mixin) -------------------
    def _null_adjusted_key(self, expr, d: bool, nu, cols, cap):
        """ORDER BY key for a possibly-nullable expression: evaluate, then
        substitute the dtype extreme on NULL rows so NULLs sort to the SQL
        end (``null_extreme_sub``); plain expressions unchanged."""
        a = eval_expr(expr, cols, cap, self.config)
        flags = self._nullable_flags_in(expr)
        if flags:
            m = self._valid_arr(flags, cols, cap)
            if m is not None:
                a = null_extreme_sub(a, ~m, d, nu)
        return a

    # -- subqueries ------------------------------------------------------------
    def _expr_state(self) -> tuple:
        """The expressions a subquery's value is substituted into."""
        return (self.final_items, self.pushdown, self.where_residual,
                self.having, self.order_items, self.agg_arg_cols,
                self.window_specs)

    def _set_expr_state(self, state: tuple) -> None:
        (self.final_items, self.pushdown, self.where_residual, self.having,
         self.order_items, self.agg_arg_cols, self.window_specs) = state

    @contextlib.contextmanager
    def one_execution(self, tables, execute=None):
        """The scope of one execution of this plan. On entry every
        subquery runs (through ``execute(plan)`` when given: the
        distributed executor runs them over its mesh) and its value is
        substituted into the plan's expressions; on exit the expressions
        go back to their unbound form and every derived table drops its
        materialization. So nothing read from the tables outlives the
        execution, and a repeated text runs its inner plans again."""
        try:
            if self._unbound is not None:
                self._bind_subqueries(tables, execute)
            yield
        finally:
            if self._unbound is not None:
                self._set_expr_state(self._unbound)
            for src in self._derived_by_stmt.values():
                src.release()

    def _iter_exprs(self):
        """Every stored expression tree that may carry subquery nodes —
        including window-spec argument / ORDER BY expressions (WindowFn
        nodes were substituted out of final_items, so their inner trees
        live only in window_specs)."""
        for e, _n in self.final_items:
            yield e
        for b in self.pushdown:
            yield self.pushdown[b]
        if self.where_residual is not None:
            yield self.where_residual
        if self.having is not None:
            yield self.having
        for e, _d in self.order_items:
            yield e
        for _i, e in self.agg_arg_cols:
            yield e
        for _out, _f, arg, _p, oexprs, _d, *_rest in self.window_specs:
            if arg is not None:
                yield arg
            for oe in oexprs:
                yield oe

    def _collect_subqueries(self, tables) -> bool:
        found = False
        for e in self._iter_exprs():
            for node in walk(e):
                subs = []
                if isinstance(node, SubQuery):
                    subs = [node]
                elif isinstance(node, InSub):
                    subs = [node.sub]
                for s in subs:
                    found = True
                    if s not in self._subplans:
                        try:
                            p = _plan_for_stmt(s.stmt, tables, self.config)
                        except PlanError as err:
                            # A sub-plan resolution failure whose
                            # STRUCTURED unresolved identifier names an
                            # OUTER binding (alias or column) is a
                            # correlated reference — say so instead of the
                            # misleading "X is not in tables".
                            if self._names_outer_binding(err):
                                raise PlanError(
                                    "correlated subqueries are not "
                                    "supported"
                                ) from None
                            raise
                        if len(p.output_names) != 1:
                            raise PlanError(
                                "Subquery must select exactly one column"
                            )
                        self._subplans[s] = p
        return found

    def _names_outer_binding(self, err: PlanError) -> bool:
        """True when a sub-plan PlanError's structured unresolved
        identifier resolves in THIS (outer) scope — i.e. the subquery was
        correlated. Structured data (no message regex-matching): an inner
        table genuinely missing from the registry whose NAME collides with
        an outer alias carries kind="table" and is only classified as
        correlated when the outer scope binds that alias — the previous
        text-matching version could not tell these apart for columns."""
        if err.unresolved_kind == "table":
            return any(
                b == err.unresolved_name for b, _t, _cols in self.bindings
            )
        if err.unresolved_kind == "column":
            return any(
                err.unresolved_name in env
                for env in self.resolver.by_binding.values()
            )
        return False

    _IN_SUB_MAX = 1024
    # > _IN_SUB_MAX distinct int values lower to a boolean-LUT gather
    # instead of an OR-chain; span cap bounds the LUT at 4 MB of bool.
    _IN_LUT_SPAN = 1 << 22

    def _bind_subqueries(self, tables, execute=None) -> None:
        """Run each subquery plan (through ``execute(plan)`` when given),
        then substitute scalar results / IN value sets as literals into
        the unbound expressions and lower them again (string values
        translate against the outer column's dictionary here), as this
        execution's expressions."""
        values: Dict[object, object] = {}      # SubQuery → scalar | np array
        for s, p in self._subplans.items():
            with inner_plan():
                b = p.execute(tables) if execute is None else execute(p)
                with host_read("subquery"):
                    n = int(b.n_valid)
                    col = b.columns[b.names[0]][:n].cpu().numpy()
                    # SQL NULL semantics for subquery results: NULL rows
                    # (hidden indicator 0) are not VALUES — IN drops them (a
                    # non-match against a set containing NULL is UNKNOWN →
                    # false anyway), NOT IN with any NULL in the set is
                    # false for every row.
                    nf = b.columns.get("#nullflag0")
                    valid = None if nf is None else nf[:n].cpu().numpy() != 0
            has_null = False
            if valid is not None:
                has_null = bool((~valid).any())
                col = col[valid]
            d = p.output_dicts[0]
            values[s] = (col, d, has_null)

        def scalar_of(s) -> object:
            col, d, has_null = values[s]
            if has_null and col.shape[0] == 0:
                raise PlanError(
                    "Scalar subquery returned NULL; comparisons with a "
                    "NULL scalar are not supported (rewrite with "
                    "COALESCE inside the subquery)"
                )
            if col.shape[0] != 1:
                raise PlanError(
                    f"Scalar subquery returned {col.shape[0]} rows, "
                    f"expected 1"
                )
            v = col[0]
            return str(d[int(v)]) if d is not None else v.item()

        def set_of(s):
            """("list", values) for small sets (OR-chain lowering), else a
            LUT form: ("slut", unique strings) for string columns (bits
            built over the OUTER column's dictionary at subst time) or
            ("ilut", min, bool bits) for bounded-span int columns."""
            col, d, _has_null = values[s]
            vals = np.unique(col)
            if vals.shape[0] <= self._IN_SUB_MAX:
                if d is not None:
                    return ("list", [str(x) for x in d[vals]])
                return ("list", [v.item() for v in vals])
            if d is not None:
                return ("slut", d[vals])
            if not np.issubdtype(vals.dtype, np.integer):
                raise PlanError(
                    f"IN (SELECT ...) with more than {self._IN_SUB_MAX} "
                    f"distinct float values is not supported"
                )
            mn, mx = int(vals[0]), int(vals[-1])
            span = mx - mn + 1
            if span > self._IN_LUT_SPAN:
                raise PlanError(
                    f"IN (SELECT ...) with more than {self._IN_SUB_MAX} "
                    f"distinct values spanning more than "
                    f"{self._IN_LUT_SPAN} is not supported"
                )
            # int32 wrap guard (round-4 advisor): the lowered index is
            # `probe - (mn-1)` in int32. A probe near INT32_MIN against a
            # value set near INT32_MAX wraps the subtraction back INTO the
            # live bit range (aliasing ⇔ mn ≥ 2^31 − span); mn−1 itself
            # must also stay representable. Both only occur at the dtype's
            # extremes — reject rather than silently mis-answer.
            if mn - 1 < -(1 << 31) or mn >= (1 << 31) - span:
                raise PlanError(
                    "IN (SELECT ...) value set sits at the int32 range "
                    "boundary; the LUT index arithmetic would wrap"
                )
            bits = np.zeros(span, bool)
            bits[vals - mn] = True
            return ("ilut", (mn, bits))

        def subst(e):
            if isinstance(e, SubQuery):
                return Lit(scalar_of(e))
            if isinstance(e, InSub):
                left = subst(e.expr)
                if e.negate and values[e.sub][2]:
                    # SQL: `x NOT IN (set containing NULL)` is never TRUE
                    # (either x matches a real value → false, or the NULL
                    # comparison makes it UNKNOWN) — constant false
                    return BinOp("<", Lit(1), Lit(0))
                kind, payload = set_of(e.sub)
                if kind == "slut":
                    # membership bits over the OUTER column's dictionary —
                    # exactly how LIKE lowers (codes are always valid
                    # dictionary indices on live rows)
                    d = self._expr_str_dict(left)
                    if d is None:
                        raise PlanError(
                            "Cannot compare string and numeric values"
                        )
                    bits = np.zeros(len(d), bool)
                    idx = np.searchsorted(d, payload)
                    ok = idx < len(d)
                    ok &= d[np.minimum(idx, len(d) - 1)] == payload
                    bits[idx[ok]] = True
                    chain = LutMember(left, bits)
                    return UnOp("not", chain) if e.negate else chain
                if kind == "ilut":
                    mn, bits = payload
                    # False guard bits at both ends + a 1-shift so the
                    # evaluator's clip maps every out-of-range value onto
                    # a guard (clip would otherwise alias the boundary
                    # entries' real membership bits)
                    bits2 = np.zeros(len(bits) + 2, bool)
                    bits2[1:-1] = bits
                    chain = LutMember(
                        BinOp("-", left, Lit(int(mn) - 1)), bits2
                    )
                    return UnOp("not", chain) if e.negate else chain
                vals = payload
                if not vals:
                    chain = BinOp("<", Lit(1), Lit(0))      # empty set: false
                else:
                    # BALANCED or-tree: a left-deep chain of ~1000 terms
                    # blows Python's recursion limit in every tree walker.
                    terms = [BinOp("=", left, Lit(v)) for v in vals]
                    while len(terms) > 1:
                        nxt = [
                            BinOp("or", a, b)
                            for a, b in zip(terms[::2], terms[1::2])
                        ]
                        if len(terms) % 2:
                            nxt.append(terms[-1])
                        terms = nxt
                    chain = terms[0]
                return UnOp("not", chain) if e.negate else chain
            if isinstance(e, BinOp):
                return BinOp(e.op, subst(e.left), subst(e.right))
            if isinstance(e, UnOp):
                return UnOp(e.op, subst(e.operand))
            if isinstance(e, Agg) and not isinstance(e.arg, Star):
                return Agg(e.func, subst(e.arg), e.distinct)
            if isinstance(e, LutMember):
                return LutMember(subst(e.col), e.lut)
            if isinstance(e, Case):
                return Case(
                    tuple((subst(c), subst(r)) for c, r in e.whens),
                    subst(e.else_) if e.else_ is not None else None,
                )
            from harkdb_tpu_torch.sql.ast_nodes import NullTag as _NT

            if isinstance(e, _NT):
                return _NT(subst(e.expr), e.flags)
            return e

        def lower(e):
            return self._lower_strings(subst(e))

        (items, pushdown, residual, having, order_items, agg_arg_cols,
         window_specs) = self._unbound
        self._set_expr_state((
            [(lower(e), n) for e, n in items],
            {b: lower(e) for b, e in pushdown.items()},
            lower(residual) if residual is not None else None,
            lower(having) if having is not None else None,
            [(lower(e), d) for e, d in order_items],
            [(i, lower(e)) for i, e in agg_arg_cols],
            [(out, f,
              lower(arg) if arg is not None else None,
              parts, tuple(lower(oe) for oe in oexprs), descs, pp, frame)
             for out, f, arg, parts, oexprs, descs, pp, frame
             in window_specs],
        ))
        # Deferred string-literal misuse (e.g. a str literal compared only
        # against a numeric subquery result) surfaces here, post-lowering.
        for e in self._iter_exprs():
            for node in walk(e):
                if isinstance(node, Lit) and isinstance(node.value, str):
                    raise PlanError(
                        "String literals are only supported in comparisons, "
                        "IN, BETWEEN and LIKE"
                    )

    def _probe_impl(self, batch: ColumnBatch):
        """On-device (min, max, any) of the group key over live rows passing
        the WHERE residual, read back in one transfer — the execute-time
        range check that admits post-join / post-WHERE keys to the dense
        path."""
        cap = batch.capacity
        live = torch.arange(cap, dtype=torch.int32,
                            device=batch.device) < batch.n_valid
        if self.where_residual is not None:
            live = live & eval_expr(
                self.where_residual, batch.columns, cap, self.config
            ).to(torch.bool)
        key = batch.column(self.fast_candidate)
        info = torch.iinfo(key.dtype)
        kmin = torch.where(live, key, info.max).min()
        kmax = torch.where(live, key, info.min).max()
        with host_read("probe"):
            kmin, kmax, nonempty = torch.stack([
                kmin.to(torch.int64), kmax.to(torch.int64),
                live.any().to(torch.int64),
            ]).tolist()
        return kmin, kmax, bool(nonempty)

    def _resolve_fast(self, batch: ColumnBatch):
        """(fast_span, key_min) for this execution; (None, 0) = sort path.

        Statically proven spans (no-join base-table stats) skip the probe;
        otherwise one device round-trip per plan measures the live key range
        (cached on the plan — the plan cache is invalidated whenever its
        tables change, api.create_table/drop_table)."""
        if self.fast_agg is not None:
            _k, kmin, span_p = self.fast_agg
            return span_p, kmin
        if self.fast_candidate is None:
            return None, 0
        if self._probed_fast is None:
            with span("hark.groupby"):
                kmin, kmax, nonempty = self._probe_impl(batch)
            fast = (None, 0)
            if nonempty and not (
                self.config.compat_u32_key_order and kmin < 0
            ):
                key_span = kmax - kmin + 1
                if key_span <= MAX_KEY_SPAN:
                    fast = (pad_span(key_span), kmin)
            self._probed_fast = fast
        return self._probed_fast

    def _apply_pushdown(self, binding: str, batch: ColumnBatch) -> ColumnBatch:
        with span("hark.filter"):
            mask = eval_expr(
                self.pushdown[binding], batch.columns, batch.capacity,
                self.config,
            ).to(torch.bool)
            return compact_batch(batch, mask)

    @staticmethod
    def _compact_filter(batch: ColumnBatch, mask) -> ColumnBatch:
        """A deferred WHERE / HAVING mask applied on its own (no sort to
        fuse into)."""
        with span("hark.filter"):
            return compact_batch(batch, mask)

    def _join_ranges(self, left: ColumnBatch, right: ColumnBatch, l_keys,
                     r_keys, l_flags=(), r_flags=(), need_full=False):
        """Count phase of one join step: one concat sort gives the ranges
        and every total; the same tensors then feed materialization.

        Empty ``l_keys`` = CROSS JOIN (constant key: one all-pairs run).
        ``l_flags``/``r_flags`` are matched-flag columns guarding that
        side's keys — rows with any flag 0 have a NULL key and must match
        nothing (three-valued ON semantics; plan/nulls.py)."""
        if l_keys:
            lk = [left.column(k) for k in l_keys]
            rk = [right.column(k) for k in r_keys]
        else:                       # CROSS JOIN
            lk = [torch.zeros(left.capacity, dtype=torch.int32,
                              device=left.device)]
            rk = [torch.zeros(right.capacity, dtype=torch.int32,
                              device=right.device)]

        def null_of(batch, flags):
            if not flags:
                return None
            return ~valid_mask(flags, batch.columns)

        return compute_join_ranges(
            lk, left.n_valid, rk, right.n_valid,
            l_cols=[left.column(n) for n in left.names],
            r_cols=[right.column(n) for n in right.names],
            l_null=null_of(left, l_flags), r_null=null_of(right, r_flags),
            need_full=need_full,
        )

    # -- execution ------------------------------------------------------------
    def execute(self, tables: Dict[str, Table]) -> ColumnBatch:
        with self.one_execution(tables):
            return self._execute(tables)

    def _execute(self, tables: Dict[str, Table]) -> ColumnBatch:
        # Phase A: load + joins (count-then-materialize per join).
        b0 = self.bindings[0][0]
        with span("hark.load"):
            batch = self._load(tables, 0)
        if b0 in self.pushdown:
            batch = self._apply_pushdown(b0, batch)
        row_align = self.config.row_align
        for step_idx, (rb, lks, rks, kind) in enumerate(self.join_steps):
            with span("hark.load"):
                right = self._load(tables, 1 + step_idx)
            if rb in self.pushdown:
                right = self._apply_pushdown(rb, right)
            kflags = tuple(self.join_key_flags[step_idx])
            l_names, r_names = batch.names, right.names
            # RIGHT JOIN = LEFT with the operands swapped: the incoming
            # table is the preserved side; the accumulated relation's
            # columns null-fill on its unmatched rows (#lmatched flag).
            swap = kind == "right"
            with span("hark.join"):
                with span("hark.join.count"):
                    if swap:
                        ranges = self._join_ranges(right, batch, rks, lks,
                                                   (), kflags)
                    else:
                        ranges = self._join_ranges(batch, right, lks, rks,
                                                   kflags, (), kind == "full")
                    _check_join_total(ranges)
                    with host_read("join_total"):
                        total = int(
                            ranges.total_full if kind == "full"
                            else ranges.total_left if kind in ("left", "right")
                            else ranges.total
                        )
                with span("hark.join.fill"):
                    cap = _next_pow2(max(total, row_align))
                    if swap:
                        batch = join_batches(
                            None, None, None, None, cap,
                            {n: n for n in r_names}, {n: n for n in l_names},
                            kind="left", ranges=ranges,
                            matched_out=f"#lmatched.{rb}",
                        )
                    else:
                        batch = join_batches(
                            None, None, None, None, cap,
                            {n: n for n in l_names}, {n: n for n in r_names},
                            kind="inner" if kind == "cross" else kind,
                            ranges=ranges,
                            matched_out=self.null_flags.get(rb),
                            l_matched_out=(f"#lmatched.{rb}" if kind == "full"
                                           else None),
                        )
        # Phase B. The dense path's span: proven from table stats, or one
        # probe per plan.
        fast_span, key_min = self._resolve_fast(batch)
        self.last_fast_span = fast_span
        # Capacity shrink after filter pushdown (single-table, sort path):
        # the group/order sorts run over the surviving rows' power-of-two
        # bucket instead of the input capacity, for one n_valid readback
        # (config.shrink_rows_min gates small inputs out of the sync).
        if (not self.join_steps and self.pushdown and fast_span is None
                and batch.capacity >= self.config.shrink_rows_min
                and (self.grouped or self.order_items or self.distinct
                     or self.window_specs)):
            with span("hark.filter"), host_read("where_shrink"):
                n_live = int(batch.n_valid)
            cap_b = min(_next_pow2(max(n_live, row_align)), batch.capacity)
            if cap_b < batch.capacity:
                batch = _slice(batch, cap_b)
        if self.grouped and (self.order_items or self.distinct):
            # Split at the aggregate: read n_groups back and bucket the
            # tail's capacity down, so its sort runs over the groups instead
            # of the full input capacity.
            g = self._phase_b(batch, fast_span, key_min,
                              stop_after_group=True)
            with span("hark.groupby"), host_read("n_groups"):
                n_groups = int(g.n_valid)
            cap2 = min(_next_pow2(max(n_groups, row_align)), g.capacity)
            return self.run_tail(_slice(g, cap2))
        return self._phase_b(batch, fast_span, key_min)

    def _source(self, tables: Dict[str, Table], tname: str):
        """Table or DerivedSource behind a binding's table name."""
        d = self._derived.get(tname)
        return d if d is not None else tables[tname]

    def _load(self, tables: Dict[str, Table], binding_idx: int) -> ColumnBatch:
        b, tname, cols = self.bindings[binding_idx]
        d = self._derived.get(tname)
        src = d.batch(tables) if d is not None else tables[tname].batch()
        remaps = self.load_remaps.get(b, {})
        out = {}
        # A query touching no columns at all (``select count(*) from t``)
        # still needs one column for row capacity.
        needed = {f"{b}.{c}" for c in cols} & self.used_columns
        if not needed and cols:
            needed = {f"{b}.{cols[0]}"}
        for c in cols:
            internal = f"{b}.{c}"
            if internal not in needed:
                continue
            col = src.column(c)
            lut = remaps.get(internal)
            if lut is not None:
                # Merged-dictionary code remap: one small-LUT gather per
                # execution.
                with host_read("upload"):
                    lut_t = torch.as_tensor(lut).to(col.device)
                col = lut_t[col.long()]
            out[internal] = col
        return ColumnBatch(out, src.n_valid)

    def _phase_b(self, batch: ColumnBatch, fast_span, key_min: int,
                 stop_after_group: bool = False) -> ColumnBatch:
        cap = batch.capacity
        if self.config.debug_checks:
            batch = debug_validate(batch, "phase_b input")
        # WHERE residual (post-join conjuncts, and conjuncts touching no
        # column; the others were pushed down). The predicate mask FUSES
        # into whichever downstream operator runs anyway (the dense
        # aggregation, group-by, ORDER BY, DISTINCT).
        where_mask = None
        if self.where_residual is not None:
            with span("hark.filter"):
                where_mask = eval_expr(
                    self.where_residual, batch.columns, cap, self.config
                ).to(torch.bool)
            # Window partitions must only see surviving rows, so UNGROUPED
            # windows force the compaction that a downstream sort would
            # otherwise absorb. Grouped windows run over the aggregated
            # output, so the WHERE mask still fuses into the groupby sort.
            absorbed = (
                (self.grouped or self.order_items or self.distinct)
                and (self.grouped or not self.window_specs)
            )
            if not absorbed:
                batch = self._compact_filter(batch, where_mask)
                where_mask = None
                if self.config.debug_checks:
                    batch = debug_validate(batch, "after WHERE")

        if self.grouped:
            with span("hark.groupby"):
                batch = self._aggregate(batch, fast_span, key_min,
                                        where_mask)
            if stop_after_group:
                return batch
            return self.run_tail(batch)

        # Grouped windows run in run_tail, after HAVING. (The JAX package
        # computes them here as well and then again there, keeping the
        # second result; group keys break every tie, so once gives the same
        # rows in the same order.)
        presorted = False
        if self.window_specs:
            with span("hark.tail"):
                batch, presorted = compute_windows(self, batch,
                                                   allow_skip_restore=True)
        return self.run_tail(batch, filter_mask=where_mask,
                             order_presorted=presorted)

    def _aggregate(self, batch: ColumnBatch, fast_span, key_min: int,
                   where_mask) -> ColumnBatch:
        """GROUP BY + aggregates, the WHERE mask fused — the dense-key path
        when the gate admits it (small int key span, sum/count only; span
        proven from table stats or probed on the device — _resolve_fast),
        else the sort path."""
        cap = batch.capacity
        dev = batch.device
        if fast_span is not None:
            key_name = self.fast_candidate
            sum_srcs = list(dict.fromkeys(
                src for src, op, _ in self.agg_specs if op == "sum"
            ))
            counts_k, sums_k, keys_axis = onehot_groupby_sums(
                batch.column(key_name),
                [batch.column(s) for s in sum_srcs],
                batch.n_valid, key_min, fast_span, mask=where_mask,
            )
            sums_by_src = dict(zip(sum_srcs, sums_k))
            gcols = {key_name: keys_axis}
            for src, op, out_name in self.agg_specs:
                gcols[out_name] = (
                    counts_k if op == "count" else sums_by_src[src]
                )
            dense = ColumnBatch(gcols, torch.full(
                (), fast_span, dtype=torch.int32, device=dev))
            return compact_batch(dense, counts_k > 0)

        cols = dict(batch.columns)
        for name, gexpr in self.group_key_exprs:
            cols[name] = eval_expr(gexpr, cols, cap, self.config)
        for name in self.group_exec_keys:
            # derived flags used as NULL-group exec keys materialize
            # here (they are expressions over the matched columns)
            dfe = self.derived_flag_cols.get(name)
            if dfe is not None and name not in cols:
                cols[name] = eval_expr(
                    dfe, cols, cap, self.config
                ).to(torch.int32)
        for internal, expr in self.agg_arg_cols:
            cols[internal] = eval_expr(expr, cols, cap, self.config)
        if any(src == "#ones" for src, _, _ in self.agg_specs):
            cols["#ones"] = torch.ones(cap, dtype=torch.int32, device=dev)
        if self.group_keys:
            keys = list(self.group_exec_keys)
        else:
            # implicit single group (select max(x) from t)
            cols["#const"] = torch.zeros(cap, dtype=torch.int32,
                                         device=dev)
            keys = ["#const"]
        batch = groupby_batch(
            ColumnBatch(cols, batch.n_valid), keys, self.agg_specs,
            mask=where_mask,
            u32_key_order=self.config.compat_u32_key_order,
        )
        if not self.group_keys:
            # SQL: an ungrouped aggregate over EMPTY input is one row
            # (COUNT 0; SUM/MIN/MAX/AVG/PROD NULL), not zero rows.
            # Fabricate the row: padding slot 0 holds 0 for sum/count
            # outputs but the op-neutral extreme for min/max, so zero
            # it explicitly; the broadcast #grp_has column (0 ⇔ empty)
            # is the agg_null_flags validity source for the non-count
            # outputs (NULL via the hidden output indicators).
            empty = batch.n_valid == 0
            fixed = {}
            for nme, cc in batch.columns.items():
                cc = cc.clone()
                cc[0] = torch.where(empty, torch.zeros_like(cc[0]), cc[0])
                fixed[nme] = cc
            fixed["#grp_has"] = (~empty).to(torch.int32).expand(
                batch.capacity
            )
            batch = ColumnBatch(
                fixed, torch.clamp(batch.n_valid, min=1)
            )
        return batch

    def run_tail(self, batch: ColumnBatch, filter_mask=None,
                 order_presorted: bool = False) -> ColumnBatch:
        """Post-aggregation tail: avg computes → HAVING → windows over
        grouped output → projection → DISTINCT → ORDER BY → OFFSET → LIMIT.

        ``filter_mask`` is a deferred WHERE predicate (ungrouped queries
        only); like HAVING it fuses into the DISTINCT / ORDER BY sort when
        one exists instead of paying its own compaction.
        ``order_presorted``: the batch already sits in the final ORDER BY
        order (a window shape's sort matched it — plan/windows.py), so the
        ORDER BY sort is skipped.
        """
        with span("hark.tail"):
            return self._tail(batch, filter_mask, order_presorted)

    def _tail(self, batch: ColumnBatch, filter_mask,
              order_presorted: bool) -> ColumnBatch:
        dev = batch.device
        # AVG's divisions and HAVING finish the aggregation.
        if self.grouped and self.post_computes:
            with span("hark.groupby"):
                gcols = dict(batch.columns)
                apply_post_computes(gcols, self.post_computes)
                batch = ColumnBatch(gcols, batch.n_valid)

        # HAVING — fused into the DISTINCT / ORDER BY sort when one follows.
        if self.having is not None:
            with span("hark.groupby"):
                hmask = eval_expr(
                    self.having, batch.columns, batch.capacity, self.config
                ).to(torch.bool)
                filter_mask = (hmask if filter_mask is None
                               else filter_mask & hmask)
                if not (self.distinct or self.order_items):
                    batch = compact_batch(batch, filter_mask)
                    filter_mask = None

        # Windows over GROUPED output (standard SQL order: after GROUP BY
        # and HAVING — so a pending HAVING mask must compact first; window
        # partitions may only see surviving groups).
        if self.grouped and self.window_specs:
            if filter_mask is not None:
                batch = self._compact_filter(batch, filter_mask)
                filter_mask = None
            batch, order_presorted = compute_windows(
                self, batch, allow_skip_restore=True)

        # Materialize select outputs (unique internal slots, duplicates OK).
        out_cols = {}
        cols = dict(batch.columns)
        for i, (expr, _name) in enumerate(self.final_items):
            out_cols[f"#out{i}"] = eval_expr(
                expr, cols, batch.capacity, self.config
            )
        # Trailing hidden NULL indicators for nullable outputs (flags may be
        # absent post-grouping when the output is not a group key — then the
        # output is never NULL and no flag is needed).
        for i, flags in enumerate(self.output_null_flags):
            if flags:
                m = self._valid_arr(flags, cols, batch.capacity)
                if m is not None:
                    out_cols[f"#nullflag{i}"] = m.to(torch.int32)
        out = ColumnBatch(out_cols, batch.n_valid)

        # DISTINCT: lexicographic sort of the output tuple (pads last), then
        # keep first of each run. Output ordering is by the full row tuple
        # (standard engines leave DISTINCT order unspecified). A pending
        # filter mask rides the sort's leading pad key.
        if self.distinct:
            names = out.names
            cap2 = out.capacity
            idx2 = torch.arange(cap2, dtype=torch.int32, device=dev)
            live = idx2 < out.n_valid
            if filter_mask is not None:
                live = live & filter_mask
                filter_mask = None
            n_live = live.sum(dtype=torch.int32)
            perm = lexsort_permutation(
                [~live] + [out.columns[c] for c in names]
            )
            sorted_all = [out.columns[c][perm] for c in names]
            changed = torch.zeros(cap2, dtype=torch.bool, device=dev)
            for col in sorted_all:
                prev = torch.cat([col[:1], col[:-1]])
                changed = changed | (col != prev)
            keep = ((idx2 == 0) | changed) & (idx2 < n_live)
            out = compact_batch(
                ColumnBatch(dict(zip(names, sorted_all)), n_live), keep,
            )

        # ORDER BY + small LIMIT: top-k selection over a monotone int32 view
        # of the one key instead of the full payload sort
        # (``harkdb_tpu/plan/planner.py:2053-2111``). The gate is the JAX
        # package's plan decision and decides which rows come back: the
        # view orders floats by their IEEE bits, so a NaN with its sign bit
        # set ranks below -inf, where the sort puts every NaN last. Ties go
        # to the lowest index, the stable sort's tie order. float64 keys
        # take the sort (the float32 view would be lossy).
        top_k_ok = (
            self.order_items and len(self.order_items) == 1
            and not order_presorted and not self.distinct
            and self.limit is not None
            and (self.limit + (self.offset or 0)) <= 1024
        )
        if top_k_ok:
            (expr, d), nu = self.order_items[0], self.order_nulls[0]
            key = self._null_adjusted_key(expr, d, nu, cols, batch.capacity)
            top_k_ok = key.dtype == torch.float32 or (
                not key.dtype.is_floating_point and key.dtype != torch.bool
                and key.dtype.itemsize <= 4)
        if self.order_items and top_k_ok:
            L = min(self.limit + (self.offset or 0), out.capacity)
            # Dead rows (int32 min in the view) must never beat a live row
            # whose view equals int32 min: ties go to the lowest index, so
            # live rows must sit below dead ones — true of a packed batch,
            # restored by compacting a pending WHERE mask (the key rides
            # along as ``#tkkey``).
            if filter_mask is not None:
                tmp = self._compact_filter(
                    ColumnBatch(dict(out.columns, **{"#tkkey": key}),
                                out.n_valid),
                    filter_mask,
                )
                key = tmp.columns["#tkkey"]
                out = ColumnBatch(
                    {n: c for n, c in tmp.columns.items() if n != "#tkkey"},
                    tmp.n_valid,
                )
                filter_mask = None
            # top-k takes the largest of the view: the view itself for
            # DESC, the order-reversed view for ASC.
            view = ieee_order_view(key, not d)
            live = torch.arange(out.capacity, dtype=torch.int32,
                                device=dev) < out.n_valid
            view = torch.where(live, view, torch.iinfo(torch.int32).min)
            pick = top_k_indices(view, L)
            out = ColumnBatch(
                {n: c[pick] for n, c in out.columns.items()},
                torch.clamp(out.n_valid, max=L),
            )
        elif self.order_items and order_presorted:
            if filter_mask is not None:
                out = self._compact_filter(out, filter_mask)
                filter_mask = None
        elif self.order_items:
            key_arrays = []
            desc = []
            if self.distinct:
                for (j, (_e, d)), nu in zip(
                    zip(self.order_out_idx, self.order_items),
                    self.order_nulls,
                ):
                    a = out.columns[f"#out{j}"]
                    nf = out.columns.get(f"#nullflag{j}")
                    if nf is not None:
                        a = null_extreme_sub(a, nf == 0, d, nu)
                    key_arrays.append(a)
                    desc.append(d)
            else:
                for (expr, d), nu in zip(self.order_items,
                                         self.order_nulls):
                    key_arrays.append(self._null_adjusted_key(
                        expr, d, nu, cols, batch.capacity
                    ))
                    desc.append(d)
            out = sort_batch(
                out, [], desc, key_arrays=key_arrays, mask=filter_mask
            )
            filter_mask = None
        elif filter_mask is not None:
            out = self._compact_filter(out, filter_mask)
            filter_mask = None

        # OFFSET: drop the first k rows — one compaction pass (rows must
        # shift to the front to keep the packed-batch invariant).
        if self.offset:
            idx3 = torch.arange(out.capacity, dtype=torch.int32, device=dev)
            out = compact_batch(out, idx3 >= self.offset)

        # LIMIT
        if self.limit is not None:
            out = ColumnBatch(
                out.columns, torch.clamp(out.n_valid, max=self.limit)
            )
        return out

    # -- observability --------------------------------------------------------
    def explain(self) -> str:
        b, tname, _cols = self.bindings[0]
        src = self._derived.get(tname)
        if src is None:
            lines = [f"Scan {tname} as {b}"]
        else:
            lines = [f"DerivedScan as {b}:"]
            lines += ["  " + ln for ln in src.plan.explain().splitlines()]
        for b in self.pushdown:
            lines.append(f"Filter pushdown → {b}")
        for rb, lks, rks, kind in self.join_steps:
            cond = " and ".join(
                f"{lk} = {rk}" for lk, rk in zip(lks, rks)
            ) or "<cross>"
            lines.append(f"SortJoin({kind}) {cond} (+ {rb})")
        if self.where_residual is not None:
            lines.append("Filter (WHERE residual) → masked-scan compaction")
        if self.grouped:
            keys = ", ".join(self.group_keys) or "<all rows>"
            aggs = ", ".join(f"{op}({src})" for src, op, _ in self.agg_specs)
            lines.append(f"Aggregate keys=[{keys}] aggs=[{aggs}]")
        if self.having is not None:
            lines.append("Filter (HAVING)")
        if self.window_specs:
            shapes = {(s[3], s[4], s[5]) for s in self.window_specs}
            funcs = ", ".join(s[1] for s in self.window_specs)
            lines.append(
                f"Window [{funcs}] over {len(shapes)} shape(s) "
                f"({len(shapes) + 1}-sort fused chain)"
            )
        if self.order_items:
            lines.append(
                "Sort " + ", ".join(
                    ("DESC" if d else "ASC") for _, d in self.order_items
                )
            )
        if self.offset:
            lines.append(f"Offset {self.offset}")
        if self.limit is not None:
            lines.append(f"Limit {self.limit}")
        lines.append("Project [" + ", ".join(self.output_names) + "]")
        return "\n".join(lines)


def _slice(batch: ColumnBatch, cap: int) -> ColumnBatch:
    """The batch cut to its first ``cap`` rows (views, no copy)."""
    return ColumnBatch({n: c[:cap] for n, c in batch.columns.items()},
                       batch.n_valid)


def _plan_for_stmt(stmt, tables: Dict[str, Table],
                   config: EngineConfig = DEFAULT_CONFIG):
    """SelectStmt → QueryPlan; UnionStmt → UnionPlan (shared by the top
    level, derived tables / CTEs / views, and IN/scalar subqueries)."""
    if isinstance(stmt, UnionStmt):
        from harkdb_tpu_torch.plan.union_plan import UnionPlan

        return UnionPlan(stmt, tables, config)
    return QueryPlan(stmt, tables, config)


def plan_query(tables: Dict[str, Table], sql: str,
               config: EngineConfig = DEFAULT_CONFIG, views=None):
    with span("hark.parse"):
        stmt = parse_sql(sql, views=views)
    return _plan_for_stmt(stmt, tables, config)
