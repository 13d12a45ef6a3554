"""Vectorized expression evaluation over columnar batches.

Counterpart of ``harkdb_tpu.plan.expr``. Expressions are *resolved* AST
trees — every ``Col`` node's ``name`` is an internal column key of the
working batch (resolution happens in the planner). Evaluation is plain
torch over whole columns, on the columns' device.

Semantics, kept bit for bit from the JAX package (XLA's definitions):
  * int ∘ int arithmetic stays int; `/` and `%` truncate toward zero;
  * int division by zero does not trap: ``x / 0 == -1`` and ``x % 0 == x``
    (the divisor is masked first — torch on the CPU raises instead), and
    ``INT_MIN / -1 == INT_MIN``, ``INT_MIN % -1 == 0``;
  * ``ROUND`` rounds half away from zero (``torch.round`` rounds half to
    even);
  * float → int casts truncate toward zero, saturate at the int32 range
    and send NaN to 0;
  * int ∘ float promotes to the engine float dtype;
  * comparisons yield bool; and/or/not operate on bool.
"""

from __future__ import annotations

from typing import Dict

import torch

from harkdb_tpu_torch.config import DEFAULT_CONFIG, EngineConfig
from harkdb_tpu_torch.sql.ast_nodes import (
    Agg, BinOp, Case, CodeMap, Col, InSub, Lit, LutMember, NullTag, SubQuery,
    UnOp,
)
from harkdb_tpu_torch.utils.metrics import host_read

Tensor = torch.Tensor

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_F32_BELOW_2_31 = 2147483520.0      # largest float32 below 2**31


class ExprError(Exception):
    pass


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _device_of(columns: Dict[str, Tensor]) -> torch.device:
    for c in columns.values():
        return c.device
    return torch.device("cpu")


def _promote(a: Tensor, b: Tensor):
    if a.dtype.is_floating_point or b.dtype.is_floating_point:
        tgt = a.dtype if a.dtype.is_floating_point else b.dtype
        return a.to(tgt), b.to(tgt)
    return a, b


def _float_to_int(v: Tensor, dtype: torch.dtype) -> Tensor:
    """XLA's float→int32 convert: truncate, saturate, NaN → 0."""
    if dtype != torch.int32:
        return v.to(dtype)
    x = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    out = x.clamp(_I32_MIN, _F32_BELOW_2_31).to(torch.int32)
    return torch.where(x >= 2.0 ** 31, _I32_MAX, out)


def _int_div(a: Tensor, b: Tensor, rem: bool) -> Tensor:
    zero = b == 0
    overflow = (a == torch.iinfo(a.dtype).min) & (b == -1)
    safe = torch.where(zero | overflow, torch.ones_like(b), b)
    if rem:
        return torch.where(zero, a, torch.fmod(a, safe))
    q = torch.div(a, safe, rounding_mode="trunc")
    return torch.where(zero, torch.full_like(q, -1), q)


def _lut(lut, dtype, device) -> Tensor:
    with host_read("upload"):
        return torch.as_tensor(lut, dtype=dtype).to(device)


def eval_expr(expr, columns: Dict[str, Tensor], capacity: int,
              config: EngineConfig = DEFAULT_CONFIG) -> Tensor:
    """Evaluate a resolved expression to a column of shape (capacity,)."""
    if isinstance(expr, Lit):
        if isinstance(expr.value, str):
            raise ExprError(
                "String literal reached the evaluator unlowered — the "
                "planner translates string comparisons to dictionary codes"
            )
        dt = _dtype(config.float_dtype if isinstance(expr.value, float)
                    else config.int_dtype)
        return torch.full((capacity,), expr.value, dtype=dt,
                          device=_device_of(columns))
    if isinstance(expr, LutMember):
        codes = eval_expr(expr.col, columns, capacity, config)
        lut = _lut(expr.lut, torch.bool, codes.device)
        # Codes of live rows are valid dictionary indices; padding rows may
        # hold anything, so clamp (their result is masked downstream anyway).
        idx = torch.clamp(codes, 0, lut.shape[0] - 1).long()
        return lut[idx]
    if isinstance(expr, CodeMap):
        # plan-time dictionary transform (UPPER/SUBSTR/LENGTH/...): one
        # small-LUT gather — row data never sees a string operation
        codes = eval_expr(expr.col, columns, capacity, config)
        lut = _lut(expr.lut, None, codes.device)
        idx = torch.clamp(codes, 0, lut.shape[0] - 1).long()
        return lut[idx]
    if isinstance(expr, Col):
        try:
            return columns[expr.name]
        except KeyError:
            raise ExprError(f"Unresolved column {expr.name!r}") from None
    if isinstance(expr, UnOp):
        v = eval_expr(expr.operand, columns, capacity, config)
        if expr.op == "-":
            return -v
        if expr.op == "not":
            return ~v.to(torch.bool)
        if expr.op == "abs":
            return torch.abs(v)
        if expr.op in ("floor", "ceil", "round"):
            # SQL numeric semantics: identity on integers; floats stay float
            # (values may exceed int32 range).
            if v.dtype.is_floating_point:
                if expr.op == "round":
                    # SQL ROUND is half-away-from-zero (round(2.5) = 3,
                    # round(-2.5) = -3).
                    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)
                return torch.floor(v) if expr.op == "floor" else torch.ceil(v)
            return v
        if expr.op == "sqrt":
            return torch.sqrt(v.to(_dtype(config.float_dtype)))
        if expr.op == "cast_int":
            # SQL CAST truncates toward zero
            if v.dtype.is_floating_point:
                return _float_to_int(v, _dtype(config.int_dtype))
            return v.to(_dtype(config.int_dtype))
        if expr.op == "cast_float":
            return v.to(_dtype(config.float_dtype))
        raise ExprError(f"Unknown unary op {expr.op!r}")
    if isinstance(expr, Case):
        # First true WHEN wins: fold torch.where back-to-front. Missing ELSE
        # yields 0 (no NULLs).
        results = [eval_expr(r, columns, capacity, config)
                   for _c, r in expr.whens]
        out = (eval_expr(expr.else_, columns, capacity, config)
               if expr.else_ is not None
               else torch.zeros_like(results[0]))
        for (cond, _r), res in zip(reversed(expr.whens), reversed(results)):
            c = eval_expr(cond, columns, capacity, config).to(torch.bool)
            res, out = _promote(res, out)
            out = torch.where(c, res, out)
        return out
    if isinstance(expr, BinOp):
        a = eval_expr(expr.left, columns, capacity, config)
        b = eval_expr(expr.right, columns, capacity, config)
        op = expr.op
        if op in ("and", "or"):
            a = a.to(torch.bool)
            b = b.to(torch.bool)
            return a & b if op == "and" else a | b
        a, b = _promote(a, b)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if a.dtype.is_floating_point:
                return a / b
            return _int_div(a, b, rem=False)
        if op == "%":
            if a.dtype.is_floating_point:
                return torch.fmod(a, b)
            return _int_div(a, b, rem=True)
        if op == "=":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        raise ExprError(f"Unknown operator {op!r}")
    if isinstance(expr, Agg):
        raise ExprError(
            "Aggregate reached the evaluator unrewritten — planner bug"
        )
    if isinstance(expr, NullTag):
        # nullability marker only — the value is the wrapped expression
        return eval_expr(expr.expr, columns, capacity, config)
    if isinstance(expr, (SubQuery, InSub)):
        raise ExprError(
            "Subquery reached the evaluator unresolved — planner bug "
            "(_resolve_subqueries substitutes literals at first execution)"
        )
    raise ExprError(f"Cannot evaluate node {expr!r}")
