"""Runtime invariant checks behind ``EngineConfig.debug_checks``.

Counterpart of ``harkdb_tpu.utils.checks``. What is checkable at runtime
are the engine's own conventions for a ``ColumnBatch``:

  * all columns share one capacity;
  * 0 <= n_valid <= capacity.

``n_valid`` is a 0-d tensor on the batch's device, so the check reads it
back to the host: one synchronisation per call, paid only when
``debug_checks`` is on.
"""

from __future__ import annotations

from harkdb_tpu_torch.columnar.batch import ColumnBatch


class InvariantViolation(AssertionError):
    pass


def debug_validate(batch: ColumnBatch, where: str = "") -> ColumnBatch:
    """Raise ``InvariantViolation`` naming ``where`` when ``batch`` breaks
    an invariant; return it unchanged otherwise."""
    caps = {c.shape[0] for c in batch.columns.values()}
    if len(caps) > 1:
        raise InvariantViolation(
            f"{where}: columns disagree on capacity: {caps}"
        )
    if caps:
        cap = caps.pop()
        n = int(batch.n_valid)
        if not 0 <= n <= cap:
            raise InvariantViolation(f"{where}: n_valid={n} not in [0, {cap}]")
    return batch
