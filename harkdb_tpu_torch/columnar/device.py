"""The device rule of the public entry points.

``Context``, ``Table``, ``Table.from_host``, ``tables_from_reference`` and
``ColumnBatch.from_numpy`` put their data on the card unless the caller
asks for the CPU, as the JAX package's counterparts put theirs on the
default device (the accelerator). There is no silent CPU fallback: with
no CUDA device, the default raises and names the way out.
"""

from __future__ import annotations

import torch


def resolve_device(device, caller: str) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when none is available and
    ``ValueError`` for a device other than CUDA or the CPU. ``caller``
    names the entry point in the message.
    """
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}(device='cuda') needs a CUDA device and none is "
            f"available; pass device='cpu' to run on the CPU"
        )
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d
