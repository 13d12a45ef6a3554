"""The engine's mesh: one rank of a ``torch.distributed`` process group.

Counterpart of ``harkdb_tpu.parallel.mesh`` (``make_engine_mesh``). In JAX
a mesh is a ``jax.sharding.Mesh`` driven by one controller under
``shard_map``. Here it is SPMD: one process per shard, every process runs
the same query on its own block of rows, and the exchanges are collectives
of the process group. An :class:`EngineMesh` is this process's view of
that group: its rank, the group's size, and the device its rows live on.

The collectives every distributed operator uses go through the mesh's
methods, which hand the tensors to ``torch.distributed`` where they lie:
on a gloo group gloo stages CUDA tensors through host memory itself (its
CUDA work classes), on NCCL they stay on the card. The backend is chosen
when the group is created, never switched.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG


@dataclasses.dataclass(frozen=True)
class EngineMesh:
    """This rank's view of the process group the engine shards over."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise reduction over ranks (``sum`` / ``max`` / ``min``)
        of ``t``; returns a new tensor."""
        w = t.contiguous().clone()
        dist.all_reduce(w, op=getattr(dist.ReduceOp, op.upper()),
                        group=self.group)
        return w

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along a new leading axis, rank 0
        first (``jax.lax.all_gather``, untiled)."""
        w = t.contiguous()
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return torch.stack(parts)

    def all_to_all(self, t: torch.Tensor, send_splits: Sequence[int],
                   recv_splits: Sequence[int],
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rows ``t[sum(send_splits[:j]) : ...]`` go to rank j; the rows
        from rank i arrive in rank order (``all_to_all_single`` with split
        sizes). ``out``, if given, receives them and is returned; it must
        be contiguous on ``t``'s device."""
        w = t.contiguous()
        if out is None:
            out = torch.empty((int(sum(recv_splits)),) + tuple(w.shape[1:]),
                              dtype=w.dtype, device=w.device)
        dist.all_to_all_single(out, w, list(recv_splits), list(send_splits),
                               group=self.group)
        return out


def make_engine_mesh(n_devices: Optional[int] = None,
                     config: EngineConfig = DEFAULT_CONFIG,
                     group=None, device=None) -> EngineMesh:
    """This rank's :class:`EngineMesh` over an already initialised process
    group (the default one unless ``group`` is given).

    ``device`` (where this rank's rows live) defaults to
    ``cuda:{LOCAL_RANK}``; pass it explicitly for several ranks on one card
    (``cuda:0``, over gloo) or for the CPU. Raises when no group is
    initialised, when ``n_devices`` (or ``config.num_shards``) differs from
    the group's size, when ``config.mesh_axis`` is not the default (a
    process group has one unnamed axis), and when the device does not fit
    the backend: NCCL needs a CUDA device, and a card of its own on every
    rank.
    """
    if config.mesh_axis != EngineConfig.mesh_axis:
        raise ValueError(
            f"mesh_axis={config.mesh_axis!r}: a torch.distributed mesh has "
            f"one axis, {EngineConfig.mesh_axis!r}, and cannot rename it"
        )
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_engine_mesh needs an initialised torch.distributed process "
            "group: start one process per rank with torchrun (python -m "
            "torch.distributed.run) or call "
            "harkdb_tpu_torch.parallel.multihost.init_multihost in each"
        )
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n = n_devices or config.num_shards or size
    if n != size:
        raise ValueError(
            f"Requested a mesh of {n} ranks, but the process group has {size}"
        )
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    backend = dist.get_backend(group)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(
                f"an NCCL process group needs a CUDA device, got {device}; "
                f"use a gloo group for the CPU"
            )
        _check_own_cards(group, rank, size, device)
    return EngineMesh(group, rank, size, device)


def _check_own_cards(group, rank: int, size: int,
                     device: torch.device) -> None:
    """NCCL refuses two ranks on one card: read every rank's (host, card)
    through the group's store and raise on a repeat."""
    store = dist.distributed_c10d._get_default_store()
    me_global = dist.get_rank()
    # Every rank calls this as often as the others (SPMD), so its own call
    # count names the same round on every rank.
    gen = store.add(f"harkdb_mesh/calls/{me_global}", 1)
    ranks: List[int] = dist.get_process_group_ranks(group)
    me = f"{socket.gethostname()}:{device.index}"
    store.set(f"harkdb_mesh/{gen}/{me_global}", me)
    seen = [store.get(f"harkdb_mesh/{gen}/{r}").decode() for r in ranks]
    if len(set(seen)) != size:
        raise ValueError(
            f"NCCL ranks must each have a card of their own; the ranks hold "
            f"{seen} (rank {rank} on {me}); put several ranks on one card "
            f"over a gloo group instead"
        )
