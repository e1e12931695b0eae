"""Process layout of the parallel paths (counterpart of
``d3human_tpu/parallel/mesh.py``): one process (rank) a device, a 1-D
layout over the ranks with a named axis, and the rank's contiguous block
of a leading axis, in the order of ``NamedSharding(mesh, P(axis))``.

The JAX package lets XLA insert its collectives from sharding
annotations; here they are ``torch.distributed`` calls on the layout's
process group: NCCL for CUDA devices, gloo for the CPU and for ranks that
share one card (NCCL refuses two ranks on one GPU). CPU objects travel on
a gloo group (``cpu_group``), because gloo has no all-gather of CUDA
tensors and NCCL none of CPU tensors. A process without a group (one
process, no launcher) has world size 1 and no group, and the callers skip
every collective; a group of one runs them. A group that fails to
initialise raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


def maybe_distributed_init(device="cuda") -> bool:
    """``init_process_group`` from the launcher's environment (torchrun
    sets ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``):
    NCCL for a CUDA device, gloo for the CPU. Returns whether it
    initialised a group; without ``WORLD_SIZE`` and ``RANK``, or with a
    group already up, it does nothing."""
    if dist.is_initialized() or not ("WORLD_SIZE" in os.environ
                                     and "RANK" in os.environ):
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, timeout=TIMEOUT)
    return True


def rank_device(device="cuda") -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` for a CUDA device given
    without an index, else ``device`` as given."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D layout over the ranks (``torch.distributed.device_mesh``'s
    ``mesh_dim_names`` has one name here). ``group`` is None in a process
    without a process group."""

    axis: str
    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    cpu_group: Optional[object] = None


def _make_mesh(n_devices: int, axis: str, device) -> Mesh:
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over {world} "
                         "process(es): the port runs one process a device")
    if not dist.is_initialized():
        return Mesh(axis, 1, 0, rank_device(device))
    group = dist.group.WORLD
    cpu_group = (group if dist.get_backend() == "gloo"
                 else dist.new_group(backend="gloo", timeout=TIMEOUT))
    return Mesh(axis, world, dist.get_rank(), rank_device(device), group,
                cpu_group)


def make_frame_mesh(n_devices: int = 0, axis: str = "frames",
                    device="cuda") -> Mesh:
    """The layout over which independent per-frame optimizations shard;
    ``n_devices`` 0 means every rank (else it must equal the world size).
    A collective call when the world is larger than 1."""
    return _make_mesh(n_devices, axis, device)


def make_data_mesh(n_devices: int = 0, axis: str = "data",
                   device="cuda") -> Mesh:
    """The layout of the data-parallel step (as ``make_frame_mesh``)."""
    return _make_mesh(n_devices, axis, device)


def shard_leading(mesh: Mesh, n: int) -> range:
    """The rank's contiguous block of a leading axis of length ``n``:
    rank d holds ``[d n / D, (d + 1) n / D)``. ``n`` must divide evenly."""
    if n % mesh.world:
        raise ValueError(f"a leading axis of {n} over {mesh.world} ranks")
    per = n // mesh.world
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples; other
    leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def replicated(mesh: Mesh, tree):
    """``tree`` whole on the rank's device (every rank holds all of it)."""
    return tree_map(lambda t: t.to(mesh.device), tree)


def put_sharded(mesh: Mesh, seq, n: Optional[int] = None) -> dict:
    """{index: item on the rank's device} for the rank's block of the
    sequence ``seq`` (length ``n``, default ``len(seq)``)."""
    n = len(seq) if n is None else n
    return {i: replicated(mesh, seq[i]) for i in shard_leading(mesh, n)}
