"""Multi-process meshes: the process group and the device grid.

Reference: pilosa_tpu/parallel/multihost.py (B16m), where every host of a
pod joins a ``jax.distributed`` group and one ``jax.sharding.Mesh``
spans every device of every host. Here the group is a
``torch.distributed`` process group on the ``gloo`` backend, and the mesh
is a ``DeviceMesh`` whose positions know the rank that owns them.

Axis placement follows the reference: the **words** axis (its sum runs
on every count) stays within one process's devices; the **shards** axis
(disjoint column ranges, only the final sums cross it) spans processes.

On each process of the group:

    from pilosa_tpu_torch.parallel import multihost
    multihost.init_distributed("10.0.0.1:8476", num_processes=2, process_id=rank)
    mesh = multihost.make_multihost_mesh(words_axis=2)
    ctx = MeshContext(mesh, multihost=True)     # places this rank's shards
    engine = MeshQueryEngine(mesh)              # the same engine as one process

A program over such a mesh is a collective: every rank calls the same
programs in the same order (parallel/mesh.py).

The backend is gloo: NCCL refuses two ranks on one card, and NCCL across
cards waits for a machine with two (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from pilosa_tpu_torch.parallel.mesh import DeviceMesh
from pilosa_tpu_torch.ops._cuda import resolve_device

BACKEND = "gloo"


class Position(NamedTuple):
    """One device of one process, as ``group_devices_by_process`` and
    ``multihost_device_grid`` read it: ``id`` orders a process's devices,
    ``process_index`` is the owning rank."""

    id: int
    process_index: int
    device: str


def _infer(value: "int | None", env: str, what: str) -> int:
    if value is not None:
        return int(value)
    if env in os.environ:
        return int(os.environ[env])
    raise ValueError(
        f"init_distributed needs {what}: pass it, or set {env} as torchrun does "
        "(torch.distributed cannot infer it from the coordinator)"
    )


def init_distributed(
    coordinator_address: "str | None" = None,
    num_processes: "int | None" = None,
    process_id: "int | None" = None,
    timeout_s: float = 300.0,
) -> None:
    """Join the fixed process group at ``tcp://{coordinator_address}``
    (rank 0 listens there). A no-op without a coordinator, or when this
    process already belongs to a group of the same size and rank.
    ``num_processes`` None (or 0) and ``process_id`` None (or < 0) are
    read from ``WORLD_SIZE`` and ``RANK``."""
    if not coordinator_address:
        return
    import datetime

    import torch.distributed as dist

    world = _infer(num_processes or None, "WORLD_SIZE", "num_processes")
    rank = _infer(None if process_id is None or process_id < 0 else process_id, "RANK", "process_id")
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} out of range for {world} processes")
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        raise RuntimeError(
            f"this process already belongs to a group of {dist.get_world_size()} as rank "
            f"{dist.get_rank()}, not {world} as rank {rank}"
        )
    dist.init_process_group(
        BACKEND,
        init_method=f"tcp://{coordinator_address}",
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def group_devices_by_process(devices) -> "list[list]":
    """Devices bucketed by owning process, each bucket in ``id`` order.
    A pure function of ``(process_index, id)``."""
    buckets: dict[int, list] = {}
    for d in devices:
        buckets.setdefault(d.process_index, []).append(d)
    return [sorted(buckets[p], key=lambda d: d.id) for p in sorted(buckets)]


def multihost_device_grid(devices, words_axis: int) -> "list[list]":
    """Arrange devices into a (shards, words) grid whose every words row
    lies inside one process. Every process must hold a multiple of
    ``words_axis`` devices."""
    rows: list[list] = []
    for host_devs in group_devices_by_process(devices):
        if len(host_devs) % words_axis:
            raise ValueError(
                f"host with {len(host_devs)} devices not divisible by "
                f"words_axis={words_axis}; the words axis would cross "
                "processes (gloo over TCP) instead of staying on one host"
            )
        for i in range(0, len(host_devs), words_axis):
            rows.append(host_devs[i : i + words_axis])
    return rows


def make_multihost_mesh(words_axis: int = 1, devices=None) -> DeviceMesh:
    """A (shards × words) mesh over every position of every process of
    the group: each process offers ``devices`` (its CUDA cards by
    default; pass ``["cpu"] * n`` for the CPU), the offers are exchanged
    with one ``all_gather_object``, and each words row stays inside one
    process. Without a group this is ``make_mesh`` of the local
    devices."""
    import torch.distributed as dist

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device for a mesh; pass devices=['cpu'] * n for the CPU")
    local = [str(resolve_device(d)) for d in devices]
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        offers: list = [None] * world
        dist.all_gather_object(offers, local)
    else:
        rank, offers = 0, [local]
    kinds = {torch.device(d).type for offer in offers for d in offer}
    if len(kinds) != 1:
        raise ValueError(f"a mesh takes devices of one type, got {sorted(kinds)}")
    positions = [
        Position(id=n, process_index=p, device=d)
        for p, offer in enumerate(offers)
        for n, d in enumerate(offer)
    ]
    grid = multihost_device_grid(positions, words_axis)
    return DeviceMesh(
        [[torch.device(pos.device) for pos in row] for row in grid],
        owners=[row[0].process_index for row in grid],
        rank=rank,
    )
