"""Parallel execution over a mesh of devices (reference:
pilosa_tpu/parallel): the device-mesh engine (``mesh``: placement over a
(shards × words) grid of devices and the serving path's blocked
programs), the process group and the mesh across processes
(``multihost``), and the bulk movement lane's accounting
(``movement``)."""

from pilosa_tpu_torch.parallel.mesh import (
    AXIS_SHARDS,
    AXIS_WORDS,
    MESH_AGGREGATES,
    MESH_FALLBACK_CALLS,
    MESH_PROGRAMS,
    DeviceMesh,
    MeshArray,
    MeshContext,
    MeshQueryEngine,
    make_mesh,
    mesh_supported,
)

__all__ = [
    "AXIS_SHARDS",
    "AXIS_WORDS",
    "MESH_AGGREGATES",
    "MESH_FALLBACK_CALLS",
    "MESH_PROGRAMS",
    "DeviceMesh",
    "MeshArray",
    "MeshContext",
    "MeshQueryEngine",
    "make_mesh",
    "mesh_supported",
]
