"""Parallel execution over a mesh of devices (reference:
pilosa_tpu/parallel). This slice holds the device-mesh engine
(``mesh``): placement over a (shards × words) grid of devices and the
serving path's blocked programs."""

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
