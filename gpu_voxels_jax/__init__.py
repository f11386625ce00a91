"""gpu_voxels_jax — a voxel-world collision engine in JAX.

A from-scratch JAX/XLA/Pallas framework (GPU kernels through Triton) with
the capabilities of the CUDA
GPU-Voxels library (reference: Changliu52/gpu-voxels): volumetric maps
(probabilistic, 256-bit deterministic, distance, counting; dense, sparse-list
and hierarchical), point-cloud/robot insertion, collision detection, swept
volumes, sensor fusion, Euclidean distance transforms, and a high-level scene
facade — all formulated as fused, jittable array programs that keep the whole
sense -> insert -> collide loop on-device.
"""
from .constants import (
    BIT_VECTOR_LENGTH,
    MAX_PROBABILITY,
    MIN_PROBABILITY,
    UNKNOWN_PROBABILITY,
    BitVoxelMeaning,
    MapType,
    float_to_probability,
)

__version__ = "0.3.0"

# lazily-resolved top-level surface: `from gpu_voxels_jax import GpuVoxels`
# works without paying every submodule's import cost up front
_LAZY = {
    "GpuVoxels": "gpu_voxels_jax.api",
    "ProbVoxelMap": "gpu_voxels_jax.maps.voxelmap",
    "BitVectorVoxelMap": "gpu_voxels_jax.maps.voxelmap",
    "CountingVoxelMap": "gpu_voxels_jax.maps.voxelmap",
    "DistanceVoxelMap": "gpu_voxels_jax.maps.distance_map",
    "VoxelList": "gpu_voxels_jax.maps.voxellist",
    "HierarchicalProbMap": "gpu_voxels_jax.maps.hierarchical",
    "HierarchicalBitMap": "gpu_voxels_jax.maps.hierarchical",
    "PagedHierarchicalMap": "gpu_voxels_jax.maps.paged",
    "MetaPointCloud": "gpu_voxels_jax.geometry.pointcloud",
    "PointCloud": "gpu_voxels_jax.geometry.pointcloud",
    "Sensor": "gpu_voxels_jax.sensors",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


__all__ = [
    "BIT_VECTOR_LENGTH",
    "BitVoxelMeaning",
    "MapType",
    "MAX_PROBABILITY",
    "MIN_PROBABILITY",
    "UNKNOWN_PROBABILITY",
    "float_to_probability",
    "__version__",
    *sorted(_LAZY),
]
