"""First-class multi-chip sharding of EXISTING map values.

`parallel/sharded.py` builds whole sharded programs from scratch (the bench
cycles); this module instead lays an already-built map pytree over a device
mesh with `jax.sharding.NamedSharding` and lets XLA's SPMD partitioner run
the map's EXISTING public ops distributed: elementwise collides become local
work + an all-reduce, scatters route points to their owner slab, reductions
psum — no bespoke shard_map wrappers, no semantic forks. This is the
productized form of SURVEY §2.4's "shard_map sharding of the grid" mandate
(the reference is single-GPU; grid scaling is this framework's new
capability).

Layout: dense grids are flat z-major (index = z*dimx*dimy + y*dimx + x,
TemplateVoxelMap.h:258), so sharding the flat axis over the mesh's 'z' axis
in equal contiguous chunks IS z-slab decomposition (dimz must divide the
mesh). Bit maps shard their uint32[8, N] planes over N and keep the plane
axis local, so the 256-bit voxel stays on-chip (SURVEY §5's packed-lane
prescription); the occupancy summary shards alongside. Hierarchical pyramids
shard every level whose z extent still divides the mesh and replicate the
coarse tail (tiny).

Facade opt-in: `GpuVoxels.add_map(..., mesh=mesh)` keeps the named map
permanently laid out over the mesh (re-pinned after every functional
update).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _check_divides(m, mesh: Mesh, axis: str) -> int:
    nz = mesh.shape[axis]
    dz = m.dims[2]
    if dz % nz:
        raise ValueError(
            f"map dimz {dz} must divide the mesh '{axis}' axis ({nz}) for "
            "z-slab sharding"
        )
    return nz


def shard_map_value(m, mesh: Mesh, axis: str = "z"):
    """Return the same map value laid out over `mesh`'s `axis`.

    Supports the dense tiers (ProbVoxelMap / CountingVoxelMap /
    DistanceVoxelMap: flat data; BitVectorVoxelMap: planes + occ summary)
    and the hierarchical pyramids (level arrays sharded while their z extent
    divides the mesh, coarse tail replicated). All public ops on the result
    (insert_point_cloud, collide_with, collide_with_types, merge, ...) run
    SPMD-distributed under their existing jit wrappers.
    """
    from ..maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
    from ..maps.voxelmap import BitVectorVoxelMap, _DenseMap

    _check_divides(m, mesh, axis)

    def put(arr, *spec):
        return jax.device_put(arr, NamedSharding(mesh, P(*spec)))

    if isinstance(m, BitVectorVoxelMap):
        kw = dict(data=put(m.data, None, axis))
        if m.occ is not None:
            kw["occ"] = put(m.occ, axis)
        return replace(m, **kw)
    if isinstance(m, _DenseMap):  # prob / counting / distance: flat [N]
        return replace(m, data=put(m.data, axis))
    if isinstance(m, (HierarchicalProbMap, HierarchicalBitMap)):
        nz = mesh.shape[axis]

        def put_level(lv):
            # [Z, Y, X] status level: slab-shard while Z divides the mesh
            return put(lv, axis) if lv.shape[0] % nz == 0 else put(lv)

        kw = dict(pyramid=tuple(put_level(lv) for lv in m.pyramid))
        if isinstance(m, HierarchicalProbMap):
            kw["occupancy"] = put(m.occupancy, axis)
        return replace(m, **kw)
    raise TypeError(f"no sharding layout for {type(m)}")


def _sharded_arrays(m) -> Dict[str, tuple]:
    """(array, sharded-dim, extent-divisor) per field expected to be sharded."""
    from ..maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
    from ..maps.voxelmap import BitVectorVoxelMap, _DenseMap

    if isinstance(m, BitVectorVoxelMap):
        out = {"data": (m.data, 1)}
        if m.occ is not None:
            out["occ"] = (m.occ, 0)
        return out
    if isinstance(m, _DenseMap):
        return {"data": (m.data, 0)}
    if isinstance(m, (HierarchicalProbMap, HierarchicalBitMap)):
        # only level 0 is asserted: coarse levels may legitimately replicate
        return {"pyramid[0]": (m.pyramid[0], 0)}
    raise TypeError(type(m))


def assert_sharded(m, mesh: Mesh, axis: str = "z") -> None:
    """Fail loudly if the map's bulk arrays are NOT actually distributed —
    each per-device shard must hold exactly global_extent / mesh[axis] of
    the sharded dimension. This is what catches a silent full replication
    slipping into a future edit (every count would still be correct, and
    nothing else would notice)."""
    nz = mesh.shape[axis]
    for name, (arr, dim) in _sharded_arrays(m).items():
        shards = arr.addressable_shards
        if len(shards) != mesh.size:
            raise AssertionError(
                f"{name}: {len(shards)} addressable shards != mesh size {mesh.size}"
            )
        if len({s.device for s in shards}) != mesh.size:
            raise AssertionError(f"{name}: shards share devices — not distributed")
        want = arr.shape[dim] // nz
        for s in shards:
            got = s.data.shape[dim]
            if got != want:
                raise AssertionError(
                    f"{name}: per-shard dim {dim} is {got}, want {want} "
                    f"(global {arr.shape[dim]} / {nz}) — silently replicated?"
                )


def reshard_like(m, mesh: Mesh, axis: str = "z"):
    """Re-pin a map to its mesh layout after a functional update (a no-op
    view when XLA already preserved the sharding, a collective otherwise)."""
    return shard_map_value(m, mesh, axis)
