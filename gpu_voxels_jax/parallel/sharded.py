"""Multi-chip scaling: shard the voxel grid over a device mesh.

The reference is single-GPU (SURVEY.md §2.4); grid scaling is this
framework's new capability. The dense grid's flat layout is z-major
(index = z*dimx*dimy + y*dimx + x), so sharding the leading Z axis over the
mesh gives contiguous per-chip slabs:

  * insert: point clouds are replicated (small); each chip masks the points
    falling in its slab and scatters locally — no communication.
  * collide/count: purely local element-wise work + one psum over the mesh.
  * swept-volume shift / clear / merge: local.
  * EDT sweeps and raycasts need halo exchange (ppermute) — see ops/edt.

A second 'world' axis batches independent scenes (motion-validity batches)
data-parallel over the remaining chips.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import UNKNOWN_PROBABILITY, float_to_probability, meaning_to_probability
from ..ops.insert import map_to_voxels


def make_grid_mesh(n_devices: int, world: int = 1, devices=None) -> Mesh:
    """Mesh over ('world', 'z'): scene batch x spatial slabs, over the first
    n_devices of `devices` (default: jax.devices())."""
    devs = list(jax.devices() if devices is None else devices)[:n_devices]
    return Mesh(np.asarray(devs).reshape(world, n_devices // world), ("world", "z"))


def _local_insert_prob(local: jnp.ndarray, points: jnp.ndarray, side_length, dims, z0, zl, value):
    """Scatter points into this chip's [zl*Y*X] slab (others dropped)."""
    dx, dy, _ = dims
    coords = map_to_voxels(points, side_length)
    in_map = (
        (coords[:, 0] >= 0) & (coords[:, 0] < dx)
        & (coords[:, 1] >= 0) & (coords[:, 1] < dy)
        & (coords[:, 2] >= z0) & (coords[:, 2] < z0 + zl)
    )
    idx = (coords[:, 2] - z0) * (dx * dy) + coords[:, 1] * dx + coords[:, 0]
    idx = jnp.where(in_map, idx, zl * dx * dy)
    vals = jnp.full(idx.shape, jnp.int8(value))
    return local.at[idx].set(vals, mode="drop")


def build_sharded_cycle(
    mesh: Mesh,
    dims: Tuple[int, int, int],
    side_length: float = 1.0,
    coll_threshold: float = 1.0,
):
    """Jitted multi-chip sense->insert->collide step.

    Returns fn(points_a [W?, M, 3], points_b [W?, M, 3]) -> count [W?] where
    the optional leading axis is sharded over 'world' and the grid over 'z'.
    Each step builds both maps from scratch (the benchmark cycle), counts
    collisions locally and psums over the z axis.
    """
    dx, dy, dz = dims
    nz = mesh.shape["z"]
    if dz % nz != 0:
        raise ValueError(f"dimz {dz} must divide over z-mesh {nz}")
    zl = dz // nz
    t = float_to_probability(coll_threshold)
    occ = meaning_to_probability(1)  # eBVM_OCCUPIED

    def _shard_fn(pa, pb):
        # pa, pb: [M, 3] replicated within z; per-world slice outside
        zi = jax.lax.axis_index("z")
        z0 = zi * zl
        local = jnp.full((zl * dy * dx,), jnp.int8(UNKNOWN_PROBABILITY))
        ma = _local_insert_prob(local, pa, side_length, dims, z0, zl, occ)
        mb = _local_insert_prob(local, pb, side_length, dims, z0, zl, occ)
        hit = (ma.astype(jnp.int32) >= t) & (mb.astype(jnp.int32) >= t)
        cnt = jnp.sum(hit, dtype=jnp.uint32)
        return jax.lax.psum(cnt, "z")

    has_world = "world" in mesh.shape and mesh.shape["world"] > 1

    if has_world:
        fn = jax.shard_map(
            jax.vmap(_shard_fn),
            mesh=mesh,
            in_specs=(P("world"), P("world")),
            out_specs=P("world"),
        )
    else:
        fn = jax.shard_map(
            _shard_fn,
            mesh=mesh,
            in_specs=(P(), P()),
            out_specs=P(),
        )
    return jax.jit(fn)


def build_sharded_sensor_cycle(
    mesh: Mesh,
    dims: Tuple[int, int, int],
    side_length: float,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    coll_threshold: float = 0.7,
):
    """Multi-chip sensor fusion: depth image -> hits + projective free-space
    carve -> collide vs a z-sharded environment grid.

    The depth image is tiny and replicated; each chip carves only its own
    slab's voxels (visibility is per-voxel, embarrassingly shard-parallel)
    and scatters the hits landing in its slab. Returns a jitted
    fn(depth [H,W], pose [4,4], env_flat int8[N] sharded) -> collision count.
    """
    from ..constants import SENSOR_MODEL_FREE, SENSOR_MODEL_OCCUPIED
    from .. import probability
    from ..ops.raycast import depth_image_to_point_cloud, projective_free_space
    from ..geometry import transforms

    dx, dy, dz = dims
    nz = mesh.shape["z"]
    if dz % nz:
        raise ValueError("dimz must divide the z mesh")
    zl = dz // nz
    t = float_to_probability(coll_threshold)

    def _shard_fn(depth, pose, env_local):
        zi = jax.lax.axis_index("z")
        z0 = zi * zl
        # endpoints (replicated compute: cheap vs the grid work)
        pts = depth_image_to_point_cloud(depth, fx, fy, cx, cy)
        world = transforms.transform_points(pose, pts)
        local_dims = (dx, dy, zl)
        finite = jnp.all(jnp.isfinite(world), axis=-1)
        coords = map_to_voxels(jnp.where(finite[:, None], world, -1.0), side_length)
        inside = (
            finite
            & (coords[:, 0] >= 0) & (coords[:, 0] < dx)
            & (coords[:, 1] >= 0) & (coords[:, 1] < dy)
            & (coords[:, 2] >= z0) & (coords[:, 2] < z0 + zl)
        )
        lidx = (coords[:, 2] - z0) * (dx * dy) + coords[:, 1] * dx + coords[:, 0]
        lidx = jnp.where(inside, lidx, zl * dx * dy)
        hits = jnp.zeros((zl * dy * dx,), jnp.int32).at[lidx].add(1, mode="drop")

        # per-slab projective carve in the GLOBAL frame: the slab shifts its
        # voxel z INDICES (exact integer adds) and keeps the original pose —
        # translating the pose by z0*side in float meters flips projection
        # boundary decisions whenever side_length is unrepresentable in f32
        free = projective_free_space(
            depth, pose, fx, fy, cx, cy, side_length, local_dims,
            z_index_offset=z0,
        )
        delta = hits * SENSOR_MODEL_OCCUPIED + jnp.where(
            free & (hits == 0), SENSOR_MODEL_FREE, 0
        )
        local = jnp.full((zl * dy * dx,), jnp.int8(UNKNOWN_PROBABILITY))
        local = jnp.where(delta != 0, probability.update_occupancy(local, delta), local)

        hit = (local.astype(jnp.int32) >= t) & (env_local.astype(jnp.int32) >= t)
        return jax.lax.psum(jnp.sum(hit, dtype=jnp.uint32), "z")

    fn = jax.shard_map(
        _shard_fn, mesh=mesh, in_specs=(P(), P(), P("z")), out_specs=P()
    )
    return jax.jit(fn)


def sharded_collide_count(mesh: Mesh, data_a: jnp.ndarray, data_b: jnp.ndarray, t1: int, t2: int):
    """Collide two already-sharded flat prob grids (z-major) -> scalar count."""

    def _fn(a, b):
        hit = (a.astype(jnp.int32) >= t1) & (b.astype(jnp.int32) >= t2)
        return jax.lax.psum(jnp.sum(hit, dtype=jnp.uint32), "z")

    fn = jax.shard_map(_fn, mesh=mesh, in_specs=(P("z"), P("z")), out_specs=P())
    return jax.jit(fn)(data_a, data_b)


def build_sharded_bit_cycle(
    mesh: Mesh,
    dims: Tuple[int, int, int],
    side_length: float = 1.0,
    meaning_a: int = 1,
    meaning_b: int = 1,
):
    """Z-slab-sharded 256-bit voxel maps (SURVEY §2.4 grid scaling for the
    bit tier): each chip scatters the replicated clouds' points landing in
    its slab into a local uint32[8, zl*Y*X] plane block, folds noneButEmpty
    locally and psums the bit x bit collision count over 'z'. Identical to
    the single-device BitVectorVoxelMap insert + collide_with count."""
    from .. import bitops

    dx, dy, dz = dims
    nz = mesh.shape["z"]
    if dz % nz:
        raise ValueError("dimz must divide the z mesh")
    zl = dz // nz

    def _insert(points, meaning: int, z0):
        coords = map_to_voxels(points, side_length)
        inside = (
            (coords[:, 0] >= 0) & (coords[:, 0] < dx)
            & (coords[:, 1] >= 0) & (coords[:, 1] < dy)
            & (coords[:, 2] >= z0) & (coords[:, 2] < z0 + zl)
        )
        idx = (coords[:, 2] - z0) * (dx * dy) + coords[:, 1] * dx + coords[:, 0]
        idx = jnp.where(inside, idx, zl * dx * dy)
        planes = jnp.zeros((8, zl * dy * dx), jnp.uint32)
        word = jnp.full(idx.shape, jnp.uint32(1 << (int(meaning) % 32)))
        return planes.at[int(meaning) // 32, idx].set(word, mode="drop")

    def _shard_fn(pa, pb):
        z0 = jax.lax.axis_index("z") * zl
        ma = _insert(pa, meaning_a, z0)
        mb = _insert(pb, meaning_b, z0)
        hit = bitops.occupied(ma) & bitops.occupied(mb)
        return jax.lax.psum(jnp.sum(hit, dtype=jnp.uint32), "z")

    fn = jax.shard_map(_shard_fn, mesh=mesh, in_specs=(P(), P()), out_specs=P())
    return jax.jit(fn)


def build_sharded_paged_probe(mesh: Mesh, min_level: int = 0, offset=(0, 0, 0)):
    """Sharded paged-octree probe batch: the snapshot pytree (page pyramid,
    sorted directory, tile pool — the octree itself, compact by construction)
    is replicated; the query coordinate batch shards over 'z'. Each chip runs
    the single-device descent (`PagedSnapshot.probe`) on its slice and the
    occupied/unknown counts psum — exactly `collide_with_coords` /
    `collide_with_counting_unknown` on the single-device map (the
    intersect_sparse analogue, NTree.hpp:817-1004, distributed over queries).

    Returns fn(snap: PagedSnapshot, coords int32[Q, 3]) -> (occupied uint32,
    unknown uint32); Q must divide over the 'z' mesh axis.
    """
    from ..maps.paged import _count_probe_hits

    def _shard_fn(snap, coords):
        valid = jnp.ones(coords.shape[:-1], bool)
        occ, unk = _count_probe_hits(snap, coords, valid, min_level, offset)
        return jax.lax.psum(occ, "z"), jax.lax.psum(unk, "z")

    fn = jax.shard_map(
        _shard_fn, mesh=mesh, in_specs=(P(), P("z")), out_specs=(P(), P())
    )
    return jax.jit(fn)


def build_sharded_list_collide(mesh: Mesh):
    """Sharded list x list collide: list A's sorted id rows shard over 'z',
    list B's are replicated; each chip binary-searches its slice and the
    match count psums — identical to `VoxelList.collide_with(list)` (the
    thrust::binary_search stencil, TemplateVoxelList.hpp:228-275, distributed
    over A's entries; EMPTY padding never matches).

    Returns fn(lo_a, hi_a, lo_b, hi_b) -> uint32 count, where (lo, hi) are a
    list's `(ids, ids_hi)` arrays and A's capacity divides the 'z' axis.
    """
    from ..maps.voxellist import EMPTY_ID, _pair_searchsorted

    def _shard_fn(lo_a, hi_a, lo_b, hi_b):
        pos = jnp.clip(
            _pair_searchsorted(hi_b, lo_b, hi_a, lo_a), 0, lo_b.shape[0] - 1
        )
        found = (lo_b[pos] == lo_a) & (hi_b[pos] == hi_a) & (lo_a != EMPTY_ID)
        return jax.lax.psum(jnp.sum(found, dtype=jnp.uint32), "z")

    fn = jax.shard_map(
        _shard_fn, mesh=mesh, in_specs=(P("z"), P("z"), P(), P()), out_specs=P()
    )
    return jax.jit(fn)


def build_sharded_hier_probe(mesh: Mesh, levels: int, dims: Tuple[int, int, int]):
    """Sharded hierarchy probe batch: the pyramid's coarse levels (tiny) are
    replicated, level 0 shards over 'z' slabs. Each chip descends the
    replicated coarse levels; queries that reach level 0 are answered by the
    slab owner only, coarse-decided queries by chip 0, and the occupied
    count psums over 'z' — exactly collide_with_coords on the single-device
    pyramid.

    Returns fn(l0 [Z,Y,X] z-sharded, coarse tuple (replicated), coords [Q,3]
    replicated) -> uint32 count."""
    from ..maps.hierarchical import NS_OCCUPIED, U8, _is_uniform

    Z = dims[2]
    nz = mesh.shape["z"]
    if Z % nz:
        raise ValueError("level-0 z extent must divide the z mesh")
    zl = Z // nz

    def _shard_fn(l0_local, coarse, coords):
        x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
        decided = jnp.zeros(x.shape, bool)
        status = jnp.zeros(x.shape, U8)
        for l in range(levels, 0, -1):
            s = coarse[l - 1][z >> l, y >> l, x >> l]
            uni = _is_uniform(s)
            take = uni & ~decided
            status = jnp.where(take, s, status)
            decided = decided | uni
        zi = jax.lax.axis_index("z")
        z0 = zi * zl
        mine = (z >= z0) & (z < z0 + zl)
        s0 = l0_local[jnp.clip(z - z0, 0, zl - 1), y, x]
        occ_fine = (~decided) & mine & ((s0 & U8(NS_OCCUPIED)) != 0)
        occ_coarse = decided & ((status & U8(NS_OCCUPIED)) != 0) & (zi == 0)
        return jax.lax.psum(jnp.sum(occ_fine | occ_coarse, dtype=jnp.uint32), "z")

    fn = jax.shard_map(
        _shard_fn, mesh=mesh, in_specs=(P("z"), P(), P()), out_specs=P()
    )
    return jax.jit(fn)
