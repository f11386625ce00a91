"""Sensor-data insertion: occupied hits + free-space ray carving.

Equivalent of ProbVoxelMap::insertSensorData (ProbVoxelMap.hpp:52-102) and
the Bresenham RayCaster (VoxelMapOperations.h:199-334).

Per-ray variable-length Bresenham is hostile to SIMD, so free-space carving
is reformulated as bounded uniform work: every ray takes the same K
dominant-axis-normalized steps (masked past its own length), each step doing
one batched scatter-add of ray-crossing counts. The per-cell update is then
count * SENSOR_MODEL_FREE in one fused clamp — deterministic, unlike the
reference's racy read-modify-write (which also multiply-counts cells crossed
by many rays; we reproduce the multiplicity, just deterministically).

The hit voxels get SENSOR_MODEL_OCCUPIED (+72); with cut_real_robot, hits
landing inside the robot's voxels are skipped (the robot is not an obstacle).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .. import probability
from ..constants import SENSOR_MODEL_FREE, SENSOR_MODEL_OCCUPIED
from .insert import linear_index, map_to_voxels

Dims = Tuple[int, int, int]


def ray_crossing_counts(
    origin: jnp.ndarray,
    points: jnp.ndarray,
    side_length: float,
    dims: Dims,
    max_steps: int = 256,
) -> jnp.ndarray:
    """int32[N]: per-voxel count of rays origin->point crossing it.

    Steps are sized so the dominant axis advances one voxel per step
    (Bresenham's visiting rule); the hit voxel itself is excluded, like the
    reference which stops the ray one cell before the measurement.
    """
    n = dims[0] * dims[1] * dims[2]
    origin = jnp.asarray(origin, jnp.float32)
    points = jnp.asarray(points, jnp.float32)
    # same host-precomputed reciprocal as insert.map_to_voxels so ray
    # endpoints land in exactly the voxel the hit insert writes
    recip = jnp.float32(1.0 / float(side_length))

    start_v = origin * recip
    end_v = points * recip
    delta = end_v - start_v[None, :]
    dominant = jnp.max(jnp.abs(delta), axis=-1)  # in voxel units
    n_steps = jnp.ceil(dominant).astype(jnp.int32)  # cells to visit per ray
    inv = jnp.where(n_steps > 0, 1.0 / jnp.maximum(n_steps.astype(jnp.float32), 1.0), 0.0)
    step_vec = delta * inv[:, None]  # one dominant-axis voxel per step

    dims_arr = jnp.asarray(dims, jnp.int32)

    def body(k, counts):
        # k=0 samples the sensor's own voxel; the endpoint voxel is excluded
        # (k goes to n_steps-1 < n_steps), matching the reference RayCaster
        pos = start_v + step_vec * jnp.float32(k)
        coords = jnp.floor(pos).astype(jnp.int32)
        live = k < n_steps
        inside = jnp.all((coords >= 0) & (coords < dims_arr), axis=-1)
        idx = jnp.where(live & inside, linear_index(coords, dims), n)
        return counts.at[idx].add(1, mode="drop")

    counts = jnp.zeros((n,), jnp.int32)
    return jax.lax.fori_loop(0, max_steps, body, counts)


def projective_free_space(
    depth: jnp.ndarray,
    pose: jnp.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    side_length: float,
    dims: Dims,
    invalid_value: float = 0.0,
    eps_vox: float = 1.0,
    z_index_offset=0,
    pool: int = 1,
) -> jnp.ndarray:
    """bool[N]: voxels observed free by a depth camera (visibility carving).

    `z_index_offset` (int scalar, may be traced) shifts the voxel z indices
    into a larger global grid: a z-slab shard passes its slab origin here and
    keeps the ORIGINAL pose, so every float in the projection is computed
    exactly as the single-device carve computes it (integer index adds are
    exact in f32; translating the pose by z0*side_length in float meters is
    NOT, and flips boundary decisions at unrepresentable side lengths —
    see parallel/sharded.py).

    The per-ray DDA walk costs K sequential scatter rounds; for a single
    depth camera the union of all rays' free cells IS the camera's visibility
    volume, so carve it the other way around: project every voxel center into
    the image and compare against the measured depth — one fused pass over
    the grid plus gathers from the (tiny) depth image, independent of ray
    count. (SURVEY.md §7.5's "wavefront/distance-based free-space carving".)

    A voxel is free iff it projects inside the FOV, lies in front of the
    camera, and sits at least eps_vox voxels closer than the measurement
    (invalid pixels carve nothing).

    pool > 1 compares against the minimum depth of the voxel's pool x pool
    pixel tile instead (`min_pool_depth`): strictly conservative — it never
    frees a voxel the exact carve keeps, and under-carves near depth edges by
    at most the tile's depth range. pool=1 is the exact per-pixel carve.
    """
    h, w = depth.shape
    pose = jnp.asarray(pose, jnp.float32)
    rot_t = pose[:3, :3].T
    origin = pose[:3, 3]

    dx, dy, dz = dims
    # voxel centers in world, streamed as a fused iota computation
    zi = jax.lax.broadcasted_iota(jnp.float32, (dz, dy, dx), 0)
    yi = jax.lax.broadcasted_iota(jnp.float32, (dz, dy, dx), 1)
    xi = jax.lax.broadcasted_iota(jnp.float32, (dz, dy, dx), 2)
    side = jnp.float32(side_length)
    wx = (xi + 0.5) * side - origin[0]
    wy = (yi + 0.5) * side - origin[1]
    zoff = jnp.asarray(z_index_offset, jnp.float32)
    wz = (zi + zoff + 0.5) * side - origin[2]
    # sensor frame (camera looks along +z of its frame)
    sx = rot_t[0, 0] * wx + rot_t[0, 1] * wy + rot_t[0, 2] * wz
    sy = rot_t[1, 0] * wx + rot_t[1, 1] * wy + rot_t[1, 2] * wz
    sz = rot_t[2, 0] * wx + rot_t[2, 1] * wy + rot_t[2, 2] * wz

    in_front = sz > jnp.float32(1e-6)
    safe_z = jnp.where(in_front, sz, 1.0)
    u = jnp.floor(fx * sx / safe_z + cx).astype(jnp.int32)
    v = jnp.floor(fy * sy / safe_z + cy).astype(jnp.int32)
    in_fov = in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    ui = jnp.clip(u, 0, w - 1)
    vi = jnp.clip(v, 0, h - 1)
    if pool > 1:
        # invalid pixels pool to -inf, which carves nothing
        d = min_pool_depth(depth, pool, invalid_value)[vi // pool, ui // pool]
        valid = True
    else:
        d = depth[vi, ui]
        valid = d != invalid_value
    free = in_fov & valid & (sz < d - eps_vox * side)
    return free.reshape(-1)


def min_pool_depth(
    depth: jnp.ndarray, pool: int, invalid_value: float = 0.0
) -> jnp.ndarray:
    """Conservative PxP min-pool: invalid pixels -> -inf (carve nothing)."""
    h, w = depth.shape
    d = jnp.where(depth == invalid_value, jnp.float32(-3.0e38), depth)
    ph, pw = -(-h // pool), -(-w // pool)
    if ph * pool != h or pw * pool != w:
        # out-of-image pixels are never indexed (the in-FOV test rejects
        # them), so edge-tile padding must be min-neutral, not -inf
        d = jnp.pad(
            d,
            ((0, ph * pool - h), (0, pw * pool - w)),
            constant_values=3.0e38,
        )
    return jnp.min(d.reshape(ph, pool, pw, pool), axis=(1, 3))


def insert_sensor_data(
    data: jnp.ndarray,
    sensor_origin,
    points: jnp.ndarray,
    side_length: float,
    dims: Dims,
    enable_raycasting: bool = True,
    cut_real_robot: bool = False,
    robot_occupied_mask: Optional[jnp.ndarray] = None,
    max_steps: int = 256,
) -> jnp.ndarray:
    """ProbVoxelMap::insertSensorData on a flat int8 log-odds grid.

    points are world-frame measurement endpoints (already transformed by the
    sensor pose, cf. transformSensorData TemplateVoxelMap.hpp:894).
    """
    n = dims[0] * dims[1] * dims[2]
    points = jnp.asarray(points, jnp.float32)
    finite = jnp.all(jnp.isfinite(points), axis=-1)
    coords = map_to_voxels(jnp.where(finite[:, None], points, -1.0), side_length)
    dims_arr = jnp.asarray(dims, jnp.int32)
    inside = finite & jnp.all((coords >= 0) & (coords < dims_arr), axis=-1)
    idx = jnp.where(inside, linear_index(coords, dims), n)

    # hit counts (multiple measurements in one cell accumulate, like the
    # reference's per-point updateOccupancy)
    hit_counts = jnp.zeros((n,), jnp.int32).at[idx].add(1, mode="drop")
    if cut_real_robot and robot_occupied_mask is not None:
        hit_counts = jnp.where(robot_occupied_mask, 0, hit_counts)

    delta = hit_counts * SENSOR_MODEL_OCCUPIED
    if enable_raycasting:
        free_counts = ray_crossing_counts(sensor_origin, points, side_length, dims, max_steps)
        delta = delta + free_counts * SENSOR_MODEL_FREE

    # only touched voxels update — the clamp floor (-127) must not lift
    # untouched UNKNOWN (-128) voxels
    return jnp.where(delta != 0, probability.update_occupancy(data, delta), data)


def insert_depth_image(
    data: jnp.ndarray,
    depth: jnp.ndarray,
    pose: jnp.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    side_length: float,
    dims: Dims,
    invalid_value: float = 0.0,
    cut_real_robot: bool = False,
    robot_occupied_mask=None,
    carve_pool: int = 1,
) -> jnp.ndarray:
    """Full projective sensor update: occupied hits (+72 per measurement) and
    visibility-carved free space (-10) in one fused program. The fast path
    for dense depth cameras; insert_sensor_data's DDA walk remains for
    sparse/arbitrary point sets.

    carve_pool > 1 carves against the PxP min-pooled depth image
    (projective_free_space's `pool`): conservative, never frees a voxel the
    exact carve keeps. The default (1) keeps the exact per-pixel carve —
    reference semantics."""
    pts = depth_image_to_point_cloud(depth, fx, fy, cx, cy, invalid_value)
    from ..geometry import transforms

    world = transforms.transform_points(jnp.asarray(pose, jnp.float32), pts)
    n = dims[0] * dims[1] * dims[2]
    finite = jnp.all(jnp.isfinite(world), axis=-1)
    coords = map_to_voxels(jnp.where(finite[:, None], world, -1.0), side_length)
    dims_arr = jnp.asarray(dims, jnp.int32)
    inside = finite & jnp.all((coords >= 0) & (coords < dims_arr), axis=-1)
    idx = jnp.where(inside, linear_index(coords, dims), n)
    hit_counts = jnp.zeros((n,), jnp.int32).at[idx].add(1, mode="drop")
    if cut_real_robot and robot_occupied_mask is not None:
        hit_counts = jnp.where(robot_occupied_mask, 0, hit_counts)
    free = projective_free_space(
        depth, pose, fx, fy, cx, cy, side_length, dims, invalid_value,
        pool=carve_pool,
    )
    delta = hit_counts * SENSOR_MODEL_OCCUPIED + jnp.where(
        free & (hit_counts == 0), SENSOR_MODEL_FREE, 0
    )
    return jnp.where(delta != 0, probability.update_occupancy(data, delta), data)


def depth_image_to_point_cloud(depth, fx, fy, cx, cy, invalid_value=0.0):
    """Pinhole back-projection: depth image -> sensor-frame points.

    Equivalent of the octree sensor preprocess kernels
    (kernel_preprocessObjectDepthImage, octree/kernels/kernel_PointCloud.h).
    Invalid measurements become NaN points (dropped by voxelization later,
    mirroring Sensor.h invalid-measure handling).
    """
    depth = jnp.asarray(depth, jnp.float32)
    h, w = depth.shape
    u = jnp.arange(w, dtype=jnp.float32)[None, :]
    v = jnp.arange(h, dtype=jnp.float32)[:, None]
    z = depth
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts = jnp.stack([x, y, z * jnp.ones_like(x)], axis=-1).reshape(-1, 3)
    valid = (depth != invalid_value).reshape(-1)
    return jnp.where(valid[:, None], pts, jnp.nan)
