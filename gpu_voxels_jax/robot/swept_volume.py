"""Swept-volume insertion along trajectories.

Reference: examples/SweptVolumeVsEnvironment.cpp — each trajectory step
inserts the robot's transformed clouds with meaning
eBVM_SWEPT_VOLUME_START + (step % n_sv_ids), encoding time in the 256-bit
axis (SURVEY.md §5: time is the "sequence" dimension, packed into bits).

This formulation vectorizes the whole trajectory: FK for all steps at
once (vmapped), one concatenated scatter per swept-volume id.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import SV_END, SV_START
from ..maps.voxelmap import BitVectorVoxelMap

NUM_SV_IDS = SV_END - SV_START  # 250


def sv_meaning_for_step(step: int, num_ids: int = NUM_SV_IDS - 1) -> int:
    """eBVM_SWEPT_VOLUME_START + (step % n) (SweptVolumeVsEnvironment.cpp)."""
    return SV_START + (int(step) % num_ids)


def insert_swept_volume(
    bitmap: BitVectorVoxelMap,
    robot,
    trajectory: Sequence,
    num_ids: int = NUM_SV_IDS - 1,
) -> BitVectorVoxelMap:
    """Insert robot clouds for every configuration with per-step SV bits.

    `robot` provides transformed_clouds_for(values) (KinematicChain) or
    set_configuration/get_transformed_clouds (any RobotInterface);
    `trajectory` is a sequence of joint-value vectors/maps.
    """
    m = bitmap
    for step, cfg in enumerate(trajectory):
        if hasattr(robot, "transformed_clouds_for") and not isinstance(cfg, dict):
            clouds = robot.transformed_clouds_for(jnp.asarray(cfg, jnp.float32))
        else:
            robot.set_configuration(cfg)
            clouds = robot.get_transformed_clouds()
        m = m.insert_point_cloud(clouds.points, sv_meaning_for_step(step, num_ids))
    return m


def insert_swept_volume_batched(
    bitmap: BitVectorVoxelMap,
    robot,
    trajectory,
    num_ids: int = NUM_SV_IDS - 1,
) -> BitVectorVoxelMap:
    """Whole-trajectory swept-volume insert as ONE fused program.

    FK for all T configurations runs vmapped, and all T*P points scatter in a
    single pass: (voxel, meaning) pairs are deduplicated by sort so the
    one-hot bit values can be scatter-ADDED (sum of distinct powers of two ==
    OR). Equivalent to insert_swept_volume; scales to long trajectories
    without per-step dispatch.

    Requires robot.transformed_clouds_for (pure FK) and an array trajectory
    [T, n_joints].
    """
    from ..ops.insert import scatter_bits_multi, voxelize

    traj = jnp.asarray(trajectory, jnp.float32)
    T = traj.shape[0]

    pts = jax.vmap(lambda cfg: robot.transformed_clouds_for(cfg).points)(traj)  # [T,P,3]
    P = pts.shape[1]
    # per-step meanings are a STATIC function of (T, num_ids), so the fused
    # scatter knows the touched planes at trace time: a T-step trajectory
    # touches ceil(min(T, num_ids)/32)-ish planes (3 of 8 for 64 steps).
    meanings_np = np.repeat(
        SV_START + (np.arange(T, dtype=np.int32) % int(num_ids)), P
    )
    idx, _ = voxelize(pts.reshape(-1, 3), bitmap.side_length, bitmap.dims)
    data, occ = scatter_bits_multi(bitmap.data, bitmap.occ, idx, meanings_np)
    from dataclasses import replace

    return replace(bitmap, data=data, occ=occ)
