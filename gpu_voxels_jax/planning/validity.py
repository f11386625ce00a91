"""Motion-planning validity checking backed by voxel collision counts.

Equivalent of gvl_ompl_planning/gvl_ompl_planner_helper.cpp:42-330: an
OMPL-style StateValidityChecker + MotionValidator where a state is valid iff
inserting the robot at that configuration collides with the environment map
in fewer than `threshold` voxels.

Batched twist: states are checked in BATCHES — motion validation
interpolates the segment at the collision resolution and evaluates every
intermediate state in one vmapped jitted program, instead of the reference's
one-insert-one-collide-per-state loop.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import float_to_probability
from ..ops.insert import linear_index, map_to_voxels


def _count_distinct_hits(lin: jnp.ndarray, hit: jnp.ndarray) -> jnp.ndarray:
    """Distinct colliding voxels (duplicates collapse, like the reference's
    voxel-level count): sort the hit voxels' linear indices and count first
    occurrences. Cost scales with the ROBOT's point count, never the grid."""
    key = jnp.where(hit, lin, jnp.uint32(0xFFFFFFFF))
    key = jnp.sort(key)
    first = jnp.concatenate([jnp.ones((1,), bool), key[1:] != key[:-1]])
    return jnp.sum(first & (key != jnp.uint32(0xFFFFFFFF)), dtype=jnp.uint32)


class GvlValidityChecker:
    """State validity: robot FK -> voxelize -> gather env occupancy -> count.

    Instead of inserting the robot into a scratch map and colliding two full
    grids per state (the reference's loop), the robot's point cloud is
    gathered directly against the environment grid — same count (point
    duplicates in one voxel collapse), far less bandwidth.
    """

    def __init__(
        self,
        env_map,
        robot,
        coll_threshold: float = 0.7,
        max_colliding_voxels: int = 0,
    ):
        self.env = env_map
        self.robot = robot
        self.t = float_to_probability(coll_threshold)
        self.max_colliding = int(max_colliding_voxels)
        self._check = jax.jit(self._build_check())
        # built ONCE: re-wrapping vmap in jit per call would recompile the
        # whole batch program every call (jit caches on callable identity)
        self._batch_check = jax.jit(jax.vmap(self._build_check(), in_axes=(0, None)))

    def _build_check(self):
        env = self.env
        robot = self.robot
        t = self.t
        dims = env.dims

        def colliding_voxels(cfg, env_data):
            clouds = robot.transformed_clouds_for(cfg)
            coords = map_to_voxels(clouds.points, env.side_length)
            dims_arr = jnp.asarray(dims, jnp.int32)
            inside = jnp.all((coords >= 0) & (coords < dims_arr), axis=-1)
            idx = jnp.where(inside, linear_index(coords, dims), 0)
            occ = (env_data[idx].astype(jnp.int32) >= t) & inside
            # an earlier one-hot formulation materialized an N-voxel buffer
            # per vmapped state (batch x full grid), which throttled batched
            # motion checks; the sort costs O(points log points) instead
            return _count_distinct_hits(idx.astype(jnp.uint32), occ)

        return colliding_voxels

    def colliding_voxels(self, cfg) -> int:
        return int(self._check(jnp.asarray(cfg, jnp.float32), self.env.data))

    def is_valid(self, cfg) -> bool:
        """isValid (gvl_ompl_planner_helper.cpp pose_check)."""
        return self.colliding_voxels(cfg) <= self.max_colliding

    def batch_colliding_voxels(self, cfgs) -> np.ndarray:
        return np.asarray(self._batch_check(jnp.asarray(cfgs, jnp.float32), self.env.data))


class HierarchicalValidityChecker(GvlValidityChecker):
    """Validity against a hierarchical map (config: octree-tier map vs
    voxellist intersection inside motion checks at high effective
    resolution). Probes descend the status pyramid per robot voxel, so
    mostly-uniform space costs a single coarse gather.

    Accepts a dense `HierarchicalMap`/`HierarchicalBitMap` pytree, a
    `PagedSnapshot`, or a host-stateful `PagedHierarchicalMap` (the sparse
    octree tier; auto-snapshotted — at >=1024^3 the paged tier covers the
    same world in ~1/10 the memory of the dense status pyramid, see
    docs/PERFORMANCE.md config-#5 row). After mutating a paged env, call
    `refresh()` to re-capture the snapshot the compiled batch probes."""

    def __init__(self, env_map, robot, max_colliding_voxels: int = 0, min_level: int = 0):
        # PagedHierarchicalMap is host-stateful (not a pytree); jitted
        # consumers take its immutable snapshot() instead (maps/paged.py:80)
        self.env = env_map.snapshot() if hasattr(env_map, "snapshot") else env_map
        self._env_source = env_map if hasattr(env_map, "snapshot") else None
        self.robot = robot
        self.max_colliding = int(max_colliding_voxels)
        self.min_level = int(min_level)
        self._check = jax.jit(self._build_check())
        self._batch_check = jax.jit(jax.vmap(self._build_check(), in_axes=(0, None)))

    def _build_check(self):
        # NOTE: the env map is a jit ARGUMENT (a pytree), never a closure —
        # closed-over gigabyte pyramids would be baked into the program as
        # constants (and overflow this environment's remote compiler)
        robot = self.robot
        min_level = self.min_level
        dims = self.env.dims
        side = self.env.side_length

        def colliding_voxels(cfg, env):
            clouds = robot.transformed_clouds_for(cfg)
            coords = map_to_voxels(clouds.points, side)
            dims_arr = jnp.asarray(dims, jnp.int32)
            inside = jnp.all((coords >= 0) & (coords < dims_arr), axis=-1)
            coords = jnp.clip(coords, 0, dims_arr - 1)
            occ, _, _ = env.probe(coords, min_level)
            # distinct colliding voxels via sort (a one-hot grid would cost a
            # full-resolution array per check at 1024^3)
            dx, dy, _ = dims
            lin = (
                coords[:, 2].astype(jnp.uint32) * jnp.uint32(dx * dy)
                + coords[:, 1].astype(jnp.uint32) * jnp.uint32(dx)
                + coords[:, 0].astype(jnp.uint32)
            )
            return _count_distinct_hits(lin, occ & inside)

        return colliding_voxels

    def refresh(self) -> None:
        """Re-capture the paged env's snapshot after host-side mutations.

        No-op for pytree (dense) envs, which callers rebind via `self.env`.
        The compiled batch program is shape-stable across snapshots unless
        the pool capacity doubled (then jit recompiles on the new shape)."""
        if self._env_source is not None:
            self.env = self._env_source.snapshot()

    def colliding_voxels(self, cfg) -> int:
        return int(self._check(jnp.asarray(cfg, jnp.float32), self.env))

    def batch_colliding_voxels(self, cfgs) -> np.ndarray:
        return np.asarray(self._batch_check(jnp.asarray(cfgs, jnp.float32), self.env))


class MotionValidator:
    """checkMotion (motion_check prefix): interpolate + batch validate."""

    def __init__(self, checker: GvlValidityChecker, resolution: float = 0.02):
        self.checker = checker
        self.resolution = float(resolution)

    def segment_states(self, s1, s2) -> np.ndarray:
        s1 = np.asarray(s1, np.float32)
        s2 = np.asarray(s2, np.float32)
        dist = float(np.max(np.abs(s2 - s1)))
        n = max(int(np.ceil(dist / self.resolution)), 1)
        ratios = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
        return s1[None, :] * (1 - ratios[:, None]) + s2[None, :] * ratios[:, None]

    def check_motion(self, s1, s2) -> Tuple[bool, int]:
        """Returns (valid, number of checked states).

        The state batch is padded to the next power of two (repeating the
        endpoint) so arbitrary segment lengths reuse a handful of compiled
        batch programs instead of recompiling per length."""
        states = self.segment_states(s1, s2)
        n = len(states)
        m = 1
        while m < n:
            m <<= 1
        if m != n:
            states = np.concatenate([states, np.repeat(states[-1:], m - n, axis=0)])
        counts = self.checker.batch_colliding_voxels(states)[:n]
        valid = bool((counts <= self.checker.max_colliding).all())
        return valid, n
