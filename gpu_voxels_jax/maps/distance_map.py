"""DistanceVoxelMap (reference: voxelmap/DistanceVoxelMap.{h,hpp}).

Dense grid of packed nearest-obstacle coordinates with EDT algorithms:
`parallel_banding` — the PBA equivalent — runs the EXACT min-plus
envelope sweeps (ops/edt_envelope.py, cross-checked against brute force);
`jump_flood` is the capped approximate JFA; `exact_separable`/brute force are the oracles; plus all distance/
extract/floodfill/merge queries.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    MAX_OBSTACLE_DISTANCE,
    PBA_UNINITIALISED_PACKED,
    BitVoxelMeaning,
    MapType,
    float_to_probability,
)
from ..ops import edt, edt_envelope
from ..ops import insert as insert_ops
from ..utils.compiled import compiled
from .voxelmap import _DenseMap, ProbVoxelMap

Dims = Tuple[int, int, int]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DistanceVoxelMap(_DenseMap):
    """data: uint32[N] DistanceVoxel-packed obstacle coords."""

    map_type: MapType = field(default=MapType.MT_DISTANCE_VOXELMAP, metadata=dict(static=True))
    _default_value = PBA_UNINITIALISED_PACKED  # printVoxelMapData skips uninit

    def fill_pba_uninit(self) -> "DistanceVoxelMap":
        """fill_pba_uninit (DistanceVoxelMap.h): reset every voxel to the
        PBA uninitialised sentinel (same as clear_map here)."""
        return self.clear_map()

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (stubbed NOT_SUPPORTED in the reference,
        DistanceVoxelMap.hpp:89-94): inserts the robot cloud as obstacles.
        Returns (new_map, ok)."""
        clash = jnp.zeros((), bool)
        if with_self_collision_test:
            clash = insert_ops.self_collision_clash(
                robot_links, self.side_length, self.dims
            )
        return self.insert_point_cloud(robot_links.points), ~clash

    def clear_voxel_meaning(self, meaning) -> "DistanceVoxelMap":
        """clearBitVoxelMeaning — a NOP-with-TODO in the reference
        (DistanceVoxelMap.hpp:96-102, "maybe clearMap instead? ProbVoxelMap
        does this"); this implements that TODO: eBVM_OCCUPIED resets to
        uninitialised, anything else logs and no-ops."""
        if int(meaning) != int(BitVoxelMeaning.eBVM_OCCUPIED):
            from ..utils.logging import log_stream

            log_stream("voxelmap").error(
                "DistanceVoxelMap only supports clearing eBVM_OCCUPIED"
            )
            return self
        return self.clear_map()

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0) -> "DistanceVoxelMap":
        n = dims[0] * dims[1] * dims[2]
        data = jnp.full((n,), jnp.uint32(PBA_UNINITIALISED_PACKED))
        return DistanceVoxelMap(data, tuple(dims), float(side_length))

    def clear_map(self) -> "DistanceVoxelMap":
        return replace(self, data=jnp.full_like(self.data, jnp.uint32(PBA_UNINITIALISED_PACKED)))

    # -- obstacle insertion --------------------------------------------------
    @compiled("meaning", arrays=("points",))
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "DistanceVoxelMap":
        """DistanceVoxel::insert: obstacle voxels store their own coords
        (DistanceVoxel.hpp insert(pos, eBVM_OCCUPIED))."""
        idx, _ = insert_ops.voxelize(jnp.asarray(points, jnp.float32), self.side_length, self.dims)
        n = self.voxelmap_size
        mask = jnp.zeros((n,), bool).at[idx].set(True, mode="drop")
        own = edt.init_from_obstacle_mask(mask, self.dims)
        return replace(self, data=jnp.where(mask, own, self.data))

    @compiled("occupancy_threshold")
    def merge_occupied(self, prob_map: ProbVoxelMap, occupancy_threshold: float = 0.5) -> "DistanceVoxelMap":
        """mergeOccupied (DistanceVoxelMap.h:86-122): occupied prob voxels
        become obstacles."""
        t = float_to_probability(occupancy_threshold)
        mask = prob_map.data.astype(jnp.int32) >= t
        own = edt.init_from_obstacle_mask(mask, self.dims)
        return replace(self, data=jnp.where(mask, own, self.data))

    # -- EDT algorithms --------------------------------------------------------
    @compiled("extra_rounds")
    def jump_flood(self, extra_rounds: int = 1) -> "DistanceVoxelMap":
        """jumpFlood3D (DistanceVoxelMap.hpp:136).

        Large grids (every axis >= 128 and a multiple of 4) take the exact
        envelope sweeps (ops/edt_envelope.parallel_banding): exact where JFA
        is only empirically so, and faster on the GPU than the converged
        multires JFA (PERF.md, kernel table). Small or non-divisible grids
        keep the flat capped-fixpoint JFA schedule; extra_rounds > 1 also
        pins the flat path. The JFA library paths (ops/edt.jump_flood*)
        remain the sharded-EDT building block (parallel/sharded_edt.py)."""
        if extra_rounds == 1 and min(self.dims) >= 128 and all(d % 4 == 0 for d in self.dims):
            return replace(self, data=edt_envelope.parallel_banding(self.data, self.dims))
        return replace(self, data=edt.jump_flood(self.data, self.dims, extra_rounds))

    @compiled("m1", "m2", "m3")
    def parallel_banding(self, m1: int = 1, m2: int = 1, m3: int = 1) -> "DistanceVoxelMap":
        """parallelBanding3D (DistanceVoxelMap.hpp:279): exact EDT, the fast
        path. PBA's banded phases re-derived as min-plus envelope sweeps with
        coarse-EDT ring bounds (ops/edt_envelope.py; a Triton kernel on the
        GPU), guaranteed exact (tests cross-check vs the brute oracle). Band
        counts m1/m2/m3 are accepted for API parity only (banding is
        re-derived, not tuned)."""
        del m1, m2, m3
        return replace(self, data=edt_envelope.parallel_banding(self.data, self.dims))

    @compiled()
    def exact_separable(self) -> "DistanceVoxelMap":
        """Guaranteed-exact EDT: the PBA math as two Z scans + batched
        all-integer lower envelopes (ops/edt.exact_separable). Slower than
        jump flooding; the exactness reference."""
        return replace(self, data=edt.exact_separable(self.data, self.dims))

    @compiled(arrays=("obstacle_coords",))
    def exact_distances(self, obstacle_coords) -> "DistanceVoxelMap":
        """exactDistances3D oracle (DistanceVoxelMap.hpp:203)."""
        return replace(self, data=edt.exact_distances(jnp.asarray(obstacle_coords, jnp.int32), self.dims))

    # -- queries ---------------------------------------------------------------
    @compiled()
    def squared_distances(self) -> jnp.ndarray:
        return edt.squared_distance_grid(self.data, self.dims)

    def get_squared_obstacle_distance(self, x: int, y: int, z: int) -> jnp.ndarray:
        """getSquaredObstacleDistance (DistanceVoxelMap.hpp:699-717)."""
        dx, dy, _ = self.dims
        return self.squared_distances().reshape(-1)[z * dx * dy + y * dx + x]

    def get_obstacle_distance(self, x: int, y: int, z: int) -> jnp.ndarray:
        d2 = self.get_squared_obstacle_distance(x, y, z)
        return jnp.sqrt(d2.astype(jnp.float32))

    @compiled(arrays=("points",))
    def min_distance_to(self, points) -> jnp.ndarray:
        """Min metric distance from any query point to its nearest obstacle
        (proximity query batch; gathers the EDT at the query voxels)."""
        idx, _ = insert_ops.voxelize(jnp.asarray(points, jnp.float32), self.side_length, self.dims)
        d2 = self.squared_distances().reshape(-1)
        vals = jnp.where(idx < self.voxelmap_size, d2[jnp.minimum(idx, self.voxelmap_size - 1)], MAX_OBSTACLE_DISTANCE)
        return jnp.sqrt(jnp.min(vals).astype(jnp.float32)) * self.side_length

    @compiled("robot_radius")
    def extract_distances(self, robot_radius: int = 0) -> jnp.ndarray:
        """int8 free-space bytes (extract_byte_distance functor)."""
        return edt.extract_byte_distances(self.data, self.dims, robot_radius)

    @compiled()
    def init_floodfill(self) -> jnp.ndarray:
        """Manhattan distance field for planners (getManhattanDistances)."""
        mask = self.obstacle_mask()
        return edt.manhattan_distance(mask, self.dims)

    @compiled()
    def obstacle_mask(self) -> jnp.ndarray:
        ox, _, _ = edt.unpack(self.data)
        d2 = self.squared_distances().reshape(-1)
        return d2 == 0

    @compiled()
    def differences(self, other: "DistanceVoxelMap") -> jnp.ndarray:
        """differences3D cross-check (testing_distance.cu:79-119)."""
        return edt.differences(self.data, other.data, self.dims)
