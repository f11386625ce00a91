"""Dense voxel maps (equivalents of voxelmap/TemplateVoxelMap + subclasses).

Maps are immutable pytrees: every operation returns a new map object sharing
unmodified buffers. Voxel data is a flat device array over
N = dimx*dimy*dimz with the reference's linear addressing
(index = z*dimx*dimy + y*dimx + x, TemplateVoxelMap.h:258), which makes the
reference's signed-pointer-offset collision semantics a pair of flat slices.

  ProbVoxelMap       int8[N] log-odds            (voxelmap/ProbVoxelMap.{h,hpp})
  BitVectorVoxelMap  uint32[8, N] bit planes     (voxelmap/BitVoxelMap.{h,hpp})
  CountingVoxelMap   int8[N] density counter     (dense variant of CountingVoxel)

All operations are jittable; whole sense->insert->collide cycles fuse into a
single XLA program.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace as _dc_replace
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.io import DiskIO
from .. import bitops, probability
from ..constants import (
    UNKNOWN_PROBABILITY,
    BitVoxelMeaning,
    MapType,
    float_to_probability,
    meaning_to_probability,
)
from ..ops import collide as collide_ops
from ..ops import insert as insert_ops
from ..utils.compiled import compiled

Dims = Tuple[int, int, int]


def replace(obj, **changes):
    """dataclasses.replace + host-state carry: the stored Sensor survives the
    immutable method chain like the reference's m_sensor member
    (TemplateVoxelMap.hpp:836-905), whatever operation derived the map."""
    new = _dc_replace(obj, **changes)
    carry = getattr(obj, "_carry_host_state", None)
    return carry(new) if carry is not None else new


def _n(dims: Dims) -> int:
    return dims[0] * dims[1] * dims[2]


# Sensor-fusion programs are jitted ONCE at module scope (lazily, to dodge the
# import cycle with ops.raycast): called eagerly, raycast.insert_depth_image /
# insert_sensor_data issue ~40 separate op dispatches instead of one fused
# program. Scalar intrinsics are static: they become compile-time constants
# with numerics identical to the eager Python floats, and recompiles happen
# only when the camera model changes. Same consolidation as utils/compiled for the collide family.
_SENSOR_PROGS: dict = {}


def _sensor_prog(name: str):
    prog = _SENSOR_PROGS.get(name)
    if prog is None:
        from ..ops import raycast

        statics = {
            "insert_depth_image": (
                "fx", "fy", "cx", "cy", "side_length", "dims",
                "invalid_value", "cut_real_robot", "carve_pool",
            ),
            "insert_sensor_data": (
                "sensor_origin", "side_length", "dims",
                "enable_raycasting", "cut_real_robot", "max_steps",
            ),
        }[name]
        prog = jax.jit(getattr(raycast, name), static_argnames=statics, inline=True)
        _SENSOR_PROGS[name] = prog
    return prog


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _DenseMap(DiskIO):
    data: jnp.ndarray
    dims: Dims = field(metadata=dict(static=True))
    side_length: float = field(metadata=dict(static=True))

    _default_value = 0  # "empty" voxel value; ProbVoxelMap overrides (-128)

    @property
    def voxelmap_size(self) -> int:
        return _n(self.dims)

    @property
    def dimensions(self) -> Dims:
        return self.dims

    @property
    def metric_dimensions(self) -> Tuple[float, float, float]:
        return tuple(d * self.side_length for d in self.dims)

    def memory_usage(self) -> int:
        """getMemoryUsage (GpuVoxelsMap.h:253): device bytes of voxel data."""
        total = self.data.size * self.data.dtype.itemsize
        occ = getattr(self, "occ", None)
        if occ is not None:
            total += occ.size * occ.dtype.itemsize
        return int(total)

    def as_3d(self) -> jnp.ndarray:
        """View as [Z, Y, X] (x fastest, reference layout)."""
        x, y, z = self.dims
        return self.data.reshape(self.data.shape[:-1] + (z, y, x))

    def clone(self) -> "_DenseMap":
        """DistanceVoxelMap.h `clone`: maps are immutable pytrees, so a clone
        shares buffers safely (copy-on-write by construction)."""
        return replace(self)

    def print_voxel_map_data(self, max_entries: int = 32) -> str:
        """printVoxelMapData (TemplateVoxelMap.hpp:282-286): readable dump of
        the non-default voxels (the device printer's practical equivalent —
        printing all N raw values is useless at 512^3)."""
        import numpy as np_

        arr = np_.asarray(self.data)
        default = getattr(self, "_default_value", 0)
        flat = arr if arr.ndim == 1 else (arr != default).any(axis=0)
        nz = np_.flatnonzero(
            (arr != default) if arr.ndim == 1 else flat
        )[:max_entries]
        dx, dy, _ = self.dims
        lines = [f"VoxelMap dump ({type(self).__name__} {self.dims}):"]
        for i in nz:
            x = int(i) % dx
            y = (int(i) // dx) % dy
            z = int(i) // (dx * dy)
            val = arr[..., int(i)]
            lines.append(f"  ({x},{y},{z}) = {val}")
        out = "\n".join(lines)
        print(out)
        return out

    def needs_rebuild(self) -> bool:
        """GpuVoxelsMap contract (GpuVoxelsMap.h:233): dense maps never
        fragment (AbstractVoxelMap returns false)."""
        return False

    def rebuild(self):
        """GpuVoxelsMap.h:241: no-op on dense maps."""
        return self

    def rebuild_if_needed(self):
        """GpuVoxelsMap::rebuildIfNeeded (GpuVoxelsMap.cpp:54-58)."""
        return self.rebuild() if self.needs_rebuild() else self

    def init_sensor_settings(self, sensor) -> None:
        """initSensorSettings (TemplateVoxelMap.hpp:836-856): store the
        Sensor whose pose transforms subsequent insert_sensor_data batches.
        Host-side convenience state like the reference's m_sensor member —
        NOT part of the pytree (it does not survive jit); the sensor-flow
        methods re-attach it to the maps they return so the reference's
        init-once / insert-repeatedly loop works across the immutable API."""
        object.__setattr__(self, "_sensor", sensor)

    def _carry_host_state(self, out):
        """Re-attach non-pytree host state (the stored Sensor) to derived
        maps. The reference's m_sensor member survives EVERY map operation
        (it lives beside the device data, TemplateVoxelMap.h:236-246); here
        jit unflattening and dataclasses.replace would silently drop it, so
        this module's `replace` and the `compiled` wrapper route every
        derived instance through this hook. Handles (map, flag) tuples."""
        s = getattr(self, "_sensor", None)
        if s is None:
            return out
        if isinstance(out, tuple):
            return tuple(self._carry_host_state(o) for o in out)
        if isinstance(out, _DenseMap):
            object.__setattr__(out, "_sensor", s)
        return out

    def _carry_sensor(self, new):
        """Propagate the non-pytree stored Sensor onto a derived instance."""
        return self._carry_host_state(new)

    def update_sensor_pose(self, sensor) -> None:
        """updateSensorPose (TemplateVoxelMap.hpp:858-876): refresh the
        stored sensor's position/orientation; errors if uninitialized."""
        cur = getattr(self, "_sensor", None)
        if cur is None:
            raise RuntimeError("Initialize Sensor first! (init_sensor_settings)")
        import numpy as np_

        cur.position = np_.asarray(sensor.position, np_.float32)
        cur.orientation_rpy = np_.asarray(sensor.orientation_rpy, np_.float32)

    # -- shared helpers -----------------------------------------------------
    def _offset(self, offset) -> Dims:
        return tuple(int(v) for v in offset)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ProbVoxelMap(_DenseMap):
    """Dense probabilistic map; voxels are int8 log-odds, UNKNOWN=-128."""

    map_type: MapType = field(default=MapType.MT_PROBAB_VOXELMAP, metadata=dict(static=True))
    _default_value = UNKNOWN_PROBABILITY

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0) -> "ProbVoxelMap":
        data = jnp.full((_n(dims),), jnp.int8(UNKNOWN_PROBABILITY))
        return ProbVoxelMap(data, tuple(dims), float(side_length))

    def clear_map(self) -> "ProbVoxelMap":
        """kernelClearVoxelMap: reset to UNKNOWN (TemplateVoxelMap.hpp:205)."""
        new = replace(self, data=jnp.full_like(self.data, jnp.int8(UNKNOWN_PROBABILITY)))
        return self._carry_sensor(new)

    # -- insertion ----------------------------------------------------------
    @compiled("meaning", arrays=("points",))
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "ProbVoxelMap":
        new, _ = insert_ops.insert_prob(self.data, jnp.asarray(points, jnp.float32), self.side_length, self.dims, meaning)
        return replace(self, data=new)

    def insert_meta_point_cloud(self, meta, meanings=None) -> "ProbVoxelMap":
        """Uniform or per-subcloud meanings (TemplateVoxelMap.hpp:609-663).

        The per-subcloud path runs as ONE fused program (the
        kernelInsertMetaPointCloud analogue): each point SETS its meaning's
        probability; on voxels shared between subclouds the LATER subcloud
        wins — the deterministic linearization of the reference's racy
        last-writer-wins kernel, identical to inserting the subclouds one by
        one. Implemented as a scatter-max of (point_rank+1)*256 + (val+128)
        encodings (rank < 2^24 guards the uint32 packing; larger meta clouds
        fall back to the per-cloud loop)."""
        if meanings is None:
            return self.insert_point_cloud(meta.points)
        import numpy as np

        sizes = [meta.get_cloud(i).shape[0] for i in range(meta.num_clouds)]
        total = int(sum(sizes))
        if total >= 2**24 - 1:
            m = self
            for i, meaning in enumerate(meanings):
                m = m.insert_point_cloud(meta.get_cloud(i), meaning)
            return m
        vals_np = np.repeat(
            np.asarray([meaning_to_probability(m) for m in meanings], np.int32),
            sizes,
        )
        enc_np = (np.arange(1, total + 1, dtype=np.int64) * 256 + (vals_np + 128)).astype(
            np.uint32
        )
        idx, _ = insert_ops.voxelize(
            jnp.asarray(meta.points, jnp.float32), self.side_length, self.dims
        )
        won = (
            jnp.zeros((self.voxelmap_size,), jnp.uint32)
            .at[idx]
            .max(jnp.asarray(enc_np), mode="drop")
        )
        new_val = ((won & jnp.uint32(255)).astype(jnp.int32) - 128).astype(jnp.int8)
        return replace(self, data=jnp.where(won > 0, new_val, self.data))

    def insert_meta_point_cloud_with_self_collision_check(
        self, meta, meaning=BitVoxelMeaning.eBVM_OCCUPIED
    ):
        """insertMetaPointCloudWithSelfcollisionCheck (ProbVoxelMap.h):
        insert all sub-clouds; report whether two different sub-clouds hit
        the same voxel. Returns (map, self_collision: bool array)."""
        clash = insert_ops.self_collision_clash(meta, self.side_length, self.dims)
        new = self.insert_point_cloud(meta.points, meaning)
        return new, clash

    def clear_voxel_meaning(self, meaning) -> "ProbVoxelMap":
        """clearBitVoxelMeaning (ProbVoxelMap.hpp:110-117): probabilistic
        maps only support clearing eBVM_OCCUPIED, which resets the map."""
        if int(meaning) != int(BitVoxelMeaning.eBVM_OCCUPIED):
            from ..utils.logging import log_stream

            log_stream("voxelmap").error(
                "ProbVoxelMap only supports clearing eBVM_OCCUPIED"
            )
            return self
        return self.clear_map()

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (GpuVoxelsMap contract). The reference
        stubs this as NOT_SUPPORTED on every map (ProbVoxelMap.hpp:104-108);
        here it works: inserts the robot MetaPointCloud, optionally with the
        self-collision check. Returns (new_map, ok) — ok False on detected
        self-collision (insert still applied, like the reference's
        insertMetaPointCloudWithSelfcollisionCheck)."""
        if with_self_collision_test:
            new, clash = self.insert_meta_point_cloud_with_self_collision_check(robot_links)
            return new, ~clash
        return self.insert_meta_point_cloud(robot_links), jnp.array(True)

    def update_occupancy(self, points, delta) -> "ProbVoxelMap":
        """Log-odds additive update for every hit voxel (sensor path)."""
        idx, _ = insert_ops.voxelize(jnp.asarray(points, jnp.float32), self.side_length, self.dims)
        hits = insert_ops.occupancy_mask(idx, self.voxelmap_size)
        upd = probability.update_occupancy(self.data, hits.astype(jnp.int32) * int(delta))
        return self._carry_sensor(replace(self, data=upd))

    def insert_sensor_data(
        self,
        points,
        sensor_origin=None,
        enable_raycasting: bool = True,
        cut_real_robot: bool = False,
        robot_map=None,
        max_steps: int = 256,
    ) -> "ProbVoxelMap":
        """ProbVoxelMap::insertSensorData (ProbVoxelMap.hpp:52-102): occupied
        hits (+72) plus optional free-space carving (-10 per crossing ray).

        With an explicit `sensor_origin`, `points` are world-frame endpoints.
        With sensor_origin=None and a sensor stored via init_sensor_settings,
        `points` are SENSOR-frame and get transformed by the stored pose (the
        reference's copySensorDataToDevice → transformSensorData flow,
        TemplateVoxelMap.hpp:879-905); otherwise the origin defaults to 0."""
        from ..ops import raycast

        sensor = getattr(self, "_sensor", None)
        if sensor_origin is None:
            if sensor is not None:
                from ..geometry import transforms

                points = transforms.transform_points(
                    jnp.asarray(sensor.pose(), jnp.float32),
                    jnp.asarray(points, jnp.float32),
                )
                sensor_origin = tuple(float(v) for v in sensor.position)
            else:
                sensor_origin = (0.0, 0.0, 0.0)
        robot_mask = None
        if cut_real_robot and robot_map is not None:
            robot_mask = (
                robot_map.occupied_mask()
                if hasattr(robot_map, "occupied_mask")
                else robot_map
            )
        new = _sensor_prog("insert_sensor_data")(
            self.data,
            tuple(float(v) for v in sensor_origin),
            jnp.asarray(points, jnp.float32),
            self.side_length,
            self.dims,
            enable_raycasting=enable_raycasting,
            cut_real_robot=cut_real_robot,
            robot_occupied_mask=robot_mask,
            max_steps=max_steps,
        )
        return self._carry_sensor(replace(self, data=new))

    def insert_depth_image(self, depth, sensor, carve_pool: int = 1, robot_map=None) -> "ProbVoxelMap":
        """Projective sensor update from a depth image + Sensor model: hits
        plus visibility-carved free space in one fused pass (the fast path;
        see ops/raycast.insert_depth_image). carve_pool=1 is the exact
        reference carve; carve_pool=8 carves against the min-pooled image
        (conservative, under-carves near depth edges). With robot_map (a
        map, or a bool mask over the voxels), hits inside the robot are cut
        out (insertSensorData's cut_real_robot, ProbVoxelMap.hpp:52-102)."""
        robot_mask = None
        if robot_map is not None:
            robot_mask = (
                robot_map.occupied_mask()
                if hasattr(robot_map, "occupied_mask")
                else jnp.asarray(robot_map)
            )
        new = _sensor_prog("insert_depth_image")(
            self.data,
            jnp.asarray(depth, jnp.float32),
            jnp.asarray(sensor.pose(), jnp.float32),
            float(sensor.fx),
            float(sensor.fy),
            float(sensor.cx),
            float(sensor.cy),
            self.side_length,
            self.dims,
            invalid_value=float(sensor.invalid_value),
            cut_real_robot=robot_mask is not None,
            robot_occupied_mask=robot_mask,
            carve_pool=int(carve_pool),
        )
        return self._carry_sensor(replace(self, data=new))

    # -- collision ----------------------------------------------------------
    @compiled("coll_threshold", "offset")
    def collide_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)):
        """collideWith returning the collision count (ProbVoxelMap.hpp:144-155).

        Matches the reference's counting kernel but without marking
        (the marking variant is collide_with_marking)."""
        t = float_to_probability(coll_threshold)
        off = self._offset(offset)
        if isinstance(other, ProbVoxelMap):
            return collide_ops.count_prob_prob(self.data, other.data, t, t, self.dims, off)
        if isinstance(other, BitVectorVoxelMap):
            if other.occ is not None:
                return collide_ops.count_prob_occ(self.data, t, other.occ, self.dims, off)
            return collide_ops.count_prob_bit(self.data, t, other.data, self.dims, off)
        raise TypeError(f"cannot collide ProbVoxelMap with {type(other)}")

    def collides_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)):
        """Boolean early-out collisionCheck (TemplateVoxelMap.hpp:329-414).

        XLA has no early exit, but the fused any() sweep is already at
        bandwidth; returns a device bool."""
        return collide_ops.any_collision(self.collide_with(other, coll_threshold, offset))

    @compiled("coll_threshold", "resolution_level", "offset")
    def collide_with_resolution(
        self, other, coll_threshold: float = 1.0, resolution_level: int = 0, offset=(0, 0, 0)
    ):
        """collideWithResolution (CollisionInterfaces.h:107-127): collide at a
        2^level-coarsened resolution. See ops.collide.count_with_resolution
        for the contract (the reference declares this mixin for dense maps
        but never implements it there)."""
        t = float_to_probability(coll_threshold)
        mine = collide_ops.prob_occupied(self.data, t)
        if isinstance(other, ProbVoxelMap):
            theirs = collide_ops.prob_occupied(other.data, t)
        elif isinstance(other, BitVectorVoxelMap):
            theirs = other.occupied_mask()
        else:
            raise TypeError(f"cannot collide ProbVoxelMap with {type(other)}")
        return collide_ops.count_with_resolution(
            mine, theirs, resolution_level, self.dims, self._offset(offset)
        )

    @compiled("coll_threshold", "offset")
    def collide_with_marking(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)):
        """Exact kernelCollideVoxelMapsDebug semantics: returns (count, map
        with eBVM_COLLISION inserted into colliding voxels)."""
        t = float_to_probability(coll_threshold)
        off = self._offset(offset)
        if isinstance(other, ProbVoxelMap):
            cnt, new = collide_ops.count_and_mark_prob(self.data, other.data, t, t, self.dims, off)
            return cnt, replace(self, data=new)
        raise TypeError(f"cannot collide ProbVoxelMap with {type(other)}")

    # -- queries ------------------------------------------------------------
    def occupancy(self) -> jnp.ndarray:
        return self.data

    def occupied_mask(self, threshold: float = 0.5) -> jnp.ndarray:
        return collide_ops.prob_occupied(self.data, float_to_probability(threshold))

    def merge(self, other: "ProbVoxelMap") -> "ProbVoxelMap":
        """Voxel::reduce = saturating occupancy add (ProbabilisticVoxel.hpp:94-101).
        UNKNOWN voxels in `other` contribute nothing."""
        delta = jnp.where(probability.is_unknown(other.data), jnp.int8(0), other.data)
        return replace(self, data=probability.update_occupancy(self.data, delta.astype(jnp.int32)))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BitVectorVoxelMap(_DenseMap):
    """Dense 256-bit deterministic map; data is uint32[8, N] bit planes.

    `occ` is a maintained occupancy summary: uint8[N], 1 exactly where the
    voxel is !noneButEmpty (eBVM_FREE masked out — BitVector.h:184-198).
    Every mutating operation keeps it coherent (inserts derive it from the
    scatter delta they already materialize; bit-clearing ops recompute it in
    the same sweep they pay anyway), so the plain `collideWith` count — whose
    contract is exactly both-voxels-!noneButEmpty — reads 2 bytes/voxel-pair
    instead of folding 64 (docs/PERFORMANCE.md lever #2). A map built with
    occ=None (e.g. hand-constructed planes) falls back to the plane fold
    everywhere; operations then propagate None."""

    map_type: MapType = field(default=MapType.MT_BITVECTOR_VOXELMAP, metadata=dict(static=True))
    occ: jnp.ndarray | None = None

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0) -> "BitVectorVoxelMap":
        data = bitops.zeros((_n(dims),))
        occ = jnp.zeros((_n(dims),), jnp.uint8)
        return BitVectorVoxelMap(data, tuple(dims), float(side_length), occ=occ)

    @staticmethod
    def from_planes(planes, dims: Dims, side_length: float = 1.0) -> "BitVectorVoxelMap":
        """Wrap raw uint32[8, N] planes, computing the occupancy summary."""
        occ = bitops.occupied(planes).astype(jnp.uint8)
        return BitVectorVoxelMap(planes, tuple(dims), float(side_length), occ=occ)

    def _occ_from(self, data) -> jnp.ndarray | None:
        """Recomputed summary (one fold) — for ops that can clear bits."""
        return None if self.occ is None else bitops.occupied(data).astype(jnp.uint8)

    def clear_map(self) -> "BitVectorVoxelMap":
        occ = None if self.occ is None else jnp.zeros_like(self.occ)
        return replace(self, data=jnp.zeros_like(self.data), occ=occ)

    # -- insertion ----------------------------------------------------------
    @compiled("meaning", arrays=("points",))
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "BitVectorVoxelMap":
        new, _, occ_d = insert_ops.insert_bit(self.data, jnp.asarray(points, jnp.float32), self.side_length, self.dims, int(meaning))
        occ = None if self.occ is None else self.occ | occ_d
        return replace(self, data=new, occ=occ)

    def insert_meta_point_cloud(self, meta, meanings=None) -> "BitVectorVoxelMap":
        """Meta insert, uniform or per-subcloud meanings. The per-subcloud
        path is the ONE-pass kernelInsertMetaPointCloud analogue: subcloud
        sizes and meanings are static, so all links scatter fused in a single
        program instead of one compiled dispatch per link."""
        if meanings is None:
            return self.insert_point_cloud(meta.points)
        import numpy as np

        sizes = [meta.get_cloud(i).shape[0] for i in range(meta.num_clouds)]
        meanings_np = np.repeat(
            np.asarray([int(m) for m in meanings], np.int32), sizes
        )
        idx, _ = insert_ops.voxelize(
            jnp.asarray(meta.points, jnp.float32), self.side_length, self.dims
        )
        data, occ = insert_ops.scatter_bits_multi(self.data, self.occ, idx, meanings_np)
        return replace(self, data=data, occ=occ)

    # -- bit maintenance ----------------------------------------------------
    def clear_bit(self, bit_index: int) -> "BitVectorVoxelMap":
        """clearBit: clear one meaning in every voxel (BitVoxelMap.hpp:58-72)."""
        new = bitops.clear_bit(self.data, bit_index)
        return replace(self, data=new, occ=self._occ_from(new))

    def clear_bits(self, bit_indices) -> "BitVectorVoxelMap":
        d = self.data
        for b in bit_indices:
            d = bitops.clear_bit(d, b)
        return replace(self, data=d, occ=self._occ_from(d))

    def clear_voxel_meaning(self, meaning) -> "BitVectorVoxelMap":
        return self.clear_bit(int(meaning))

    def clear_collision_flags(self) -> "BitVectorVoxelMap":
        """NTree::clearCollisionFlags analogue (NTree.h:301): reset the
        eBVM_COLLISION marks written by the marking collides."""
        return self.clear_bit(int(BitVoxelMeaning.eBVM_COLLISION))

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (GpuVoxelsMap contract). The reference
        stubs this NOT_SUPPORTED on BitVoxelMap (BitVoxelMap.hpp:221-227);
        here it inserts the robot MetaPointCloud, optionally with a pairwise
        sub-cloud self-collision check. Returns (new_map, ok)."""
        clash = jnp.zeros((), bool)
        if with_self_collision_test:
            clash = insert_ops.self_collision_clash(
                robot_links, self.side_length, self.dims
            )
        return self.insert_meta_point_cloud(robot_links), ~clash

    @compiled("shift_size")
    def shift_left_swept_volume_ids(self, shift_size: int) -> "BitVectorVoxelMap":
        """shiftLeftSweptVolumeIDs (BitVoxelMap.hpp:226-240)."""
        new = bitops.perform_left_shift(self.data, shift_size)
        return replace(self, data=new, occ=self._occ_from(new))

    # -- collision ----------------------------------------------------------
    @compiled("coll_threshold", "offset")
    def collide_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)):
        t = float_to_probability(coll_threshold)
        off = self._offset(offset)
        if isinstance(other, BitVectorVoxelMap):
            if self.occ is not None and other.occ is not None:
                # summary fast path: plain bit x bit is exactly both-
                # !noneButEmpty, which the maintained summaries answer alone
                return collide_ops.count_occ_occ(self.occ, other.occ, self.dims, off)
            return collide_ops.count_bit_bit(self.data, other.data, self.dims, off)
        if isinstance(other, ProbVoxelMap):
            # DefaultCollider bit x prob: threshold applies to the prob side
            roff = tuple(-v for v in off)
            if self.occ is not None:
                return collide_ops.count_prob_occ(other.data, t, self.occ, self.dims, roff)
            return collide_ops.count_prob_bit(other.data, t, self.data, self.dims, roff)
        raise TypeError(f"cannot collide BitVectorVoxelMap with {type(other)}")

    def collides_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)):
        """Boolean early-out collisionCheck (TemplateVoxelMap.hpp:329-414)."""
        return collide_ops.any_collision(self.collide_with(other, coll_threshold, offset))

    @compiled("coll_threshold", "resolution_level", "offset")
    def collide_with_resolution(
        self, other, coll_threshold: float = 1.0, resolution_level: int = 0, offset=(0, 0, 0)
    ):
        """collideWithResolution (CollisionInterfaces.h:37-60) at a
        2^level-coarsened resolution (see ops.collide.count_with_resolution)."""
        mine = self.occupied_mask()
        if isinstance(other, BitVectorVoxelMap):
            theirs = other.occupied_mask()
        elif isinstance(other, ProbVoxelMap):
            theirs = collide_ops.prob_occupied(other.data, float_to_probability(coll_threshold))
        else:
            raise TypeError(f"cannot collide BitVectorVoxelMap with {type(other)}")
        return collide_ops.count_with_resolution(
            mine, theirs, resolution_level, self.dims, self._offset(offset)
        )

    @compiled("coll_threshold", "sv_window", "sv_offset")
    def collide_with_types(self, other, coll_threshold: float = 1.0, sv_window: int = 0, sv_offset: int = 0):
        """collideWithTypes (BitVoxelMap.hpp:195-210): SVCollider collision
        collecting colliding meanings. Returns (count, meanings[8] uint32,
        map with eBVM_COLLISION marked)."""
        if isinstance(other, BitVectorVoxelMap):
            cnt, meanings, new = collide_ops.collide_with_types_bit_bit(
                self.data, other.data, margin=sv_window, sv_offset=sv_offset,
            )
            return cnt, meanings, replace(self, data=new, occ=self._occ_marked(new))
        if isinstance(other, ProbVoxelMap):
            t = float_to_probability(coll_threshold)
            cnt, meanings, new = collide_ops.collide_with_types_bit_prob(self.data, other.data, t)
            return cnt, meanings, replace(self, data=new, occ=self._occ_marked(new))
        raise TypeError(f"cannot collide BitVectorVoxelMap with {type(other)}")

    def _occ_marked(self, new_data) -> jnp.ndarray | None:
        """Summary after a marking collide: marking only ever ADDS the
        eBVM_COLLISION bit (bit 2), and any voxel holding it is occupied."""
        if self.occ is None:
            return None
        bit2 = ((new_data[0] >> bitops.UINT32(2)) & bitops.UINT32(1)).astype(jnp.uint8)
        return self.occ | bit2

    @compiled("margin", "sv_offset")
    def collide_with_bitcheck(self, other: "BitVectorVoxelMap", margin: int = 0, sv_offset: int = 0):
        """Same-bit collision with +-margin window, count only. Margin 0 is
        a plain fold that XLA already streams at the read floor, so only
        wider windows take the Triton kernel (PERF.md)."""
        if margin > 0 and collide_ops._types_kernel(self.voxelmap_size, margin, sv_offset):
            cnt, _, _ = collide_ops.collide_triton.collide_types(
                self.data, other.data, margin, mark=False
            )
            return cnt
        if sv_offset == 0:
            hit, _ = bitops.bit_margin_collision_check_packed(self.data, other.data, margin)
        else:
            # packed full-domain path: never unpacks to bool[..., 256], so
            # dense swept-volume checks are safe at 512^3 (and margin < 32)
            hit, _ = bitops.bit_margin_collision_check_packed_full(
                self.data, other.data, bitops.zeros((self.voxelmap_size,)), margin, sv_offset
            )
        return jnp.sum(hit, dtype=jnp.uint32)

    # -- queries ------------------------------------------------------------
    def occupied_mask(self) -> jnp.ndarray:
        if self.occ is not None:
            return self.occ != 0
        return bitops.occupied(self.data)

    def get_bit_mask(self, meaning) -> jnp.ndarray:
        return bitops.get_bit(self.data, int(meaning))

    def merge(self, other: "BitVectorVoxelMap", new_meaning=None) -> "BitVectorVoxelMap":
        """Voxel::reduce = bitwise OR; optional re-meaning of merged voxels."""
        if new_meaning is None:
            new = self.data | other.data
            if self.occ is not None and other.occ is not None:
                occ = self.occ | other.occ
            else:
                occ = self._occ_from(new)
            return replace(self, data=new, occ=occ)
        occ_m = other.occupied_mask()
        word = bitops.UINT32(bitops.bit_word(int(new_meaning)))
        p = bitops.bit_plane(int(new_meaning))
        plane = jnp.where(occ_m, self.data[p] | word, self.data[p])
        if self.occ is None or int(new_meaning) == 0:
            occ = self.occ  # bit 0 never flips noneButEmpty
        else:
            occ = self.occ | occ_m.astype(jnp.uint8)
        return replace(self, data=self.data.at[p].set(plane), occ=occ)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CountingVoxelMap(_DenseMap):
    """Dense per-voxel point counter (dense variant of CountingVoxelList's
    noise filtering; the sparse list lives in maps/voxellist)."""

    map_type: MapType = field(default=MapType.MT_COUNTING_VOXELLIST, metadata=dict(static=True))

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0) -> "CountingVoxelMap":
        return CountingVoxelMap(jnp.zeros((_n(dims),), jnp.int8), tuple(dims), float(side_length))

    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "CountingVoxelMap":
        del meaning  # density counters have no meanings; keep it out of the jit key
        return self._insert_impl(points)

    @compiled(arrays=("points",))
    def _insert_impl(self, points) -> "CountingVoxelMap":
        new, _ = insert_ops.insert_count(self.data, jnp.asarray(points, jnp.float32), self.side_length, self.dims)
        return replace(self, data=new)

    def occupied_mask(self, threshold: int = 1) -> jnp.ndarray:
        return self.data.astype(jnp.int32) >= int(threshold)

    def clear_map(self) -> "CountingVoxelMap":
        return replace(self, data=jnp.zeros_like(self.data))
