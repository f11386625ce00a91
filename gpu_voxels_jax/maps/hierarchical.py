"""Hierarchical maps: the array-native octree (NTree) replacement.

The reference NTree (octree/NTree.{h,hpp}, ~9 kLoC of pointer-chasing CUDA
with a work-stealing load balancer) exists to answer *multi-resolution
tri-state* queries: is this region FREE / UNKNOWN / OCCUPIED / mixed (PART)?
Pointer trees and device stacks are hostile to fused array programs; the same semantics
map to a dense Morton-friendly *status pyramid*:

  level 0:        per-voxel status byte (bits: FREE|UNKNOWN|OCCUPIED)
  level l+1:      OR of the 8 children's statuses (2x2x2 reduce)

A node is "uniform" iff exactly one status bit is set (the reference's
non-PART nodes, Nodes.h:50-84: getNewStatus ORs child statuses and sets
ns_PART when mixed). Probe queries descend top-down and stop at the first
uniform node (kernel_Octree.h:383-423) — here that is L gathers + a select,
fully vectorized, no stacks, no load balancer.

Occupancy semantics (probabilistic variant) follow the octree contract:
  occupied <=> occ != -128 && occ >= THRESHOLD_OCCUPANCY(=10)
  unknown  <=> occ == -128          (EnvNodesProbCommon.h:30-45)
Rebuilding the pyramid after an insert costs ~N/7 OR-reduces — this replaces
NTree::propagate (NTree.hpp:3056).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.io import DiskIO
from .. import probability
from ..constants import (
    THRESHOLD_OCCUPANCY,
    UNKNOWN_PROBABILITY,
    BitVoxelMeaning,
    MapType,
    meaning_to_probability,
)
from ..ops import insert as insert_ops
from ..utils.compiled import compiled
from ..ops import raycast as raycast_ops

Dims = Tuple[int, int, int]

NS_FREE = 1
NS_UNKNOWN = 2
NS_OCCUPIED = 4
NS_PART = 8  # implicit here: a multi-bit occupancy status (Nodes.h:50-57)
NS_LAST_LEVEL = 16
NS_COLLISION = 32
NS_STATIC_MAP = 64
NS_DYNAMIC_MAP = 128
STATUS_OCCUPANCY_MASK = NS_FREE | NS_UNKNOWN | NS_OCCUPIED

U8 = jnp.uint8


def decode_status_flags(status):
    """Status byte -> (occupied, unknown, free) bool arrays — the ONE probe
    decode rule (kernel_Octree.h:383-423 semantics), shared by every probe
    surface (PagedSnapshot.probe, parallel.ShardedPagedWorld.probe). Works on
    numpy and jnp arrays alike (pure elementwise bit math)."""
    occupied = (status & NS_OCCUPIED) != 0
    unknown = ((status & NS_UNKNOWN) != 0) & ~occupied
    free = (status & STATUS_OCCUPANCY_MASK) == NS_FREE
    return occupied, unknown, free


def _pad_dims(dims: Dims, levels: int) -> Dims:
    q = 1 << levels
    return tuple(-(-d // q) * q for d in dims)


def _num_levels(dims: Dims, cap: int = 8) -> int:
    l = 0
    m = min(dims)
    while (1 << (l + 1)) <= m and l + 1 < cap:
        l += 1
    return max(l, 1)


def _status_from_occupancy(occ: jnp.ndarray) -> jnp.ndarray:
    unknown = occ == jnp.int8(UNKNOWN_PROBABILITY)
    occupied = (~unknown) & (occ >= jnp.int8(THRESHOLD_OCCUPANCY))
    return jnp.where(
        unknown, U8(NS_UNKNOWN), jnp.where(occupied, U8(NS_OCCUPIED), U8(NS_FREE))
    )


def _build_pyramid(status0_3d: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    """[level0 [Z,Y,X], level1 [Z/2,Y/2,X/2], ...] status bytes.

    The 2x2x2 OR (getNewStatus fusion) reduces one axis at a time with
    strided slices rather than one 6D reshape."""
    pyr = [status0_3d]
    cur = status0_3d
    for _ in range(levels):
        cur = cur[:, :, 0::2] | cur[:, :, 1::2]
        cur = cur[:, 0::2, :] | cur[:, 1::2, :]
        cur = cur[0::2, :, :] | cur[1::2, :, :]
        pyr.append(cur)
    return pyr


def _is_uniform(status: jnp.ndarray) -> jnp.ndarray:
    """Exactly one occupancy bit set — the reference's non-PART condition
    (getNewStatus, Nodes.h:64-84); map flags (STATIC/DYNAMIC) are ignored."""
    s = status.astype(jnp.int32) & STATUS_OCCUPANCY_MASK
    return (s & (s - 1)) == 0  # 0 never occurs in-range


def query_coords_of(other):
    """(coords, valid-occupied mask) of the map being probed against an
    octree — the intersect_sparse input enumeration. Lists yield their
    entries; dense maps yield their full index space masked by the octree
    probe's occupancy rule (prob occ >= 50 hardcoded, kernel_common.h:172-183;
    bit-map !isZero)."""
    from .voxellist import VoxelList
    from .voxelmap import BitVectorVoxelMap, ProbVoxelMap

    if isinstance(other, VoxelList):
        coords = other.entry_coords()  # hi-aware: 60-bit morton ids decode fully
        valid = other.ids != jnp.uint32(0xFFFFFFFF)
        return coords, valid & other._entry_occupied()
    if isinstance(other, ProbVoxelMap):
        mask = other.data.astype(jnp.int32) >= 50
    elif isinstance(other, BitVectorVoxelMap):
        from .. import bitops

        mask = ~bitops.is_zero(other.data)  # !isZero, NOT noneButEmpty
    else:
        raise TypeError(type(other))
    dx, dy, _ = other.dims
    n = other.voxelmap_size
    lin = jnp.arange(n, dtype=jnp.int32)
    zz = lin // (dx * dy)
    rem = lin - zz * dx * dy
    coords = jnp.stack([rem - (rem // dx) * dx, rem // dx, zz], axis=-1)
    return coords, mask


def _reject_octree_offset(offset) -> None:
    """Octree x octree intersection takes no offset; the reference logs
    GPU_VOXELS_MAP_OFFSET_ON_WRONG_DATA_STRUCTURE and proceeds without it
    (GvlNTree.hpp:260-262) — here silently dropping a requested translation
    would corrupt collision answers, so raise instead."""
    if tuple(int(v) for v in offset) != (0, 0, 0):
        raise ValueError("offset not supported on octree x octree collides")


class _PyramidQueries(DiskIO):
    """Probe/collide machinery shared by the hierarchical tiers. Operates on
    self.pyramid / self.levels / self.dims only."""

    def probe_status(self, coords: jnp.ndarray, min_level: int = 0) -> jnp.ndarray:
        """Raw status byte per voxel coordinate: descend from the top, stop at
        the first occupancy-uniform node (kernel_Octree.h:383-423). Map flags
        (ns_STATIC_MAP/ns_DYNAMIC_MAP) ride along with the decided node."""
        coords = jnp.asarray(coords, jnp.int32)
        x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
        decided = jnp.zeros(x.shape, bool)
        status = jnp.zeros(x.shape, U8)
        for l in range(self.levels, min_level - 1, -1):
            s = self.pyramid[l][z >> l, y >> l, x >> l]
            uni = _is_uniform(s) | (l == min_level)
            take = uni & ~decided
            status = jnp.where(take, s, status)
            decided = decided | uni
        return status

    @compiled("min_level", arrays=("coords",))
    def probe(self, coords: jnp.ndarray, min_level: int = 0):
        """Tri-state query per voxel coordinate (the intersect_sparse descent,
        NTree.hpp:817-1004). Returns (occupied, unknown, free) bool arrays.

        The descent starts at the top level and stops at the first uniform
        node; `min_level` stops early (coarser), matching the reference's
        min_level/resolution checks."""
        status = self.probe_status(coords, min_level)
        occupied = (status & U8(NS_OCCUPIED)) != 0
        unknown = ((status & U8(NS_UNKNOWN)) != 0) & ~occupied
        free = (status & U8(STATUS_OCCUPANCY_MASK)) == U8(NS_FREE)
        return occupied, unknown, free

    def _query_coords_of(self, other):
        return query_coords_of(other)

    @compiled("min_level", "offset")
    def _collide_probe(self, other, min_level: int = 0, offset=(0, 0, 0)):
        """intersect_sparse descent: probe self at other's voxel coords +
        offset (GvlNTree.hpp:195); translated coords leaving the map never
        hit. Returns (occupied hits, unknown hits)."""
        coords, valid = query_coords_of(other)
        c = coords + jnp.asarray(offset, jnp.int32)
        dims_arr = jnp.asarray(self.dims, jnp.int32)
        inside = jnp.all((c >= 0) & (c < dims_arr), axis=-1)
        occ, unk, _ = self.probe(jnp.clip(c, 0, dims_arr - 1), min_level)
        live = valid & inside
        return (
            jnp.sum(occ & live, dtype=jnp.uint32),
            jnp.sum(unk & live, dtype=jnp.uint32),
        )

    def collide_with(self, other, min_level: int = 0, offset=(0, 0, 0)):
        """collideWith dispatch (GvlNTree.hpp:150-330): octree vs list/dense
        map runs the intersect_sparse probe at other+offset; octree vs octree
        runs the hierarchy intersection, which rejects nonzero offsets
        exactly like the reference (GvlNTree.hpp:260-262)."""
        from .paged import PagedHierarchicalMap

        if isinstance(other, PagedHierarchicalMap):
            _reject_octree_offset(offset)
            return other.collide_with(self, min_level=min_level)
        if isinstance(other, _PyramidQueries):
            _reject_octree_offset(offset)
            return self.collide_with_hierarchical(other, min_level=min_level)
        return self._collide_probe(other, min_level, offset)[0]

    def collide_with_resolution(
        self, other, coll_threshold: float = 1.0, resolution_level: int = 0, offset=(0, 0, 0)
    ):
        """collideWithResolution (CollisionInterfaces.h:53-60). In the
        reference only GvlNTree implements this mixin (GvlNTree.hpp:179-197);
        resolution_level maps to the probe descent's min_level and offset is
        forwarded into the probe (GvlNTree.hpp:195). coll_threshold is
        ignored on this path exactly like the reference's hardcoded probe
        occupancy (kernel_common.h:172)."""
        del coll_threshold
        if resolution_level > self.levels:
            raise ValueError("resolution_level greater than octree height")
        return self.collide_with(other, min_level=int(resolution_level), offset=offset)

    def collide_with_counting_unknown(self, other, min_level: int = 0, offset=(0, 0, 0)):
        """collideWithTypesConsideringUnknownCells (GvlNTree.h:120-129):
        returns (collisions, unknown-cell hits)."""
        return self._collide_probe(other, min_level, offset)

    @compiled("min_level")
    def collide_with_hierarchical(self, other, min_level: int = 0):
        """NTree x NTree intersection (intersect_load_balance,
        NTree.hpp:1139): count voxels occupied in both hierarchies.

        The reference's simultaneous DFS with a work-stealing balancer
        reduces to a fused dense AND at the fine level (uniform work);
        min_level > 0 counts coarse-node pairs instead, mirroring the
        resolution-limited traversal."""
        if other.padded_dims != self.padded_dims:
            raise ValueError("hierarchies must share dimensions")
        a = self.pyramid[min_level]
        b = other.pyramid[min_level]
        hit = ((a & U8(NS_OCCUPIED)) != 0) & ((b & U8(NS_OCCUPIED)) != 0)
        return jnp.sum(hit, dtype=jnp.uint32)

    def extract_occupied_coords(self) -> np.ndarray:
        s0 = np.asarray(self.pyramid[0])
        z, y, x = np.nonzero((s0 & STATUS_OCCUPANCY_MASK) == NS_OCCUPIED)
        keep = (x < self.dims[0]) & (y < self.dims[1]) & (z < self.dims[2])
        return np.stack([x[keep], y[keep], z[keep]], axis=1).astype(np.int32)

    def memory_usage(self) -> int:
        total = 0
        for leaf in jax.tree_util.tree_leaves(self):
            total += leaf.size * leaf.dtype.itemsize
        return int(total)

    def insert_meta_point_cloud(self, meta, meanings=None):
        """insertMetaPointCloud on the octree adapter (GvlNTree.hpp:437-453):
        given per-subcloud meanings the reference warns and inserts the whole
        cloud with the FIRST meaning; same semantics here."""
        meaning = BitVoxelMeaning.eBVM_OCCUPIED
        if meanings is not None and len(meanings):
            meaning = meanings[0]
        return self.insert_point_cloud(meta.points, meaning)

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (GpuVoxelsMap contract; the reference
        octree adapter does not support it). Returns (new_map, ok)."""
        clash = jnp.zeros((), bool)
        if with_self_collision_test:
            clash = insert_ops.self_collision_clash(
                robot_links, self.side_length, self.padded_dims
            )
        return self.insert_meta_point_cloud(robot_links), ~clash

    def clear_voxel_meaning(self, meaning):
        """clearBitVoxelMeaning (GvlNTree.hpp:487-494): octree adapters only
        support clearing eBVM_OCCUPIED, which resets the map."""
        if int(meaning) != int(BitVoxelMeaning.eBVM_OCCUPIED):
            from ..utils.logging import log_stream

            log_stream("octree").error("octree maps only clear eBVM_OCCUPIED")
            return self
        return self.clear_map()

    # -- NTree maintenance contract (NTree.h:267-301, NTree.hpp:2941) --------
    def needs_rebuild(self) -> bool:
        """NTree::needsRebuild — the dense pyramid is contiguous by
        construction and never fragments, so a rebuild is never needed."""
        return False

    def rebuild(self):
        """NTree::rebuild (NTree.hpp:2941): defragmentation no-op here —
        there is no pointer soup to compact."""
        return self

    def check_tree(self) -> bool:
        """NTree::checkTree (NTree.h:267-271): validate the tree invariant —
        every coarse status byte must equal the getNewStatus fusion of its
        2x2x2 children. True unless someone mutated pyramid levels directly."""
        want = _build_pyramid(self.pyramid[0], self.levels)
        return all(bool(jnp.all(w == p)) for w, p in zip(want, self.pyramid))

    def clear_collision_flags(self):
        """NTree::clearCollisionFlags (NTree.h:301): probes here RETURN
        collision results instead of writing ns_COLLISION into nodes, so
        there is nothing stored to clear."""
        return self

    def _bbox_mask_flat(self, points) -> jnp.ndarray:
        """Boolean mask (flat over padded dims) of the points' voxel AABB."""
        pts = jnp.asarray(points, jnp.float32)
        lo = jnp.floor(jnp.min(pts, axis=0) / self.side_length).astype(jnp.int32)
        hi = jnp.floor(jnp.max(pts, axis=0) / self.side_length).astype(jnp.int32)
        px, py, pz = self.padded_dims
        ix = jnp.arange(px, dtype=jnp.int32)[None, None, :]
        iy = jnp.arange(py, dtype=jnp.int32)[None, :, None]
        iz = jnp.arange(pz, dtype=jnp.int32)[:, None, None]
        inside = (
            (ix >= lo[0]) & (ix <= hi[0])
            & (iy >= lo[1]) & (iy <= hi[1])
            & (iz >= lo[2]) & (iz <= hi[2])
        )
        return inside.reshape(-1)


# Whole-method sensor-fusion programs, jitted once at module scope: called
# eagerly the fusion + pyramid rebuild is ~40+ separate dispatches (see
# utils/compiled.py). The map
# pytree is a traced argument (dims/side_length ride along as static fields);
# camera intrinsics are static scalars — numerics identical to the eager
# Python floats, recompile only when the camera model changes.
@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "invalid_value", "carve_pool"),
    inline=True,
)
def _depth_fusion_prob(m, depth, pose, fx, fy, cx, cy, invalid_value, carve_pool):
    flat = raycast_ops.insert_depth_image(
        m.occupancy.reshape(-1), depth, pose, fx, fy, cx, cy,
        m.side_length, m.padded_dims,
        invalid_value=invalid_value, carve_pool=carve_pool,
    )
    return m._rebuilt(flat.reshape(m.occupancy.shape))


@functools.partial(
    jax.jit,
    static_argnames=("fx", "fy", "cx", "cy", "invalid_value", "carve_pool"),
    inline=True,
)
def _depth_fusion_bit(m, depth, pose, fx, fy, cx, cy, invalid_value, carve_pool):
    pd = m.padded_dims
    n = pd[0] * pd[1] * pd[2]
    pts = raycast_ops.depth_image_to_point_cloud(depth, fx, fy, cx, cy, invalid_value)
    from ..geometry import transforms

    world = transforms.transform_points(pose, pts)
    finite = jnp.all(jnp.isfinite(world), axis=-1)
    idx, _ = insert_ops.voxelize(
        jnp.where(finite[:, None], world, -1.0), m.side_length, pd
    )
    hits = jnp.zeros((n,), bool).at[idx].set(True, mode="drop")
    free = raycast_ops.projective_free_space(
        depth, pose, fx, fy, cx, cy, m.side_length, pd, invalid_value,
        pool=carve_pool,
    )
    out = m._hard_set(free & ~hits, NS_FREE, NS_DYNAMIC_MAP)
    return out._hard_set(hits, NS_OCCUPIED, NS_DYNAMIC_MAP)


def _sensor_scalars(sensor):
    return (
        float(sensor.fx), float(sensor.fy), float(sensor.cx), float(sensor.cy),
        float(sensor.invalid_value),
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HierarchicalProbMap(_PyramidQueries):
    """Probabilistic hierarchical map (MT_PROBAB_OCTREE equivalent)."""

    occupancy: jnp.ndarray  # int8[Zp, Yp, Xp] (padded)
    pyramid: Tuple[jnp.ndarray, ...]  # status bytes per level
    dims: Dims = field(metadata=dict(static=True))  # logical dims (x, y, z)
    side_length: float = field(metadata=dict(static=True))
    levels: int = field(metadata=dict(static=True))
    map_type: MapType = field(default=MapType.MT_PROBAB_OCTREE, metadata=dict(static=True))

    # -- construction -------------------------------------------------------
    @staticmethod
    def create(dims: Dims, side_length: float = 1.0, levels: int | None = None) -> "HierarchicalProbMap":
        levels = levels if levels is not None else _num_levels(dims)
        pd = _pad_dims(dims, levels)
        occ = jnp.full((pd[2], pd[1], pd[0]), jnp.int8(UNKNOWN_PROBABILITY))
        pyr = _build_pyramid(_status_from_occupancy(occ), levels)
        return HierarchicalProbMap(occ, tuple(pyr), tuple(dims), float(side_length), levels)

    @property
    def padded_dims(self) -> Dims:
        z, y, x = self.occupancy.shape
        return (x, y, z)

    def _rebuilt(self, occ: jnp.ndarray) -> "HierarchicalProbMap":
        pyr = _build_pyramid(_status_from_occupancy(occ), self.levels)
        return replace(self, occupancy=occ, pyramid=tuple(pyr))

    def clear_map(self) -> "HierarchicalProbMap":
        return self._rebuilt(jnp.full_like(self.occupancy, jnp.int8(UNKNOWN_PROBABILITY)))

    # -- insertion ------------------------------------------------------------
    @compiled("meaning", arrays=("points",))
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "HierarchicalProbMap":
        """Point insert: voxels take the meaning's probability (then one
        propagate pass rebuilds the pyramid)."""
        pd = self.padded_dims
        flat = self.occupancy.reshape(-1)
        idx, _ = insert_ops.voxelize(jnp.asarray(points, jnp.float32), self.side_length, pd)
        val = jnp.int8(meaning_to_probability(meaning))
        flat = flat.at[idx].set(jnp.full(idx.shape, val), mode="drop")
        return self._rebuilt(flat.reshape(self.occupancy.shape))

    @compiled("sensor_origin", "max_steps", arrays=("points",))
    def insert_point_cloud_with_free_space(
        self, points, sensor_origin=(0.0, 0.0, 0.0), max_steps: int = 256
    ) -> "HierarchicalProbMap":
        """insertPointCloudWithFreespaceCalculation (GvlNTree.hpp:108-130):
        occupied hits + carved free space, probabilistic update."""
        pd = self.padded_dims
        flat = raycast_ops.insert_sensor_data(
            self.occupancy.reshape(-1),
            sensor_origin,
            jnp.asarray(points, jnp.float32),
            self.side_length,
            pd,
            enable_raycasting=True,
            max_steps=max_steps,
        )
        return self._rebuilt(flat.reshape(self.occupancy.shape))

    def insert_depth_image(self, depth, sensor, carve_pool: int = 1) -> "HierarchicalProbMap":
        """Projective sensor fusion (fast path): hits + visibility-carved
        free space on the fine grid, then one propagate pass. carve_pool=1 is
        the exact carve; 8 selects the Pallas pooled conservative carve.
        Runs as ONE jitted program (_depth_fusion_prob)."""
        fx, fy, cx, cy, inv = _sensor_scalars(sensor)
        return _depth_fusion_prob(
            self, jnp.asarray(depth, jnp.float32),
            jnp.asarray(sensor.pose(), jnp.float32),
            fx, fy, cx, cy, inv, int(carve_pool),
        )

    def build(self, points, free_bounding_box: bool = False) -> "HierarchicalProbMap":
        """NTree::build (NTree.hpp:385-540): (re)construct from a point set.
        With free_bounding_box the points' voxel AABB is first set FREE
        (NTree.h:127), then the points overwrite their cells OCCUPIED."""
        m = self.clear_map()
        if free_bounding_box:
            occ = m.occupancy.reshape(-1)
            free_val = jnp.int8(meaning_to_probability(BitVoxelMeaning.eBVM_FREE))
            occ = jnp.where(m._bbox_mask_flat(points), free_val, occ)
            m = m._rebuilt(occ.reshape(m.occupancy.shape))
        return m.insert_point_cloud(points)

    # -- maintenance -------------------------------------------------------------
    def propagate(self) -> "HierarchicalProbMap":
        """Re-establish the tree invariant (NTree::propagate). The pyramid is
        rebuilt after every insert already; exposed for API parity."""
        return self._rebuilt(self.occupancy)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HierarchicalBitMap(_PyramidQueries):
    """Deterministic hierarchical map (MT_BITVECTOR_OCTREE / NTreeDet
    equivalent): the ground truth IS the status byte per voxel, and inserts
    write hard statuses instead of probabilistic updates:

      * occupied insert: status = (old & ~OCC_MASK) | ns_OCCUPIED
        (setOccupied, kernel_common.h:219-223 / EnvironmentNodes.h:225-290)
      * free-space insert: status = (old & ~OCC_MASK) | ns_FREE
      * environment inserts tag ns_STATIC_MAP, sensor inserts ns_DYNAMIC_MAP
        (clearNode/insertNode, kernel_common.h:186-245); the flags OR up the
        pyramid like getNewStatus does (Nodes.h:78)

    pyramid[0] is the status grid itself; coarser levels are 2x2x2 ORs.
    """

    pyramid: Tuple[jnp.ndarray, ...]  # status bytes per level; [0] = ground truth
    dims: Dims = field(metadata=dict(static=True))  # logical dims (x, y, z)
    side_length: float = field(metadata=dict(static=True))
    levels: int = field(metadata=dict(static=True))
    map_type: MapType = field(default=MapType.MT_BITVECTOR_OCTREE, metadata=dict(static=True))

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0, levels: int | None = None) -> "HierarchicalBitMap":
        levels = levels if levels is not None else _num_levels(dims)
        pd = _pad_dims(dims, levels)
        s0 = jnp.full((pd[2], pd[1], pd[0]), U8(NS_UNKNOWN))
        pyr = _build_pyramid(s0, levels)
        return HierarchicalBitMap(tuple(pyr), tuple(dims), float(side_length), levels)

    @property
    def status(self) -> jnp.ndarray:
        return self.pyramid[0]

    @property
    def padded_dims(self) -> Dims:
        z, y, x = self.pyramid[0].shape
        return (x, y, z)

    def _rebuilt(self, status0: jnp.ndarray) -> "HierarchicalBitMap":
        return replace(self, pyramid=tuple(_build_pyramid(status0, self.levels)))

    def clear_map(self) -> "HierarchicalBitMap":
        return self._rebuilt(jnp.full_like(self.pyramid[0], U8(NS_UNKNOWN)))

    def _hard_set(self, mask_flat: jnp.ndarray, occ_bit: int, map_flag: int) -> "HierarchicalBitMap":
        s = self.pyramid[0].reshape(-1)
        new = (s & U8(0xFF ^ STATUS_OCCUPANCY_MASK)) | U8(occ_bit | map_flag)
        return self._rebuilt(jnp.where(mask_flat, new, s).reshape(self.pyramid[0].shape))

    @compiled("meaning", "static_map", arrays=("points",))
    def insert_point_cloud(
        self,
        points,
        meaning=BitVoxelMeaning.eBVM_OCCUPIED,
        static_map: bool = True,
    ) -> "HierarchicalBitMap":
        """Hard status insert. eBVM_FREE marks cells free, everything else
        occupied; static_map selects the ns_STATIC_MAP vs ns_DYNAMIC_MAP tag
        (build-from-pointcloud uses STATIC, insertVoxel uses DYNAMIC)."""
        pd = self.padded_dims
        n = pd[0] * pd[1] * pd[2]
        idx, _ = insert_ops.voxelize(jnp.asarray(points, jnp.float32), self.side_length, pd)
        mask = jnp.zeros((n,), bool).at[idx].set(True, mode="drop")
        occ_bit = NS_FREE if int(meaning) == int(BitVoxelMeaning.eBVM_FREE) else NS_OCCUPIED
        return self._hard_set(mask, occ_bit, NS_STATIC_MAP if static_map else NS_DYNAMIC_MAP)

    @compiled("sensor_origin", "max_steps", arrays=("points",))
    def insert_point_cloud_with_free_space(
        self, points, sensor_origin=(0.0, 0.0, 0.0), max_steps: int = 256
    ) -> "HierarchicalBitMap":
        """Deterministic sensor insert (GvlNTree.hpp:108-130 with the
        deterministic node specialization): hits become hard OCCUPIED, ray
        cells hard FREE (hits win), both tagged ns_DYNAMIC_MAP."""
        pd = self.padded_dims
        n = pd[0] * pd[1] * pd[2]
        pts = jnp.asarray(points, jnp.float32)
        idx, _ = insert_ops.voxelize(pts, self.side_length, pd)
        hits = jnp.zeros((n,), bool).at[idx].set(True, mode="drop")
        free_counts = raycast_ops.ray_crossing_counts(
            sensor_origin, pts, self.side_length, pd, max_steps
        )
        out = self._hard_set(free_counts > 0, NS_FREE, NS_DYNAMIC_MAP)
        return out._hard_set(hits, NS_OCCUPIED, NS_DYNAMIC_MAP)

    def insert_depth_image(self, depth, sensor, carve_pool: int = 1) -> "HierarchicalBitMap":
        """Projective deterministic sensor fusion: visibility-carved cells
        hard FREE, measurement cells hard OCCUPIED (ns_DYNAMIC_MAP).
        carve_pool=1 is the exact carve; 8 carves against the min-pooled
        depth image (conservative). Runs as ONE jitted program
        (_depth_fusion_bit), through ops/raycast.projective_free_space like
        the dense ProbVoxelMap path."""
        fx, fy, cx, cy, inv = _sensor_scalars(sensor)
        return _depth_fusion_bit(
            self, jnp.asarray(depth, jnp.float32),
            jnp.asarray(sensor.pose(), jnp.float32),
            fx, fy, cx, cy, inv, int(carve_pool),
        )

    def build(self, points, free_bounding_box: bool = False) -> "HierarchicalBitMap":
        """NTree::build (NTree.hpp:385-540): (re)construct from a point set.
        With free_bounding_box the points' voxel AABB is first marked hard
        FREE (NTree.h:127), then the points overwrite their cells OCCUPIED —
        both tagged ns_STATIC_MAP like an environment build."""
        m = self.clear_map()
        if free_bounding_box:
            m = m._hard_set(m._bbox_mask_flat(points), NS_FREE, NS_STATIC_MAP)
        return m.insert_point_cloud(points, static_map=True)

    def propagate(self) -> "HierarchicalBitMap":
        """Re-establish the tree invariant (NTree::propagate)."""
        return self._rebuilt(self.pyramid[0])
