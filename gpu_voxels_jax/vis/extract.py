"""Cube extraction: device maps -> renderable cube sets.

Equivalent of the extractCubes paths (TemplateVoxelList.hpp:704,
NTree.hpp:2637) feeding the visualizer. The CUDA reference shares device
memory with a viewer process over CUDA IPC; here the visualizer is an
async host readback consumer: extract the occupied voxel coordinates (+ a
type id per cube) and hand them to an exporter (vis.export) or any viewer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..constants import BitVoxelMeaning
from ..maps.hierarchical import (
    NS_COLLISION,
    NS_FREE,
    NS_OCCUPIED,
    NS_UNKNOWN,
    STATUS_OCCUPANCY_MASK,
)


def occupied_coords(m, threshold: float = 0.5, max_cubes: Optional[int] = None) -> np.ndarray:
    """int32[K, 3] coordinates of occupied voxels (host readback).

    Works for ProbVoxelMap (occupancy >= threshold), BitVectorVoxelMap
    (!noneButEmpty), CountingVoxelMap (count >= 1), DistanceVoxelMap
    (distance == 0), and voxel lists.
    """
    from ..maps.distance_map import DistanceVoxelMap
    from ..maps.voxellist import VoxelList
    from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap

    if isinstance(m, VoxelList):
        n = int(m.count)
        return np.asarray(m.coords_from_ids(m.ids[:n], m.ids_hi[:n]))
    from ..maps.hierarchical import HierarchicalProbMap

    from ..ops.compact import compacted_nonzero

    if isinstance(m, HierarchicalProbMap):
        # honor the caller's threshold against the ground-truth occupancy
        # grid (the status pyramid bakes the octree's fixed
        # THRESHOLD_OCCUPANCY, which is the probe contract, not the
        # visualization contract); mask + compaction stay on device so the
        # readback is O(occupied), not the padded occupancy grid
        import jax.numpy as jnp

        from ..constants import UNKNOWN_PROBABILITY, float_to_probability

        occ = m.occupancy
        t = float_to_probability(threshold)
        mask3 = (occ.astype(jnp.int32) >= t) & (occ != jnp.int8(UNKNOWN_PROBABILITY))
        idx = compacted_nonzero(mask3.reshape(-1))
        pdx, pdy, _ = m.padded_dims
        z = idx // (pdx * pdy)
        rem = idx - z * pdx * pdy
        y = rem // pdx
        x = rem - y * pdx
        keep = (x < m.dims[0]) & (y < m.dims[1]) & (z < m.dims[2])
        coords = np.stack([x[keep], y[keep], z[keep]], axis=1).astype(np.int32)
        return coords[:max_cubes] if max_cubes is not None else coords
    if hasattr(m, "extract_occupied_coords"):  # deterministic + paged tiers
        coords = np.asarray(m.extract_occupied_coords())
        return coords[:max_cubes] if max_cubes is not None else coords
    if isinstance(m, ProbVoxelMap):
        mask = m.occupied_mask(threshold)
    elif isinstance(m, BitVectorVoxelMap):
        mask = m.occupied_mask()
    elif isinstance(m, CountingVoxelMap):
        mask = m.occupied_mask(1)
    elif isinstance(m, DistanceVoxelMap):
        mask = m.obstacle_mask()
    else:
        raise TypeError(type(m))
    dx, dy, _ = m.dims
    # device compaction: the viewer fetch is O(occupied) (bounded by
    # max_cubes when given), never the O(N) mask — ops/compact.py
    idx = compacted_nonzero(mask, capacity=max_cubes)
    z = idx // (dx * dy)
    rem = idx - z * dx * dy
    y = rem // dx
    x = rem - y * dx
    return np.stack([x, y, z], axis=1).astype(np.int32)


def _status_types(status: np.ndarray) -> np.ndarray:
    """Status byte -> BitVoxelMeaning type id, the reference's default
    status-to-meaning mapping (NTree.hpp:336-352): FREE and FREE|UNKNOWN ->
    eBVM_FREE, UNKNOWN -> eBVM_UNKNOWN, anything containing OCCUPIED ->
    eBVM_OCCUPIED, anything carrying ns_COLLISION -> eBVM_COLLISION."""
    s = status.astype(np.uint8)
    occ = s & np.uint8(STATUS_OCCUPANCY_MASK)
    t = np.full(s.shape, int(BitVoxelMeaning.eBVM_UNKNOWN), np.uint8)
    t[(occ == NS_FREE) | (occ == (NS_FREE | NS_UNKNOWN))] = int(BitVoxelMeaning.eBVM_FREE)
    t[(occ & NS_OCCUPIED) != 0] = int(BitVoxelMeaning.eBVM_OCCUPIED)
    t[(s & np.uint8(NS_COLLISION)) != 0] = int(BitVoxelMeaning.eBVM_COLLISION)
    return t


def _is_uniform_np(status: np.ndarray) -> np.ndarray:
    s = status.astype(np.int32) & STATUS_OCCUPANCY_MASK
    return (s & (s - 1)) == 0


def _gather_level(level_arr, coords: np.ndarray) -> np.ndarray:
    """Fetch level_arr[z, y, x] for compact host coords — ONE device gather
    + a K-byte readback instead of materializing the whole level on host
    (a 32768^3 paged world's page grid alone is 134 MB)."""
    import jax.numpy as jnp

    if coords.shape[0] == 0:
        return np.zeros((0,), np.uint8)
    c = jnp.asarray(coords, jnp.int32)
    return np.asarray(level_arr[c[:, 2], c[:, 1], c[:, 0]])


def _children_of(coords: np.ndarray) -> np.ndarray:
    """8 child coords (next finer level) per parent coord [K,3] -> [8K,3]."""
    offs = np.stack(
        np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1
    ).reshape(-1, 3)[:, ::-1]  # (x,y,z) order
    return (coords[:, None, :] * 2 + offs[None, :, :]).reshape(-1, 3)


class _CubeSink:
    """Accumulates (corner, size, status) rows and applies the status
    selection filter (the reference's const_extract_selection,
    Extract.cuh:178; defaults select everything, NTree.hpp:361-363)."""

    def __init__(self, occupied: bool, free: bool, unknown: bool, dims):
        self.rows = []
        self._sel = {
            int(BitVoxelMeaning.eBVM_OCCUPIED): occupied,
            int(BitVoxelMeaning.eBVM_COLLISION): occupied,
            int(BitVoxelMeaning.eBVM_FREE): free,
            int(BitVoxelMeaning.eBVM_UNKNOWN): unknown,
        }
        self._dims = np.asarray(dims, np.int64)

    def emit(self, corners: np.ndarray, size: int, statuses: np.ndarray) -> None:
        if corners.shape[0] == 0:
            return
        types = _status_types(statuses)
        keep = np.zeros(types.shape, bool)
        for t, sel in self._sel.items():
            if sel:
                keep |= types == t
        # drop cubes entirely outside the logical dims (pyramid padding)
        keep &= np.all(corners < self._dims[None, :], axis=1)
        if np.any(keep):
            self.rows.append((corners[keep], np.full(int(keep.sum()), size, np.int32), types[keep]))

    def result(self, max_cubes: Optional[int]):
        if not self.rows:
            return (
                np.zeros((0, 3), np.int64),
                np.zeros((0,), np.int32),
                np.zeros((0,), np.uint8),
            )
        corners = np.concatenate([r[0] for r in self.rows]).astype(np.int64)
        sizes = np.concatenate([r[1] for r in self.rows])
        types = np.concatenate([r[2] for r in self.rows])
        if max_cubes is not None and len(sizes) > max_cubes:
            # coarsest-first: large context cubes survive truncation
            order = np.argsort(-sizes, kind="stable")[:max_cubes]
            corners, sizes, types = corners[order], sizes[order], types[order]
        return corners, sizes, types


def _mini_walk(sink, grid: np.ndarray, base_corners: np.ndarray, top_fine_level: int,
               stop_level: int, min_level: int):
    """Walk per-group 8^3 mini-pyramids (block summaries within open pages /
    voxels within open tiles), vectorized across groups.

    grid: uint8[G, 8, 8, 8] statuses in [wz, wy, wx] order (zero bytes
    already substituted with NS_UNKNOWN); base_corners: int64[G, 3] fine-
    voxel corner of each group. Emits uniform nodes from top_fine_level
    (2x2x2 over the group) down to stop_level; returns (corners, statuses)
    of the still-open cells at stop_level - 1 granularity... or rather the
    open CELL corners + their grid values for the caller's next stage.
    """
    # level l (fine) within a group of edge E=8 at group-level gl = top+1:
    # cells per axis at fine level l is 8 >> (l - (top_fine_level - 2))
    levels = []  # coarse->fine list of [G, n, n, n]
    cur = grid
    levels.append(cur)
    while cur.shape[1] > 2:
        cur = (
            cur[:, :, :, 0::2] | cur[:, :, :, 1::2]
        )
        cur = cur[:, :, 0::2, :] | cur[:, :, 1::2, :]
        cur = cur[:, 0::2, :, :] | cur[:, 1::2, :, :]
        levels.append(cur)
    # levels[0] = fine (8^3, fine level = top_fine_level - 2),
    # levels[-1] = 2^3 (fine level = top_fine_level)
    open_mask = None  # [G, n, n, n] bool at the previous (coarser) level
    for fl in range(top_fine_level, stop_level - 1, -1):
        li = fl - (top_fine_level - len(levels) + 1)
        lv = levels[li]
        n = lv.shape[1]
        if open_mask is None:
            sel = np.ones(lv.shape, bool)
        else:
            sel = np.repeat(
                np.repeat(np.repeat(open_mask, 2, axis=1), 2, axis=2), 2, axis=3
            )
        uni = _is_uniform_np(lv)
        leaf = sel & (uni | (fl == min_level))
        gi, zz, yy, xx = np.nonzero(leaf)
        corners = base_corners[gi] + (
            np.stack([xx, yy, zz], axis=1).astype(np.int64) << fl
        )
        sink.emit(corners, 1 << fl, lv[gi, zz, yy, xx])
        open_mask = sel & ~leaf
        if fl == stop_level:
            gi, zz, yy, xx = np.nonzero(open_mask)
            corners = base_corners[gi] + (
                np.stack([xx, yy, zz], axis=1).astype(np.int64) << fl
            )
            return corners, np.stack([gi, zz, yy, xx], axis=1)
    return np.zeros((0, 3), np.int64), np.zeros((0, 4), np.int64)


def extract_multilevel_cubes(
    m,
    min_level: int = 0,
    occupied: bool = True,
    free: bool = True,
    unknown: bool = True,
    max_cubes: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One cube per occupancy-uniform octree node — the reference's
    extractCubes (NTree.hpp:2637 via the Extract load-balancer task,
    Extract.h:50): the traversal descends ns_PART nodes and emits every
    non-PART node at its own level; min_level stops the descent early,
    emitting (possibly mixed) nodes at that level (Extract.cuh:163-178).

    Works on HierarchicalProbMap / HierarchicalBitMap (dense status pyramid)
    and PagedHierarchicalMap (coarse page pyramid -> block summaries -> tile
    pool). A 32768^3 paged world extracts in O(allocated surface) cubes, not
    O(volume) — this is what makes octree-scale worlds viewable.

    Returns (corners int64[K,3] fine-voxel coords of the cube's min corner,
    sizes int32[K] cube edge in fine voxels, types uint8[K] BitVoxelMeaning
    ids per the reference's default status mapping, NTree.hpp:336-352).
    occupied/free/unknown toggle the status selection (default: everything,
    like the reference's default extract selection, NTree.hpp:361-363).
    """
    from ..maps.hierarchical import _PyramidQueries
    from ..maps.paged import PagedHierarchicalMap
    from ..parallel.paged_world import ShardedPagedWorld

    if isinstance(m, ShardedPagedWorld):
        # per-slab extraction (each fetch is local to its device), corners
        # translated into the global frame; coarsest-first truncation is
        # applied to the combined set like the single-map sink's
        parts = [
            _paged_multilevel(s, min_level, occupied, free, unknown, max_cubes)
            for s in m.shards
        ]
        corners = [c.copy() for c, _, _ in parts]
        for k, c in enumerate(corners):
            if c.shape[0]:
                c[:, 2] += m.z0s[k]
        corners = np.concatenate(corners, axis=0)
        sizes = np.concatenate([s for _, s, _ in parts], axis=0)
        types = np.concatenate([t for _, _, t in parts], axis=0)
        if max_cubes is not None and corners.shape[0] > max_cubes:
            order = np.argsort(-sizes.astype(np.int64), kind="stable")[:max_cubes]
            corners, sizes, types = corners[order], sizes[order], types[order]
        return corners, sizes, types
    if isinstance(m, PagedHierarchicalMap):
        return _paged_multilevel(m, min_level, occupied, free, unknown, max_cubes)
    if isinstance(m, _PyramidQueries):
        return _dense_multilevel(m, min_level, occupied, free, unknown, max_cubes)
    raise TypeError(f"multi-level extraction needs a hierarchical map, got {type(m)}")


def _dense_multilevel(m, min_level, occupied, free, unknown, max_cubes):
    if min_level > m.levels:
        raise ValueError("min_level greater than octree height")
    sink = _CubeSink(occupied, free, unknown, m.dims)
    top = m.levels
    zt, yt, xt = m.pyramid[top].shape
    gz, gy, gx = np.meshgrid(np.arange(zt), np.arange(yt), np.arange(xt), indexing="ij")
    open_c = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.int64)
    for l in range(top, min_level - 1, -1):
        if open_c.shape[0] == 0:
            break
        s = _gather_level(m.pyramid[l], open_c)
        leaf = _is_uniform_np(s) | (l == min_level)
        sink.emit(open_c[leaf] << l, 1 << l, s[leaf])
        open_c = _children_of(open_c[~leaf])
    return sink.result(max_cubes)


def _paged_multilevel(m, min_level, occupied, free, unknown, max_cubes):
    import jax.numpy as jnp

    from ..maps.paged import B, PAGE_EDGE, SB

    if min_level > m.fine_levels:
        raise ValueError("min_level greater than octree height")
    sink = _CubeSink(occupied, free, unknown, m.dims)

    # -- coarse page pyramid (fine levels >= 6), compact-gather walk --------
    top = m.levels
    zt, yt, xt = m.pyramid[top].shape
    gz, gy, gx = np.meshgrid(np.arange(zt), np.arange(yt), np.arange(xt), indexing="ij")
    open_c = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.int64)
    stop = max(min_level - 6, 0)
    for l in range(top, stop - 1, -1):
        if open_c.shape[0] == 0:
            break
        s = _gather_level(m.pyramid[l], open_c)
        leaf = _is_uniform_np(s) | (l == stop and min_level >= 6)
        fine_shift = l + 6
        sink.emit(open_c[leaf] << fine_shift, 1 << fine_shift, s[leaf])
        if l > stop:
            open_c = _children_of(open_c[~leaf])
        else:
            open_c = open_c[~leaf]
    if min_level >= 6 or open_c.shape[0] == 0:
        return sink.result(max_cubes)

    # -- block summaries of the open (mixed => allocated) pages -------------
    sx, sy, _ = m.sdims
    page_keys = (open_c[:, 2] * sy + open_c[:, 1]) * sx + open_c[:, 0]
    rows = np.asarray([m._page_of[int(k)] for k in page_keys], np.int32)
    bs = np.asarray(jnp.take(m.block_summaries, jnp.asarray(rows), axis=0))
    bs = bs.reshape(-1, SB, SB, SB)  # [P, wz, wy, wx]
    bs = np.where(bs == 0, np.uint8(NS_UNKNOWN), bs)  # unallocated block
    page_corners = open_c * PAGE_EDGE
    open_corners, open_cells = _mini_walk(
        sink, bs, page_corners, top_fine_level=5, stop_level=max(min_level, 3),
        min_level=min_level,
    )
    if min_level >= 3 or open_corners.shape[0] == 0:
        return sink.result(max_cubes)

    # -- tile pool of the open (mixed => allocated) blocks -------------------
    gi, wz, wy, wx = open_cells.T
    within = (wz * SB + wy) * SB + wx
    slots = np.asarray(
        jnp.take(m.pages, jnp.asarray(rows[gi]), axis=0)[
            jnp.arange(len(gi)), jnp.asarray(within)
        ]
    )
    # a mixed block summary can only come from an existing tile (the
    # summaries are rebuilt FROM the pool), so every open block has a slot
    assert np.all(slots >= 0), "mixed block without a tile slot"
    tiles = np.asarray(jnp.take(m.pool, jnp.asarray(slots), axis=0))
    tiles = tiles.reshape(-1, B, B, B)
    tiles = np.where(tiles == 0, np.uint8(NS_UNKNOWN), tiles)
    _mini_walk(
        sink, tiles, open_corners, top_fine_level=2, stop_level=max(min_level, 0),
        min_level=max(min_level, 0),
    )
    return sink.result(max_cubes)


def extract_distance_slice(m, axis: str = "z", index: Optional[int] = None):
    """(coords int32[K,3], distances float32[K]) of one plane of a
    DistanceVoxelMap — the distance-field visualization source (the
    reference viewer colors DistanceVoxel maps by distance,
    gpu_visualization/Visualizer.cu / XMLInterpreter distance configs).
    Distances are metric (voxel units x side_length)."""
    ax = {"x": 0, "y": 1, "z": 2}[axis]
    dx, dy, dz = m.dims
    n_ax = (dx, dy, dz)[ax]
    if index is None:
        index = n_ax // 2
    if not (0 <= index < n_ax):
        raise ValueError(f"slice index {index} outside axis {axis} of {n_ax}")
    d2 = np.asarray(m.squared_distances()).reshape(dz, dy, dx)  # [z, y, x]
    sl = [slice(None)] * 3
    sl[2 - ax] = index
    plane = d2[tuple(sl)]
    uu, vv = np.meshgrid(*[np.arange(s) for s in plane.shape], indexing="ij")
    rem = [d for d in (0, 1, 2) if d != 2 - ax]  # remaining z-major d2 dims
    coords = np.zeros((plane.size, 3), np.int32)
    coords[:, 2 - rem[0]] = uu.ravel()
    coords[:, 2 - rem[1]] = vv.ravel()
    coords[:, ax] = index
    dist = np.sqrt(plane.ravel().astype(np.float64)) * float(m.side_length)
    return coords, dist.astype(np.float32)


def extract_cubes(
    m, threshold: float = 0.5, max_cubes: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """(centers float32[K,3] in metric space, types uint8[K]).

    Types: for bit maps the lowest set meaning bit per voxel; for prob maps
    eBVM_OCCUPIED; mirrors what the reference visualizer colors by.
    max_cubes bounds the device->host fetch (compaction capacity) — the
    live-viewer budget knob.
    """
    from ..maps.voxelmap import BitVectorVoxelMap

    coords = occupied_coords(m, threshold, max_cubes=max_cubes)
    centers = (coords.astype(np.float32) + 0.5) * m.side_length
    if isinstance(m, BitVectorVoxelMap):
        import jax.numpy as jnp

        dx, dy, _ = m.dims
        lin = coords[:, 2] * dx * dy + coords[:, 1] * dx + coords[:, 0]
        # gather the K occupied columns ON DEVICE: the readback is [8, K]
        # words, never the full 32N-byte plane set (536 MB at 512^3). K pads
        # to a pow2 bucket so per-frame-varying counts reuse one compiled
        # gather per bucket instead of recompiling every call
        k = len(lin)
        kp = 1 << max(k - 1, 0).bit_length() if k else 1
        lin_p = np.zeros((kp,), np.int32)
        lin_p[:k] = lin.astype(np.int32)
        planes = np.asarray(m.data[:, jnp.asarray(lin_p)])[:, :k]
        types = np.zeros(len(lin), np.uint8)
        found = np.zeros(len(lin), bool)
        for p in range(planes.shape[0]):
            w = planes[p]
            for b in range(32):
                bitset = ((w >> b) & 1).astype(bool) & ~found
                if p == 0 and b == 0:
                    continue  # skip eBVM_FREE
                types[bitset] = p * 32 + b
                found |= bitset
        return centers, types
    return centers, np.full(len(centers), 1, np.uint8)  # eBVM_OCCUPIED
