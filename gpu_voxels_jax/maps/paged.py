"""Paged hierarchical map: octree-scale addressability on dense arrays.

The reference NTree spans 15 levels = 32768^3 virtual voxels with sparse
node allocation (octree/DataTypes.h, common_defines.h:189-191). The dense
status pyramid (maps/hierarchical.py) hits a memory wall near 1024^3, so
this tier splits the world VDB-style into dense-coarse + two sparse-fine
levels:

  * a 64^3-page coarse grid carries a dense status pyramid (a 32768^3 world
    is a 512^3 page grid = 134 MB of statuses; a 4096^3 world is 64^3 =
    262 KB), answering every query a uniform page can decide;
  * allocated pages own a 512-entry block-summary byte row and a 512-entry
    block->tile-slot row (sparse over pages, dense within a page);
  * mixed 8^3 blocks own an 8^3 tile of per-voxel status bytes in a fixed
    pool. Fine storage scales with occupied surface, not volume.

Tiles/pages are allocated by the host (inserts are host API calls already);
all bulk work — voxelizing, scattering statuses, rebuilding block/page
summaries and the coarse pyramid, probing — runs on device. Probes are pure
gathers: coarse pyramid descent, then a sorted-page-key binary search ->
block summary -> tile for undecided points. Status bytes are the
deterministic tier's (hard FREE/UNKNOWN/OCCUPIED + ns_STATIC_MAP/
ns_DYNAMIC_MAP flags, EnvironmentNodes.h:225-290); byte 0 = never-written =
UNKNOWN.

Capacity: virtual dims to 65536^3 (page keys must fit int32; the dense page
pyramid at 65536^3 is 1 GiB — 32768^3 and below is the practical envelope),
meeting and exceeding the reference's 15-level / 32768^3 NTree. min_level
probes resolve exactly at every level: >= 6 on the dense pyramid, 3-5 by
OR-ing block summaries, 0-2 inside tiles (kernel_Octree.h:383-423
semantics).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.io import DiskIO
from ..constants import (
    MAX_PROBABILITY,
    MIN_PROBABILITY,
    SENSOR_MODEL_FREE,
    SENSOR_MODEL_OCCUPIED,
    UNKNOWN_PROBABILITY,
    BitVoxelMeaning,
    MapType,
    meaning_to_probability,
)
from ..ops.insert import map_to_voxels
from .hierarchical import (
    NS_DYNAMIC_MAP,
    NS_FREE,
    NS_OCCUPIED,
    NS_STATIC_MAP,
    NS_UNKNOWN,
    STATUS_OCCUPANCY_MASK,
    U8,
    _build_pyramid,
    _is_uniform,
    _num_levels,
    _pad_dims,
    _status_from_occupancy,
    decode_status_flags,
)

Dims = Tuple[int, int, int]
B = 8  # tile edge (fine voxels per block axis)
SB = 8  # page edge (blocks per page axis); page covers (B*SB)^3 = 64^3 voxels
PAGE = SB * SB * SB
TILE = B * B * B
PAGE_EDGE = B * SB


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PagedSnapshot:
    """Immutable pytree view of a PagedHierarchicalMap's device state.

    This is what jitted consumers take as an ARGUMENT (the map itself is not
    a pytree because the host grows its arrays between steps). E.g. the
    motion-validity checkers probe a snapshot of a 32768^3 world inside one
    compiled batch program. All probe machinery lives here; the map
    delegates."""

    pyramid: Tuple[jnp.ndarray, ...]
    skeys: jnp.ndarray
    srows: jnp.ndarray
    pages: jnp.ndarray
    block_summaries: jnp.ndarray
    pool: jnp.ndarray
    slot_block: jnp.ndarray  # int32[NT, 3] block coord per tile slot
    n_slots: jnp.ndarray  # int32 scalar: live tile count (dynamic: no recompiles)
    dims: Dims = field(metadata=dict(static=True))
    sdims: Dims = field(metadata=dict(static=True))
    levels: int = field(metadata=dict(static=True))
    side_length: float = field(metadata=dict(static=True))

    def _page_rows_of(self, coords: jnp.ndarray):
        """(page_row, found) for fine coords via the sorted page-key table."""
        sx, sy, _ = self.sdims
        pc = coords // PAGE_EDGE
        skey = (pc[..., 2] * sy + pc[..., 1]) * sx + pc[..., 0]
        pos = jnp.clip(jnp.searchsorted(self.skeys, skey), 0, self.skeys.shape[0] - 1)
        found = self.skeys[pos] == skey
        return jnp.where(found, self.srows[pos], 0), found

    def probe_status(self, coords: jnp.ndarray, min_level: int = 0) -> jnp.ndarray:
        """Status byte per fine voxel coordinate. Levels >= 6 descend the
        dense page pyramid only; levels 3-5 refine through block summaries
        (OR over the 2^(l-3) block cube); levels 0-2 refine through the tile
        pool (0 = exact voxel, 1/2 = OR over the 2^l cube — the NTree
        min_level semantics, kernel_Octree.h:383-423).

        Out-of-range coords CLAMP to the border cell (defined behavior, and
        what parallel.ShardedPagedWorld's owner routing reproduces); without
        the clamp the page-directory searchsorted would alias a wrong page
        and answer garbage."""
        coords = jnp.asarray(coords, jnp.int32)
        coords = jnp.clip(coords, 0, jnp.asarray(self.dims, jnp.int32) - 1)
        pc = coords // PAGE_EDGE
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        decided = jnp.zeros(x.shape, bool)
        status = jnp.zeros(x.shape, U8)
        stop = max(min_level - 6, 0)
        for l in range(self.levels, stop - 1, -1):
            s = self.pyramid[l][z >> l, y >> l, x >> l]
            uni = _is_uniform(s) | (l == stop)
            take = uni & ~decided
            status = jnp.where(take, s, status)
            decided = decided | uni
        if min_level >= 6:
            return status

        # refine undecided (mixed-page) points through the block summaries
        needs = ~_is_uniform(status)
        page_row, found = self._page_rows_of(coords)
        bc = coords // B
        if min_level >= 3:
            # OR over the aligned 2^(l-3) block cube (always within one page)
            r = 1 << (min_level - 3)
            wb = bc % SB
            base = (wb // r) * r
            blk = jnp.zeros(x.shape, U8)
            for dz in range(r):
                for dy in range(r):
                    for dx in range(r):
                        widx = (
                            (base[..., 2] + dz) * (SB * SB)
                            + (base[..., 1] + dy) * SB
                            + (base[..., 0] + dx)
                        )
                        b = self.block_summaries[page_row, widx]
                        # unallocated block (byte 0) = UNKNOWN, substituted
                        # BEFORE the cube OR so unknown survives alongside an
                        # occupied sibling (matches the dense page pyramid)
                        b = jnp.where(
                            (b & U8(STATUS_OCCUPANCY_MASK)) == 0, b | U8(NS_UNKNOWN), b
                        )
                        blk = blk | b
            return jnp.where(needs & found, blk, status)

        within_s = ((bc[..., 2] % SB) * SB + (bc[..., 1] % SB)) * SB + bc[..., 0] % SB
        blk = self.block_summaries[page_row, within_s]
        blk = jnp.where((blk & U8(STATUS_OCCUPANCY_MASK)) == 0, blk | U8(NS_UNKNOWN), blk)
        blk_uniform = _is_uniform(blk)

        # refine undecided (mixed-block) points through the tile pool
        slot = self.pages[page_row, within_s]
        have_tile = found & (slot >= 0)
        slot = jnp.maximum(slot, 0)
        wc = coords % B
        fine = jnp.zeros(x.shape, U8)
        r = 1 << min_level
        base = (wc // r) * r
        for dz in range(r):
            for dy in range(r):
                for dx in range(r):
                    widx = (
                        (base[..., 2] + dz) * (B * B)
                        + (base[..., 1] + dy) * B
                        + (base[..., 0] + dx)
                    )
                    fine = fine | self.pool[slot, widx]
        fine = jnp.where((fine & U8(STATUS_OCCUPANCY_MASK)) == 0, fine | U8(NS_UNKNOWN), fine)
        refined = jnp.where(blk_uniform | ~have_tile, blk, fine)
        return jnp.where(needs & found, refined, status)

    def probe(self, coords: jnp.ndarray, min_level: int = 0):
        return decode_status_flags(self.probe_status(coords, min_level))

    def occupied_cells(self):
        """([NT*512, 3] fine coords, [NT*512] valid mask) of every occupied
        voxel — the device-side extractCubes enumeration. All fine occupancy
        lives in the tile pool, so this is the map's exact occupied set."""
        nt = self.pool.shape[0]
        wi = jnp.arange(TILE, dtype=jnp.int32)
        wz, rem = wi // (B * B), wi % (B * B)
        w = jnp.stack([rem % B, rem // B, wz], axis=-1)
        coords = self.slot_block[:, None, :] * B + w[None, :, :]
        occ = (self.pool & U8(STATUS_OCCUPANCY_MASK)) == U8(NS_OCCUPIED)
        valid = (jnp.arange(nt, dtype=jnp.int32) < self.n_slots)[:, None] & occ
        return coords.reshape(-1, 3), valid.reshape(-1)


# -- compiled programs (module-level so the jit cache is shared) --------------
# Each eager op pays its own dispatch (and first-call compile), so the map's
# device work is consolidated into a handful of jitted programs.
# Shapes are stabilized (pow2-padded points, capacity-sized state arrays) so
# recompiles happen only on capacity doublings / new batch sizes.


def _host_fetch(arr):
    """The allocator's single device->host fetch point. Tests stub this to
    count transfer volume (the steady-state contract is one scalar per
    insert; allocation frames add one scalar + one O(new tiles) prefix)."""
    return np.asarray(arr)


def _canon_offset(offset) -> tuple:
    """Offsets are static jit arguments; canonicalize lists/arrays to a
    hashable int tuple."""
    return tuple(int(v) for v in np.asarray(offset).ravel())


def _pad_points_pow2(pts: jnp.ndarray) -> jnp.ndarray:
    """Pad [N,3] float points to the next power of two with far-outside
    sentinels (dropped by the inside mask downstream)."""
    n = max(int(pts.shape[0]), 1)
    cap = 1 << (n - 1).bit_length()
    if cap == pts.shape[0]:
        return pts
    pad = jnp.full((cap - pts.shape[0], 3), -1e9, pts.dtype)
    return jnp.concatenate([pts, pad], axis=0)


@functools.partial(jax.jit, static_argnames=("side_length", "dims"))
def _voxelize_points(pts, side_length: float, dims: Dims, voff=None):
    """Voxelize in the GLOBAL frame, then (optionally) shift by an integer
    voxel offset. `voff` exists for slab decomposition
    (parallel/paged_world.py): translating points by z0*side_length in float
    meters before voxelizing disagrees with floor(p/side) - z0 whenever
    side_length is not exactly representable in float32, so the shift must
    happen AFTER the one global boundary decision, in integer space."""
    coords = map_to_voxels(pts, side_length)
    if voff is not None:
        coords = coords - jnp.asarray(voff, jnp.int32)
    dims_arr = jnp.asarray(dims, jnp.int32)
    inside = jnp.all((coords >= 0) & (coords < dims_arr), axis=-1)
    return jnp.clip(coords, 0, dims_arr - 1), inside


def _pool_address(pages, skeys, srows, coords, inside, sdims: Dims, cap: int):
    """Point coords -> (slot, within) tile-pool address; unresolvable points
    (outside, unallocated page/block) get slot=cap so `.at[...,mode='drop']`
    ignores them."""
    sx, sy, _ = sdims
    pc = coords // PAGE_EDGE
    skey = (pc[:, 2] * sy + pc[:, 1]) * sx + pc[:, 0]
    pos = jnp.clip(jnp.searchsorted(skeys, skey), 0, skeys.shape[0] - 1)
    found = skeys[pos] == skey
    page_row = jnp.where(found, srows[pos], 0)
    blocks = coords // B
    within_s = ((blocks[:, 2] % SB) * SB + (blocks[:, 1] % SB)) * SB + blocks[:, 0] % SB
    slot = pages[page_row, within_s]
    ok = inside & found & (slot >= 0)
    slot = jnp.where(ok, jnp.maximum(slot, 0), cap)
    within = ((coords[:, 2] % B) * B + (coords[:, 1] % B)) * B + coords[:, 0] % B
    return slot, within


@functools.partial(jax.jit, static_argnames=("sdims",))
def _needs_allocation(pages, skeys, srows, coords, inside, sdims: Dims, cap):
    """True iff any in-bounds point lands outside every allocated tile —
    the only case where the host allocator must run. Steady-state inserts
    (all touched tiles exist) fetch this ONE scalar instead of the whole
    coords array."""
    slot, _ = _pool_address(pages, skeys, srows, coords, inside, sdims, cap)
    return jnp.any(inside & (slot == cap))


@functools.partial(jax.jit, static_argnames=("sdims",))
def _new_tile_blocks(pages, skeys, srows, coords, inside, sdims: Dims, cap):
    """(n_new, blocks): unique block coords of in-bounds points whose tile is
    UNALLOCATED, compacted to the front of `blocks` int32[N, 3].

    Device-side dedup so a frame entering fresh territory fetches O(new
    tiles), not O(points): blocks are identified by their (page key, index
    within page) pair — both int32-safe at any supported world size (page
    keys are < 2^30 by the dims check; a packed block key would need 39 bits
    past 8192^3 and jnp has no real int64) — lexsorted, first-occurrence
    marked, and scatter-compacted. The host fetches the n_new scalar and then
    only the `blocks[:n_new]` prefix."""
    slot, _ = _pool_address(pages, skeys, srows, coords, inside, sdims, cap)
    new = inside & (slot == cap)
    sx, sy, _ = sdims
    pc = coords // PAGE_EDGE
    skey = (pc[:, 2] * sy + pc[:, 1]) * sx + pc[:, 0]
    bc = coords // B
    within = ((bc[:, 2] % SB) * SB + (bc[:, 1] % SB)) * SB + bc[:, 0] % SB
    sent = jnp.int32(2**31 - 1)  # > any real page key: sorts to the back
    k1 = jnp.where(new, skey, sent)
    k2 = jnp.where(new, within, sent)
    order = jnp.lexsort((k2, k1))
    k1s, k2s, bcs = k1[order], k2[order], bc[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])]
    )
    take = first & (k1s != sent)
    n_new = jnp.sum(take, dtype=jnp.int32)
    pos = jnp.where(take, jnp.cumsum(take) - 1, coords.shape[0])
    blocks = jnp.zeros((coords.shape[0], 3), jnp.int32).at[pos].set(bcs, mode="drop")
    return n_new, blocks


@functools.partial(jax.jit, static_argnames=("sdims", "occ_bit", "flag"))
def _scatter_pool(pool, pages, skeys, srows, coords, inside, sdims: Dims,
                  occ_bit: int, flag: int):
    """Point -> page row -> tile slot -> hard status set, one program."""
    slot, within = _pool_address(pages, skeys, srows, coords, inside, sdims, pool.shape[0])
    old = pool[jnp.minimum(slot, pool.shape[0] - 1), within]
    new = (old & U8(0xFF ^ STATUS_OCCUPANCY_MASK)) | U8(occ_bit | flag)
    return pool.at[slot, within].set(new, mode="drop")


@functools.partial(jax.jit, static_argnames=("sdims",))
def _scatter_pool_prob_set(occ_pool, pages, skeys, srows, coords, inside,
                           sdims: Dims, value):
    """Probabilistic point insert: voxels take the meaning's probability
    (ProbabilisticVoxel::insert semantics, ProbabilisticVoxel.hpp:77-92 —
    the same contract as the dense HierarchicalProbMap insert). Returns
    (occ_pool, derived status pool)."""
    slot, within = _pool_address(
        pages, skeys, srows, coords, inside, sdims, occ_pool.shape[0]
    )
    occ = occ_pool.at[slot, within].set(value, mode="drop")
    return occ, _status_from_occupancy(occ)


@functools.partial(jax.jit, static_argnames=("sdims",))
def _scatter_pool_prob_add(occ_pool, pages, skeys, srows, coords, weights,
                           inside, sdims: Dims):
    """Probabilistic sensor update: per-voxel int32 delta accumulation then
    ONE saturating clamp — the paged analogue of insertSensorData's
    hit_counts*SENSOR_MODEL_OCCUPIED + free_counts*SENSOR_MODEL_FREE
    (ProbVoxelMap.hpp:52-102, ops/raycast.insert_sensor_data). Untouched
    voxels keep UNKNOWN (-128); the clamp floor (-127) only applies to
    touched ones. Returns (occ_pool, derived status pool)."""
    slot, within = _pool_address(
        pages, skeys, srows, coords, inside, sdims, occ_pool.shape[0]
    )
    cnt = jnp.zeros(occ_pool.shape, jnp.int32).at[slot, within].add(
        weights, mode="drop"
    )
    upd = jnp.clip(
        occ_pool.astype(jnp.int32) + cnt, MIN_PROBABILITY, MAX_PROBABILITY
    ).astype(jnp.int8)
    occ = jnp.where(cnt != 0, upd, occ_pool)
    return occ, _status_from_occupancy(occ)


@functools.partial(jax.jit, static_argnames=("coarse_shape", "levels"))
def _rebuild_programs(pool, slot_page, slot_within, page_coord, n_slots, n_pages,
                      coarse_shape, levels: int):
    """Tile summaries -> block summaries -> page statuses -> pyramid, one
    program over capacity-sized arrays (counts are dynamic scalars)."""
    cap_slots = pool.shape[0]
    cap_pages = page_coord.shape[0]
    summary = jnp.bitwise_or.reduce(pool, axis=1)
    summary = summary | jnp.where(jnp.any(pool == 0, axis=1), U8(NS_UNKNOWN), U8(0))
    valid_s = jnp.arange(cap_slots, dtype=jnp.int32) < n_slots
    bs = jnp.zeros((cap_pages, PAGE), jnp.uint8)
    bs = bs.at[jnp.where(valid_s, slot_page, cap_pages), slot_within].set(
        summary, mode="drop"
    )
    page_status = jnp.bitwise_or.reduce(bs, axis=1)
    page_status = page_status | jnp.where(jnp.any(bs == 0, axis=1), U8(NS_UNKNOWN), U8(0))
    valid_p = jnp.arange(cap_pages, dtype=jnp.int32) < n_pages
    zi = jnp.where(valid_p, page_coord[:, 2], coarse_shape[0])
    coarse0 = jnp.full(coarse_shape, U8(NS_UNKNOWN))
    coarse0 = coarse0.at[zi, page_coord[:, 1], page_coord[:, 0]].set(
        page_status, mode="drop"
    )
    return bs, tuple(_build_pyramid(coarse0, levels))


@functools.partial(jax.jit, static_argnames=("coarse_shape", "levels"))
def _empty_pyramid(coarse_shape, levels: int):
    return tuple(_build_pyramid(jnp.full(coarse_shape, U8(NS_UNKNOWN)), levels))


def meta_first_meaning(meanings):
    """insertMetaPointCloud meaning degrade (GvlNTree.hpp:437-453): the
    octree adapter honors only the FIRST per-subcloud meaning. Shared by the
    single-device map and parallel.ShardedPagedWorld (one rule, one place)."""
    if meanings is not None and len(meanings):
        return meanings[0]
    return BitVoxelMeaning.eBVM_OCCUPIED


def robot_self_collision_clash(robot_links, side_length: float) -> bool:
    """Host cell-set self-collision test for insertRobotConfiguration
    (GpuVoxelsMap contract): links clash iff two link clouds share a voxel.
    Shared by the single-device map and parallel.ShardedPagedWorld."""
    seen: set = set()
    clash = False
    for i in range(robot_links.num_clouds):
        pts = np.asarray(robot_links.get_cloud(i), np.float32)
        cells = set(map(tuple, np.floor(pts / side_length).astype(np.int64)))
        if seen & cells:
            clash = True
        seen |= cells
    return clash


def _free_box_cloud(points, side_length: float) -> np.ndarray:
    """NTree::build's free_bounding_box (NTree.h:127) as an explicit free
    cloud: voxel centers of the points' AABB. Raises (without touching any
    map state) when the box is too large to enumerate."""
    pts = np.asarray(points, np.float32)
    lo = np.floor(pts.min(axis=0) / side_length).astype(np.int64)
    hi = np.floor(pts.max(axis=0) / side_length).astype(np.int64)
    n_box = int(np.prod(hi - lo + 1))
    if n_box > 64 * 1024 * 1024:
        raise ValueError(
            f"free bounding box spans {n_box} voxels; carve free space "
            "incrementally via insert_point_cloud_with_free_space instead"
        )
    xs, ys, zs = (np.arange(lo[i], hi[i] + 1) for i in range(3))
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    out = (np.stack([gx, gy, gz], axis=-1).reshape(-1, 3) + 0.5) * side_length
    return out.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("side_length", "dims", "max_steps"))
def _free_ray_cells(pts, origin, side_length: float, dims: Dims, max_steps: int, voff=None):
    """[S,N,3] visited voxel coords + [S,N] live mask for origin->point rays
    (one dominant-axis voxel per step, endpoint excluded).

    `voff` (integer voxel offset, see _voxelize_points): the ray is walked in
    the GLOBAL frame — identical step geometry to the single-device map — and
    only the visited cells are shifted, so a slab world carves exactly the
    slab-owned subset of the single-device cells at ANY side length."""
    # host-precomputed reciprocal, same rule as insert.map_to_voxels (see
    # its docstring: f32 division-by-constant is not shape-deterministic
    # under XLA CPU fast-math; the endpoint voxel must match the hit insert)
    recip = jnp.float32(1.0 / float(side_length))
    start_v = origin * recip
    delta = pts * recip - start_v[None, :]
    dominant = jnp.max(jnp.abs(delta), axis=-1)
    # padded sentinel points (-1e9 from _pad_points_pow2) must not cast rays:
    # their origin->corner segments pass through real in-map cells and would
    # carve them hard-FREE. Kill the whole ray for any far-outside endpoint.
    real = jnp.all(pts > -1e8, axis=-1)
    n_steps = jnp.where(real, jnp.ceil(dominant).astype(jnp.int32), 0)
    inv = jnp.where(n_steps > 0, 1.0 / jnp.maximum(n_steps.astype(jnp.float32), 1.0), 0.0)
    step_vec = delta * inv[:, None]
    ks = jnp.arange(max_steps, dtype=jnp.int32)
    pos = start_v[None, None, :] + step_vec[None, :, :] * ks[:, None, None].astype(jnp.float32)
    # clamp before the int cast: padded sentinel points otherwise produce
    # float->int32 overflow (undefined, could wrap into range)
    coords = jnp.floor(jnp.clip(pos, -1.0, 2.0**30)).astype(jnp.int32)
    if voff is not None:
        coords = coords - jnp.asarray(voff, jnp.int32)
    dims_arr = jnp.asarray(dims, jnp.int32)
    live = (ks[:, None] < n_steps[None, :]) & jnp.all(
        (coords >= 0) & (coords < dims_arr), axis=-1
    )
    return coords, live


_probe_status_jit = jax.jit(PagedSnapshot.probe_status, static_argnames=("min_level",))
_probe_jit = jax.jit(PagedSnapshot.probe, static_argnames=("min_level",))


@functools.partial(jax.jit, static_argnames=("sdims",))
def _probe_occupancy(occ_pool, pages, skeys, srows, coords, sdims: Dims):
    slot, within = _pool_address(
        pages, skeys, srows, coords,
        jnp.ones(coords.shape[:-1], bool), sdims, occ_pool.shape[0],
    )
    have = slot < occ_pool.shape[0]
    occ = occ_pool[jnp.minimum(slot, occ_pool.shape[0] - 1), within]
    return jnp.where(have, occ, jnp.int8(UNKNOWN_PROBABILITY))


_probe_occupancy_jit = _probe_occupancy


# -- collision programs (snapshot-based, shared jit cache) ---------------------
def _count_probe_hits(snap: PagedSnapshot, coords, valid, min_level: int, offset):
    """Probe snap at coords+offset (the intersect_sparse descent direction:
    octree probed at the other map's voxel coordinates translated by offset,
    GvlNTree.hpp:195); out-of-bounds translated coords never hit."""
    c = coords + jnp.asarray(offset, jnp.int32)
    dims_arr = jnp.asarray(snap.dims, jnp.int32)
    inside = jnp.all((c >= 0) & (c < dims_arr), axis=-1)
    occ, unk, _ = snap.probe(jnp.clip(c, 0, dims_arr - 1), min_level)
    live = valid & inside
    return (
        jnp.sum(occ & live, dtype=jnp.uint32),
        jnp.sum(unk & live, dtype=jnp.uint32),
    )


@functools.partial(jax.jit, static_argnames=("min_level", "offset"))
def _paged_collide_list(snap, lst, min_level: int, offset):
    from .hierarchical import query_coords_of

    coords, valid = query_coords_of(lst)
    return _count_probe_hits(snap, coords, valid, min_level, offset)


@functools.partial(jax.jit, static_argnames=("min_level", "offset"))
def _paged_collide_coords(snap, coords, min_level: int, offset):
    valid = jnp.ones(coords.shape[:-1], bool)
    return _count_probe_hits(snap, coords, valid, min_level, offset)


@functools.partial(jax.jit, static_argnames=("min_level", "offset"))
def _paged_collide_paged(snap, other_snap, min_level: int, offset):
    """NTree x NTree (intersect_load_balance, NTree.hpp:1139): enumerate the
    other octree's exact occupied set (its tile pool) and run the probe
    descent on self — the uniform-work replacement for the
    simultaneous DFS + work-stealing balancer."""
    coords, valid = other_snap.occupied_cells()
    return _count_probe_hits(snap, coords, valid, min_level, offset)[0]


@functools.partial(jax.jit, static_argnames=("min_level", "offset"))
def _paged_collide_hier(snap, hier, min_level: int, offset):
    """Paged octree x dense hierarchy: enumerate self's sparse occupied set
    and probe the dense pyramid (cheaper than materializing the dense side's
    dims^3 coordinates; the count — occupied-in-both voxels — is symmetric).
    The offset still translates the OTHER map into self's frame, so self's
    cells map back at coords - offset."""
    coords, valid = snap.occupied_cells()
    c = coords - jnp.asarray(offset, jnp.int32)
    pd = jnp.asarray(hier.padded_dims, jnp.int32)
    inside = jnp.all((c >= 0) & (c < pd), axis=-1)
    occ, _, _ = hier.probe.__wrapped__(hier, jnp.clip(c, 0, pd - 1), min_level)
    return jnp.sum(occ & valid & inside, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnames=("min_level", "offset"))
def _paged_collide_dense_probed(snap, other, min_level: int, offset):
    """Paged octree x dense map at coarse resolution: the literal
    intersect_sparse direction — probe self at every map voxel + offset,
    counting map-occupied voxels whose (coarse) octree probe hits. Exact for
    any min_level but materializes the map's full coordinate grid; the
    min_level==0 default takes _paged_collide_dense's sparse gather
    instead."""
    from .hierarchical import query_coords_of

    coords, valid = query_coords_of(other)
    return _count_probe_hits(snap, coords, valid, min_level, offset)


@functools.partial(jax.jit, static_argnames=("offset",))
def _paged_collide_dense(snap, other, offset):
    """Paged octree x dense voxel map (intersect_load_balance(ProbVoxelMap&),
    NTree.hpp:1006). Enumerates self's sparse occupied set and gathers the
    map — identical count to the reference's traversal+lookup at level 0.
    Map occupancy uses the octree probe contract: prob occ >= 50 hardcoded
    (kernel_common.h:172-183), bit-map !isZero."""
    from .voxelmap import ProbVoxelMap
    from .. import bitops
    from ..ops.insert import linear_index

    coords, valid = snap.occupied_cells()
    c = coords - jnp.asarray(offset, jnp.int32)
    dims_arr = jnp.asarray(other.dims, jnp.int32)
    inside = jnp.all((c >= 0) & (c < dims_arr), axis=-1)
    lin = linear_index(jnp.clip(c, 0, dims_arr - 1), other.dims)
    if isinstance(other, ProbVoxelMap):
        occ_map = other.data[lin].astype(jnp.int32) >= 50
    else:
        occ_map = ~bitops.is_zero(other.data[:, lin])
    return jnp.sum(occ_map & valid & inside, dtype=jnp.uint32)


class PagedHierarchicalMap(DiskIO):
    """Sparse deterministic hierarchical map (GvlNTree-scale worlds).

    Not a pytree: the host grows the pool/page arrays between jitted steps.
    Device state: coarse status pyramid over pages, sorted page-key table
    (skeys/srows int32[NP]), per-page block->slot rows (pages int32[NP,512])
    and block summaries (uint8[NP,512]), tile pool uint8[NT,512].
    """

    def __init__(self, dims: Dims, side_length: float = 1.0, probabilistic: bool = False):
        if any(d % PAGE_EDGE for d in dims):
            raise ValueError(f"dims must be multiples of {PAGE_EDGE}")
        if (dims[0] // PAGE_EDGE) * (dims[1] // PAGE_EDGE) * (dims[2] // PAGE_EDGE) >= 2**31:
            raise ValueError("page count must fit int32 (dims <= 65536^3)")
        self.dims = tuple(int(d) for d in dims)
        self.side_length = float(side_length)
        self.probabilistic = bool(probabilistic)
        self.map_type = (
            MapType.MT_PROBAB_OCTREE if probabilistic else MapType.MT_BITVECTOR_OCTREE
        )
        self.cdims = tuple(d // B for d in self.dims)  # blocks per axis (x,y,z)
        self.sdims = tuple(d // PAGE_EDGE for d in self.dims)  # pages per axis
        # cap 16 (not the dense tier's 8): a 65536^3 world has a 1024^3 page
        # grid and needs 10 pyramid levels to reach a single root cell
        self.levels = _num_levels(self.sdims, cap=16)
        pd = _pad_dims(self.sdims, self.levels)
        self._coarse_shape = (pd[2], pd[1], pd[0])
        self.pyramid = _empty_pyramid(self._coarse_shape, self.levels)
        # sparse page directory (sorted int32 keys for device binary search)
        self.skeys = jnp.full((1,), jnp.int32(2**31 - 1))
        self.srows = jnp.zeros((1,), jnp.int32)
        self.pages = jnp.full((1, PAGE), jnp.int32(-1))  # block -> tile slot
        self.block_summaries = jnp.zeros((1, PAGE), jnp.uint8)
        self.page_coord = jnp.zeros((1, 3), jnp.int32)  # (px, py, pz) per page row
        self.pool = jnp.zeros((1, TILE), jnp.uint8)
        # probabilistic tier (GvlNTreeProb, Octree.cu:71): int8 log-odds
        # ground truth per fine voxel (EnvNodesProbabilistic.h); the status
        # pool above is DERIVED from it so all probe machinery is shared.
        # occupied <=> occ != -128 && occ >= THRESHOLD_OCCUPANCY(10)
        # (EnvNodesProbCommon.h:30-45, via _status_from_occupancy).
        self.occ_pool = (
            jnp.full((1, TILE), jnp.int8(UNKNOWN_PROBABILITY)) if probabilistic else None
        )
        self.slot_block = jnp.zeros((1, 3), jnp.int32)  # (bx, by, bz) per slot
        self.slot_page = jnp.zeros((1,), jnp.int32)  # page row per slot
        self.slot_within = jnp.zeros((1,), jnp.int32)  # block index in page
        self._n_pages = 0
        self._n_slots = 0
        self._page_of: dict[int, int] = {}  # page key -> page row
        self._slot_of: dict[int, int] = {}  # block key -> pool row

    @property
    def fine_levels(self) -> int:
        """Octree height in fine-voxel levels (reference level_count analogue)."""
        return self.levels + 6

    # -- host-side allocation -------------------------------------------------
    def _ensure_capacity(self, arr, n_needed, fill):
        cap = arr.shape[0]
        if n_needed <= cap:
            return arr
        new_cap = max(n_needed, cap * 2)
        grown = jnp.full((new_cap,) + arr.shape[1:], fill, arr.dtype)
        return grown.at[:cap].set(arr)

    def _allocate(self, blocks_np: np.ndarray) -> None:
        """Host: ensure a tile slot (and page) exists for every (bx,by,bz)."""
        cx, cy, _ = self.cdims
        sx, sy, _ = self.sdims
        new_pages = []  # (page_row, px, py, pz)
        new_slots = []  # (page_row, within, slot, bx, by, bz)
        for bx, by, bz in blocks_np:
            key = (int(bz) * cy + int(by)) * cx + int(bx)  # python int: no overflow
            if key in self._slot_of:
                continue
            px, py, pz = int(bx) // SB, int(by) // SB, int(bz) // SB
            skey = (pz * sy + py) * sx + px  # < 2^30 by the dims check
            page = self._page_of.get(skey)
            if page is None:
                page = self._n_pages
                self._page_of[skey] = page
                self._n_pages += 1
                new_pages.append((page, px, py, pz))
            slot = self._n_slots
            self._slot_of[key] = slot
            self._n_slots += 1
            within = ((int(bz) % SB) * SB + (int(by) % SB)) * SB + int(bx) % SB
            new_slots.append((page, within, slot, int(bx), int(by), int(bz)))
        if new_pages:
            self.pages = self._ensure_capacity(self.pages, self._n_pages, jnp.int32(-1))
            self.block_summaries = self._ensure_capacity(
                self.block_summaries, self._n_pages, jnp.uint8(0)
            )
            self.page_coord = self._ensure_capacity(self.page_coord, self._n_pages, jnp.int32(0))
            arr = np.asarray(new_pages, np.int32)
            self.page_coord = self.page_coord.at[arr[:, 0]].set(arr[:, 1:4])
            # re-sort the page key directory, padded to pow2 capacity with
            # INT32_MAX sentinels (valid keys are < 2^30) so directory growth
            # does not change compiled-program shapes every allocation
            npg = len(self._page_of)
            keys = np.fromiter(self._page_of.keys(), np.int64, npg)
            rows = np.fromiter(self._page_of.values(), np.int32, npg)
            order = np.argsort(keys)
            cap = 1 << (npg - 1).bit_length() if npg else 1
            sk = np.full(cap, 2**31 - 1, np.int32)
            sr = np.zeros(cap, np.int32)
            sk[:npg] = keys[order].astype(np.int32)
            sr[:npg] = rows[order]
            self.skeys = jnp.asarray(sk)
            self.srows = jnp.asarray(sr)
        if new_slots:
            self.pool = self._ensure_capacity(self.pool, self._n_slots, jnp.uint8(0))
            if self.probabilistic:
                self.occ_pool = self._ensure_capacity(
                    self.occ_pool, self._n_slots, jnp.int8(UNKNOWN_PROBABILITY)
                )
            self.slot_block = self._ensure_capacity(self.slot_block, self._n_slots, jnp.int32(0))
            self.slot_page = self._ensure_capacity(self.slot_page, self._n_slots, jnp.int32(0))
            self.slot_within = self._ensure_capacity(self.slot_within, self._n_slots, jnp.int32(0))
            arr = np.asarray(new_slots, np.int32)
            self.pages = self.pages.at[arr[:, 0], arr[:, 1]].set(arr[:, 2])
            self.slot_page = self.slot_page.at[arr[:, 2]].set(arr[:, 0])
            self.slot_within = self.slot_within.at[arr[:, 2]].set(arr[:, 1])
            self.slot_block = self.slot_block.at[arr[:, 2]].set(arr[:, 3:6])

    # -- device-side directory lookups ---------------------------------------
    def snapshot(self) -> PagedSnapshot:
        """Immutable pytree view for jitted consumers (arrays by reference)."""
        return PagedSnapshot(
            pyramid=self.pyramid,
            skeys=self.skeys,
            srows=self.srows,
            pages=self.pages,
            block_summaries=self.block_summaries,
            pool=self.pool,
            slot_block=self.slot_block,
            n_slots=jnp.int32(self._n_slots),
            dims=self.dims,
            sdims=self.sdims,
            levels=self.levels,
            side_length=self.side_length,
        )

    def _page_rows_of(self, coords: jnp.ndarray):
        return self.snapshot()._page_rows_of(coords)

    # -- insertion --------------------------------------------------------------
    def _allocate_for(self, coords, inside) -> None:
        """Host: allocate tiles for the blocks touched by device coords.

        Steady-state inserts (every touched tile already allocated — the
        common sensor-loop case) fetch ONE scalar (`_needs_allocation`).
        When allocation IS needed, the new-tile blocks are deduped and
        compacted ON DEVICE (`_new_tile_blocks`) and the host fetches only
        the count scalar + that compacted prefix — O(new tiles), never
        O(points) (a 640x480 frame entering fresh territory fetches a few
        hundred rows, not 300k ray cells)."""
        if self._n_slots and not bool(
            _host_fetch(
                _needs_allocation(
                    self.pages, self.skeys, self.srows, coords, inside,
                    self.sdims, self.pool.shape[0],
                )
            )
        ):
            return
        n_new, blocks = _new_tile_blocks(
            self.pages, self.skeys, self.srows, coords, inside,
            self.sdims, self.pool.shape[0],
        )
        n = int(_host_fetch(n_new))
        if n:
            # pow2-bucket the fetched prefix so distinct new-tile counts share
            # compiled fetch programs (each fresh shape costs ~15 s through the
            # remote compiler — same rationale as ops/compact.py); trim on host.
            kp = min(int(blocks.shape[0]), max(8, 1 << (n - 1).bit_length()))
            self._allocate(np.asarray(_host_fetch(blocks[:kp]), np.int64)[:n])

    def insert_point_cloud(
        self,
        points,
        meaning=BitVoxelMeaning.eBVM_OCCUPIED,
        static_map: bool = True,
        voxel_offset=None,
    ) -> "PagedHierarchicalMap":
        """Point insert (setOccupied/insertNode, kernel_common.h:186-245).

        Deterministic tier: eBVM_FREE marks cells hard-free, everything else
        hard-occupied; static_map picks the ns_STATIC_MAP vs ns_DYNAMIC_MAP
        tag. Probabilistic tier: voxels take the meaning's probability
        (ProbabilisticVoxel.hpp:77-92 — the GvlNTreeProb insert). Free-space
        from a depth sensor enters as explicit free points (see
        gpu_voxels_jax.ops.raycast.depth_image_to_point_cloud + ray sampling),
        mirroring the octree Sensor's sparse free-voxel list (Sensor.cu).

        `voxel_offset` (integer voxel units) shifts the voxelized coords
        AFTER the global boundary decision — the slab-decomposition hook
        (parallel/paged_world.py); see _voxelize_points.
        """
        pts = _pad_points_pow2(jnp.asarray(points, jnp.float32))
        voff = None if voxel_offset is None else np.asarray(voxel_offset, np.int32)
        coords, inside = _voxelize_points(pts, self.side_length, self.dims, voff)
        self._allocate_for(coords, inside)

        # device: one compiled scatter + one compiled summary/pyramid rebuild
        if self.probabilistic:
            val = jnp.int8(meaning_to_probability(meaning))
            self.occ_pool, self.pool = _scatter_pool_prob_set(
                self.occ_pool, self.pages, self.skeys, self.srows, coords,
                inside, self.sdims, val,
            )
        else:
            occ_bit = NS_FREE if int(meaning) == int(BitVoxelMeaning.eBVM_FREE) else NS_OCCUPIED
            flag = NS_STATIC_MAP if static_map else NS_DYNAMIC_MAP
            self.pool = _scatter_pool(
                self.pool, self.pages, self.skeys, self.srows, coords, inside,
                self.sdims, int(occ_bit), int(flag),
            )
        self._rebuild_coarse()
        return self

    def insert_point_cloud_with_free_space(
        self,
        points,
        sensor_origin=(0.0, 0.0, 0.0),
        max_steps: int = 128,
        static_map: bool = False,
        voxel_offset=None,
    ) -> "PagedHierarchicalMap":
        """insertPointCloudWithFreespaceCalculation (GvlNTree.hpp:108-130) on
        the sparse tier.

        Deterministic tier: carve hard-FREE cells along each sensor ray, then
        insert the hits as occupied (hits override free, like NTree's object-
        over-freespace priority). Probabilistic tier: one log-odds update per
        cell — hit_count*SENSOR_MODEL_OCCUPIED + ray_crossings*
        SENSOR_MODEL_FREE, saturating clamp (insertSensorData semantics,
        ProbVoxelMap.hpp:52-102; magnitudes VoxelMapOperations.h:38-39).

        Rays step one dominant-axis voxel at a time with the endpoint voxel
        excluded (the reference RayCaster's visiting rule, VoxelMapOperations.h:
        199-323), bounded at max_steps cells. This is the sparse-point-set
        analogue of the octree Sensor's free-voxel list (Sensor.cu:116-230);
        dense depth frames at sub-1024^3 scale should use the dense tier's
        projective carve instead.
        """
        pts = _pad_points_pow2(jnp.asarray(points, jnp.float32))
        origin = jnp.asarray(sensor_origin, jnp.float32)
        voff = None if voxel_offset is None else np.asarray(voxel_offset, np.int32)
        ray_coords, live = _free_ray_cells(
            pts, origin, self.side_length, self.dims, max_steps, voff
        )
        hit_coords, hit_inside = _voxelize_points(pts, self.side_length, self.dims, voff)
        dims_arr = jnp.asarray(self.dims, jnp.int32)
        rc = jnp.clip(ray_coords.reshape(-1, 3), 0, dims_arr - 1)
        if not self.probabilistic:
            # carve FREE then set hits OCCUPIED, both as device scatters over
            # the same allocation pass (hits override free, NTree's object-
            # over-freespace priority); the ray cells never visit the host
            all_coords = jnp.concatenate([rc, hit_coords], axis=0)
            all_inside = jnp.concatenate([live.reshape(-1), hit_inside], axis=0)
            self._allocate_for(all_coords, all_inside)
            flag = NS_STATIC_MAP if static_map else NS_DYNAMIC_MAP
            self.pool = _scatter_pool(
                self.pool, self.pages, self.skeys, self.srows, rc,
                live.reshape(-1), self.sdims, int(NS_FREE), int(flag),
            )
            self.pool = _scatter_pool(
                self.pool, self.pages, self.skeys, self.srows, hit_coords,
                hit_inside, self.sdims, int(NS_OCCUPIED), int(flag),
            )
            self._rebuild_coarse()
            return self
        all_coords = jnp.concatenate([rc, hit_coords], axis=0)
        all_inside = jnp.concatenate([live.reshape(-1), hit_inside], axis=0)
        weights = jnp.concatenate([
            jnp.full((rc.shape[0],), SENSOR_MODEL_FREE, jnp.int32),
            jnp.full((hit_coords.shape[0],), SENSOR_MODEL_OCCUPIED, jnp.int32),
        ])
        self._allocate_for(all_coords, all_inside)
        self.occ_pool, self.pool = _scatter_pool_prob_add(
            self.occ_pool, self.pages, self.skeys, self.srows, all_coords,
            weights, all_inside, self.sdims,
        )
        self._rebuild_coarse()
        return self

    def insert_depth_image(
        self, depth, sensor, max_steps: int = 128, voxel_offset=None
    ) -> "PagedHierarchicalMap":
        """Octree sensor pipeline (Sensor.cu processSensorData): back-project
        the depth image (kernel_preprocessObjectDepthImage), transform into
        the world frame, then run the ray-carved sensor insert. Invalid
        pixels become far-outside sentinels whose rays are dead."""
        from ..geometry import transforms
        from ..ops import raycast as raycast_ops

        depth = jnp.asarray(depth, jnp.float32)
        pts = raycast_ops.depth_image_to_point_cloud(
            depth, sensor.fx, sensor.fy, sensor.cx, sensor.cy, sensor.invalid_value
        )
        world = transforms.transform_points(sensor.pose(), pts)
        finite = jnp.all(jnp.isfinite(world), axis=-1)
        world = jnp.where(finite[:, None], world, -1e9)
        origin = np.asarray(sensor.pose())[:3, 3]
        return self.insert_point_cloud_with_free_space(
            world, tuple(float(v) for v in origin), max_steps=max_steps,
            voxel_offset=voxel_offset,
        )

    def _rebuild_coarse(self) -> None:
        """Tile summaries -> block summaries -> page statuses -> pyramid
        (one compiled program; see _rebuild_programs)."""
        if self._n_slots == 0:
            return
        self.block_summaries, self.pyramid = _rebuild_programs(
            self.pool,
            self.slot_page,
            self.slot_within,
            self.page_coord,
            jnp.int32(self._n_slots),
            jnp.int32(self._n_pages),
            self._coarse_shape,
            self.levels,
        )

    # -- probing (compiled snapshot programs) ---------------------------------
    def probe_status(self, coords: jnp.ndarray, min_level: int = 0) -> jnp.ndarray:
        return _probe_status_jit(
            self.snapshot(), jnp.asarray(coords, jnp.int32), min_level=min_level
        )

    def probe(self, coords: jnp.ndarray, min_level: int = 0):
        return _probe_jit(
            self.snapshot(), jnp.asarray(coords, jnp.int32), min_level=min_level
        )

    def probe_occupancy(self, coords) -> jnp.ndarray:
        """int8 log-odds per fine voxel (probabilistic tier only). Unallocated
        space reads UNKNOWN_PROBABILITY — the virtual NTree's implicit
        unknown nodes (EnvNodesProbabilistic.h). Out-of-range coords clamp to
        the border cell, like probe_status."""
        if not self.probabilistic:
            raise TypeError("probe_occupancy requires a probabilistic paged map")
        c = jnp.clip(
            jnp.asarray(coords, jnp.int32), 0, jnp.asarray(self.dims, jnp.int32) - 1
        )
        return _probe_occupancy_jit(
            self.occ_pool, self.pages, self.skeys, self.srows, c, self.sdims
        )

    def clear_map(self) -> "PagedHierarchicalMap":
        """Drop all pages/tiles back to the pristine UNKNOWN world."""
        self.__init__(self.dims, self.side_length, self.probabilistic)
        return self

    def build(self, points, free_bounding_box: bool = False) -> "PagedHierarchicalMap":
        """NTree::build (NTree.hpp:385-540): (re)construct from a point set.
        free_bounding_box (NTree.h:127) carves the points' voxel AABB FREE
        before inserting — here as explicit free points over the box
        (tractable for the sensor-scale boxes the reference builds from;
        the virtual remainder of a 32768^3 world stays implicit UNKNOWN)."""
        # validate BEFORE clear_map: this class mutates in place, so a
        # rejected box must not destroy the caller's existing contents
        free = _free_box_cloud(points, self.side_length) if free_bounding_box else None
        self.clear_map()
        if free is not None:
            self.insert_point_cloud(free.astype(np.float32), BitVoxelMeaning.eBVM_FREE)
        return self.insert_point_cloud(points, BitVoxelMeaning.eBVM_OCCUPIED)

    def insert_meta_point_cloud(self, meta, meanings=None) -> "PagedHierarchicalMap":
        """insertMetaPointCloud (GvlNTree.hpp:437-453): per-subcloud meanings
        degrade to the FIRST meaning, exactly like the reference adapter."""
        return self.insert_point_cloud(meta.points, meta_first_meaning(meanings))

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (GpuVoxelsMap contract). Self-collision
        uses the probe path on voxelized link clouds. Returns (map, ok)."""
        ok = True
        if with_self_collision_test:
            ok = not robot_self_collision_clash(robot_links, self.side_length)
        return self.insert_meta_point_cloud(robot_links), ok

    def clear_voxel_meaning(self, meaning) -> "PagedHierarchicalMap":
        """clearBitVoxelMeaning (GvlNTree.hpp:487-494): only eBVM_OCCUPIED
        clears (= reset)."""
        if int(meaning) != int(BitVoxelMeaning.eBVM_OCCUPIED):
            from ..utils.logging import log_stream

            log_stream("octree").error("octree maps only clear eBVM_OCCUPIED")
            return self
        return self.clear_map()

    # -- NTree maintenance contract -------------------------------------------
    def needs_rebuild(self) -> bool:
        """NTree::needsRebuild — the pool is compact by construction (tiles
        are never freed individually), so a defrag rebuild is never needed."""
        return False

    def rebuild(self) -> "PagedHierarchicalMap":
        """NTree::rebuild (NTree.hpp:2941): defragmentation no-op."""
        return self

    def check_tree(self) -> bool:
        """NTree::checkTree (NTree.h:267-271): validate the summary
        invariant — recompute block summaries + page pyramid from the tile
        pool and compare against the maintained ones."""
        if self._n_slots == 0:
            return True
        want_blocks, want_pyr = _rebuild_programs(
            self.pool, self.slot_page, self.slot_within, self.page_coord,
            jnp.int32(self._n_slots), jnp.int32(self._n_pages),
            self._coarse_shape, self.levels,
        )
        if not bool(jnp.all(want_blocks == self.block_summaries)):
            return False
        return all(bool(jnp.all(w == p)) for w, p in zip(want_pyr, self.pyramid))

    def clear_collision_flags(self) -> "PagedHierarchicalMap":
        """NTree::clearCollisionFlags (NTree.h:301): collide results are
        returned, never written into nodes — nothing to clear."""
        return self

    def collide_with_coords(self, coords, min_level: int = 0, offset=(0, 0, 0)) -> jnp.ndarray:
        return _paged_collide_coords(
            self.snapshot(), jnp.asarray(coords, jnp.int32), min_level,
            _canon_offset(offset),
        )[0]

    def collide_with(self, other, min_level: int = 0, offset=(0, 0, 0)) -> jnp.ndarray:
        """collideWith dispatch on the sparse octree (GvlNTree.hpp:150-330):

        - voxel list: intersect_sparse probe at other's coords + offset
          (GvlNTree.hpp:222-240, offset forwarded at :195)
        - dense voxel map: intersect_load_balance(ProbVoxelMap&) analogue
          (NTree.hpp:1006) — at min_level 0 self's exact occupied set gathers
          the map (identical count, sparse work); coarser levels run the
          literal per-map-voxel probe
        - paged octree / dense hierarchy: NTree x NTree (NTree.hpp:1139);
          nonzero offsets are rejected, where the reference logs
          GPU_VOXELS_MAP_OFFSET_ON_WRONG_DATA_STRUCTURE and drops them
          (GvlNTree.hpp:260-262)
        """
        from .hierarchical import _PyramidQueries, _reject_octree_offset
        from .voxellist import VoxelList
        from .voxelmap import BitVectorVoxelMap, ProbVoxelMap

        off = _canon_offset(offset)
        if isinstance(other, VoxelList):
            return _paged_collide_list(self.snapshot(), other, min_level, off)[0]
        if isinstance(other, PagedHierarchicalMap):
            _reject_octree_offset(off)
            return _paged_collide_paged(self.snapshot(), other.snapshot(), min_level, (0, 0, 0))
        if isinstance(other, _PyramidQueries):
            _reject_octree_offset(off)
            return _paged_collide_hier(self.snapshot(), other, min_level, (0, 0, 0))
        if isinstance(other, (ProbVoxelMap, BitVectorVoxelMap)):
            if min_level == 0:
                return _paged_collide_dense(self.snapshot(), other, off)
            return _paged_collide_dense_probed(self.snapshot(), other, min_level, off)[0]
        raise TypeError(type(other))

    def collide_with_resolution(
        self, other, coll_threshold: float = 1.0, resolution_level: int = 0, offset=(0, 0, 0)
    ):
        """collideWithResolution on the sparse octree (GvlNTree.hpp:179-330);
        coll_threshold ignored like the reference's hardcoded probe occupancy
        (kernel_common.h:172)."""
        del coll_threshold
        if resolution_level > self.fine_levels:
            raise ValueError("resolution_level greater than octree height")
        return self.collide_with(other, min_level=int(resolution_level), offset=offset)

    def collide_with_counting_unknown(self, other, min_level: int = 0, offset=(0, 0, 0)):
        """collideWithTypesConsideringUnknownCells (GvlNTree.h:115-129):
        (collisions, unknown-cell hits). Unallocated space reads unknown —
        the virtual NTree's implicit unknown nodes."""
        from .voxellist import VoxelList

        off = _canon_offset(offset)
        if isinstance(other, VoxelList):
            return _paged_collide_list(self.snapshot(), other, min_level, off)
        return _paged_collide_dense_probed(self.snapshot(), other, min_level, off)

    def collide_with_counting_unknown_coords(self, coords, min_level: int = 0, offset=(0, 0, 0)):
        return _paged_collide_coords(
            self.snapshot(), jnp.asarray(coords, jnp.int32), min_level,
            _canon_offset(offset),
        )

    # -- maintenance --------------------------------------------------------------
    def memory_usage(self) -> int:
        total = 0
        for a in (
            self.skeys,
            self.srows,
            self.pages,
            self.block_summaries,
            self.page_coord,
            self.pool,
            self.slot_block,
            self.slot_page,
            self.slot_within,
        ) + ((self.occ_pool,) if self.probabilistic else ()):
            total += a.size * a.dtype.itemsize
        for p in self.pyramid:
            total += p.size * p.dtype.itemsize
        return int(total)

    def n_tiles(self) -> int:
        return self._n_slots

    def extract_occupied_coords(self, max_out: int | None = None) -> np.ndarray:
        """Occupied fine coords (extractCubes analogue), host-side."""
        n = self._n_slots
        if n == 0:
            return np.zeros((0, 3), np.int32)
        pool = np.asarray(self.pool[:n])
        sb = np.asarray(self.slot_block[:n])
        slot_i, widx = np.nonzero((pool & STATUS_OCCUPANCY_MASK) == NS_OCCUPIED)
        wz, rem = widx // (B * B), widx % (B * B)
        wy, wx = rem // B, rem % B
        out = np.stack(
            [
                sb[slot_i, 0] * B + wx,
                sb[slot_i, 1] * B + wy,
                sb[slot_i, 2] * B + wz,
            ],
            axis=1,
        ).astype(np.int32)
        return out[:max_out] if max_out is not None else out
