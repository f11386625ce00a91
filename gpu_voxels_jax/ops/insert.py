"""Point -> voxel scatter pipelines (dense maps).

Deterministic replacement for the reference's racy atomic scatter kernels
(voxelmap/kernels/VoxelMapOperations.hpp:241-264 kernelInsertGlobalPointCloud,
kernelInsertMetaPointCloud): points are voxelized with the reference's
floor(p / side_length) rule (VoxelMapOperations.h:123-133), mapped to linear
indices z*dimx*dimy + y*dimx + x (VoxelMapOperations.h:44-74), and scattered
deterministically — same-value set for probabilistic voxels, one-hot
scatter-max + OR for bit voxels. Out-of-bounds points are dropped and
reported via a flag, matching TemplateVoxelMap.hpp:588-607.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..bitops import UINT32, bit_plane, bit_word
from ..constants import meaning_to_probability


def map_to_voxels(points: jnp.ndarray, side_length: float) -> jnp.ndarray:
    """float coords -> integer voxel coords (VoxelMapOperations.h:123-133).

    The pre-cast clamp keeps far-out-of-range points (and padding sentinels)
    deterministically out of range: float->int32 conversion of values beyond
    int32 is undefined and can wrap INTO the map on some backends. In-range
    values (< 2^30 voxels per axis) are unaffected.

    Voxelization is an explicit multiply by a host-precomputed f32
    reciprocal, NOT a division: XLA's CPU fast-math lowers f32
    division-by-constant shape-dependently (vectorized approximate
    reciprocal vs exact divide), so `floor(p / side)` can voxelize the SAME
    point into different cells between two call shapes (observed: padded
    insert vs unpadded probe disagreeing at an integer boundary). One fixed
    reciprocal gives one boundary rule everywhere. At ulp-straddling boundaries this may
    differ from the reference's CUDA `div.rn`; determinism across our own
    call sites is the contract that matters."""
    v = jnp.floor(points * jnp.float32(1.0 / float(side_length)))
    return jnp.clip(v, -(2.0**30), 2.0**30).astype(jnp.int32)


def linear_index(coords: jnp.ndarray, dims: Tuple[int, int, int]) -> jnp.ndarray:
    """Voxel coords -> linear index (VoxelMapOperations.h:44-52)."""
    dx, dy, _ = dims
    return coords[..., 2] * (dx * dy) + coords[..., 1] * dx + coords[..., 0]


def linear_offset(offset: Tuple[int, int, int], dims: Tuple[int, int, int]) -> int:
    """Signed voxel offset -> signed linear offset (getVoxelIndexSigned)."""
    dx, dy, _ = dims
    return int(offset[2]) * dx * dy + int(offset[1]) * dx + int(offset[0])


def voxelize(points, side_length, dims):
    """Returns (linear idx with out-of-map points sent to N, any_outside).

    Out-of-range indices use the scatter 'drop' mode downstream; the flag
    feeds the host-side warning (TemplateVoxelMap.hpp:601-606).
    """
    coords = map_to_voxels(points, side_length)
    dims_arr = jnp.asarray(dims, dtype=jnp.int32)
    valid = jnp.all((coords >= 0) & (coords < dims_arr), axis=-1)
    n = dims[0] * dims[1] * dims[2]
    idx = jnp.where(valid, linear_index(coords, dims), n)
    return idx, ~jnp.all(valid)


def insert_prob(data, points, side_length, dims, meaning):
    """ProbVoxelMap point insert: voxel occupancy SET to the meaning's value
    (ProbabilisticVoxel::insert, a store not an update)."""
    idx, outside = voxelize(points, side_length, dims)
    val = jnp.int8(meaning_to_probability(meaning))
    vals = jnp.full(idx.shape, val, dtype=jnp.int8)
    return data.at[idx].set(vals, mode="drop"), outside


def occupancy_mask(idx, n):
    """One-hot bool[n] of hit voxels (duplicates collapse)."""
    hits = jnp.zeros((n,), dtype=jnp.int8)
    hits = hits.at[idx].max(jnp.int8(1), mode="drop")
    return hits


def insert_bit(planes, points, side_length, dims, meaning: int):
    """BitVoxelMap point insert: set bit `meaning` in every hit voxel.

    Deterministic formulation of the reference's atomic byte-OR: a one-hot
    scatter-max builds the hit set, then a single vector OR merges it into
    the target plane.

    Returns (planes, any_outside, occ_delta) where occ_delta is uint8[N]
    1 for voxels this insert made !noneButEmpty — derived elementwise from
    the already-materialized scatter delta (no second scatter), so
    maintaining the map's occupancy summary costs only bandwidth. Inserting
    eBVM_FREE (bit 0, masked out of noneButEmpty) contributes nothing.
    """
    idx, outside = voxelize(points, side_length, dims)
    n = planes.shape[1]
    word = UINT32(bit_word(meaning))
    delta = jnp.zeros((n,), dtype=UINT32).at[idx].max(word, mode="drop")
    p = bit_plane(meaning)
    occ_word = delta & UINT32(0xFFFFFFFE) if p == 0 else delta
    occ_delta = (occ_word != 0).astype(jnp.uint8)
    return planes.at[p].set(planes[p] | delta), outside, occ_delta


def scatter_bits_multi(planes, occ, idx, meanings_np):
    """Fused multi-meaning bit scatter: set bit ``meanings_np[i]`` (STATIC
    numpy array, one per point) at voxel ``idx[i]`` — the one-launch
    kernelInsertMetaPointCloud analogue (VoxelMapOperations.hpp, meta insert)
    shared by the batched swept-volume insert and the per-subcloud-meanings
    meta insert.

    Meanings are static, so the touched bit planes are known at trace time
    and only those pay scatter + OR traffic. (voxel, meaning) pairs are
    deduplicated via a lexicographic two-pass stable sort (safe at any map
    size — a fused ``idx*256+meaning`` uint32 key would overflow past 2^24
    voxels), after which the one-hot bit values can be scatter-ADDED in one
    flat slot-major pass (sum of distinct powers of two == OR).

    Returns (new_planes, new_occ) where new_occ is the maintained
    !noneButEmpty summary (None in -> None out); bit 0 (eBVM_FREE) is masked
    out of the plane-0 contribution per BitVector.h:184-198.
    """
    meanings_np = np.asarray(meanings_np, np.int32)
    if meanings_np.size == 0:
        return planes, occ
    touched = sorted({int(m) >> 5 for m in meanings_np})
    slot_of_plane = np.full(8, -1, np.int32)
    for s, p in enumerate(touched):
        slot_of_plane[p] = s
    K = len(touched)
    n = planes.shape[1]
    meaning = jnp.asarray(meanings_np)

    if (n + 1) * K * 32 <= 2**32:
        # fused single-key sort: (idx*K + slot)*32 + bit identifies the
        # (voxel, bit-to-set) pair exactly and fits uint32 up to n = 2^27/K
        # (256^3 with all 8 planes, 512^3 single-plane). One argsort instead
        # of the two stable passes below.
        slot_np = jnp.asarray(slot_of_plane)[meaning >> 5].astype(jnp.uint32)
        bit = (meaning & 31).astype(jnp.uint32)
        key = (idx.astype(jnp.uint32) * jnp.uint32(K) + slot_np) * jnp.uint32(32) + bit
        order = jnp.argsort(key)
        key_s = key[order]
        first = jnp.concatenate([jnp.ones((1,), bool), key_s[1:] != key_s[:-1]])
    else:
        # lexicographic (idx, meaning) order via two stable argsorts
        order = jnp.argsort(meaning.astype(jnp.uint32), stable=True)
        order = order[jnp.argsort(idx[order], stable=True)]
        i_s = idx[order]
        m_s = meaning[order]
        first = jnp.concatenate(
            [jnp.ones((1,), bool), (i_s[1:] != i_s[:-1]) | (m_s[1:] != m_s[:-1])]
        )
    idx_s = idx[order]
    meaning_s = meaning[order]
    word = jnp.where(first, jnp.uint32(1) << (meaning_s.astype(jnp.uint32) & 31), 0)
    slot = jnp.asarray(slot_of_plane)[meaning_s >> 5]

    tgt = jnp.where(first & (idx_s < n), slot * n + idx_s, K * n)
    delta = (
        jnp.zeros((K * n,), jnp.uint32).at[tgt].add(word, mode="drop").reshape(K, n)
    )

    out_planes = [
        planes[p] if slot_of_plane[p] < 0 else planes[p] | delta[slot_of_plane[p]]
        for p in range(planes.shape[0])
    ]
    new_occ = occ
    if occ is not None:
        occ_words = delta
        if slot_of_plane[0] >= 0:
            occ_words = occ_words.at[slot_of_plane[0]].set(
                delta[slot_of_plane[0]] & jnp.uint32(0xFFFFFFFE)
            )
        new_occ = occ | jnp.any(occ_words != 0, axis=0).astype(jnp.uint8)
    return jnp.stack(out_planes, axis=0), new_occ


def self_collision_clash(robot_links, side_length, dims):
    """Pairwise sub-cloud self-collision predicate shared by every map's
    insert_robot_configuration: True iff two DIFFERENT sub-clouds of the
    MetaPointCloud voxelize into the same cell (the clash test of
    insertMetaPointCloudWithSelfcollisionCheck, ProbVoxelMap.h:61-77).
    Duplicate points within one sub-cloud do not clash."""
    n = dims[0] * dims[1] * dims[2]
    union = jnp.zeros((n,), dtype=jnp.int8)
    clash = jnp.zeros((), bool)
    for i in range(robot_links.num_clouds):
        idx, _ = voxelize(robot_links.get_cloud(i), side_length, dims)
        hits = occupancy_mask(idx, n)
        clash = clash | jnp.any((hits > 0) & (union > 0))
        union = jnp.maximum(union, hits)
    return clash


def insert_count(data, points, side_length, dims):
    """CountingVoxel insert: +1 per inserted point (CountingVoxel.hpp:69-72).

    The reference counter is a raw int8 ``m_count++`` — it wraps past 127
    rather than saturating, and the final astype reproduces exactly that
    (two's-complement mod-256 truncation), matching the list tier's
    wrap-add reduce (CountingVoxel.hpp:75-80)."""
    idx, outside = voxelize(points, side_length, dims)
    ones = jnp.ones(idx.shape, dtype=jnp.int32)
    counts = data.astype(jnp.int32).at[idx].add(ones, mode="drop")
    return counts.astype(data.dtype), outside
