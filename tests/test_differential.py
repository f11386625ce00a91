"""Randomized differential tests: framework vs independent numpy oracles.

Broader hardening than the fixed reference scenes: random clouds, random
offsets, random thresholds — counts must match exact set arithmetic.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax.constants import float_to_probability
from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap

DIMS = (21, 18, 15)


def _voxels(pts, side=1.0):
    return set(map(tuple, np.floor(np.asarray(pts) / side).astype(int)))


def _clip_in(vox, dims):
    return {v for v in vox if all(0 <= v[i] < dims[i] for i in range(3))}


@pytest.mark.parametrize("seed", range(6))
def test_offset_collision_differential(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-2, 20, (rng.integers(5, 400), 3)).astype(np.float32)
    b = rng.uniform(-2, 20, (rng.integers(5, 400), 3)).astype(np.float32)
    off = tuple(int(v) for v in rng.integers(-3, 4, 3))

    m1 = ProbVoxelMap.create(DIMS).insert_point_cloud(a)
    m2 = ProbVoxelMap.create(DIMS).insert_point_cloud(b)
    got = int(m1.collide_with(m2, 0.1, off))

    # oracle: collide(this[i+off], other[i]) over in-range flat indices;
    # equivalently this voxel v (in-map) vs other voxel v-off (in-map), where
    # "in-map" means the flat index stays in range — the reference's shifted
    # pointer wraps across rows, so emulate via flat index arithmetic
    va = _clip_in(_voxels(a), DIMS)
    vb = _clip_in(_voxels(b), DIMS)
    dx, dy, dz = DIMS
    n = dx * dy * dz

    def flat(v):
        return v[2] * dx * dy + v[1] * dx + v[0]

    offl = off[2] * dx * dy + off[1] * dx + off[0]
    fa = {flat(v) for v in va}
    fb = {flat(v) for v in vb}
    expect = sum(1 for i in range(n) if 0 <= i + offl < n and (i + offl) in fa and i in fb)
    assert got == expect, (seed, off)


@pytest.mark.parametrize("seed", range(4))
def test_list_set_ops_differential(seed):
    rng = np.random.default_rng(100 + seed)
    a = rng.uniform(0, 20, (rng.integers(10, 300), 3)).astype(np.float32)
    b = rng.uniform(0, 20, (rng.integers(10, 300), 3)).astype(np.float32)
    la = bit_vector_voxel_list(DIMS).insert_point_cloud(a, 50)
    lb = bit_vector_voxel_list(DIMS).insert_point_cloud(b, 60)

    # the list insert does NOT bounds-check (reference parity): out-of-range
    # coords produce wrapped linear ids that can alias, so the oracle works
    # on linear ids, not 3D voxels
    dx, dy, _ = DIMS

    def ids(pts):
        v = np.floor(np.asarray(pts)).astype(np.int64)
        return set(((v[:, 2] * dx * dy + v[:, 1] * dx + v[:, 0]) % (1 << 32)).tolist())

    va, vb = ids(a), ids(b)
    assert int(la.count) == len(va)
    assert int(la.collide_with(lb)) == len(va & vb)
    assert int(la.subtract(lb).count) == len(va - vb)
    assert int(la.merge(lb).count) == len(va | vb)


@pytest.mark.parametrize("seed", range(4))
def test_bitmap_vs_probmap_cross_type_differential(seed):
    rng = np.random.default_rng(200 + seed)
    a = rng.uniform(0, 18, (200, 3)).astype(np.float32)
    b = rng.uniform(0, 18, (200, 3)).astype(np.float32)
    bm = BitVectorVoxelMap.create(DIMS).insert_point_cloud(a, 77)
    pm = ProbVoxelMap.create(DIMS).insert_point_cloud(b)
    expect = len(_clip_in(_voxels(a), DIMS) & _clip_in(_voxels(b), DIMS))
    assert int(bm.collide_with(pm, 0.5)) == expect
    assert int(pm.collide_with(bm, 0.5)) == expect
    assert bool(bm.collides_with(pm, 0.5)) == (expect > 0)


def _cube_hits(query_vox, occupied_vox, level, dims):
    """Oracle: query voxel q hits iff its ALIGNED 2^level cube contains any
    occupied voxel (the top-down probe's min_level semantics)."""
    occ_cubes = {tuple(c >> level for c in v) for v in occupied_vox}
    return sum(
        1
        for q in query_vox
        if all(0 <= q[i] < dims[i] for i in range(3))
        and tuple(c >> level for c in q) in occ_cubes
    )


@pytest.mark.parametrize("seed", range(4))
def test_hierarchy_probe_collide_differential(seed):
    """Hierarchy (dense pyramid) collide vs list/dense with random offsets
    and min_levels, against an aligned-cube numpy oracle."""
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap

    rng = np.random.default_rng(100 + seed)
    dims = (32, 32, 32)
    a = rng.uniform(0, 32, (rng.integers(20, 300), 3)).astype(np.float32)
    b = rng.uniform(0, 32, (rng.integers(20, 300), 3)).astype(np.float32)
    off = tuple(int(v) for v in rng.integers(-2, 3, 3))
    h = HierarchicalBitMap.create(dims, 1.0).insert_point_cloud(a)
    lst = bit_vector_voxel_list(dims).insert_point_cloud(b, 9)
    va = _clip_in(_voxels(a), dims)
    vb_unique = _clip_in(_voxels(b), dims)  # list dedups entries
    for level in (0, 1, 2):
        got = int(h.collide_with(lst, min_level=level, offset=off))
        shifted = [tuple(q[i] + off[i] for i in range(3)) for q in vb_unique]
        expect = _cube_hits(shifted, va, level, dims)
        assert got == expect, (seed, level, off)


@pytest.mark.parametrize("seed", range(3))
def test_paged_collide_differential(seed):
    """Sparse paged tier vs the same oracle (content far from the origin so
    block/page boundaries are exercised), incl. counting-unknown."""
    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap
    from gpu_voxels_jax.maps.voxellist import bit_vector_morton_voxel_list

    rng = np.random.default_rng(200 + seed)
    base = np.array([1000, 1500, 700], np.float32)
    a = (base + rng.uniform(0, 24, (rng.integers(20, 200), 3))).astype(np.float32)
    b = (base + rng.uniform(0, 24, (rng.integers(20, 200), 3))).astype(np.float32)
    dims = (4096, 4096, 4096)
    m = PagedHierarchicalMap(dims, 1.0)
    m.insert_point_cloud(a)
    # linear uint32 ids wrap past 2^32 voxels (creation raises); octree-scale
    # worlds pair with MORTON lists exactly like the reference
    with pytest.raises(ValueError):
        bit_vector_voxel_list(dims)
    lst = bit_vector_morton_voxel_list(dims).insert_point_cloud(b, 9)
    va = _voxels(a)
    vb_unique = _voxels(b)
    for level in (0, 1, 3):
        got = int(m.collide_with(lst, min_level=level))
        expect = _cube_hits(sorted(vb_unique), va, level, dims)
        assert got == expect, (seed, level)
    # counting-unknown: every non-hit probe coord reads implicit UNKNOWN
    hits, unknown = m.collide_with_counting_unknown(lst)
    assert int(hits) == _cube_hits(sorted(vb_unique), va, 0, dims)
    assert int(hits) + int(unknown) == len(vb_unique)


@pytest.mark.parametrize("seed", range(3))
def test_paged_prob_fusion_matches_dense_differential(seed):
    """The probabilistic paged tier's sensor fusion must write EXACTLY the
    log-odds the dense ProbVoxelMap writes for the same scene: both use the
    dominant-axis ray rule with the endpoint excluded and SensorModel
    magnitudes (VoxelMapOperations.h:38-39, 199-323)."""
    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap

    rng = np.random.default_rng(300 + seed)
    origin = rng.uniform(4, 28, 3).astype(np.float32)
    pts = rng.uniform(2, 30, (rng.integers(10, 120), 3)).astype(np.float32)
    dense = ProbVoxelMap.create((32, 32, 32), 1.0).insert_sensor_data(
        pts, tuple(origin), max_steps=128
    )
    paged = PagedHierarchicalMap((4096, 4096, 4096), 1.0, probabilistic=True)
    paged.insert_point_cloud_with_free_space(pts, tuple(origin), max_steps=128)
    xs = np.arange(32)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    coords = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.int32)
    got = np.asarray(paged.probe_occupancy(jnp.asarray(coords)))
    dx = 32
    flat = coords[:, 2] * (dx * dx) + coords[:, 1] * dx + coords[:, 0]
    want = np.asarray(dense.data)[flat]
    np.testing.assert_array_equal(got, want)
