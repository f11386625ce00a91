"""Multi-level cube extraction (extractCubes, NTree.hpp:2637 / Extract.h:50).

Contract: the emitted cubes PARTITION the world — every fine voxel is covered
by exactly one cube — and each cube's type equals the status the probe descent
decides for its voxels at the same min_level (the cubes are literally the
probe's decision nodes). Verified by rasterizing the cubes into a dense grid
and comparing against probe_status + the reference's default status->meaning
mapping (NTree.hpp:336-352).
"""
import numpy as np
import pytest

from gpu_voxels_jax.constants import BitVoxelMeaning
from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
from gpu_voxels_jax.maps.paged import PagedHierarchicalMap
from gpu_voxels_jax.vis.extract import (
    _status_types,
    extract_distance_slice,
    extract_multilevel_cubes,
)

OCC = int(BitVoxelMeaning.eBVM_OCCUPIED)
FREE = int(BitVoxelMeaning.eBVM_FREE)
UNK = int(BitVoxelMeaning.eBVM_UNKNOWN)


def _rasterize(dims, corners, sizes, types):
    """Dense [z, y, x] type grid from cubes; asserts the cubes never overlap
    and exactly tile the world."""
    dx, dy, dz = dims
    grid = np.full((dz, dy, dx), -1, np.int16)
    for (x, y, z), s, t in zip(corners, sizes, types):
        region = grid[z : z + s, y : y + s, x : x + s]
        assert np.all(region == -1), "overlapping cubes"
        region[...] = t
    assert np.all(grid >= 0), "world not fully covered"
    return grid


def _probe_types(m, dims, min_level):
    dx, dy, dz = dims
    gz, gy, gx = np.meshgrid(np.arange(dz), np.arange(dy), np.arange(dx), indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.int32)
    status = np.asarray(m.probe_status(coords, min_level=min_level))
    return _status_types(status).astype(np.int16).reshape(dz, dy, dx)


def _box_points(lo, hi, side=1.0):
    rngs = [np.arange(lo[i], hi[i]) + 0.5 for i in range(3)]
    g = np.meshgrid(*rngs, indexing="ij")
    return (np.stack(g, axis=-1).reshape(-1, 3) * side).astype(np.float32)


@pytest.mark.parametrize("min_level", [0, 1, 2])
def test_dense_hier_extraction_partitions_and_matches_probe(min_level):
    m = HierarchicalBitMap.create((32, 32, 32), side_length=1.0)
    m = m.insert_point_cloud(_box_points((3, 3, 3), (11, 9, 7)))
    m = m.insert_point_cloud(_box_points((16, 16, 16), (32, 32, 32)),
                             meaning=BitVoxelMeaning.eBVM_FREE)
    corners, sizes, types = extract_multilevel_cubes(m, min_level=min_level)
    grid = _rasterize(m.dims, corners, sizes, types)
    assert np.array_equal(grid, _probe_types(m, m.dims, min_level))
    # multi-resolution is real: coarse nodes appear as soon as regions unify
    assert sizes.max() >= 8
    if min_level > 0:
        assert sizes.min() == 1 << min_level


def test_dense_prob_hier_extraction():
    m = HierarchicalProbMap.create((16, 16, 16), side_length=1.0)
    m = m.insert_point_cloud(_box_points((0, 0, 0), (8, 8, 8)))
    corners, sizes, types = extract_multilevel_cubes(m)
    grid = _rasterize(m.dims, corners, sizes, types)
    assert np.array_equal(grid, _probe_types(m, m.dims, 0))
    # the occupied 8^3 box unifies into ONE level-3 cube
    occ_rows = types == OCC
    assert occ_rows.sum() == 1 and sizes[occ_rows][0] == 8


@pytest.mark.parametrize("min_level", [0, 2, 4, 7])
def test_paged_extraction_partitions_and_matches_probe(min_level):
    m = PagedHierarchicalMap((128, 128, 128), side_length=1.0)
    m.insert_point_cloud(_box_points((5, 64, 64), (13, 72, 72)))
    m.insert_point_cloud(_box_points((64, 0, 0), (128, 64, 64)),
                         meaning=BitVoxelMeaning.eBVM_FREE)
    m.insert_point_cloud(_box_points((100, 100, 100), (101, 104, 109)))
    corners, sizes, types = extract_multilevel_cubes(m, min_level=min_level)
    grid = _rasterize(m.dims, corners, sizes, types)
    assert np.array_equal(grid, _probe_types(m, m.dims, min_level))


def test_paged_octree_scale_extraction_is_sparse():
    """A 32768^3 world must extract in O(allocated), far under 1e6 cubes,
    while still tiling the full virtual volume (the VERDICT 'octree-scale
    worlds are actually visualizable' requirement)."""
    m = PagedHierarchicalMap((32768, 32768, 32768), side_length=1.0)
    m.insert_point_cloud(_box_points((1024, 1024, 1024), (1040, 1040, 1040)))
    m.insert_point_cloud(_box_points((30000, 20000, 10000), (30004, 20004, 10004)))
    corners, sizes, types = extract_multilevel_cubes(m)
    assert len(sizes) < 1_000_000
    assert np.sum(sizes.astype(np.int64) ** 3) == 32768**3
    # the 16^3 aligned occupied box unifies into one level-4 cube
    occ = types == OCC
    assert np.any((sizes == 16) & occ)
    assert np.sum(sizes[occ].astype(np.int64) ** 3) == 16**3 + 4**3


def test_selection_filters_types():
    m = PagedHierarchicalMap((64, 64, 64), side_length=1.0)
    m.insert_point_cloud(_box_points((0, 0, 0), (8, 8, 8)))
    c_all, s_all, t_all = extract_multilevel_cubes(m)
    c_occ, s_occ, t_occ = extract_multilevel_cubes(m, free=False, unknown=False)
    assert set(np.unique(t_all)) >= {OCC, UNK}
    assert np.all(t_occ == OCC)
    assert np.sum(s_occ.astype(np.int64) ** 3) == np.sum(
        s_all[t_all == OCC].astype(np.int64) ** 3
    )


def test_max_cubes_keeps_coarsest():
    m = PagedHierarchicalMap((128, 128, 128), side_length=1.0)
    m.insert_point_cloud(_box_points((0, 0, 0), (3, 5, 7)))
    c, s, t = extract_multilevel_cubes(m, max_cubes=4)
    assert len(s) == 4
    full = extract_multilevel_cubes(m)
    assert s.min() >= np.sort(full[1])[-4:].min()


def test_provider_publishes_distance_gradient(tmp_path):
    """VisProvider adds a <name>.distance gradient layer for distance maps
    (the reference viewer's DistanceVoxel coloring, Visualizer.cu)."""
    import json

    from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap
    from gpu_voxels_jax.vis.provider import VisProvider

    m = DistanceVoxelMap.create((16, 16, 16), side_length=1.0)
    m = m.insert_point_cloud(np.array([[8.5, 8.5, 8.5]], np.float32))
    m = m.parallel_banding()
    vp = VisProvider("dmap", out_dir=tmp_path)
    assert vp.visualize(m)
    payload = json.loads((tmp_path / "dmap.distance.cubes.json").read_text())
    assert len(payload["centers"]) == 16 * 16  # one z plane
    assert len(payload["colors"]) == len(payload["values"]) == 16 * 16
    # the obstacle cell (distance 0) is red, far cells trend blue
    vals = payload["values"]
    cols = payload["colors"]
    i0 = vals.index(0.0)
    assert cols[i0] == [255, 0, 0]
    ifar = vals.index(max(vals))
    assert cols[ifar][2] > cols[ifar][0]
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert {"dmap", "dmap.distance"} <= set(manifest["maps"])


def test_distance_slice_extraction():
    from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap

    m = DistanceVoxelMap.create((8, 8, 8), side_length=2.0)
    m = m.insert_point_cloud(np.array([[3.0, 3.0, 9.0]], np.float32))  # voxel (1,1,4)
    m = m.parallel_banding()
    coords, dist = extract_distance_slice(m, axis="z", index=4)
    assert coords.shape == (64, 3) and np.all(coords[:, 2] == 4)
    at = {tuple(c): d for c, d in zip(map(tuple, coords), dist)}
    assert at[(1, 1, 4)] == 0.0
    assert at[(1, 4, 4)] == pytest.approx(3 * 2.0)
    assert at[(4, 5, 4)] == pytest.approx(5 * 2.0)
    # x-axis slices address the right plane too
    cx, dxv = extract_distance_slice(m, axis="x", index=1)
    ax = {tuple(c): d for c, d in zip(map(tuple, cx), dxv)}
    assert ax[(1, 1, 4)] == 0.0 and ax[(1, 1, 6)] == pytest.approx(2 * 2.0)
