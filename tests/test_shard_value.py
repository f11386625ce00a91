"""First-class sharding of EXISTING maps (parallel/shard_value.py).

These tests shard PRE-EXISTING single-device map values over the virtual
8-device CPU mesh (tests/conftest.py) and assert that the maps' ordinary
public ops — insert, collide_with, collide_with_types, bitcheck, probe —
produce bit-identical results while the bulk arrays are genuinely
distributed (per-shard shapes asserted; silent replication fails).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_voxels_jax.constants import BitVoxelMeaning, MapType
from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap
from gpu_voxels_jax.parallel import assert_sharded, make_grid_mesh, shard_map_value

DIMS = (16, 16, 32)


def _mesh(n=8):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    return make_grid_mesh(n)


def _cloud(lo, hi):
    rngs = [np.arange(lo, hi) + 0.5] * 3
    g = np.meshgrid(*rngs, indexing="ij")
    return np.stack(g, axis=-1).reshape(-1, 3).astype(np.float32)


def test_prob_map_sharded_ops_match_single_device():
    mesh = _mesh()
    a = ProbVoxelMap.create(DIMS).insert_point_cloud(_cloud(2, 12))
    b = ProbVoxelMap.create(DIMS).insert_point_cloud(_cloud(6, 14))
    sa, sb = shard_map_value(a, mesh), shard_map_value(b, mesh)
    assert_sharded(sa, mesh)
    assert_sharded(sb, mesh)
    assert int(sa.collide_with(sb, 0.5)) == int(a.collide_with(b, 0.5)) == 6**3
    # inserting THROUGH the sharded value stays correct and distributed
    sa2 = sa.insert_point_cloud(_cloud(0, 4))
    a2 = a.insert_point_cloud(_cloud(0, 4))
    assert int(sa2.collide_with(sb, 0.5)) == int(a2.collide_with(b, 0.5))
    np.testing.assert_array_equal(np.asarray(sa2.data), np.asarray(a2.data))


def test_bit_map_sharded_types_and_bitcheck_match():
    mesh = _mesh()
    a = BitVectorVoxelMap.create(DIMS).insert_point_cloud(_cloud(2, 12), meaning=7)
    a = a.insert_point_cloud(_cloud(3, 6), meaning=40)
    b = BitVectorVoxelMap.create(DIMS).insert_point_cloud(_cloud(5, 14), meaning=7)
    b = b.insert_point_cloud(_cloud(5, 8), meaning=9)
    sa, sb = shard_map_value(a, mesh), shard_map_value(b, mesh)
    assert_sharded(sa, mesh)
    cnt_s, meanings_s, marked_s = sa.collide_with_types(sb)
    cnt_1, meanings_1, marked_1 = a.collide_with_types(b)
    assert int(cnt_s) == int(cnt_1) > 0
    np.testing.assert_array_equal(np.asarray(meanings_s), np.asarray(meanings_1))
    np.testing.assert_array_equal(np.asarray(marked_s.data), np.asarray(marked_1.data))
    assert int(sa.collide_with_bitcheck(sb, margin=2)) == int(
        a.collide_with_bitcheck(b, margin=2)
    )
    assert int(sa.collide_with(sb)) == int(a.collide_with(b))


def test_counting_map_sharded():
    mesh = _mesh()
    m = CountingVoxelMap.create(DIMS).insert_point_cloud(
        np.repeat(_cloud(1, 9), 3, axis=0)
    )
    sm = shard_map_value(m, mesh)
    assert_sharded(sm, mesh)
    np.testing.assert_array_equal(np.asarray(sm.data), np.asarray(m.data))


def test_hierarchical_sharded_probe_matches():
    mesh = _mesh()
    for cls in (HierarchicalBitMap, HierarchicalProbMap):
        m = cls.create(DIMS).insert_point_cloud(_cloud(4, 12))
        sm = shard_map_value(m, mesh)
        assert_sharded(sm, mesh)
        qs = jnp.asarray(
            np.random.default_rng(0).integers(0, 16, (256, 3)).astype(np.int32)
        )
        occ_s, unk_s, free_s = sm.probe(qs)
        occ_1, unk_1, free_1 = m.probe(qs)
        for s, o in ((occ_s, occ_1), (unk_s, unk_1), (free_s, free_1)):
            np.testing.assert_array_equal(np.asarray(s), np.asarray(o))


def test_assert_sharded_catches_replication():
    mesh = _mesh()
    m = ProbVoxelMap.create(DIMS)  # plain single-device value
    with pytest.raises(AssertionError):
        assert_sharded(m, mesh)


def test_dimz_must_divide_mesh():
    mesh = _mesh()
    m = ProbVoxelMap.create((16, 16, 12))  # 12 % 8 != 0
    with pytest.raises(ValueError):
        shard_map_value(m, mesh)


def test_facade_mesh_opt_in():
    """add_map(..., mesh=) keeps the named map distributed through facade
    updates (insert via update_map re-pins the layout)."""
    from gpu_voxels_jax.api import GpuVoxels

    mesh = _mesh()
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(16, 16, 32, 1.0)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "shardedA", mesh=mesh)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "plainB")
    gvl.insert_point_cloud_into_map(_cloud(2, 12), "shardedA", BitVoxelMeaning.eBVM_OCCUPIED)
    gvl.insert_point_cloud_into_map(_cloud(6, 14), "plainB", BitVoxelMeaning.eBVM_OCCUPIED)
    assert_sharded(gvl.get_map("shardedA"), mesh)
    assert int(gvl.get_map("shardedA").collide_with(gvl.get_map("plainB"), 0.5)) == 6**3
    gvl.clear_map("shardedA")
    assert_sharded(gvl.get_map("shardedA"), mesh)
    assert int(gvl.get_map("shardedA").collide_with(gvl.get_map("plainB"), 0.5)) == 0
