"""Hierarchical map (octree replacement) tests."""
import numpy as np
import jax.numpy as jnp

from gpu_voxels_jax.constants import THRESHOLD_OCCUPANCY, UNKNOWN_PROBABILITY
from gpu_voxels_jax.maps.hierarchical import (
    NS_FREE,
    NS_OCCUPIED,
    NS_UNKNOWN,
    HierarchicalBitMap,
    HierarchicalProbMap,
)
from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list
from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap

DIMS = (32, 32, 32)


def test_fresh_map_is_all_unknown():
    h = HierarchicalProbMap.create(DIMS)
    occ, unk, free = h.probe(jnp.asarray([[0, 0, 0], [31, 31, 31]], jnp.int32))
    assert not bool(occ.any()) and bool(unk.all()) and not bool(free.any())
    # top node is uniform unknown -> probe decides at the very top
    assert int(np.asarray(h.pyramid[-1]).max()) == NS_UNKNOWN


def test_insert_builds_pyramid_and_probe_descends():
    pts = np.array([[5.5, 6.5, 7.5]], np.float32)
    h = HierarchicalProbMap.create(DIMS).insert_point_cloud(pts)
    occ, unk, free = h.probe(jnp.asarray([[5, 6, 7], [5, 6, 8]], jnp.int32))
    assert bool(occ[0]) and not bool(occ[1])
    assert bool(unk[1])
    # coarse query at min_level: the containing node is mixed -> status OR
    occ2, _, _ = h.probe(jnp.asarray([[5, 6, 7]], jnp.int32), min_level=3)
    assert bool(occ2[0])  # coarse node contains an occupied child


def test_free_space_carving_probabilistic():
    h = HierarchicalProbMap.create(DIMS)
    h = h.insert_point_cloud_with_free_space(
        np.array([[20.5, 10.5, 10.5]], np.float32), sensor_origin=(0.5, 10.5, 10.5)
    )
    occ = np.asarray(h.occupancy)  # [Z,Y,X]
    assert occ[10, 10, 20] == UNKNOWN_PROBABILITY + 72
    assert occ[10, 10, 5] == -127  # carved
    o, u, f = h.probe(jnp.asarray([[5, 10, 10]], jnp.int32))
    assert bool(f[0])


def test_collide_with_voxellist_and_probmap():
    pts = np.array([[4.5, 4.5, 4.5], [9.5, 9.5, 9.5]], np.float32)
    h = HierarchicalProbMap.create(DIMS).insert_point_cloud(pts)
    lst = bit_vector_voxel_list(DIMS).insert_point_cloud(pts[:1], 50)
    assert int(h.collide_with(lst)) == 1
    pm = ProbVoxelMap.create(DIMS).insert_point_cloud(pts)
    assert int(h.collide_with(pm)) == 2
    # prob map probe threshold is the hardcoded >=50 (kernel_common.h:172-183)
    weak = ProbVoxelMap.create(DIMS)
    from dataclasses import replace
    weak = replace(weak, data=weak.data.at[0].set(jnp.int8(40)))
    assert int(h.collide_with(weak)) == 0


def test_unknown_cell_counting():
    pts = np.array([[4.5, 4.5, 4.5]], np.float32)
    h = HierarchicalProbMap.create(DIMS).insert_point_cloud(pts)
    probe_pts = np.array([[4.5, 4.5, 4.5], [20.5, 20.5, 20.5]], np.float32)
    lst = bit_vector_voxel_list(DIMS).insert_point_cloud(probe_pts, 50)
    colls, unknowns = h.collide_with_counting_unknown(lst)
    assert int(colls) == 1
    assert int(unknowns) == 1


def test_bit_hierarchical_variant():
    pts = np.array([[4.5, 4.5, 4.5]], np.float32)
    h = HierarchicalBitMap.create(DIMS).insert_point_cloud(pts)
    occ, _, _ = h.probe(jnp.asarray([[4, 4, 4]], jnp.int32))
    assert bool(occ[0])
    coords = h.extract_occupied_coords()
    assert coords.tolist() == [[4, 4, 4]]


def test_non_pow2_dims_are_padded():
    h = HierarchicalProbMap.create((20, 24, 12))
    assert all(p % (1 << h.levels) == 0 for p in h.padded_dims)
    pts = np.array([[19.5, 23.5, 11.5]], np.float32)
    h = h.insert_point_cloud(pts)
    occ, _, _ = h.probe(jnp.asarray([[19, 23, 11]], jnp.int32))
    assert bool(occ[0])


def test_collide_with_bit_map_uses_iszero():
    """GvlNTree probes bit maps with !isZero, not noneButEmpty
    (kernel_common.h:172-183): a FREE-only bit voxel still counts."""
    from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap

    pts = np.array([[4.5, 4.5, 4.5]], np.float32)
    h = HierarchicalProbMap.create(DIMS).insert_point_cloud(pts)
    bm_free = BitVectorVoxelMap.create(DIMS).insert_point_cloud(pts, 0)  # eBVM_FREE
    assert int(h.collide_with(bm_free)) == 1  # !isZero includes bit 0
    bm_empty = BitVectorVoxelMap.create(DIMS)
    assert int(h.collide_with(bm_empty)) == 0


def test_min_level_coarse_probe():
    pts = np.array([[8.5, 8.5, 8.5]], np.float32)
    h = HierarchicalProbMap.create(DIMS).insert_point_cloud(pts)
    # probing the far corner of the same level-3 node at min_level=3:
    # node [8..15]^3 contains an occupied child -> OR status includes OCCUPIED
    occ, _, _ = h.probe(jnp.asarray([[15, 15, 15]], jnp.int32), min_level=3)
    assert bool(occ[0])
    occ, _, _ = h.probe(jnp.asarray([[15, 15, 15]], jnp.int32), min_level=0)
    assert not bool(occ[0])


def test_hierarchical_x_hierarchical_collide():
    a_pts = np.array([[4.5, 4.5, 4.5], [9.5, 9.5, 9.5]], np.float32)
    b_pts = np.array([[4.5, 4.5, 4.5], [20.5, 20.5, 20.5]], np.float32)
    ha = HierarchicalProbMap.create(DIMS).insert_point_cloud(a_pts)
    hb = HierarchicalProbMap.create(DIMS).insert_point_cloud(b_pts)
    assert int(ha.collide_with_hierarchical(hb)) == 1
    # coarse-level pairs: both have an occupied child inside node (0,0,0)@L3
    assert int(ha.collide_with_hierarchical(hb, min_level=3)) >= 1


def test_hierarchical_projective_sensor():
    from gpu_voxels_jax.sensors import Sensor

    sensor = Sensor(
        position=np.array([0.5, 16.0, 16.0], np.float32),
        orientation_rpy=np.array([0.0, np.pi / 2, 0.0], np.float32),  # +z -> +x? checked below
        data_width=8, data_height=8, fx=6.0, fy=6.0, cx=4.0, cy=4.0,
    )
    # simpler: identity orientation looking along +z of world
    sensor = Sensor(position=np.array([16.0, 16.0, 0.5], np.float32),
                    data_width=8, data_height=8, fx=6.0, fy=6.0, cx=4.0, cy=4.0)
    depth = np.full((8, 8), 10.0, np.float32)
    h = HierarchicalProbMap.create(DIMS)
    for _ in range(2):  # push hits over the occupancy threshold
        h = h.insert_depth_image(depth, sensor)
    occ, unk, free = h.probe(jnp.asarray([[16, 16, 10], [16, 16, 5]], jnp.int32))
    assert bool(occ[0]) and bool(free[1])


def test_deterministic_hard_statuses_diverge_from_probabilistic():
    """The deterministic tier writes hard statuses (kernel_common.h:219-223):
    carving through an occupied cell frees it outright, while the
    probabilistic tier's log-odds keep it occupied (+72 - 10 = 62 >= 10)."""
    hit = np.array([[10.5, 10.5, 10.5]], np.float32)
    beyond = np.array([[20.5, 10.5, 10.5]], np.float32)
    origin = (0.5, 10.5, 10.5)

    hp = HierarchicalProbMap.create(DIMS)
    for _ in range(3):  # -128 + 3*72 = 88 >= THRESHOLD_OCCUPANCY
        hp = hp.insert_point_cloud_with_free_space(hit, origin)
    hp = hp.insert_point_cloud_with_free_space(beyond, origin)  # ray crosses (10,10,10)
    occ_p, _, free_p = hp.probe(jnp.asarray([[10, 10, 10]], jnp.int32))
    assert bool(occ_p[0]) and not bool(free_p[0])  # log-odds stay occupied (78)

    hd = HierarchicalBitMap.create(DIMS)
    for _ in range(3):
        hd = hd.insert_point_cloud_with_free_space(hit, origin)
    hd = hd.insert_point_cloud_with_free_space(beyond, origin)
    occ_d, _, free_d = hd.probe(jnp.asarray([[10, 10, 10]], jnp.int32))
    assert not bool(occ_d[0]) and bool(free_d[0])  # hard FREE overwrote OCCUPIED


def test_deterministic_static_dynamic_flags_propagate():
    """ns_STATIC_MAP/ns_DYNAMIC_MAP tags (Nodes.h:50-57) OR up the pyramid
    (getNewStatus, Nodes.h:78) and ride along with probed statuses."""
    from gpu_voxels_jax.maps.hierarchical import NS_DYNAMIC_MAP, NS_STATIC_MAP

    env = np.array([[4.5, 4.5, 4.5]], np.float32)
    sensor_pt = np.array([[20.5, 20.5, 20.5]], np.float32)
    h = HierarchicalBitMap.create(DIMS).insert_point_cloud(env, static_map=True)
    h = h.insert_point_cloud(sensor_pt, static_map=False)

    s_env = np.asarray(h.probe_status(jnp.asarray([[4, 4, 4]], jnp.int32)))[0]
    s_dyn = np.asarray(h.probe_status(jnp.asarray([[20, 20, 20]], jnp.int32)))[0]
    assert s_env & NS_STATIC_MAP and not s_env & NS_DYNAMIC_MAP
    assert s_dyn & NS_DYNAMIC_MAP and not s_dyn & NS_STATIC_MAP
    # both flags reach the root by OR-propagation
    top = int(np.asarray(h.pyramid[-1]).reshape(-1)[0])
    assert top & NS_STATIC_MAP and top & NS_DYNAMIC_MAP


def test_deterministic_free_insert_and_reoccupy():
    """eBVM_FREE inserts mark cells hard-free; a later occupied insert flips
    them back in one shot (no accumulation)."""
    pts = np.array([[6.5, 6.5, 6.5]], np.float32)
    h = HierarchicalBitMap.create(DIMS).insert_point_cloud(pts, meaning=0)  # eBVM_FREE
    _, _, free = h.probe(jnp.asarray([[6, 6, 6]], jnp.int32))
    assert bool(free[0])
    h = h.insert_point_cloud(pts)  # one occupied insert suffices
    occ, _, _ = h.probe(jnp.asarray([[6, 6, 6]], jnp.int32))
    assert bool(occ[0])


def test_collide_with_morton_list_past_1024():
    """Morton lists carry 60-bit (hi,lo) ids: hierarchical collide must
    decode the high word, not alias coords mod 1024 (octree/Morton.h:80-160).
    Regression: _query_coords_of dropped ids_hi."""
    from gpu_voxels_jax.maps.hierarchical import HierarchicalProbMap
    from gpu_voxels_jax.maps.voxellist import VoxelList

    dims = (2048, 64, 64)
    h = HierarchicalProbMap.create(dims)
    h = h.insert_point_cloud(np.array([[2000.5, 30.5, 40.5]], np.float32))
    lst = VoxelList.create(dims, 1.0, kind="bit", capacity=8, id_mode="morton")
    lst = lst.insert_point_cloud(np.array([[2000.5, 30.5, 40.5]], np.float32))
    assert int(h.collide_with(lst)) == 1
    # the mod-1024 alias must NOT collide
    h2 = HierarchicalProbMap.create(dims)
    h2 = h2.insert_point_cloud(np.array([[976.5, 30.5, 40.5]], np.float32))
    assert int(h2.collide_with(lst)) == 0


def test_bitmap_tier_save_load_and_camelcase(tmp_path):
    """HierarchicalBitMap (deterministic tier) keeps the facade save/load
    dispatch and the reference-spelled aliases after losing its
    HierarchicalProbMap parentage. Regression: isinstance dispatch and
    compat.install() both missed it."""
    from gpu_voxels_jax.api import GpuVoxels
    from gpu_voxels_jax.constants import MapType
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap

    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(128, 128, 128, 1.0)
    m = gvl.add_map(MapType.MT_BITVECTOR_OCTREE, "det")
    assert isinstance(m, HierarchicalBitMap)
    # camelCase alias installed
    gvl.insert_point_cloud_into_map(np.array([[5.5, 6.5, 7.5]], np.float32), "det")
    m = gvl.get_map("det")
    assert hasattr(m, "insertPointCloud") and hasattr(m, "collideWith")
    path = tmp_path / "det.bin"
    assert gvl.save_map("det", path)
    assert gvl.load_map("det", path)
    m2 = gvl.get_map("det")
    assert isinstance(m2, HierarchicalBitMap)
    occ, _, _ = m2.probe(jnp.asarray([[5, 6, 7]], jnp.int32))
    assert bool(occ[0])
    GpuVoxels._instance = None


def test_hierarchy_collide_offset_forwarded():
    """The reference forwards offset into intersect_sparse on every octree
    collide (GvlNTree.hpp:195): probe self at other's coords + offset."""
    h = HierarchicalBitMap.create(DIMS).insert_point_cloud(
        np.array([[10.5, 10.5, 10.5]], np.float32)
    )
    lst = bit_vector_voxel_list(DIMS).insert_point_cloud(
        np.array([[7.5, 12.5, 10.5]], np.float32), 50
    )
    assert int(h.collide_with(lst)) == 0
    assert int(h.collide_with(lst, offset=(3, -2, 0))) == 1
    assert int(h.collide_with_resolution(lst, resolution_level=0, offset=(3, -2, 0))) == 1
    # translated coords leaving the map never hit
    assert int(h.collide_with(lst, offset=(100, 0, 0))) == 0
    occ, unk = h.collide_with_counting_unknown(lst, offset=(3, -2, 0))
    assert (int(occ), int(unk)) == (1, 0)
    # list->octree dispatch direction (CollisionInterfaces.h:231-243)
    assert int(lst.collide_with(h, offset=(3, -2, 0))) == 1

    dense = ProbVoxelMap.create(DIMS).insert_point_cloud(
        np.array([[7.5, 12.5, 10.5]], np.float32)
    )
    assert int(h.collide_with(dense, offset=(3, -2, 0))) == 1
    assert int(h.collide_with(dense)) == 0


def test_build_with_free_bounding_box_and_maintenance_contract():
    """NTree::build (NTree.hpp:385-540) + free_bounding_box (NTree.h:127):
    the AABB of the built points reads FREE, the points OCCUPIED, space
    outside the box stays UNKNOWN; checkTree/needsRebuild/rebuild/
    clearCollisionFlags round out the NTree maintenance contract."""
    pts = np.array([[2.5, 2.5, 2.5], [5.5, 5.5, 5.5]], np.float32)
    for cls in (HierarchicalBitMap, HierarchicalProbMap):
        m = cls.create((16, 16, 16), 1.0).build(pts, free_bounding_box=True)
        occ, unk, free = m.probe(jnp.array([[2, 2, 2], [4, 4, 4], [10, 10, 10]]))
        assert bool(occ[0]) and not bool(free[0])
        assert bool(free[1]) and not bool(occ[1]) and not bool(unk[1])
        assert bool(unk[2])
        assert m.check_tree()
        assert not m.needs_rebuild()
        assert m.rebuild() is m and m.clear_collision_flags() is m
    # without the flag the box interior stays unknown
    m = HierarchicalBitMap.create((16, 16, 16), 1.0).build(pts)
    _, unk, _ = m.probe(jnp.array([[4, 4, 4]]))
    assert bool(unk[0])


def test_octree_adapter_contract_methods():
    """GpuVoxelsMap contract on the octree adapters: insertMetaPointCloud
    degrades per-subcloud meanings to the first one (GvlNTree.hpp:437-453),
    clearBitVoxelMeaning only honors eBVM_OCCUPIED (GvlNTree.hpp:487-494),
    insertRobotConfiguration reports self-collisions."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud

    link = np.array([[2.5, 2.5, 2.5]], np.float32)
    meta = MetaPointCloud.from_clouds([link, link + 2.0])
    clashing = MetaPointCloud.from_clouds([link, link])
    for cls in (HierarchicalBitMap, HierarchicalProbMap):
        m = cls.create((16, 16, 16), 1.0)
        m2 = m.insert_meta_point_cloud(meta, meanings=[1, 1])
        occ, _, _ = m2.probe(jnp.array([[2, 2, 2], [4, 4, 4]]))
        assert bool(occ[0]) and bool(occ[1])
        _, ok = m.insert_robot_configuration(meta, with_self_collision_test=True)
        assert bool(ok)
        _, bad = m.insert_robot_configuration(clashing, with_self_collision_test=True)
        assert not bool(bad)
        unchanged = m2.clear_voxel_meaning(5)
        occ3, _, _ = unchanged.probe(jnp.array([[2, 2, 2]]))
        assert bool(occ3[0])
        wiped = m2.clear_voxel_meaning(1)  # eBVM_OCCUPIED
        _, unk, _ = wiped.probe(jnp.array([[2, 2, 2]]))
        assert bool(unk[0])
