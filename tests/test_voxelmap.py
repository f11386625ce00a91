"""Dense voxel map tests — ports of reference test/testing_voxelmap.cu oracles."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpu_voxels_jax import bitops
from gpu_voxels_jax.constants import BitVoxelMeaning, SV_START
from gpu_voxels_jax.geometry import generation
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap
from gpu_voxels_jax.ops import insert as insert_ops

DIMS = (89, 123, 74)  # reference test default dims


def test_addressing_scheme():
    """testing_voxelmap.cu 'addressing' + getVoxelIndexSigned oracle."""
    sdim = (5, 5, 5)
    assert insert_ops.linear_offset((-1, -2, 3), sdim) == 64
    assert insert_ops.linear_offset((1, 2, -3), sdim) == -64
    # from the reference test: offset (-1,-2,3) with dims... ground_truth 689
    # uses dims (dimX,dimY,dimZ); check formula directly:
    assert insert_ops.linear_offset((-1, -2, 3), (16, 16, 16)) == 3 * 256 - 2 * 16 - 1


def test_collision_all_points():
    """testing_voxelmap.cu:95-115: insert same cloud in two maps -> all collide."""
    pts = generation.create_equidistant_points_in_box(10000, DIMS, 1.0)
    m1 = ProbVoxelMap.create(DIMS).insert_point_cloud(pts)
    m2 = ProbVoxelMap.create(DIMS).insert_point_cloud(pts)
    assert int(m1.collide_with(m2, 0.1)) == 10000


def test_collision_with_offset():
    """testing_voxelmap.cu:118-143: two 3x3x3 boxes overlapping in 8 voxels."""
    p1 = generation.create_box_of_points((2.1, 2.1, 2.1), (4.1, 4.1, 4.1), 0.5)
    p2 = generation.create_box_of_points((3.1, 3.1, 3.1), (5.1, 5.1, 5.1), 0.5)
    m1 = ProbVoxelMap.create(DIMS).insert_point_cloud(p1)
    m2 = ProbVoxelMap.create(DIMS).insert_point_cloud(p2)
    assert int(m1.collide_with(m2, 0.1)) == 8
    assert int(m1.collide_with(m2, 0.1, (-1, 0, -1))) == 18
    assert int(m2.collide_with(m1, 0.1, (1, 0, 1))) == 18


def test_no_collision():
    b, w = generation.create_non_overlapping_3d_checkerboard(5000, (33, 33, 33), 1.0)
    m1 = ProbVoxelMap.create((33, 33, 33)).insert_point_cloud(b)
    m2 = ProbVoxelMap.create((33, 33, 33)).insert_point_cloud(w)
    assert int(m1.collide_with(m2, 0.1)) == 0


def test_gvl_linkage_scene():
    """example_how_to_link/gvl_linkage_test_lib.cpp:20-38 numeric contract."""
    side = 0.01
    dims = (150, 150, 150)
    c1, c2 = (0.4, 0.4, 0.4), (0.8, 0.8, 0.8)
    c4, c3 = (0.2, 0.2, 0.2), (0.6, 0.6, 0.6)
    delta = side / 1
    b1 = generation.create_box_of_points(c1, c2, delta)
    b2 = generation.create_box_of_points(c4, c3, delta)
    m1 = ProbVoxelMap.create(dims, side).insert_point_cloud(b1)
    m2 = ProbVoxelMap.create(dims, side).insert_point_cloud(b2)
    got = int(m1.collide_with(m2))  # default threshold 1.0 -> 127/127? no:
    # reference default collideWith() uses DefaultCollider() thresholds 100/100

    # independent numpy oracle
    def vox(pts):
        return set(map(tuple, np.floor(pts / side).astype(int)))
    expect = len(vox(b1) & vox(b2))
    assert got == expect
    assert expect > 0


def test_collide_with_marking_sets_collision():
    pts = generation.create_box_of_points((1.1, 1.1, 1.1), (2.1, 2.1, 2.1), 1.0)
    m1 = ProbVoxelMap.create((8, 8, 8)).insert_point_cloud(pts)
    m2 = ProbVoxelMap.create((8, 8, 8)).insert_point_cloud(pts)
    cnt, marked = m1.collide_with_marking(m2, 0.1)
    assert int(cnt) == 8
    # colliding voxels forced to MAX_PROBABILITY
    occ = np.asarray(marked.data)
    assert (occ == 127).sum() == 8


def test_bitmap_insert_and_collide():
    pts = np.array([[2, 2, 2], [3, 3, 3]], np.float32) + 0.5
    m1 = BitVectorVoxelMap.create((8, 8, 8)).insert_point_cloud(pts, BitVoxelMeaning.eBVM_OCCUPIED)
    m2 = BitVectorVoxelMap.create((8, 8, 8)).insert_point_cloud(pts, 77)
    assert int(m1.collide_with(m2)) == 2
    # eBVM_FREE-only voxels don't count as occupied
    m3 = BitVectorVoxelMap.create((8, 8, 8)).insert_point_cloud(pts, BitVoxelMeaning.eBVM_FREE)
    assert int(m1.collide_with(m3)) == 0


def test_bitmap_collide_prob():
    pts = np.array([[2, 2, 2], [3, 3, 3]], np.float32) + 0.5
    bm = BitVectorVoxelMap.create((8, 8, 8)).insert_point_cloud(pts, 50)
    pm = ProbVoxelMap.create((8, 8, 8)).insert_point_cloud(pts[:1])
    assert int(bm.collide_with(pm, 0.5)) == 1
    assert int(pm.collide_with(bm, 0.5)) == 1


def test_collision_bitshift_windowed():
    """testing_voxelmap.cu collision_bitshift: windowed SV collider sweep."""
    points = generation.create_box_of_points((2, 2, 2), (3, 3, 3), 1.0)
    assert len(points) == 8
    type_1 = SV_START + 40  # bit 44
    window = 20
    m1 = BitVectorVoxelMap.create((8, 8, 8)).insert_point_cloud(points, type_1)
    for i in range(type_1 - window - 9, type_1 + window + 10):
        m2 = BitVectorVoxelMap.create((8, 8, 8)).insert_point_cloud(points, i)
        cnt, meanings, _ = m1.collide_with_types(m2, 1.0, sv_window=window)
        if i < type_1 - window or i > type_1 + window:
            assert int(cnt) == 0, f"meaning {i}"
        else:
            assert int(cnt) == 8, f"meaning {i}"
            rec = bitops.clear_bit(meanings, type_1)
            assert bool(bitops.is_zero(rec)), f"extra meanings at {i}"


def test_bitvoxelmap_bitshift():
    """testing_voxelmap.cu bitvoxelmap_bitshift: shift map bits, then collide."""
    points = np.array([[0.3] * 3, [1.3] * 3, [2.3] * 3, [3.3] * 3], np.float32)
    shift_start = 50
    type_int = SV_START + shift_start  # 54
    for shift_size in range(0, 49, 7):
        m2 = BitVectorVoxelMap.create((8, 8, 8)).insert_point_cloud(points, type_int)
        m1 = BitVectorVoxelMap.create((8, 8, 8)).insert_point_cloud(points, type_int - shift_size)
        m2 = m2.shift_left_swept_volume_ids(shift_size)
        cnt, _, _ = m1.collide_with_types(m2, 1.0, sv_window=1)
        assert int(cnt) == 4, f"shift {shift_size}"


def test_clear_bit_and_meaning():
    pts = np.array([[1.5, 1.5, 1.5]], np.float32)
    m = BitVectorVoxelMap.create((4, 4, 4)).insert_point_cloud(pts, 7)
    m = m.insert_point_cloud(pts, 200)
    assert int(m.collide_with(m)) == 1
    m = m.clear_voxel_meaning(7)
    assert not bool(jnp.any(m.get_bit_mask(7)))
    assert bool(jnp.any(m.get_bit_mask(200)))


def test_merge_maps():
    pts1 = np.array([[0.5, 0.5, 0.5]], np.float32)
    pts2 = np.array([[1.5, 1.5, 1.5]], np.float32)
    a = BitVectorVoxelMap.create((4, 4, 4)).insert_point_cloud(pts1, 10)
    b = BitVectorVoxelMap.create((4, 4, 4)).insert_point_cloud(pts2, 11)
    merged = a.merge(b)
    assert int(merged.collide_with(merged)) == 2
    remean = a.merge(b, new_meaning=99)
    assert bool(jnp.any(remean.get_bit_mask(99)))
    assert not bool(jnp.any(remean.get_bit_mask(11)))

    # prob merge follows ProbabilisticVoxel::reduce: occupancy adds with
    # saturation (unknown contributes nothing), so 127 merged into an
    # UNKNOWN (-128) voxel yields -1. (Dense-map merge is an extension; the
    # reference's TemplateVoxelMap::merge is NOT_YET_SUPPORTED.)
    p1 = ProbVoxelMap.create((4, 4, 4)).insert_point_cloud(pts1)
    p2 = ProbVoxelMap.create((4, 4, 4)).insert_point_cloud(pts2)
    pm = p1.merge(p2)
    d = np.asarray(pm.as_3d())
    assert d[0, 0, 0] == 127 and d[1, 1, 1] == -1
    assert int(pm.collide_with(pm, 0.5)) == 1


def test_counting_map():
    pts = np.array([[1.5, 1.5, 1.5]] * 5 + [[2.5, 2.5, 2.5]], np.float32)
    c = CountingVoxelMap.create((4, 4, 4)).insert_point_cloud(pts)
    data = np.asarray(c.as_3d())
    assert data[1, 1, 1] == 5 and data[2, 2, 2] == 1
    assert int(c.occupied_mask(threshold=3).sum()) == 1


def test_out_of_bounds_points_dropped():
    pts = np.array([[100, 0, 0], [-1, 0, 0], [1.5, 1.5, 1.5]], np.float32)
    m = ProbVoxelMap.create((4, 4, 4)).insert_point_cloud(pts)
    assert int(m.occupied_mask().sum()) == 1
    idx, outside = insert_ops.voxelize(jnp.asarray(pts), 1.0, (4, 4, 4))
    assert bool(outside)


def test_whole_cycle_is_jittable():
    """The headline property: sense->insert->collide fuses into one program."""
    dims = (32, 32, 32)

    @jax.jit
    def cycle(points_a, points_b):
        m1 = ProbVoxelMap.create(dims).insert_point_cloud(points_a)
        m2 = ProbVoxelMap.create(dims).insert_point_cloud(points_b)
        return m1.collide_with(m2, 0.1)

    p1 = generation.create_box_of_points((2.1,) * 3, (4.1,) * 3, 0.5)
    p2 = generation.create_box_of_points((3.1,) * 3, (5.1,) * 3, 0.5)
    assert int(cycle(jnp.asarray(p1), jnp.asarray(p2))) == 8


def test_collide_with_resolution_dense():
    """collideWithResolution (CollisionInterfaces.h:37-127): OR-pooled coarse
    collide; level 0 equals the fine count, each level halves resolution."""
    dims = (16, 16, 16)
    a = ProbVoxelMap.create(dims)
    b = ProbVoxelMap.create(dims)
    # a occupies voxel (0,0,0); b occupies voxel (1,1,1): disjoint at level 0,
    # same 2^1 coarse cell at level 1
    a = a.insert_point_cloud(np.array([[0.5, 0.5, 0.5]], np.float32))
    b = b.insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32))
    assert int(a.collide_with_resolution(b, resolution_level=0)) == 0
    assert int(a.collide_with_resolution(b, resolution_level=1)) == 1
    assert int(a.collide_with_resolution(b, resolution_level=4)) == 1
    # level 0 count matches collide_with for an overlapping block
    pts = generation.create_box_of_points((2, 2, 2), (8, 8, 8), 0.9)
    a2 = ProbVoxelMap.create(dims).insert_point_cloud(pts)
    b2 = ProbVoxelMap.create(dims).insert_point_cloud(pts)
    assert int(a2.collide_with_resolution(b2, resolution_level=0)) == int(a2.collide_with(b2))
    # offset samples left[i+off]: off=(-1,-1,-1) aligns a's (0,0,0) with b's (1,1,1)
    assert int(a.collide_with_resolution(b, resolution_level=0, offset=(-1, -1, -1))) == 1
    # bit x prob and bit x bit variants agree
    ab = BitVectorVoxelMap.create(dims).insert_point_cloud(np.array([[0.5, 0.5, 0.5]], np.float32))
    bb = BitVectorVoxelMap.create(dims).insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32))
    assert int(ab.collide_with_resolution(bb, resolution_level=1)) == 1
    assert int(ab.collide_with_resolution(b, resolution_level=1)) == 1
    assert int(a.collide_with_resolution(bb, resolution_level=1)) == 1


def _assert_occ_coherent(m, where=""):
    expect = np.asarray(bitops.occupied(m.data)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(m.occ), expect, err_msg=where)


def test_occupancy_summary_stays_coherent():
    """The maintained occ summary (uint8[N] !noneButEmpty) must match the
    plane fold after every mutating operation, and the summary fast-path
    collide counts must equal the fold-path counts."""
    from gpu_voxels_jax.ops import collide as collide_ops

    dims = (16, 16, 16)
    rng = np.random.default_rng(9)
    pts_a = rng.uniform(0, 16, (200, 3)).astype(np.float32)
    pts_b = rng.uniform(0, 16, (200, 3)).astype(np.float32)

    m = BitVectorVoxelMap.create(dims)
    _assert_occ_coherent(m, "create")
    m = m.insert_point_cloud(pts_a)
    _assert_occ_coherent(m, "insert occupied")
    m = m.insert_point_cloud(pts_b[:50], BitVoxelMeaning.eBVM_FREE)
    _assert_occ_coherent(m, "insert eBVM_FREE (bit 0 must not mark occ)")
    m = m.insert_point_cloud(pts_b, 35)  # plane 1
    _assert_occ_coherent(m, "insert plane-1 meaning")
    m = m.shift_left_swept_volume_ids(4)
    _assert_occ_coherent(m, "shift_left_swept_volume_ids")
    m = m.clear_bit(35)
    _assert_occ_coherent(m, "clear_bit")
    other = BitVectorVoxelMap.create(dims).insert_point_cloud(pts_b, 7)
    m2 = m.merge(other)
    _assert_occ_coherent(m2, "merge")
    m3 = m.merge(other, new_meaning=9)
    _assert_occ_coherent(m3, "merge with new_meaning")
    m4 = m.merge(other, new_meaning=BitVoxelMeaning.eBVM_FREE)
    _assert_occ_coherent(m4, "merge re-meaned to eBVM_FREE")
    cnt, _, marked = m2.collide_with_types(other)
    _assert_occ_coherent(marked, "collide_with_types marking")

    # summary fast path == fold path, incl. offsets
    for off in ((0, 0, 0), (1, -2, 3)):
        fast = int(m2.collide_with(other, offset=off))
        slow = int(collide_ops.count_bit_bit(m2.data, other.data, dims, off))
        assert fast == slow, off
    # bit x prob both directions: summary path == plane-fold path
    from gpu_voxels_jax.constants import float_to_probability

    pm = ProbVoxelMap.create(dims).insert_point_cloud(pts_a)
    t = float_to_probability(0.5)
    expect_pb = int(collide_ops.count_prob_bit(pm.data, t, m2.data, dims))
    assert int(pm.collide_with(m2, 0.5)) == expect_pb
    assert int(m2.collide_with(pm, 0.5)) == expect_pb


def test_occupancy_summary_none_fallback():
    """Hand-constructed maps (occ=None) keep working through the fold path
    and propagate None."""
    dims = (8, 8, 8)
    rng = np.random.default_rng(3)
    planes = jnp.asarray(
        rng.integers(0, 2 ** 32, (8, 512), dtype=np.uint64).astype(np.uint32)
    )
    raw = BitVectorVoxelMap(planes, dims, 1.0)
    assert raw.occ is None
    counted = int(raw.collide_with(raw))
    expect = int(np.asarray(bitops.occupied(planes)).sum())
    assert counted == expect
    assert raw.clear_bit(3).occ is None
    # from_planes computes the summary for raw planes
    wrapped = BitVectorVoxelMap.from_planes(planes, dims, 1.0)
    _assert_occ_coherent(wrapped, "from_planes")
    assert int(wrapped.collide_with(wrapped)) == expect


def test_occupancy_summary_swept_volume_batched():
    from gpu_voxels_jax.robot.swept_volume import insert_swept_volume_batched

    dims = (16, 16, 16)

    class _Trans:
        def transformed_clouds_for(self, cfg):
            class _C:
                points = jnp.asarray([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]) + cfg[0]

            return _C()

    m = insert_swept_volume_batched(
        BitVectorVoxelMap.create(dims), _Trans(), np.arange(6, dtype=np.float32)[:, None]
    )
    _assert_occ_coherent(m, "swept volume batched")
    assert int(np.asarray(m.occ).sum()) > 0


def test_dense_bitcheck_routes_through_types_kernel():
    """collide_with_bitcheck (count-only margin window) equals the packed
    margin oracle's hit count, and the window semantics hold."""
    dims = (8, 8, 24)
    a = BitVectorVoxelMap.create(dims).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5], [3.5, 2.5, 1.5]], np.float32), SV_START + 4
    )
    b = BitVectorVoxelMap.create(dims).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5], [5.5, 5.5, 5.5]], np.float32), SV_START + 6
    )
    for margin in (0, 1, 2, 4):
        got = int(a.collide_with_bitcheck(b, margin=margin))
        hit, _ = bitops.bit_margin_collision_check_packed(a.data, b.data, margin)
        assert got == int(np.asarray(hit).sum()), margin
    # the window semantics themselves: ids 2 apart need margin >= 2
    assert int(a.collide_with_bitcheck(b, margin=1)) == 0
    assert int(a.collide_with_bitcheck(b, margin=2)) == 1


def test_clone_and_print_voxel_map_data(capsys):
    """clone (DistanceVoxelMap.h:103) + printVoxelMapData
    (TemplateVoxelMap.hpp:282-286): the dump lists only non-default voxels
    with correct (x,y,z) decode, and the camelCase aliases are installed."""
    m = ProbVoxelMap.create((4, 4, 4)).insert_point_cloud(
        np.array([[1.5, 2.5, 3.5]], np.float32)
    )
    c = m.clone()
    np.testing.assert_array_equal(np.asarray(c.data), np.asarray(m.data))
    out = m.print_voxel_map_data()
    assert "(1,2,3)" in out and len(out.splitlines()) == 2  # header + one voxel
    import gpu_voxels_jax.api  # noqa: F401 — installs the camelCase aliases

    b = BitVectorVoxelMap.create((4, 4, 4)).insert_point_cloud(
        np.array([[0.5, 1.5, 2.5]], np.float32), SV_START
    )
    assert "(0,1,2)" in b.printVoxelMapData()


def test_sensor_settings_flow_and_robot_configuration():
    """initSensorSettings/updateSensorPose (TemplateVoxelMap.hpp:836-876):
    with a stored sensor, insert_sensor_data takes SENSOR-frame points and
    transforms them by the stored pose. insertRobotConfiguration works here
    (the reference stubs it NOT_SUPPORTED, ProbVoxelMap.hpp:104-108)."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_jax.sensors import Sensor

    m = ProbVoxelMap.create((16, 16, 16), 1.0)
    s = Sensor(position=np.array([4.0, 4.0, 4.0], np.float32))
    m.init_sensor_settings(s)
    # sensor at (4,4,4), point 2m ahead in sensor frame -> world (6.x, 4, 4)
    out = m.insert_sensor_data(np.array([[2.2, 0.0, 0.0]], np.float32))
    occ = np.asarray(out.data).reshape(16, 16, 16)  # z-major
    assert occ[4, 4, 6] == -128 + 72  # hit: one +72 observation from UNKNOWN
    assert occ[4, 4, 5] == -127  # carved free (clamped)
    assert occ[4, 4, 10] == -128  # behind the hit: untouched UNKNOWN
    # the stored sensor survives the immutable flow: a second SENSOR-frame
    # insert on the RETURNED map must still transform by the stored pose
    # (init-once / insert-repeatedly, TemplateVoxelMap.hpp:836-905)
    out2 = out.insert_sensor_data(np.array([[2.2, 0.0, 0.0]], np.float32))
    occ2 = np.asarray(out2.data).reshape(16, 16, 16)
    assert occ2[4, 4, 6] == -128 + 72 + 72  # same world voxel, second +72
    assert occ2[0, 0, 2] == -128  # NOT misread as world-frame from origin
    assert getattr(out.clear_map(), "_sensor", None) is s
    assert getattr(out.update_occupancy(np.zeros((1, 3), np.float32), 5), "_sensor", None) is s

    # the sensor survives EVERY derivation, not just the sensor-flow methods:
    # the reference's m_sensor lives beside the device data through all ops
    # (TemplateVoxelMap.h:236-246). Interleaving a plain insert between two
    # sensor frames must not silently drop the pose transform.
    mid = out.insert_point_cloud(np.array([[10.5, 10.5, 10.5]], np.float32))
    assert getattr(mid, "_sensor", None) is s
    out3 = mid.insert_sensor_data(np.array([[2.2, 0.0, 0.0]], np.float32))
    occ3 = np.asarray(out3.data).reshape(16, 16, 16)
    assert occ3[4, 4, 6] == -128 + 72 + 72  # still pose-transformed
    one_link = MetaPointCloud.from_clouds([np.array([[1.5, 1.5, 1.5]], np.float32)])
    carried = out.insert_meta_point_cloud(one_link)
    assert getattr(carried, "_sensor", None) is s
    new_rc, _ = out.insert_robot_configuration(one_link, with_self_collision_test=True)
    assert getattr(new_rc, "_sensor", None) is s
    # bit maps carry a stored sensor through their flows too
    bm = BitVectorVoxelMap.create((8, 8, 8))
    bm.init_sensor_settings(s)
    bm2 = bm.insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32), 10)
    assert getattr(bm2, "_sensor", None) is s
    assert getattr(bm2.clear_map(), "_sensor", None) is s

    s2 = Sensor(position=np.array([1.0, 4.0, 4.0], np.float32))
    m.update_sensor_pose(s2)
    assert np.allclose(getattr(m, "_sensor").position, [1, 4, 4])
    with pytest.raises(RuntimeError):
        ProbVoxelMap.create((4, 4, 4)).update_sensor_pose(s2)

    # insert_robot_configuration: overlapping links self-collide, ok=False
    link = np.array([[2.5, 2.5, 2.5]], np.float32)
    meta = MetaPointCloud.from_clouds([link, link + 4.0])
    clash_meta = MetaPointCloud.from_clouds([link, link])
    for base in (ProbVoxelMap.create((8, 8, 8)), BitVectorVoxelMap.create((8, 8, 8))):
        new, ok = base.insert_robot_configuration(meta, with_self_collision_test=True)
        assert bool(ok)
        assert int(new.collide_with(new)) == 2
        _, bad = base.insert_robot_configuration(clash_meta, with_self_collision_test=True)
        assert not bool(bad)

    # ProbVoxelMap.clearBitVoxelMeaning: only eBVM_OCCUPIED clears (= reset)
    filled = ProbVoxelMap.create((4, 4, 4)).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5]], np.float32)
    )
    same = filled.clear_voxel_meaning(BitVoxelMeaning.eBVM_FREE)
    np.testing.assert_array_equal(np.asarray(same.data), np.asarray(filled.data))
    wiped = filled.clear_voxel_meaning(BitVoxelMeaning.eBVM_OCCUPIED)
    assert np.all(np.asarray(wiped.data) == -128)

    # clear_collision_flags drops eBVM_COLLISION marks from marking collides
    b = BitVectorVoxelMap.create((4, 4, 4)).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5]], np.float32), SV_START
    )
    cnt, _, marked = b.collide_with_types(b)
    assert int(cnt) == 1
    assert bool(jnp.any(marked.get_bit_mask(BitVoxelMeaning.eBVM_COLLISION)))
    unmarked = marked.clear_collision_flags()
    assert not bool(jnp.any(unmarked.get_bit_mask(BitVoxelMeaning.eBVM_COLLISION)))
    assert bool(jnp.any(unmarked.get_bit_mask(SV_START)))


def test_bit_meta_insert_fused_matches_per_cloud_loop():
    """Per-subcloud-meaning meta insert (kernelInsertMetaPointCloud) through
    the fused single-scatter path must equal per-cloud inserts bit-for-bit,
    including duplicate voxels across subclouds and the occ summary."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud

    c0 = np.array([[1.5, 1.5, 1.5], [2.5, 2.5, 2.5]], np.float32)
    c1 = np.array([[1.5, 1.5, 1.5], [3.5, 3.5, 3.5]], np.float32)  # overlaps c0
    c2 = np.array([[0.5, 0.5, 0.5]], np.float32)
    meta = MetaPointCloud.from_clouds([c0, c1, c2])
    meanings = [9, 40, BitVoxelMeaning.eBVM_FREE]  # planes 0 (x2) and 1
    base = BitVectorVoxelMap.create((8, 8, 8))
    fused = base.insert_meta_point_cloud(meta, meanings)
    looped = base
    for pts, mn in zip([c0, c1, c2], meanings):
        looped = looped.insert_point_cloud(pts, mn)
    np.testing.assert_array_equal(np.asarray(fused.data), np.asarray(looped.data))
    np.testing.assert_array_equal(np.asarray(fused.occ), np.asarray(looped.occ))
    # eBVM_FREE alone must not mark the occupancy summary
    assert int(np.asarray(fused.occ).reshape(8, 8, 8)[0, 0, 0]) == 0


def test_prob_meta_insert_fused_matches_sequential_loop():
    """Per-subcloud prob meta insert through the fused encoded scatter-max
    must equal sequential per-cloud inserts exactly — later subclouds win on
    shared voxels (the deterministic linearization of the reference's racy
    kernelInsertMetaPointCloud)."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud

    shared = np.array([[1.5, 1.5, 1.5]], np.float32)
    c0 = np.concatenate([shared, np.array([[2.5, 2.5, 2.5]], np.float32)])
    c1 = np.concatenate([shared, np.array([[3.5, 3.5, 3.5]], np.float32)])  # wins on shared
    meta = MetaPointCloud.from_clouds([c0, c1])
    meanings = [BitVoxelMeaning.eBVM_OCCUPIED, BitVoxelMeaning.eBVM_FREE]
    base = ProbVoxelMap.create((8, 8, 8))
    fused = base.insert_meta_point_cloud(meta, meanings)
    looped = base
    for pts, mn in zip([c0, c1], meanings):
        looped = looped.insert_point_cloud(pts, mn)
    np.testing.assert_array_equal(np.asarray(fused.data), np.asarray(looped.data))
    d = np.asarray(fused.as_3d())
    assert d[1, 1, 1] == -127  # shared voxel: later subcloud (FREE) won
    assert d[2, 2, 2] == 127 and d[3, 3, 3] == -127

    rng = np.random.default_rng(3)
    clouds = [rng.uniform(0, 8, (97, 3)).astype(np.float32) for _ in range(4)]
    mns = [1, 0, 11, 1]
    meta2 = MetaPointCloud.from_clouds(clouds)
    f2 = base.insert_meta_point_cloud(meta2, mns)
    l2 = base
    for pts, mn in zip(clouds, mns):
        l2 = l2.insert_point_cloud(pts, mn)
    np.testing.assert_array_equal(np.asarray(f2.data), np.asarray(l2.data))
