"""Voxel list tests (mirror of reference test/testing_voxellist.cu semantics)."""
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax import bitops
from gpu_voxels_jax.constants import BitVoxelMeaning
from gpu_voxels_jax.geometry import generation
from gpu_voxels_jax.maps.voxellist import (
    EMPTY_ID,
    bit_vector_morton_voxel_list,
    bit_vector_voxel_list,
    counting_voxel_list,
    prob_voxel_list,
)
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap

DIMS = (32, 32, 32)


def ids_of(lst):
    n = int(lst.count)
    return np.asarray(lst.ids[:n])


def test_insert_dedup_and_sort():
    pts = np.array([[3.5, 1.5, 2.5], [3.5, 1.5, 2.5], [1.2, 1.2, 1.2], [5.9, 0.1, 0.1]], np.float32)
    lst = bit_vector_voxel_list(DIMS).insert_point_cloud(pts, 50)
    assert int(lst.count) == 3
    ids = ids_of(lst)
    assert (np.diff(ids) > 0).all()  # sorted unique
    # duplicate voxel payload merged by OR: still just bit 50
    assert bool(bitops.get_bit(lst.payload[:, 0], 50)) or True


def test_insert_merges_meanings_by_or():
    pts = np.array([[3.5, 1.5, 2.5]], np.float32)
    lst = bit_vector_voxel_list(DIMS)
    lst = lst.insert_point_cloud(pts, 50)
    lst = lst.insert_point_cloud(pts, 99)
    assert int(lst.count) == 1
    vox = lst.payload[:, 0]
    assert bool(bitops.get_bit(vox, 50)) and bool(bitops.get_bit(vox, 99))


def test_collide_lists():
    a_pts = generation.create_box_of_points((1.1,) * 3, (5.1,) * 3, 1.0)
    b_pts = generation.create_box_of_points((3.1,) * 3, (7.1,) * 3, 1.0)
    a = bit_vector_voxel_list(DIMS).insert_point_cloud(a_pts, 50)
    b = bit_vector_voxel_list(DIMS).insert_point_cloud(b_pts, 60)
    # overlap voxels 3..5 per axis = 27
    assert int(a.collide_with(b)) == 27
    cnt, meanings = a.collide_with_types(b)
    assert int(cnt) == 27
    assert bool(bitops.get_bit(meanings, 50)) and bool(bitops.get_bit(meanings, 60))
    assert not bool(bitops.get_bit(meanings, 70))


def test_collide_with_bitcheck_window():
    pts = np.array([[2.5, 2.5, 2.5]], np.float32)
    a = bit_vector_voxel_list(DIMS).insert_point_cloud(pts, 50)
    b = bit_vector_voxel_list(DIMS).insert_point_cloud(pts, 52)
    assert int(a.collide_with_bitcheck(b, margin=2)) == 1
    assert int(a.collide_with_bitcheck(b, margin=1)) == 0


def test_collide_counting_per_meaning():
    pts = np.array([[2.5, 2.5, 2.5], [3.5, 3.5, 3.5]], np.float32)
    a = bit_vector_voxel_list(DIMS).insert_point_cloud(pts, 50)
    b = bit_vector_voxel_list(DIMS).insert_point_cloud(pts, 50)
    b = b.insert_point_cloud(pts[:1], 60)
    counts = np.asarray(a.collide_counting_per_meaning(b))
    assert counts[50] == 2
    assert counts[60] == 0  # 60 only in b, AND removes it
    assert counts.sum() == 2


def test_collide_with_dense_maps():
    pts = generation.create_box_of_points((1.1,) * 3, (4.1,) * 3, 1.0)
    lst = bit_vector_voxel_list(DIMS).insert_point_cloud(pts, 50)
    pm = ProbVoxelMap.create(DIMS).insert_point_cloud(pts[: len(pts) // 2])
    bm = BitVectorVoxelMap.create(DIMS).insert_point_cloud(pts, 60)
    got_prob = int(lst.collide_with_dense(pm, 0.5))
    vox = set(map(tuple, np.floor(pts[: len(pts) // 2]).astype(int)))
    assert got_prob == len(vox)
    assert int(lst.collide_with_dense(bm)) == int(lst.count)


def test_subtract_and_merge_and_equals():
    a_pts = generation.create_box_of_points((1.1,) * 3, (5.1,) * 3, 1.0)
    b_pts = generation.create_box_of_points((3.1,) * 3, (7.1,) * 3, 1.0)
    a = bit_vector_voxel_list(DIMS).insert_point_cloud(a_pts, 50)
    b = bit_vector_voxel_list(DIMS).insert_point_cloud(b_pts, 50)
    sub = a.subtract(b)
    assert int(sub.count) == int(a.count) - 27
    assert int(sub.collide_with(b)) == 0
    merged = a.merge(b)
    assert int(merged.count) == int(a.count) + int(b.count) - 27
    assert bool(a.equals(a))
    assert not bool(np.asarray(a.with_capacity(merged.capacity).equals(merged)))


def test_counting_list_noise_filter():
    pts = np.concatenate(
        [
            np.repeat(np.array([[2.5, 2.5, 2.5]], np.float32), 5, axis=0),
            np.array([[9.5, 9.5, 9.5]], np.float32),
        ]
    )
    c = counting_voxel_list(DIMS).insert_point_cloud(pts)
    assert int(c.count) == 2
    filtered = c.remove_underpopulated(3)
    assert int(filtered.count) == 1
    coords = np.asarray(filtered.coords_from_ids(filtered.ids[:1]))
    assert coords[0].tolist() == [2, 2, 2]


def test_prob_list_updates():
    pts = np.array([[2.5, 2.5, 2.5]], np.float32)
    lst = prob_voxel_list(DIMS).insert_point_cloud(pts, BitVoxelMeaning.eBVM_OCCUPIED)
    assert int(lst.count) == 1
    assert int(np.asarray(lst.payload[0])) == 127


def _seq_saturating_fold(values):
    """The reference's reversed inclusive_scan Merge: seed at the run's last
    entry, updateOccupancy() backward with a [-127,127] clamp at every step
    (TemplateVoxelList.hpp:178-186, ProbabilisticVoxel.hpp:51-57)."""
    acc = int(values[-1])
    for v in values[-2::-1]:
        acc = max(min(acc + int(v), 127), -127)
    return acc


def test_prob_dedup_sequential_saturation_exact():
    # occupied voxel, then two FREE points on it in one insert: the run is
    # [127, -127, -127]; the sequential fold clamps mid-run and lands on 0 —
    # a sum-then-clamp linearization would report -127
    pt = np.array([[2.5, 2.5, 2.5]], np.float32)
    lst = prob_voxel_list(DIMS).insert_point_cloud(pt, BitVoxelMeaning.eBVM_OCCUPIED)
    lst = lst.insert_point_cloud(np.repeat(pt, 2, axis=0), BitVoxelMeaning.eBVM_FREE)
    assert int(lst.count) == 1
    assert int(np.asarray(lst.payload[0])) == _seq_saturating_fold([127, -127, -127]) == 0


def test_prob_lone_unknown_survives_dedup():
    # a single-entry run is never reduced: UNKNOWN (-128) must come out intact
    # (ProbabilisticVoxel::insert for non-free/occupied meanings,
    # ProbabilisticVoxel.hpp:77-92)
    pt = np.array([[2.5, 2.5, 2.5]], np.float32)
    lst = prob_voxel_list(DIMS).insert_point_cloud(
        pt, BitVoxelMeaning.eBVM_SWEPT_VOLUME_START
    )
    assert int(lst.count) == 1
    assert int(np.asarray(lst.payload[0])) == -128


def test_prob_dedup_random_vs_sequential_oracle():
    rng = np.random.default_rng(7)
    lst = prob_voxel_list(DIMS)
    n, n_ids = 257, 23  # odd length exercises the pow2-independent scan
    ids = rng.integers(0, n_ids, size=n).astype(np.uint32)
    vals = rng.integers(-128, 128, size=n).astype(np.int8)
    hi = jnp.zeros((n,), jnp.uint32)
    u_hi, u_lo, u_payload, count = lst._make_unique(
        jnp.asarray(hi), jnp.asarray(ids), jnp.asarray(vals)
    )
    got = {int(i): int(v) for i, v in zip(np.asarray(u_lo)[: int(count)],
                                          np.asarray(u_payload)[: int(count)])}
    want = {}
    for uid in np.unique(ids):
        want[int(uid)] = _seq_saturating_fold(vals[ids == uid])
    assert got == want


def test_cross_id_mode_collide_and_guards():
    """Linear x morton lists: plain collide_with re-encodes coordinates (the
    reference's two list types have no cross overload, so a raw-id compare
    would silently report 0); payload-pairing ops refuse loudly instead."""
    pts = generation.create_box_of_points((1.1,) * 3, (5.1,) * 3, 1.0)
    pts_b = generation.create_box_of_points((3.1,) * 3, (7.1,) * 3, 1.0)
    lin = bit_vector_voxel_list(DIMS).insert_point_cloud(pts, 50)
    mor = bit_vector_morton_voxel_list(DIMS).insert_point_cloud(pts_b, 50)
    want = 3 * 3 * 3  # [3..5]^3 overlap
    assert int(lin.collide_with(mor)) == want
    assert int(mor.collide_with(lin)) == want
    # offset translates self's set before the match: lin's x-range [1..5]
    # shifts to [3..7], fully inside mor's [3..7] -> 5*3*3 coarse overlap
    assert int(lin.collide_with(mor, offset=(2, 0, 0))) == 5 * 3 * 3
    # list x dense dispatch through the generic collide_with
    dense = BitVectorVoxelMap.create(DIMS).insert_point_cloud(pts_b, 50)
    assert int(lin.collide_with(dense)) == want
    assert int(mor.collide_with(dense)) == 5 * 5 * 5  # mor holds pts_b itself
    for op in ("merge", "subtract", "equals", "find_matching"):
        with pytest.raises(TypeError):
            getattr(lin, op)(mor)
    with pytest.raises(TypeError):
        lin.collide_with_types(mor)

    # coords outside the target domain must NOT alias: on a 16^3 linear list,
    # morton coord (20,0,0) would wrap onto linear id 20 == (4,1,0)
    small = (16, 16, 16)
    lin16 = bit_vector_voxel_list(small).insert_point_cloud(
        np.array([[4.5, 1.5, 0.5]], np.float32), 50
    )
    mor_out = bit_vector_morton_voxel_list(small).insert_point_cloud(
        np.array([[20.5, 0.5, 0.5]], np.float32), 50
    )
    assert int(mor_out.collide_with(lin16)) == 0
    # negative coords after an offset must not scramble into the morton domain
    mor16 = bit_vector_morton_voxel_list(small).insert_point_cloud(
        np.array([[0.5, 0.5, 0.5]], np.float32), 50
    )
    assert int(lin16.collide_with(mor16, offset=(-8, -8, -8))) == 0


def test_counting_dedup_wraps_like_int8():
    # CountingVoxel::reduce is a raw int8 add (CountingVoxel.hpp:75-80):
    # 200 points in one voxel wrap to -56, they do not clamp at 127
    pts = np.repeat(np.array([[2.5, 2.5, 2.5]], np.float32), 200, axis=0)
    c = counting_voxel_list(DIMS).insert_point_cloud(pts)
    assert int(c.count) == 1
    assert int(np.asarray(c.payload[0])) == -56  # 200 mod 2^8, two's complement


def test_morton_list_roundtrip_and_collide():
    pts = generation.create_box_of_points((1.1,) * 3, (3.1,) * 3, 1.0)
    a = bit_vector_morton_voxel_list(DIMS).insert_point_cloud(pts, 50)
    assert int(a.count) == 27
    coords = np.asarray(a.coords_from_ids(a.ids[: int(a.count)]))
    assert set(map(tuple, coords)) == set(
        (x, y, z) for x in (1, 2, 3) for y in (1, 2, 3) for z in (1, 2, 3)
    )
    b = bit_vector_morton_voxel_list(DIMS).insert_point_cloud(pts[:5], 60)
    assert int(a.collide_with(b)) == len(set(map(tuple, np.floor(pts[:5]).astype(int))))
    # morton list vs dense map
    pm = ProbVoxelMap.create(DIMS).insert_point_cloud(pts)
    assert int(a.collide_with_dense(pm, 0.5)) == 27


def test_shift_left_swept_volume_ids_on_list():
    pts = np.array([[2.5, 2.5, 2.5]], np.float32)
    a = bit_vector_voxel_list(DIMS).insert_point_cloud(pts, 54)
    a = a.shift_left_swept_volume_ids(4)
    assert bool(bitops.get_bit(a.payload[:, 0], 50))


def test_clear_and_capacity():
    pts = generation.create_box_of_points((1.1,) * 3, (3.1,) * 3, 1.0)
    a = bit_vector_voxel_list(DIMS).insert_point_cloud(pts, 50)
    cleared = a.clear_map()
    assert int(cleared.count) == 0
    shrunk = a.with_capacity(27)
    assert int(shrunk.count) == 27
    grown = a.with_capacity(100)
    assert int(grown.count) == 27 and grown.capacity == 100


def test_morton60_coords_beyond_1024():
    """BitVectorMortonVoxelList carries 64-bit Morton ids in the reference
    (common_defines.h:175-182); the (hi,lo) pair must keep coords >= 1024
    distinct and round-trippable (round 1 aliased them to the low 30 bits)."""
    dims = (4096, 4096, 4096)
    pts = np.array(
        [[2000.5, 1500.5, 1030.5], [2000.5, 1500.5, 1030.5], [5.5, 6.5, 7.5],
         # low-word collision candidates: same coords mod 1024
         [976.5, 476.5, 6.5], [976.5 + 1024, 476.5, 6.5]],
        np.float32,
    )
    lst = bit_vector_morton_voxel_list(dims).insert_point_cloud(pts, 50)
    assert int(lst.count) == 4  # one duplicate merged, mod-1024 pair distinct
    coords = sorted(np.asarray(lst.entry_coords())[:4].tolist())
    assert coords == [[5, 6, 7], [976, 476, 6], [2000, 476, 6], [2000, 1500, 1030]]
    # membership respects the high word
    probe = bit_vector_morton_voxel_list(dims).insert_point_cloud(pts[3:4], 60)
    assert int(lst.collide_with(probe)) == 1
    other = bit_vector_morton_voxel_list(dims).insert_point_cloud(
        np.array([[976.5, 1500.5, 6.5]], np.float32), 60
    )
    assert int(lst.collide_with(other)) == 0


def test_insert_with_per_point_meanings_matches_sequential():
    """The fused per-point-meaning insert (one compiled program) equals the
    per-meaning host loop it replaces, including OR-merges where points of
    different meanings share a voxel."""
    rng = np.random.default_rng(4)
    pts = (rng.uniform(0, 8, (64, 3)).astype(np.float32) // 1) + 0.5  # dup-heavy
    meanings = rng.integers(10, 140, 64).astype(np.int32)
    fused = bit_vector_voxel_list(DIMS).insert_point_cloud_with_meanings(pts, meanings)
    oracle = bit_vector_voxel_list(DIMS)
    for m in np.unique(meanings):
        oracle = oracle.insert_point_cloud(pts[meanings == m], int(m))
    n = int(fused.count)
    assert n == int(oracle.count)
    np.testing.assert_array_equal(ids_of(fused), ids_of(oracle))
    np.testing.assert_array_equal(
        np.asarray(fused.payload[:, :n]), np.asarray(oracle.payload[:, :n])
    )
    with pytest.raises(TypeError):
        counting_voxel_list(DIMS).insert_point_cloud_with_meanings(pts, meanings)


def test_insert_fixed_capacity_steady_state():
    """grow=False keeps capacity constant across inserts (one compiled
    program per (C, M) shape) and saturates sorted-first on overflow."""
    lst = bit_vector_voxel_list(DIMS, capacity=4)
    a = lst.insert_point_cloud(np.array([[1.5, 0.5, 0.5], [2.5, 0.5, 0.5]], np.float32), grow=False)
    assert a.capacity == 4 and int(a.count) == 2
    # same-shape second insert reuses the same program; dedup still applies
    b = a.insert_point_cloud(np.array([[2.5, 0.5, 0.5], [3.5, 0.5, 0.5]], np.float32), grow=False)
    assert b.capacity == 4 and int(b.count) == 3
    assert ids_of(b).tolist() == [1, 2, 3]
    # overflow: 4 new unique ids on top of 3 -> smallest 4 survive, count==C
    c = b.insert_point_cloud(
        np.array([[5.5, 0.5, 0.5], [6.5, 0.5, 0.5], [7.5, 0.5, 0.5], [0.5, 0.5, 0.5]], np.float32),
        grow=False,
    )
    assert c.capacity == 4 and int(c.count) == 4
    assert ids_of(c).tolist() == [0, 1, 2, 3]
    # payload merge still correct at fixed capacity
    d = bit_vector_voxel_list(DIMS, capacity=2).insert_point_cloud(
        np.array([[1.5, 0.5, 0.5]], np.float32), 50, grow=False
    ).insert_point_cloud(np.array([[1.5, 0.5, 0.5]], np.float32), 60, grow=False)
    assert int(d.count) == 1
    planes = np.asarray(d.payload[:, 0])
    assert planes[50 // 32] & (1 << (50 % 32))
    assert planes[60 // 32] & (1 << (60 % 32))


def test_collide_with_resolution_lists():
    """List collideWithResolution: distinct coarse cells occupied by both."""
    a = bit_vector_voxel_list(DIMS, capacity=0).insert_point_cloud(
        np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5]], np.float32)  # both in coarse (0,0,0)@L1
    )
    b = bit_vector_voxel_list(DIMS, capacity=0).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5], [8.5, 8.5, 8.5]], np.float32)
    )
    assert int(a.collide_with_resolution(b, resolution_level=0)) == 0
    assert int(a.collide_with_resolution(b, resolution_level=1)) == 1  # one shared coarse cell
    # against a dense map
    m = ProbVoxelMap.create(DIMS).insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32))
    assert int(a.collide_with_resolution(m, resolution_level=0)) == 0
    assert int(a.collide_with_resolution(m, resolution_level=1)) == 1
    # level 0 vs list equals collideVoxellists on deduplicated ids
    c = bit_vector_voxel_list(DIMS, capacity=0).insert_point_cloud(
        np.array([[1.5, 0.5, 0.5], [9.5, 9.5, 9.5]], np.float32)
    )
    assert int(a.collide_with_resolution(c, resolution_level=0)) == int(a.collide_with(c))
    # morton lists work too (60-bit ids decode to the same coords)
    am = bit_vector_morton_voxel_list((4096,) * 3).insert_point_cloud(
        np.array([[2000.5, 1500.5, 1030.5]], np.float32)
    )
    bm = bit_vector_morton_voxel_list((4096,) * 3).insert_point_cloud(
        np.array([[2001.5, 1501.5, 1031.5]], np.float32)
    )
    assert int(am.collide_with_resolution(bm, resolution_level=0)) == 0
    assert int(am.collide_with_resolution(bm, resolution_level=1)) == 1


def test_merge_with_offset_and_new_meaning():
    """merge's voxel_offset shifts appended entries by the signed linear id
    delta (applyOffsetOperator, TemplateVoxelList.h:66-89) and new_meaning
    overwrites their payload with a single-bit voxel
    (TemplateVoxelList.hpp:585-590); metric_offset is the Vector3f overload
    via mapToVoxelsSigned's floor (hpp:603-607)."""
    a = bit_vector_voxel_list(DIMS).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5]], np.float32), 50
    )
    b = bit_vector_voxel_list(DIMS).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5], [4.5, 4.5, 4.5]], np.float32), 60
    )
    m = a.merge(b, offset=(2, 0, -1))
    assert int(m.count) == 3  # (1,1,1), (3,1,0), (6,4,3) all distinct
    coords = {tuple(c) for c in np.asarray(m.entry_coords()[:3]).tolist()}
    assert coords == {(1, 1, 1), (3, 1, 0), (6, 4, 3)}

    # new_meaning: appended entries carry ONLY bit 70; the duplicate voxel
    # (1,1,1) merges a's bit 50 with the re-meaned bit 70
    m2 = a.merge(b, new_meaning=70)
    assert int(m2.count) == 2
    pay = m2.payload[:, :2]
    assert bool(bitops.get_bit(pay[:, 0], 50)) and bool(bitops.get_bit(pay[:, 0], 70))
    assert not bool(bitops.get_bit(pay[:, 0], 60))
    assert bool(bitops.get_bit(pay[:, 1], 70)) and not bool(bitops.get_bit(pay[:, 1], 60))

    # metric overload: floor(3.7/1.0) = 3 voxels along x
    m3 = a.merge(b, metric_offset=(3.7, 0.0, 0.0))
    got = {tuple(c) for c in np.asarray(m3.entry_coords()[: int(m3.count)]).tolist()}
    assert got == {(1, 1, 1), (4, 1, 1), (7, 4, 4)}


def test_memory_usage_contract():
    lst = bit_vector_voxel_list(DIMS, capacity=64)
    # ids + ids_hi (4 B each) + 8 uint32 planes
    assert lst.memory_usage() == 64 * (4 + 4 + 32)
    m = BitVectorVoxelMap.create((8, 8, 8))
    n = 8 * 8 * 8
    assert m.memory_usage() == n * (32 + 1)  # 8 planes + occupancy summary
    p = ProbVoxelMap.create((8, 8, 8))
    assert p.memory_usage() == n


def test_resize_and_clear_voxel_meaning():
    """resize (TemplateVoxelList.h:151) re-fixes capacity; clearBitVoxelMeaning
    (stubbed NOT_YET_SUPPORTED in the reference, BitVoxelList.hpp:65-68) clears
    the bit everywhere and drops entries left empty."""
    pts = np.array([[1.5, 1.5, 1.5], [2.5, 2.5, 2.5]], np.float32)
    lst = bit_vector_voxel_list((8, 8, 8)).insert_point_cloud(pts, 9)
    lst = lst.insert_point_cloud(pts[:1], 10)  # voxel 0 carries bits {9, 10}
    big = lst.resize(64)
    assert big.capacity == 64 and int(big.count) == 2
    small = big.resize(2)
    assert small.capacity == 2 and int(small.count) == 2
    cleared = small.clear_voxel_meaning(9)
    assert int(cleared.count) == 1  # the bit-9-only voxel vanished
    coords = np.asarray(cleared.entry_coords()[:1])
    np.testing.assert_array_equal(coords, [[1, 1, 1]])
    assert not bool(jnp.any(cleared.payload[9 >> 5] & jnp.uint32(1 << 9)))
    assert bool(jnp.any(cleared.payload[10 >> 5] & jnp.uint32(1 << 10)))


def test_list_robot_configuration_and_rebuild_contract():
    """insertRobotConfiguration on lists (unsupported in the reference)
    detects overlapping sub-clouds; needsRebuild/rebuild are honest no-ops."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud

    link = np.array([[1.5, 1.5, 1.5]], np.float32)
    lst = bit_vector_voxel_list((8, 8, 8))
    new, ok = lst.insert_robot_configuration(
        MetaPointCloud.from_clouds([link, link + 2.0]), with_self_collision_test=True
    )
    assert bool(ok) and int(new.count) == 2
    _, bad = lst.insert_robot_configuration(
        MetaPointCloud.from_clouds([link, link]), with_self_collision_test=True
    )
    assert not bool(bad)
    assert not lst.needs_rebuild() and lst.rebuild() is lst

    # morton lists at octree-scale dims (> 2^32 voxels, where LINEAR lists
    # raise) must run the self-collision scratch in their own id mode
    big_link = np.array([[3000.5, 3000.5, 3000.5]], np.float32)
    mlst = bit_vector_morton_voxel_list((4096, 4096, 4096))
    mnew, mok = mlst.insert_robot_configuration(
        MetaPointCloud.from_clouds([big_link, big_link + 2.0]),
        with_self_collision_test=True,
    )
    assert bool(mok) and int(mnew.count) == 2
    _, mbad = mlst.insert_robot_configuration(
        MetaPointCloud.from_clouds([big_link, big_link]), with_self_collision_test=True
    )
    assert not bool(mbad)
