"""Exact-count contracts re-run on a real GPU.

The CPU suite (tests/) proves these semantics on the virtual mesh; this tier
proves the same *bit-exact* numbers where XLA's GPU code, TF32 matmul
defaults and the compiled Triton kernel actually run.
Contracts mirror the reference's exactness oracles: linkage scene count
(example_how_to_link/gvl_linkage_test_lib.cpp:20-38), differences3D == 0
(test/testing_distance.cu:79-119), bitMarginCollisionCheck byte oracle
(helpers/BitVector.h:415-471).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax import bitops
from gpu_voxels_jax.api import GpuVoxels, MapType
from gpu_voxels_jax.constants import BitVoxelMeaning
from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_jax.maps.voxellist import VoxelList


def fresh_gvl():
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(150, 150, 150, 0.01)
    return gvl


def test_linkage_scene_exact_count_on_gpu():
    """BASELINE config #1: the gvl_linkage_test overlap must be exactly 8000
    on hardware (float32 voxelization + int8 thresholds, no bf16 drift)."""
    gvl = fresh_gvl()
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "a")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "b")
    center, box, overlap = np.array([0.5] * 3), np.array([0.4] * 3), np.array([0.1] * 3)
    c1 = center - overlap
    c2 = c1 + box
    c3 = center + overlap
    c4 = c3 - box
    gvl.insert_box_into_map(c1, c2, "a", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map(c4, c3, "b", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    assert int(gvl.get_map("a").collide_with(gvl.get_map("b"))) == 8000


def test_prob_collide_count_matches_numpy_on_gpu():
    """The fused XLA threshold-compare + count equals NumPy on random int8
    occupancy (unaligned length)."""
    from gpu_voxels_jax.ops import collide as xla_collide

    rng = np.random.default_rng(7)
    n = 257 * 1024 + 13
    a = rng.integers(-128, 128, n, dtype=np.int8)
    b = rng.integers(-128, 128, n, dtype=np.int8)
    t = 100
    want = int(np.sum((a.astype(np.int32) >= t) & (b.astype(np.int32) >= t)))
    got = int(xla_collide.count_prob_prob(jnp.asarray(a), jnp.asarray(b), t, t))
    assert got == want


def test_bit_margin_packed_full_vs_byte_oracle_on_gpu():
    """bitMarginCollisionCheck (BitVector.h:415-471) over margin/offset
    combos including the uint64-truncation regime, on hardware."""
    rng = np.random.default_rng(3)
    n = 513
    v1 = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    v2 = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    v1[:, 0] &= 0xF0  # ids live in bits 4..253
    v2[:, 0] &= 0xF0
    p1 = jnp.asarray(v1.reshape(n, 8, 4).astype(np.uint32) @ (256 ** np.arange(4)).astype(np.uint32)).T
    p2 = jnp.asarray(v2.reshape(n, 8, 4).astype(np.uint32) @ (256 ** np.arange(4)).astype(np.uint32)).T
    for margin, sv_offset in [(1, 0), (5, 6), (24, 40), (31, 0), (31, 17)]:
        want = np.array([
            bitops.bit_margin_collision_check_np(v1[i], v2[i], np.zeros(32, np.uint8), margin, sv_offset)[0]
            for i in range(n)
        ])
        got, _ = bitops.bit_margin_collision_check_packed_full(
            p1, p2, bitops.zeros((n,)), margin, sv_offset
        )
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=f"margin={margin} off={sv_offset}")


def test_edt_parallel_banding_exact_on_gpu():
    """differences3D(parallel_banding, brute) == 0 with the compiled Triton
    envelope kernel (testing_distance.cu:79-119 oracle)."""
    dims = (96, 80, 64)
    rng = np.random.default_rng(11)
    obs = np.stack([
        rng.integers(0, dims[0], 500),
        rng.integers(0, dims[1], 500),
        rng.integers(0, dims[2], 500),
    ], -1).astype(np.float32)
    m = DistanceVoxelMap.create(dims).insert_point_cloud(obs + 0.5)
    pba = m.parallel_banding()
    brute = m.exact_distances(np.unique(np.floor(obs), axis=0))
    assert int(pba.differences(brute)) == 0


def test_jump_flood_api_exact_on_gpu():
    """jumpFlood3D API (DistanceVoxelMap.hpp:136) at 128^3 takes its
    large-grid route on the GPU; differences3D against the brute oracle
    must be 0."""
    dims = (128, 128, 128)
    rng = np.random.default_rng(12)
    obs = np.unique(
        np.stack([rng.integers(0, d, 400) for d in dims], -1), axis=0
    )
    m = DistanceVoxelMap.create(dims).insert_point_cloud(
        obs.astype(np.float32) + 0.5
    )
    jf = m.jump_flood()
    brute = m.exact_distances(obs.astype(np.int32))
    assert int(jf.differences(brute)) == 0


def test_list_dispatch_directions_on_gpu():
    """The round-3 collide dispatch additions on hardware: list->dense
    routing (CollidableWith*VoxelMap on BitVoxelList, BitVoxelList.h:110-114)
    and the cross linear x morton list collide (coordinate re-encoding; raw
    ids would silently mismatch)."""
    from gpu_voxels_jax.geometry import generation
    from gpu_voxels_jax.maps.voxellist import (
        bit_vector_morton_voxel_list,
        bit_vector_voxel_list,
    )

    dims = (32, 32, 32)
    pts = generation.create_box_of_points((1.1,) * 3, (5.1,) * 3, 1.0)
    pts_b = generation.create_box_of_points((3.1,) * 3, (7.1,) * 3, 1.0)
    lin = bit_vector_voxel_list(dims).insert_point_cloud(pts, 50)
    mor = bit_vector_morton_voxel_list(dims).insert_point_cloud(pts_b, 50)
    assert int(lin.collide_with(mor)) == 27
    assert int(mor.collide_with(lin)) == 27
    assert int(lin.collide_with(mor, offset=(2, 0, 0))) == 45
    dense_b = BitVectorVoxelMap.create(dims).insert_point_cloud(pts_b, 50)
    assert int(lin.collide_with(dense_b)) == 27
    assert int(mor.collide_with(dense_b)) == 125
    prob_b = ProbVoxelMap.create(dims).insert_point_cloud(pts_b)
    assert int(lin.collide_with(prob_b)) == 27


def test_edt_512_sampled_brute_on_gpu():
    """parallel_banding at the full 512^3 BASELINE scale, spot-verified
    against a host brute-force nearest-obstacle oracle on a random voxel
    sample (full differences3D at this size needs a second 536 MB grid; the
    sampled oracle is exact on every sampled voxel — roadmap #10)."""
    dims = (512, 512, 512)
    rng = np.random.default_rng(17)
    obs = rng.integers(0, 512, (20_000, 3)).astype(np.int64)
    obs = np.unique(obs, axis=0)
    m = DistanceVoxelMap.create(dims).insert_point_cloud(obs.astype(np.float32) + 0.5)
    pba = m.parallel_banding()

    q = rng.integers(0, 512, (2048, 3)).astype(np.int64)
    dx, dy, _ = dims
    lin = q[:, 2] * dx * dy + q[:, 1] * dx + q[:, 0]
    got = np.asarray(
        jnp.take(pba.squared_distances().reshape(-1), jnp.asarray(lin, jnp.int32))
    )
    # exact host oracle: min squared distance over all obstacles, chunked
    want = np.empty(len(q), np.int64)
    for i in range(0, len(q), 256):
        d = obs[None, :, :] - q[i : i + 256, None, :]
        want[i : i + 256] = (d * d).sum(-1).min(1)
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_voxellist_morton60_membership_on_gpu():
    """60-bit Morton ids: coords past 1024 must not alias (octree/Morton.h)."""
    dims = (4096, 4096, 4096)
    coords = np.array([[1, 2, 3], [1025, 9, 3000], [4095, 4095, 4095], [1, 2, 3]], np.float32)
    lst = VoxelList.create(dims, 1.0, kind="bit", capacity=8, id_mode="morton")
    lst = lst.insert_point_cloud(coords + 0.5)
    assert int(lst.count) == 3  # duplicate folded, no aliasing between rows
    other = VoxelList.create(dims, 1.0, kind="bit", capacity=8, id_mode="morton")
    other = other.insert_point_cloud(np.array([[4095, 4095, 4095]], np.float32) + 0.5)
    assert int(lst.collide_with(other)) == 1


def test_bitvector_swept_volume_window_on_gpu():
    """Windowed SV collide: exact hit count through the packed margin path."""
    dims = (32, 32, 32)
    a = BitVectorVoxelMap.create(dims)
    b = BitVectorVoxelMap.create(dims)
    pts = np.array([[4.5, 4.5, 4.5], [10.5, 4.5, 4.5]], np.float32)
    sv0 = int(BitVoxelMeaning.eBVM_SWEPT_VOLUME_START)  # ids are ints 4..253
    a = a.insert_point_cloud(pts, sv0)
    b = b.insert_point_cloud(pts[:1], sv0 + 3)
    # margin 2 misses (steps 3 apart), margin 3 hits exactly one voxel
    assert int(a.collide_with_bitcheck(b, margin=2)) == 0
    assert int(a.collide_with_bitcheck(b, margin=3)) == 1


def test_prob_bit_cross_collide_on_gpu():
    """Mixed-type dense collide (DefaultCollider thresholds) exact count."""
    dims = (64, 64, 64)
    prob = ProbVoxelMap.create(dims)
    bitm = BitVectorVoxelMap.create(dims)
    pts = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3) + 0.5
    prob = prob.insert_point_cloud(pts.astype(np.float32))
    bitm = bitm.insert_point_cloud((pts + [4, 0, 0]).astype(np.float32))
    assert int(prob.collide_with(bitm)) == 4 * 8 * 8


def test_paged_octree_scale_contracts_on_gpu():
    """The sparse 32768^3 tier on hardware: exact probes after insert and
    ray-carved free space (GvlNTree.hpp:108-130), sparse memory."""
    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap

    m = PagedHierarchicalMap((32768, 32768, 32768), 1.0)
    hits = np.array([[31000.5, 17.5, 22222.5], [200.5, 200.5, 190.5]], np.float32)
    m.insert_point_cloud_with_free_space(hits, (200.5, 200.5, 200.5))
    occ, _, _ = m.probe(jnp.asarray(np.floor(hits).astype(np.int32)))
    assert bool(np.asarray(occ).all())
    o2, _, f2 = m.probe(jnp.asarray([[200, 200, 195]], jnp.int32))
    assert bool(f2[0]) and not bool(o2[0])
    _, u3, _ = m.probe(jnp.asarray([[1, 1, 1]], jnp.int32))
    assert bool(u3[0])
    assert m.memory_usage() < 300 * 1024 * 1024


@pytest.mark.parametrize("margin", [0, 4, 8, 24])
def test_collide_types_matches_packed_oracle_on_gpu(margin):
    """collideWithTypes (count + meanings OR + marking) on dense-random words
    equals the packed margin oracle on the GPU, across the margin domain
    (kernelCollideVoxelMapsBitvector, BitVoxelMap.hpp:85-135)."""
    from gpu_voxels_jax.ops import collide as xla_collide

    n = 70_000

    def mk(seed):
        r = np.random.default_rng(seed)
        w = r.integers(0, 2**32, (8, n), dtype=np.uint64).astype(np.uint32)
        return jnp.asarray(w * (r.random(n) < 0.3))

    a, b = mk(3), mk(4)
    got_c, got_m, got_a = xla_collide.collide_with_types_bit_bit(a, b, margin)
    hit, rec = bitops.bit_margin_collision_check_packed(a, b, margin)
    hit_np = np.asarray(hit)
    ref_m = np.bitwise_or.reduce(np.where(hit_np[None, :], np.asarray(rec), 0), axis=1)
    assert int(got_c) == int(hit_np.sum())
    np.testing.assert_array_equal(np.asarray(got_m), ref_m.astype(np.uint32))
    plane0 = np.where(hit_np, np.asarray(a[0]) | np.uint32(4), np.asarray(a[0]))
    np.testing.assert_array_equal(np.asarray(got_a[0]), plane0)


def test_prob_paged_octree_scale_on_gpu():
    """GvlNTreeProb at full NTree scale on hardware: exact insertSensorData
    log-odds arithmetic (UNKNOWN -> -128+72 -> +72 -> occupied at >= 10,
    crossings clamp at -127; EnvNodesProbCommon.h:30-45, SensorModel
    magnitudes VoxelMapOperations.h:38-39) at 32768^3, sparse."""
    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap

    m = PagedHierarchicalMap((32768, 32768, 32768), 1.0, probabilistic=True)
    origin = (20000.5, 20000.5, 20000.5)
    hits = np.array([[20020.5, 20000.5, 20000.5]], np.float32)
    m.insert_point_cloud_with_free_space(hits, origin)
    hit_q = jnp.asarray([[20020, 20000, 20000]], jnp.int32)
    ray_q = jnp.asarray([[20010, 20000, 20000]], jnp.int32)
    assert int(np.asarray(m.probe_occupancy(hit_q))[0]) == -56  # -128 + 72
    assert int(np.asarray(m.probe_occupancy(ray_q))[0]) == -127
    o1, _, f1 = m.probe(jnp.concatenate([hit_q, ray_q]))
    assert not bool(o1[0]) and bool(f1[1])
    m.insert_point_cloud_with_free_space(hits, origin)
    assert int(np.asarray(m.probe_occupancy(hit_q))[0]) == 16  # -56 + 72
    assert bool(m.probe(hit_q)[0][0])  # 16 >= THRESHOLD_OCCUPANCY
    assert bool(m.probe(jnp.asarray([[1, 1, 1]], jnp.int32))[1][0])  # unknown
    assert m.memory_usage() < 300 * 1024 * 1024


@pytest.mark.parametrize("tilted", [False, True])
def test_exact_carve_matches_cpu_on_gpu(tilted):
    """The exact per-pixel carve on the GPU equals the same program on the
    CPU backend, up to voxels whose float decision sits within 1 ulp of its
    boundary (XLA may contract multiply-adds differently), including depth
    edges, invalid patches and an off-axis pose (insertSensorData raycast
    semantics, VoxelMapOperations.h:199-334)."""
    import jax

    import chip_smoke
    from gpu_voxels_jax.ops import raycast as rc
    from gpu_voxels_jax.sensors import Sensor

    dims = (64, 64, 64)
    rng = np.random.default_rng(7)
    depth = np.full((48, 64), 2.4, np.float32)
    depth[:, 32:] = 1.2
    depth[10:14, 5:9] = 0.0
    depth[30:34, :] += rng.uniform(-0.3, 0.3, (4, 64)).astype(np.float32)
    rpy = np.array([0.4, 0.0, 0.0] if tilted else [0.0, 0.0, 0.0], np.float32)
    sensor = Sensor(position=np.array([1.2, 2.7, 0.2], np.float32), orientation_rpy=rpy,
                    data_width=64, data_height=48, fx=52.0, fy=52.0, cx=32.0, cy=24.0)
    side = 0.06

    def carve():
        return rc.projective_free_space(
            jnp.asarray(depth), jnp.asarray(sensor.pose(), jnp.float32),
            52.0, 52.0, 32.0, 24.0, side, dims)

    got = np.asarray(carve())
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(carve())
    diff = np.flatnonzero(got != want)
    margins = chip_smoke.carve_margin_ulps(diff, [depth], sensor, side, dims)
    assert want.sum() > 0  # the scene actually carves
    assert len(diff) <= 2 and (margins <= 1.0).all(), (len(diff), margins)


def test_occupancy_summary_coherence_on_gpu():
    """The maintained uint8 occupancy summary stays exactly
    !noneButEmpty(data) through insert -> shift -> types-mark -> merge on
    hardware (the plain collideWith contract reads ONLY the summary, so any
    drift silently corrupts counts)."""
    dims = (96, 96, 96)
    r = np.random.default_rng(8)
    pts = r.uniform(2, 94, (30_000, 3)).astype(np.float32)
    m = BitVectorVoxelMap.create(dims).insert_point_cloud(pts, 10)
    other = BitVectorVoxelMap.create(dims).insert_point_cloud(pts[:5000] + 0.5, 12)

    def check(mm, tag):
        want = bitops.occupied(mm.data).astype(jnp.uint8)
        np.testing.assert_array_equal(np.asarray(mm.occ), np.asarray(want)), tag

    check(m, "insert")
    m2 = m.shift_left_swept_volume_ids(3)
    check(m2, "shift")
    _, _, m3 = m2.collide_with_types(other, sv_window=2)
    check(m3, "types-mark")
    check(m3.merge(other, new_meaning=20), "merge-remeaned")
    check(m3.merge(other), "merge")
    check(m3.clear_bit(10), "clear_bit")


def test_fused_multi_meaning_scatter_on_gpu():
    """ops/insert.scatter_bits_multi (the one-pass kernelInsertMetaPointCloud
    analogue behind batched swept volumes AND per-subcloud meta inserts) must
    match per-meaning inserts bit-for-bit on hardware, occ summary included."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud

    rngl = np.random.default_rng(11)
    clouds = [
        rngl.uniform(0.0, 16.0, (257, 3)).astype(np.float32) for _ in range(5)
    ]
    meanings = [4, 44, 99, 4, BitVoxelMeaning.eBVM_FREE]
    meta = MetaPointCloud.from_clouds(clouds)
    base = BitVectorVoxelMap.create((16, 16, 16))
    fused = base.insert_meta_point_cloud(meta, meanings)
    looped = base
    for pts, mn in zip(clouds, meanings):
        looped = looped.insert_point_cloud(pts, mn)
    np.testing.assert_array_equal(np.asarray(fused.data), np.asarray(looped.data))
    np.testing.assert_array_equal(np.asarray(fused.occ), np.asarray(looped.occ))


def test_fitter_slot_delays_on_gpu():
    """Per-slot start-delay deconfliction (robot/fitter.py) on hardware:
    three swept maps sharing cells at steps 10-12 need exactly the greedy
    [0, 4, 8] delays at margin=1 (pairwise clearance = span-1 + margin + 1),
    driven through the packed bitcheck path on the GPU."""
    from gpu_voxels_jax.robot.fitter import deconflict_slot, fit_schedule

    SV = int(BitVoxelMeaning.eBVM_SWEPT_VOLUME_START)
    dims = (64, 64, 64)

    def box(lo, hi):
        ax = [np.arange(lo[i], hi[i], dtype=np.float32) + 0.5 for i in range(3)]
        return np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3)

    def swept(home_lo):
        m = BitVectorVoxelMap.create(dims, 1.0)
        home = box(home_lo, tuple(c + 4 for c in home_lo))
        for s in range(5):
            m = m.insert_point_cloud(home, SV + s)
        shared = box((20, 20, 20), (26, 26, 26))
        for s in range(10, 13):
            m = m.insert_point_cloud(shared, SV + s)
        return m

    a, b, c = swept((1, 1, 1)), swept((40, 1, 1)), swept((1, 40, 1))
    assert int(a.collide_with_bitcheck(b, margin=1)) == 216  # 6^3 shared
    assert deconflict_slot([a, b, c], margin=1) == [0, 4, 8]
    robots = [("A", [("t", a)]), ("B", [("t", b)]), ("C", [("t", c)])]
    rescued = fit_schedule(robots, margin=1, windows_in_search=True)
    assert rescued[0][1] == [[0, 4, 8]]


def test_native_streamed_disk_io_on_gpu(tmp_path):
    """write_to_disk/read_from_disk of a GPU-resident bit map through the
    native interleave streamer round-trips bit-exactly (and byte-identically
    to the numpy fallback)."""
    from gpu_voxels_jax.utils import io as gio
    from gpu_voxels_jax.utils import native

    m = BitVectorVoxelMap.create((64, 64, 64), 0.02)
    pts = np.random.default_rng(0).uniform(0.1, 1.2, size=(4000, 3)).astype(np.float32)
    m = m.insert_point_cloud(pts, 17).insert_point_cloud(pts[::3] + 0.04, 201)
    p = tmp_path / "bits.bin"
    assert m.write_to_disk(p)
    back = m.read_from_disk(p)
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(m.data))
    if native.available() or native.build():
        p2 = tmp_path / "bits_np.bin"
        lib, att = native._lib, native._load_attempted
        native._lib, native._load_attempted = None, True
        try:
            gio.write_map(m, p2)
        finally:
            native._lib, native._load_attempted = lib, att
        assert p.read_bytes() == p2.read_bytes()


def test_sharded_paged_world_on_gpu():
    """ShardedPagedWorld on one GPU (1 device -> 1 slab): the committed
    device_put / pinning / slab-translation paths run on hardware and every
    result equals the plain PagedHierarchicalMap's (GvlNTree.hpp:150-330
    semantics per slab; parallel/paged_world.py)."""
    import jax

    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap
    from gpu_voxels_jax.parallel import ShardedPagedWorld

    dims = (64, 64, 64)
    rng = np.random.default_rng(41)
    pts = rng.uniform([0, 0, 0], dims, size=(300, 3)).astype(np.float32)

    single = PagedHierarchicalMap(dims, 1.0)
    single.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 2.5), max_steps=64)
    world = ShardedPagedWorld(dims, 1.0, devices=jax.devices()[:1])
    world.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 2.5), max_steps=64)

    world.assert_distributed()
    assert world.check_tree() and world.n_tiles() == single.n_tiles()
    q = np.concatenate(
        [
            rng.integers([0, 0, 0], dims, size=(480, 3)),
            np.floor(pts[:32]).astype(np.int64),  # guaranteed occupied hits
        ]
    ).astype(np.int32)
    assert (world.probe_status(q) == np.asarray(single.probe_status(q))).all()
    count = world.collide_with_coords(q)
    assert count == int(single.collide_with_coords(q)) and count >= 32
    lst = VoxelList.create(dims, 1.0, "bit", 2048, "linear").insert_point_cloud(
        rng.uniform([0, 0, 0], dims, size=(200, 3)).astype(np.float32)
    )
    off = (1, -2, 3)
    assert world.collide_with(lst, offset=off) == int(single.collide_with(lst, offset=off))


def test_rrt_connect_planner_on_gpu():
    """The library planner on the GPU: RRT-Connect replays the SAME
    deterministic tree as the CPU suite (all device work is exact integer
    gather/compare, so extension decisions are backend-independent —
    tests/test_planning.py builds the identical wall world), and the
    simplified path is collision-free end to end on hardware."""
    from gpu_voxels_jax.planning import (
        GvlValidityChecker,
        JointSpace,
        MotionValidator,
        PathSimplifier,
        RRTConnect,
    )

    class PointRobot:
        def transformed_clouds_for(self, cfg):
            class _C:
                pass

            c = _C()
            c.points = jnp.asarray(cfg, jnp.float32)[None, :]
            return c

    ys, zs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    pts = np.stack(
        [np.full(ys.size, 8.5), ys.ravel() + 0.5, zs.ravel() + 0.5], axis=1
    ).astype(np.float32)
    hole = (pts[:, 1] < 3.0) & (pts[:, 2] < 3.0)
    env = ProbVoxelMap.create((16, 16, 16), 1.0).insert_point_cloud(pts[~hole])
    checker = GvlValidityChecker(env, PointRobot(), 0.7)
    validator = MotionValidator(checker, resolution=0.5)
    space = JointSpace(np.zeros(3, np.float32), np.full(3, 16.0, np.float32))
    start = np.array([2.5, 8.5, 8.5], np.float32)
    goal = np.array([14.5, 8.5, 8.5], np.float32)

    ok, _ = validator.check_motion(start, goal)
    assert not ok  # the wall blocks the straight segment on hardware too
    planner = RRTConnect(space, validator, step=2.0, seed=3)
    result = planner.solve(start, goal, max_iters=4000)
    assert result.solved and result.iterations == 183  # CPU-identical tree
    path = PathSimplifier(validator, seed=5).simplify(result.path)
    states = path.interpolate(validator.resolution)
    assert int(checker.batch_colliding_voxels(states).max()) == 0
    np.testing.assert_array_equal(path.states[0], start)
    np.testing.assert_array_equal(path.states[-1], goal)


def test_voxellist_per_point_meanings_on_gpu():
    """Fused per-point-meaning insert equals the sequential per-meaning loop
    exactly on hardware (ids, count, AND payload bit planes)."""
    from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list

    dims = (32, 32, 32)
    rng = np.random.default_rng(4)
    pts = (rng.uniform(0, 8, (64, 3)).astype(np.float32) // 1) + 0.5
    meanings = rng.choice(np.array([12, 57, 99, 201], np.int32), 64)
    fused = bit_vector_voxel_list(dims).insert_point_cloud_with_meanings(pts, meanings)
    oracle = bit_vector_voxel_list(dims)
    for m in np.unique(meanings):
        oracle = oracle.insert_point_cloud(pts[meanings == m], int(m))
    n = int(fused.count)
    assert n == int(oracle.count)
    np.testing.assert_array_equal(np.asarray(fused.ids[:n]), np.asarray(oracle.ids[:n]))
    np.testing.assert_array_equal(
        np.asarray(fused.payload[:, :n]), np.asarray(oracle.payload[:, :n])
    )
