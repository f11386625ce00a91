"""Paged hierarchical map (octree-scale sparse tier) tests."""
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax.maps.hierarchical import NS_DYNAMIC_MAP, NS_STATIC_MAP
from gpu_voxels_jax.maps.paged import PagedHierarchicalMap
from gpu_voxels_jax.maps.voxellist import bit_vector_morton_voxel_list

DIMS = (4096, 4096, 4096)


def scattered_points(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 4096, (n, 3)).astype(np.float32)


def test_insert_probe_scales_past_dense_wall():
    m = PagedHierarchicalMap(DIMS, 1.0)
    pts = scattered_points()
    m.insert_point_cloud(pts)
    coords = np.floor(pts).astype(np.int32)
    occ, unk, free = m.probe(jnp.asarray(coords))
    assert int(np.asarray(occ).sum()) == len(pts)
    # memory scales with surface, not volume (4096^3 dense int8 = 69 GB)
    assert m.memory_usage() < 600 * 1024 * 1024
    assert m.n_tiles() <= len(pts)

    empty = np.array([[1, 1, 1], [4000, 12, 7]], np.int32)
    occ2, unk2, _ = m.probe(jnp.asarray(empty))
    assert not bool(occ2.any()) and bool(unk2.all())


def test_allocation_fetches_o_new_tiles_not_o_points(monkeypatch):
    """Device-side allocation path (VERDICT r3 item #8): a frame entering
    fresh territory fetches the new-tile count + the compacted new-block
    prefix — O(new tiles) — never the full O(points) coords array; a
    steady-state insert (all tiles allocated) fetches ONE scalar."""
    from gpu_voxels_jax.maps import paged as paged_mod

    fetches = []
    real = paged_mod._host_fetch

    def counting(arr):
        out = real(arr)
        fetches.append(int(np.asarray(out).size))
        return out

    monkeypatch.setattr(paged_mod, "_host_fetch", counting)

    m = PagedHierarchicalMap(DIMS, 1.0)
    # 50k points clustered into few blocks: new tiles << points
    rng = np.random.default_rng(3)
    centers = rng.uniform(64, 4000, (6, 3)).astype(np.float32)
    pts = (centers[rng.integers(0, 6, 50_000)] + rng.uniform(0, 4, (50_000, 3))).astype(
        np.float32
    )
    def bucket(n):
        # the fetched prefix is pow2-bucketed (maps/paged.py _allocate_for) so
        # distinct new-tile counts reuse compiled fetch programs; still O(tiles)
        return max(8, 1 << (n - 1).bit_length())

    m.insert_point_cloud(pts)
    nt = m.n_tiles()
    assert nt < 200  # clustered: tiles << points
    # fresh map: one count scalar + one [bucket(n_new), 3] prefix (no pre-check)
    assert fetches == [1, 3 * bucket(nt)], fetches

    # steady state: same territory -> exactly one pre-check scalar
    fetches.clear()
    m.insert_point_cloud(pts[:1000])
    assert fetches == [1], fetches

    # partial growth: pre-check scalar + count + O(new tiles) prefix only
    fetches.clear()
    n0 = m.n_tiles()
    grow = np.concatenate([pts[:30_000], pts[:100] + 900.0]).astype(np.float32)
    m.insert_point_cloud(grow)
    new_tiles = m.n_tiles() - n0
    assert new_tiles > 0
    assert fetches == [1, 1, 3 * bucket(new_tiles)], fetches
    assert fetches[2] < len(grow)  # O(new tiles), never O(points)

    # correctness unchanged: every inserted point probes occupied
    occ, _, _ = m.probe(jnp.asarray(np.floor(pts[:500]).astype(np.int32)))
    assert bool(np.asarray(occ).all())


def test_hard_status_semantics_and_flags():
    m = PagedHierarchicalMap(DIMS, 1.0)
    p = np.array([[100.5, 100.5, 100.5]], np.float32)
    m.insert_point_cloud(p, meaning=0, static_map=False)  # eBVM_FREE, dynamic
    q = jnp.asarray([[100, 100, 100]], jnp.int32)
    o, u, f = m.probe(q)
    assert bool(f[0]) and not bool(o[0])
    assert int(np.asarray(m.probe_status(q))[0]) & NS_DYNAMIC_MAP
    m.insert_point_cloud(p, static_map=True)  # hard re-occupy
    o, _, f = m.probe(q)
    assert bool(o[0]) and not bool(f[0])
    assert int(np.asarray(m.probe_status(q))[0]) & NS_STATIC_MAP


def test_min_level_probes():
    m = PagedHierarchicalMap(DIMS, 1.0)
    m.insert_point_cloud(np.array([[100.5, 100.5, 100.5]], np.float32))
    # same 2-cube at min_level=1, same 4-cube at 2, same block at 3
    assert bool(m.probe(jnp.asarray([[100, 100, 101]], jnp.int32), min_level=1)[0][0])
    assert bool(m.probe(jnp.asarray([[103, 103, 103]], jnp.int32), min_level=2)[0][0])
    assert bool(m.probe(jnp.asarray([[97, 98, 99]], jnp.int32), min_level=3)[0][0])
    # exact neighbor voxel is NOT occupied at level 0
    assert not bool(m.probe(jnp.asarray([[100, 100, 101]], jnp.int32))[0][0])


def test_collide_with_morton_list():
    m = PagedHierarchicalMap(DIMS, 1.0)
    pts = scattered_points(300, seed=3)
    m.insert_point_cloud(pts)
    lst = bit_vector_morton_voxel_list(DIMS).insert_point_cloud(pts[:40], 50)
    assert int(m.collide_with(lst)) == 40
    far = bit_vector_morton_voxel_list(DIMS).insert_point_cloud(
        np.array([[2.5, 2.5, 2.5]], np.float32), 50
    )
    assert int(m.collide_with(far)) == 0


def test_extract_and_reinsert():
    m = PagedHierarchicalMap(DIMS, 1.0)
    pts = scattered_points(500, seed=5)
    m.insert_point_cloud(pts)
    tiles0 = m.n_tiles()
    m.insert_point_cloud(pts)  # same voxels: no new tiles
    assert m.n_tiles() == tiles0
    ex = m.extract_occupied_coords()
    got = set(map(tuple, ex.tolist()))
    expect = set(map(tuple, np.floor(pts).astype(np.int32).tolist()))
    assert got == expect


def test_factory_routes_large_worlds_to_paged():
    from gpu_voxels_jax.api import GpuVoxels
    from gpu_voxels_jax.constants import MapType

    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(2048, 2048, 2048, 1.0)
    m = gvl.add_map(MapType.MT_BITVECTOR_OCTREE, "bigworld")
    assert isinstance(m, PagedHierarchicalMap)
    GpuVoxels._instance = None


def test_octree_scale_32768():
    """Full reference-scale addressability: 15 levels = 32768^3 virtual
    voxels (common_defines.h:189-191), sparse memory, exact probes."""
    m = PagedHierarchicalMap((32768, 32768, 32768), 1.0)
    assert m.fine_levels >= 15
    pts = np.array(
        [[31000.5, 17.5, 22222.5], [5.5, 30000.5, 12345.5], [31000.5, 17.5, 22223.5]],
        np.float32,
    )
    m.insert_point_cloud(pts)
    coords = np.floor(pts).astype(np.int32)
    occ, unk, free = m.probe(jnp.asarray(coords))
    assert bool(np.asarray(occ).all())
    # neighbors are unknown at level 0, shared at min_level 1
    n = jnp.asarray([[31000, 16, 22222]], jnp.int32)
    assert not bool(m.probe(n)[0][0])
    assert bool(m.probe(n, min_level=1)[0][0])
    # block (3) and page (6) levels resolve too
    assert bool(m.probe(jnp.asarray([[31007, 23, 22216]], jnp.int32), min_level=3)[0][0])
    assert bool(m.probe(jnp.asarray([[31039, 60, 22270]], jnp.int32), min_level=6)[0][0])
    # far empty space stays unknown; memory is sparse (dense int8 = 32 TB)
    assert bool(m.probe(jnp.asarray([[1, 1, 1]], jnp.int32))[1][0])
    assert m.memory_usage() < 300 * 1024 * 1024


def test_paged_snapshot_motion_validity():
    """Motion validation against a snapshot of an octree-scale world: the
    PagedSnapshot pytree rides through the jitted batch checker (the map
    itself is host-grown and not a pytree)."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_jax.planning import MotionValidator
    from gpu_voxels_jax.planning.validity import HierarchicalValidityChecker
    from gpu_voxels_jax.robot.dh import DHParameters, KinematicChain

    params = [DHParameters(0, 0, 0.0, 0), DHParameters(0, 0, 0.0, 0)]
    clouds = MetaPointCloud.from_clouds(
        [np.linspace([40.0, 0.0, 0.0], [80.0, 0.0, 0.0], 9).astype(np.float32)],
        names=("l2",),
    )
    arm = KinematicChain(["l1", "l2"], params, clouds)

    class Based:
        def transformed_clouds_for(self, cfg):
            import jax.numpy as jnp
            from dataclasses import replace

            full = jnp.concatenate([jnp.asarray(cfg, jnp.float32), jnp.zeros((1,))])
            c = arm.transformed_clouds_for(full)
            return replace(c, points=c.points + jnp.asarray([8000.0, 8000.0, 50.0]))

    m = PagedHierarchicalMap((32768, 32768, 32768), 1.0)
    # wall slab blocking the +x direction (x 8050..8080, y 7995..8005, z 50):
    # thick enough that a 0.02-rad sweep through zero cannot step over it
    gx, gy = np.meshgrid(np.arange(8050, 8081), np.arange(7995, 8006), indexing="ij")
    wall = np.stack(
        [gx.ravel(), gy.ravel(), np.full(gx.size, 50.0)], -1
    ).astype(np.float32) + 0.5
    m.insert_point_cloud(wall)
    checker = HierarchicalValidityChecker(m.snapshot(), Based())
    assert checker.colliding_voxels(np.array([0.0], np.float32)) >= 1  # +x blocked
    assert checker.colliding_voxels(np.array([np.pi / 2], np.float32)) == 0
    mv = MotionValidator(checker, resolution=0.02)
    ok, _ = mv.check_motion([np.pi / 2], [np.pi])
    assert ok
    bad, _ = mv.check_motion([-0.2], [0.2])
    assert not bad


def test_paged_checker_matches_dense_and_refreshes():
    """The paged tier is a drop-in env for HierarchicalValidityChecker (the
    config-#5 route at >=1024^3, gvl_ompl_planner_helper.cpp:42-330 at
    octree/DataTypes.h scale): batch colliding-voxel counts equal the dense
    status pyramid's bit-for-bit, the host-stateful map is accepted directly
    (auto-snapshot), and refresh() re-captures after mutation."""
    from dataclasses import replace

    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap
    from gpu_voxels_jax.planning.validity import HierarchicalValidityChecker

    rng = np.random.default_rng(7)
    env_pts = rng.uniform(0, 128, (4000, 3)).astype(np.float32)
    dense = HierarchicalBitMap.create((128, 128, 128)).insert_point_cloud(env_pts)
    paged = PagedHierarchicalMap((128, 128, 128), 1.0)
    paged.insert_point_cloud(env_pts)

    robot_cloud = MetaPointCloud.from_clouds(
        [rng.uniform(-2, 2, (60, 3)).astype(np.float32)], names=("body",)
    )

    class Translated:
        def transformed_clouds_for(self, cfg):
            return replace(robot_cloud, points=robot_cloud.points + cfg)

    states = rng.uniform(8.0, 120.0, (17, 3)).astype(np.float32)
    cv_dense = HierarchicalValidityChecker(dense, Translated()).batch_colliding_voxels(
        states
    )
    checker = HierarchicalValidityChecker(paged, Translated())  # map, not snapshot
    cv_paged = checker.batch_colliding_voxels(states)
    assert (cv_dense == cv_paged).all()
    assert int(cv_dense.sum()) > 0  # scene actually collides somewhere

    # mutate the paged env; stale snapshot until refresh()
    free0 = states[int(np.flatnonzero(cv_paged == 0)[0])]
    blob = (free0[None, :] + rng.uniform(-2, 2, (60, 3))).astype(np.float32)
    paged.insert_point_cloud(blob)
    assert int(checker.batch_colliding_voxels(states[:1])[0]) == int(cv_paged[0])
    checker.refresh()
    assert int(checker.colliding_voxels(free0)) > 0


def test_free_space_insert_carves_rays():
    """insertPointCloudWithFreespaceCalculation on the sparse tier: cells
    between sensor and hit become hard FREE, hits occupied, off-ray space
    stays unknown (GvlNTree.hpp:108-130 semantics)."""
    m = PagedHierarchicalMap(DIMS, 1.0)
    origin = (100.5, 100.5, 100.5)
    hits = np.array([[120.5, 100.5, 100.5], [100.5, 100.5, 90.5]], np.float32)
    m.insert_point_cloud_with_free_space(hits, origin)
    occ, _, free = m.probe(jnp.asarray(np.floor(hits).astype(np.int32)))
    assert bool(np.asarray(occ).all())
    # ray interiors are FREE (endpoint excluded, sensor cell included)
    ray = jnp.asarray([[100, 100, 100], [110, 100, 100], [119, 100, 100],
                       [100, 100, 95], [100, 100, 91]], jnp.int32)
    o2, _, f2 = m.probe(ray)
    assert bool(np.asarray(f2).all()) and not bool(np.asarray(o2).any())
    # off-ray stays unknown
    _, u3, _ = m.probe(jnp.asarray([[100, 105, 100]], jnp.int32))
    assert bool(u3[0])


def test_free_space_insert_nonpow2_no_phantom_carve():
    """Regression: a non-power-of-two point count pads with -1e9 sentinels;
    sentinel rays must be dead — previously each one carved the whole
    origin->corner diagonal hard-FREE, overwriting legitimate statuses."""
    m = PagedHierarchicalMap(DIMS, 1.0)
    origin = (100.5, 100.5, 100.5)
    hits = np.array(
        [[120.5, 100.5, 100.5], [100.5, 120.5, 100.5], [100.5, 100.5, 120.5]],
        np.float32,
    )  # 3 points -> pads to 4: one sentinel ray toward the negative corner
    m.insert_point_cloud_with_free_space(hits, origin)
    # the origin->corner diagonal must stay UNKNOWN, not FREE
    diag = np.arange(10, 100, dtype=np.int32)
    q = jnp.asarray(np.stack([diag, diag, diag], axis=1))
    _, unk, free = m.probe(q)
    assert not bool(np.asarray(free).any())
    assert bool(np.asarray(unk).all())
    # the real rays still carved
    o, _, f = m.probe(jnp.asarray([[110, 100, 100], [100, 110, 100]], jnp.int32))
    assert bool(np.asarray(f).all()) and not bool(np.asarray(o).any())


def test_min_level_block_cube_keeps_unknown_beside_occupied():
    """probe_status at min_level 3-5: a cube mixing an occupied block with
    unallocated (unknown) blocks must carry NS_UNKNOWN through the OR, same
    as the dense page pyramid and the tile path."""
    from gpu_voxels_jax.maps.hierarchical import NS_OCCUPIED, NS_UNKNOWN

    m = PagedHierarchicalMap(DIMS, 1.0)
    m.insert_point_cloud(np.array([[100.5, 100.5, 100.5]], np.float32))
    s = int(np.asarray(m.probe_status(jnp.asarray([[100, 100, 100]], jnp.int32), min_level=4))[0])
    assert s & NS_OCCUPIED
    assert s & NS_UNKNOWN  # 15 of the 16-block cube are unallocated


def test_paged_disk_roundtrip(tmp_path):
    """write_paged_map/read_paged_map: statuses, flags, page/slot structure
    and probes survive a disk roundtrip; facade save/load dispatches it."""
    from gpu_voxels_jax.utils import io as map_io

    m = PagedHierarchicalMap((32768, 32768, 32768), 0.5)
    pts = np.array(
        [[3000.25, 17.75, 12222.25], [5.25, 15000.25, 1234.75]], np.float32
    )
    m.insert_point_cloud(pts)
    m.insert_point_cloud(
        np.array([[40.25, 40.25, 40.25]], np.float32), meaning=0, static_map=False
    )
    path = tmp_path / "paged.bin"
    map_io.write_paged_map(m, path)
    m2 = map_io.read_hierarchical_map(path)
    assert isinstance(m2, PagedHierarchicalMap)
    assert m2.dims == m.dims and m2.side_length == m.side_length
    assert m2.n_tiles() == m.n_tiles()
    np.testing.assert_array_equal(
        np.asarray(m2.pool[: m2.n_tiles()]), np.asarray(m.pool[: m.n_tiles()])
    )
    q = jnp.asarray(np.floor(pts / 0.5).astype(np.int32))
    np.testing.assert_array_equal(
        np.asarray(m.probe_status(q)), np.asarray(m2.probe_status(q))
    )
    o, _, f = m2.probe(jnp.asarray([[80, 80, 80]], jnp.int32))
    assert bool(f[0]) and not bool(o[0])


def test_paged_ascii_roundtrip(tmp_path):
    """NTree::serialize ascii mode (NTree.hpp:3283-3400) on the sparse tier:
    both instantiations roundtrip pool contents and probe results."""
    from gpu_voxels_jax.utils import io as map_io

    pts = np.array([[3000.25, 17.75, 1222.25], [5.25, 1500.25, 1234.75]], np.float32)
    for prob in (False, True):
        m = PagedHierarchicalMap((4096, 4096, 4096), 0.5, probabilistic=prob)
        m.insert_point_cloud(pts)
        path = tmp_path / "paged.txt"
        map_io.write_paged_map(m, path, ascii=True)
        assert path.read_bytes().startswith(b"GPU_VOXELS_JAX_OCTREE ascii")
        m2 = map_io.read_hierarchical_map(path)
        assert isinstance(m2, PagedHierarchicalMap) and m2.probabilistic == prob
        assert m2.dims == m.dims and m2.side_length == m.side_length
        assert m2.n_tiles() == m.n_tiles()
        if prob:
            np.testing.assert_array_equal(
                np.asarray(m2.occ_pool[: m2.n_tiles()]),
                np.asarray(m.occ_pool[: m.n_tiles()]),
            )
        np.testing.assert_array_equal(
            np.asarray(m2.pool[: m2.n_tiles()]), np.asarray(m.pool[: m.n_tiles()])
        )
        q = jnp.asarray(np.floor(pts / 0.5).astype(np.int32))
        np.testing.assert_array_equal(
            np.asarray(m.probe_status(q)), np.asarray(m2.probe_status(q))
        )


def test_probabilistic_paged_octree_scale():
    """GvlNTreeProb at full NTree scale (Octree.cu:71): log-odds inserts and
    the EnvNodesProbCommon.h:30-45 occupancy contract at 32768^3, sparse."""
    from gpu_voxels_jax.constants import MapType

    m = PagedHierarchicalMap((32768, 32768, 32768), 1.0, probabilistic=True)
    assert m.map_type == MapType.MT_PROBAB_OCTREE
    pts = np.array([[31000.5, 17.5, 22222.5], [5.5, 30000.5, 12345.5]], np.float32)
    m.insert_point_cloud(pts)  # meaning insert: occ = MAX_PROBABILITY
    c = jnp.asarray(np.floor(pts).astype(np.int32))
    np.testing.assert_array_equal(np.asarray(m.probe_occupancy(c)), [127, 127])
    occ, unk, free = m.probe(c)
    assert bool(np.asarray(occ).all())
    # eBVM_FREE insert sets MIN_PROBABILITY
    m.insert_point_cloud(pts[:1], meaning=0)
    assert int(np.asarray(m.probe_occupancy(c))[0]) == -127
    o2, _, f2 = m.probe(c)
    assert bool(f2[0]) and not bool(o2[0]) and bool(o2[1])
    # untouched space reads UNKNOWN (-128), coarse pyramid still answers
    q = jnp.asarray([[1, 1, 1]], jnp.int32)
    assert int(np.asarray(m.probe_occupancy(q))[0]) == -128
    assert bool(m.probe(q)[1][0])
    assert bool(m.probe(c[1:], min_level=6)[0][0])
    assert m.memory_usage() < 300 * 1024 * 1024


def test_probabilistic_paged_sensor_fusion_contract():
    """Exact insertSensorData arithmetic on the sparse tier: hit =
    UNKNOWN+SENSOR_MODEL_OCCUPIED clamped, ray crossing = SENSOR_MODEL_FREE
    clamped at MIN_PROBABILITY; occupied needs occ >= 10 (two frames)."""
    m = PagedHierarchicalMap(DIMS, 1.0, probabilistic=True)
    origin = (100.5, 100.5, 100.5)
    hits = np.array([[120.5, 100.5, 100.5]], np.float32)
    m.insert_point_cloud_with_free_space(hits, origin)
    hit_q = jnp.asarray([[120, 100, 100]], jnp.int32)
    ray_q = jnp.asarray([[110, 100, 100]], jnp.int32)
    assert int(np.asarray(m.probe_occupancy(hit_q))[0]) == -128 + 72  # -56
    assert int(np.asarray(m.probe_occupancy(ray_q))[0]) == -127  # clamp floor
    o, _, f = m.probe(jnp.concatenate([hit_q, ray_q]))
    assert not bool(o[0])  # -56 < THRESHOLD_OCCUPANCY: not yet occupied
    assert bool(f[1])
    m.insert_point_cloud_with_free_space(hits, origin)
    assert int(np.asarray(m.probe_occupancy(hit_q))[0]) == -56 + 72  # 16
    o2, _, _ = m.probe(hit_q)
    assert bool(o2[0])  # 16 >= 10: occupied
    # off-ray space stays untouched
    assert int(np.asarray(m.probe_occupancy(jnp.asarray([[100, 105, 100]], jnp.int32)))[0]) == -128


def test_probabilistic_paged_nonpow2_and_depth_image():
    """Sentinel rays are dead in the probabilistic tier too; the depth-image
    entry point (octree Sensor pipeline) fuses hits + carving."""
    from gpu_voxels_jax.sensors import Sensor

    m = PagedHierarchicalMap(DIMS, 1.0, probabilistic=True)
    origin = (100.5, 100.5, 100.5)
    hits = np.array(
        [[120.5, 100.5, 100.5], [100.5, 120.5, 100.5], [100.5, 100.5, 120.5]],
        np.float32,
    )  # 3 points pads to 4: one sentinel
    m.insert_point_cloud_with_free_space(hits, origin)
    diag = np.arange(10, 100, dtype=np.int32)
    q = jnp.asarray(np.stack([diag, diag, diag], axis=1))
    assert bool((np.asarray(m.probe_occupancy(q)) == -128).all())

    cam = Sensor(
        position=np.array([200.5, 200.5, 200.5], np.float32),
        data_width=16, data_height=16, fx=16.0, fy=16.0, cx=8.0, cy=8.0,
    )
    depth = np.full((16, 16), 20.0, np.float32)
    depth[0, 0] = 0.0  # invalid pixel: no ray
    m2 = PagedHierarchicalMap(DIMS, 1.0, probabilistic=True)
    m2.insert_depth_image(depth, cam)
    # the central ray's endpoint voxel got one +72 hit
    center = np.asarray(cam.pose())[:3, 3] + np.asarray([0.0, 0.0, 20.0])
    cq = jnp.asarray(np.floor(center[None]).astype(np.int32))
    assert int(np.asarray(m2.probe_occupancy(cq))[0]) >= -56
    # a cell partway along the optical axis was carved: any crossing count
    # clamps -128 + k*SENSOR_MODEL_FREE to the -127 floor
    mid = jnp.asarray([[200, 200, 210]], jnp.int32)
    assert int(np.asarray(m2.probe_occupancy(mid))[0]) == -127
    assert bool(m2.probe(mid)[2][0])  # reads FREE


def test_factory_routes_large_prob_octree_to_paged():
    from gpu_voxels_jax.api import GpuVoxels
    from gpu_voxels_jax.constants import MapType

    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(2048, 2048, 2048, 1.0)
    m = gvl.add_map(MapType.MT_PROBAB_OCTREE, "bigprob")
    assert isinstance(m, PagedHierarchicalMap) and m.probabilistic
    GpuVoxels._instance = None


def test_paged_prob_disk_roundtrip(tmp_path):
    from gpu_voxels_jax.utils import io as map_io

    m = PagedHierarchicalMap((32768, 32768, 32768), 0.5, probabilistic=True)
    pts = np.array([[3000.25, 17.75, 12222.25], [5.25, 15000.25, 1234.75]], np.float32)
    m.insert_point_cloud_with_free_space(pts, (3000.25, 20.75, 12222.25))
    path = tmp_path / "paged_prob.bin"
    map_io.write_paged_map(m, path)
    m2 = map_io.read_hierarchical_map(path)
    assert isinstance(m2, PagedHierarchicalMap) and m2.probabilistic
    assert m2.n_tiles() == m.n_tiles()
    np.testing.assert_array_equal(
        np.asarray(m2.occ_pool[: m2.n_tiles()]), np.asarray(m.occ_pool[: m.n_tiles()])
    )
    q = jnp.asarray(np.floor(pts / 0.5).astype(np.int32))
    np.testing.assert_array_equal(
        np.asarray(m.probe_occupancy(q)), np.asarray(m2.probe_occupancy(q))
    )
    np.testing.assert_array_equal(
        np.asarray(m.probe_status(q)), np.asarray(m2.probe_status(q))
    )


def test_small_side_length_padding_sentinel_safe():
    """Pow2 padding uses far-negative sentinel points; with small
    side_length the scaled sentinel exceeds int32 — the pre-cast clamp in
    map_to_voxels must keep it deterministically out of range (no phantom
    voxels)."""
    m = PagedHierarchicalMap((2048, 2048, 2048), 0.01)
    pts = np.array([[5.115, 5.115, 5.115], [5.125, 5.115, 5.115], [5.135, 5.115, 5.115]], np.float32)
    m.insert_point_cloud(pts)  # 3 points pads to 4: one -1e9 sentinel
    occ = np.asarray(m.extract_occupied_coords())
    assert len(occ) == 3
    np.testing.assert_array_equal(
        np.sort(occ[:, 0]), np.array([511, 512, 513])
    )


# -- collide surface (NTree.hpp:1006/1139, GvlNTree.hpp:150-330) --------------
def _oracle_hits(a_coords, b_coords, offset=(0, 0, 0)):
    """Count of b-voxels c with (c + offset) in a's occupied set."""
    a = {tuple(v) for v in np.asarray(a_coords).tolist()}
    off = np.asarray(offset, np.int64)
    return sum(tuple((np.asarray(c) + off).tolist()) in a for c in np.asarray(b_coords).tolist())


def test_paged_x_dense_map_collide_with_offset():
    """intersect_load_balance(ProbVoxelMap&) analogue (NTree.hpp:1006):
    exact counts vs the set oracle, prob and bit maps, zero and nonzero
    offsets."""
    from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap

    rng = np.random.default_rng(11)
    paged_pts = rng.uniform(0, 250, (400, 3)).astype(np.float32)
    map_pts = np.concatenate([paged_pts[:120], rng.uniform(0, 250, (200, 3)).astype(np.float32)])
    m = PagedHierarchicalMap(DIMS, 1.0)
    m.insert_point_cloud(paged_pts)
    pc, mc = np.floor(paged_pts).astype(np.int32), np.floor(map_pts).astype(np.int32)

    for dense in (
        ProbVoxelMap.create((256, 256, 256)).insert_point_cloud(map_pts),
        BitVectorVoxelMap.create((256, 256, 256)).insert_point_cloud(map_pts),
    ):
        assert int(m.collide_with(dense)) == _oracle_hits(pc, mc)
        off = (3, -2, 5)
        assert int(m.collide_with(dense, offset=off)) == _oracle_hits(pc, mc, off)


def test_paged_x_dense_map_resolution_probe():
    """collideWithResolution vs a dense map at min_level > 0 runs the literal
    per-map-voxel probe: count = map-occupied voxels whose coarse octree
    probe hits."""
    from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap

    m = PagedHierarchicalMap(DIMS, 1.0)
    m.insert_point_cloud(np.array([[100.5, 100.5, 100.5]], np.float32))
    dense = ProbVoxelMap.create((256, 256, 256)).insert_point_cloud(
        np.array([[100.5, 100.5, 101.5], [103.5, 100.5, 100.5], [90.5, 90.5, 90.5]], np.float32)
    )
    # level 1: (100,100,101) shares the 2-cube -> 1 hit; level 2 adds (103,100,100)
    assert int(m.collide_with_resolution(dense, resolution_level=1)) == 1
    assert int(m.collide_with_resolution(dense, resolution_level=2)) == 2


def test_paged_x_paged_collide():
    """NTree x NTree (intersect_load_balance, NTree.hpp:1139): exact shared
    occupied count; offset rejected like the reference's error path."""
    rng = np.random.default_rng(12)
    pa = rng.uniform(0, 3000, (300, 3)).astype(np.float32)
    pb = np.concatenate([pa[:77], rng.uniform(0, 3000, (100, 3)).astype(np.float32)])
    a = PagedHierarchicalMap(DIMS, 1.0)
    a.insert_point_cloud(pa)
    b = PagedHierarchicalMap(DIMS, 1.0)
    b.insert_point_cloud(pb)
    expect = _oracle_hits(np.floor(pa).astype(np.int32), np.floor(pb).astype(np.int32))
    assert int(a.collide_with(b)) == expect
    with pytest.raises(ValueError):
        a.collide_with(b, offset=(1, 0, 0))


def test_paged_x_dense_hierarchy_collide_both_directions():
    """Paged octree x dense pyramid tier, dispatched from either side."""
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap

    rng = np.random.default_rng(13)
    pa = rng.uniform(0, 200, (150, 3)).astype(np.float32)
    pb = np.concatenate([pa[:40], rng.uniform(0, 200, (60, 3)).astype(np.float32)])
    paged = PagedHierarchicalMap(DIMS, 1.0)
    paged.insert_point_cloud(pa)
    hier = HierarchicalBitMap.create((256, 256, 256)).insert_point_cloud(pb)
    expect = _oracle_hits(np.floor(pb).astype(np.int32), np.floor(pa).astype(np.int32))
    assert int(paged.collide_with(hier)) == expect
    assert int(hier.collide_with(paged)) == expect


def test_paged_counting_unknown_and_list_dispatch():
    """collideWithTypesConsideringUnknownCells (GvlNTree.h:115-129) on the
    sparse tier + the list->octree collide direction
    (CollisionInterfaces.h:231-243)."""
    m = PagedHierarchicalMap(DIMS, 1.0)
    origin = (100.5, 100.5, 100.5)
    hits = np.array([[120.5, 100.5, 100.5], [100.5, 120.5, 100.5]], np.float32)
    m.insert_point_cloud_with_free_space(hits, origin)  # carves rays FREE
    lst = bit_vector_morton_voxel_list(DIMS).insert_point_cloud(
        np.array(
            [[120.5, 100.5, 100.5],  # occupied hit
             [110.5, 100.5, 100.5],  # carved free: neither
             [50.5, 50.5, 50.5]],    # untouched: unknown
            np.float32,
        ),
        50,
    )
    occ, unk = m.collide_with_counting_unknown(lst)
    assert (int(occ), int(unk)) == (1, 1)
    assert int(lst.collide_with(m)) == 1  # list->octree dispatch
    # offset translates the list into the octree frame (GvlNTree.hpp:195):
    # (120,100,100) + (-20,20,0) lands on the occupied (100,120,100)
    assert int(m.collide_with(lst, offset=(-20, 20, 0))) == 1
    occ2, unk2 = m.collide_with_counting_unknown(lst, offset=(-20, 20, 0))
    assert int(occ2) == 1


def test_paged_build_free_bounding_box_and_check_tree():
    """NTree::build + free_bounding_box on the sparse tier: box interior
    reads FREE, hits OCCUPIED, the virtual remainder stays UNKNOWN; the
    checkTree invariant holds and oversized boxes are rejected."""
    m = PagedHierarchicalMap((4096, 4096, 4096), 1.0)
    pts = (np.array([[100, 100, 100], [110, 110, 110]], np.float32) + 0.5)
    m.build(pts, free_bounding_box=True)
    occ, unk, free = m.probe(jnp.array([[100, 100, 100], [105, 105, 105], [2000, 2000, 2000]]))
    assert bool(occ[0]) and bool(free[1]) and not bool(occ[1]) and bool(unk[2])
    assert m.check_tree() and not m.needs_rebuild()
    with pytest.raises(ValueError):
        m.build(np.array([[0.5] * 3, [4000.5] * 3], np.float32), free_bounding_box=True)
    # the rejected oversized box must NOT have wiped the existing contents
    occ3, _, _ = m.probe(jnp.array([[100, 100, 100]]))
    assert bool(occ3[0])


def test_paged_adapter_contract_methods():
    """Same GpuVoxelsMap contract on the sparse paged tier."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud

    link = (np.array([[100, 100, 100]], np.float32) + 0.5)
    meta = MetaPointCloud.from_clouds([link, link + 8.0])
    m = PagedHierarchicalMap((4096, 4096, 4096), 1.0)
    m.insert_meta_point_cloud(meta, meanings=[1, 1])
    occ, _, _ = m.probe(jnp.array([[100, 100, 100], [108, 108, 108]]))
    assert bool(occ[0]) and bool(occ[1])
    _, ok = m.insert_robot_configuration(meta, with_self_collision_test=True)
    assert ok
    _, bad = m.insert_robot_configuration(
        MetaPointCloud.from_clouds([link, link]), with_self_collision_test=True
    )
    assert not bad
    m.clear_voxel_meaning(5)  # non-OCCUPIED: no-op
    occ2, _, _ = m.probe(jnp.array([[100, 100, 100]]))
    assert bool(occ2[0])
    m.clear_voxel_meaning(1)
    _, unk, _ = m.probe(jnp.array([[100, 100, 100]]))
    assert bool(unk[0])
