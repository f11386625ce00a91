"""ShardedPagedWorld: z-slab multi-device paged octree vs the single-device
PagedHierarchicalMap oracle (runs on the virtual 8-device CPU mesh).

Every result — probe statuses, occupancies, all collide directions, tile
counts — must EQUAL the single-device map's; the sharding is a layout, not a
semantic fork. `assert_distributed` pins that the pools really live on
distinct devices (a silent single-device fallback would still pass the
equality checks)."""
import jax
import numpy as np
import pytest

from gpu_voxels_jax.constants import BitVoxelMeaning
from gpu_voxels_jax.maps.paged import PagedHierarchicalMap
from gpu_voxels_jax.parallel import ShardedPagedWorld

DIMS = (64, 64, 512)  # 8 slabs of 64 -> one page of depth per device


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_caches():
    """Running late in the full suite, the XLA CPU JIT has hundreds of live
    loaded executables; compiling this module's paged programs on top of
    them has segfaulted LLVM twice (full-suite runs only — the file alone
    and the paged subset both pass). Dropping the accumulated executables
    first costs a few recompiles and removes the crash."""
    jax.clear_caches()


def _devices(n=8):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return devs[:n]


def _scene(seed=0, n=400):
    """Points spread across every slab (cluster + uniform spray)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, 0, 0], [64, 64, 512], size=(n, 3)).astype(np.float32)
    cluster = rng.normal([32, 32, 250], 6.0, size=(64, 3)).astype(np.float32)
    return np.concatenate([pts, cluster], axis=0)


def _queries(seed=1, q=2048):
    rng = np.random.default_rng(seed)
    return rng.integers([0, 0, 0], [64, 64, 512], size=(q, 3)).astype(np.int32)


def test_deterministic_world_matches_single_device():
    devs = _devices()
    pts = _scene()
    free = _scene(seed=7, n=100)

    single = PagedHierarchicalMap(DIMS, 1.0)
    single.insert_point_cloud(pts)
    single.insert_point_cloud(free, BitVoxelMeaning.eBVM_FREE, static_map=False)

    world = ShardedPagedWorld(DIMS, 1.0, devices=devs)
    world.insert_point_cloud(pts)
    world.insert_point_cloud(free, BitVoxelMeaning.eBVM_FREE, static_map=False)

    world.assert_distributed()
    assert world.check_tree()
    # tiles partition exactly: slab boundaries are page boundaries
    assert world.n_tiles() == single.n_tiles()
    # at least two slabs hold tiles (the scene spans the world)
    assert sum(1 for m in world.shards if m.n_tiles()) >= 2

    q = _queries()
    want = np.asarray(single.probe_status(q))
    assert (world.probe_status(q) == want).all()
    occ_w, unk_w, free_w = world.probe(q)
    occ_s, unk_s, free_s = (np.asarray(a) for a in single.probe(q))
    assert (occ_w == occ_s).all() and (unk_w == unk_s).all() and (free_w == free_s).all()

    assert world.collide_with_coords(q) == int(single.collide_with_coords(q))
    cw, uw = world.collide_with_counting_unknown_coords(q)
    cs, us = single.collide_with_counting_unknown_coords(q)
    assert (cw, uw) == (int(cs), int(us))

    # occupied extraction matches as a set
    ws = {tuple(r) for r in world.extract_occupied_coords()}
    ss = {tuple(r) for r in single.extract_occupied_coords()}
    assert ws == ss


def test_free_space_rays_cross_slabs():
    """A sensor in slab 0 looking down +z: rays traverse many slabs and every
    slab's cells must carve exactly like the single-device walk."""
    devs = _devices()
    origin = (32.5, 32.5, 4.5)
    rng = np.random.default_rng(3)
    hits = rng.uniform([8, 8, 300], [56, 56, 500], size=(95, 3)).astype(np.float32)
    # one ray straight down +z so specific mid-slab cells are provably carved
    hits = np.concatenate([hits, [[32.5, 32.5, 490.5]]]).astype(np.float32)

    single = PagedHierarchicalMap(DIMS, 1.0)
    single.insert_point_cloud_with_free_space(hits, origin, max_steps=512)
    world = ShardedPagedWorld(DIMS, 1.0, devices=devs)
    world.insert_point_cloud_with_free_space(hits, origin, max_steps=512)

    assert world.n_tiles() == single.n_tiles()
    q = _queries(seed=5)
    assert (world.probe_status(q) == np.asarray(single.probe_status(q))).all()
    # cells along the optical axis in middle slabs really read FREE
    mid = np.array([[32, 32, 200], [32, 32, 340]], np.int32)
    assert world.probe(mid)[2].all()


def test_probabilistic_world_occupancy():
    devs = _devices()
    origin = (32.5, 32.5, 4.5)
    hits = _scene(seed=11, n=64)[:, :]
    hits[:, 2] = np.clip(hits[:, 2], 64, 511)  # endpoints beyond slab 0

    single = PagedHierarchicalMap(DIMS, 1.0, probabilistic=True)
    single.insert_point_cloud_with_free_space(hits, origin, max_steps=512)
    world = ShardedPagedWorld(DIMS, 1.0, probabilistic=True, devices=devs)
    world.insert_point_cloud_with_free_space(hits, origin, max_steps=512)

    q = _queries(seed=13)
    assert (world.probe_occupancy(q) == np.asarray(single.probe_occupancy(q))).all()
    assert (world.probe_status(q) == np.asarray(single.probe_status(q))).all()


def test_collide_directions_match_single_device():
    from gpu_voxels_jax.maps.voxellist import VoxelList
    from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap

    devs = _devices()
    pts = _scene(seed=17)
    single = PagedHierarchicalMap(DIMS, 1.0)
    single.insert_point_cloud(pts)
    world = ShardedPagedWorld(DIMS, 1.0, devices=devs)
    world.insert_point_cloud(pts)

    other_pts = _scene(seed=19, n=300)
    lst = VoxelList.create(DIMS, 1.0, "bit", 4096, "linear").insert_point_cloud(other_pts)
    dense = ProbVoxelMap.create(DIMS, 1.0).insert_point_cloud(other_pts)

    for off in ((0, 0, 0), (2, -1, 67)):
        assert world.collide_with(lst, offset=off) == int(
            single.collide_with(lst, offset=off)
        )
        assert world.collide_with(dense, offset=off) == int(
            single.collide_with(dense, offset=off)
        )
        cw, uw = world.collide_with_counting_unknown(lst, offset=off)
        cs, us = single.collide_with_counting_unknown(lst, offset=off)
        assert (cw, uw) == (int(cs), int(us))
    assert world.collide_with(lst) > 0

    # paged x paged (NTree x NTree): world vs single-device octree
    other_paged = PagedHierarchicalMap(DIMS, 1.0).insert_point_cloud(other_pts)
    assert world.collide_with(other_paged) == int(single.collide_with(other_paged))
    with pytest.raises(ValueError):
        world.collide_with(other_paged, offset=(1, 0, 0))


def test_min_level_probes_and_guard():
    devs = _devices()
    pts = _scene(seed=23)
    single = PagedHierarchicalMap(DIMS, 1.0).insert_point_cloud(pts)
    world = ShardedPagedWorld(DIMS, 1.0, devices=devs).insert_point_cloud(pts)

    q = _queries(seed=29, q=512)
    for lvl in (1, 3, 6):  # 2^6 = 64 divides the slab depth
        assert (
            world.probe_status(q, min_level=lvl)
            == np.asarray(single.probe_status(q, min_level=lvl))
        ).all()
        assert world.collide_with_coords(q, min_level=lvl) == int(
            single.collide_with_coords(q, min_level=lvl)
        )
    with pytest.raises(ValueError):
        world.probe_status(q, min_level=7)  # 128-cube would cross 64-slabs


def test_depth_image_matches_single_device():
    from gpu_voxels_jax.sensors import Sensor

    devs = _devices()
    cam = Sensor(
        position=np.array([32.5, 32.5, 8.5], np.float32),
        data_width=16, data_height=16, fx=16.0, fy=16.0, cx=8.0, cy=8.0,
    )
    depth = np.full((16, 16), 300.0, np.float32)  # rays span ~5 slabs
    depth[0, 0] = 0.0  # invalid pixel

    single = PagedHierarchicalMap(DIMS, 1.0, probabilistic=True)
    single.insert_depth_image(depth, cam, max_steps=512)
    world = ShardedPagedWorld(DIMS, 1.0, probabilistic=True, devices=devs)
    world.insert_depth_image(depth, cam, max_steps=512)

    q = _queries(seed=31)
    assert (world.probe_occupancy(q) == np.asarray(single.probe_occupancy(q))).all()
    assert world.n_tiles() == single.n_tiles()


def test_world_validation_errors():
    devs = _devices()
    with pytest.raises(ValueError):
        ShardedPagedWorld((64, 64, 500), devices=devs)  # 500 % 8 != 0
    with pytest.raises(ValueError):
        ShardedPagedWorld((64, 64, 256), devices=devs)  # 32-deep slabs < page


def test_to_from_paged_map_and_disk_round_trip(tmp_path):
    """Gather/scatter conversions and writeToDisk format parity: the world
    writes the single-device format (same layout; tile slots are ordered
    slab-major rather than insertion-major, so bytes may legally permute)
    and both read paths (single map, distributed world) reproduce every
    probe."""
    devs = _devices()
    pts = _scene(seed=37)
    single = PagedHierarchicalMap(DIMS, 1.0)
    single.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 2.5), max_steps=512)
    world = ShardedPagedWorld(DIMS, 1.0, devices=devs)
    world.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 2.5), max_steps=512)

    q = _queries(seed=41)
    want = np.asarray(single.probe_status(q))

    gathered = world.to_paged_map()
    assert gathered.n_tiles() == single.n_tiles() and gathered.check_tree()
    assert (np.asarray(gathered.probe_status(q)) == want).all()

    split = ShardedPagedWorld.from_paged_map(single, devs)
    split.assert_distributed()
    assert split.n_tiles() == single.n_tiles() and split.check_tree()
    assert (split.probe_status(q) == want).all()

    p_world = tmp_path / "w.bin"
    assert world.write_to_disk(p_world)
    # the world's file reads back through the ordinary single-map path
    from gpu_voxels_jax.utils import io as map_io

    as_single = map_io.read_map(p_world)
    assert isinstance(as_single, PagedHierarchicalMap)
    assert as_single.n_tiles() == single.n_tiles() and as_single.check_tree()
    assert (np.asarray(as_single.probe_status(q)) == want).all()
    back = world.read_from_disk(p_world)
    back.assert_distributed()
    assert (back.probe_status(q) == want).all()
    assert back.n_tiles() == single.n_tiles()


def test_probabilistic_conversions(tmp_path):
    devs = _devices()
    hits = _scene(seed=43, n=80)
    single = PagedHierarchicalMap(DIMS, 1.0, probabilistic=True)
    single.insert_point_cloud_with_free_space(hits, (32.5, 32.5, 2.5), max_steps=512)

    world = ShardedPagedWorld.from_paged_map(single, devs)
    q = _queries(seed=47)
    assert (world.probe_occupancy(q) == np.asarray(single.probe_occupancy(q))).all()
    p = tmp_path / "p.bin"
    assert world.write_to_disk(p)
    back = world.read_from_disk(p)
    assert (back.probe_occupancy(q) == np.asarray(single.probe_occupancy(q))).all()
    with pytest.raises(ValueError):
        ShardedPagedWorld(DIMS, 1.0, devices=devs).read_from_disk(p)  # type mismatch


def test_facade_mesh_routes_paged_tier_to_world(tmp_path):
    """add_map(..., mesh=) on an octree type at paged scale builds a
    distributed ShardedPagedWorld, and facade save/load keep working
    (save = single-device format bytes; load stays distributed)."""
    from jax.sharding import Mesh

    from gpu_voxels_jax.api import GpuVoxels, MapType

    devs = _devices()
    mesh = Mesh(np.asarray(devs), ("z",))
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(64, 64, 2048, 1.0)
    m = gvl.add_map(MapType.MT_BITVECTOR_OCTREE, "world", mesh=mesh)
    assert isinstance(m, ShardedPagedWorld)
    m.assert_distributed()

    pts = (np.random.default_rng(53).uniform(0, 1, (200, 3)) *
           np.asarray([64, 64, 2048])).astype(np.float32)
    m.insert_point_cloud(pts)
    q = np.floor(pts[:50]).astype(np.int32)
    assert m.collide_with_coords(q) == 50  # every inserted cell hits
    assert gvl.visualize_map("world")

    p = tmp_path / "f.bin"
    assert gvl.save_map("world", p)
    m.clear_map()
    assert m.n_tiles() == 0
    assert gvl.load_map("world", p)
    m2 = gvl.get_map("world")
    assert isinstance(m2, ShardedPagedWorld)
    m2.assert_distributed()
    assert m2.collide_with_coords(q) == 50

    # small dims keep the dense pyramid + NamedSharding route
    GpuVoxels._instance = None
    gvl2 = GpuVoxels.get_instance()
    gvl2.initialize(64, 64, 512, 1.0)
    small = gvl2.add_map(MapType.MT_BITVECTOR_OCTREE, "small", mesh=mesh)
    assert not isinstance(small, ShardedPagedWorld)


def test_multilevel_extraction_on_world():
    from gpu_voxels_jax.vis.extract import extract_multilevel_cubes

    devs = _devices()
    pts = _scene(seed=59)
    single = PagedHierarchicalMap(DIMS, 1.0)
    single.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 2.5), max_steps=512)
    world = ShardedPagedWorld.from_paged_map(single, devs)

    cs, ss, ts = extract_multilevel_cubes(single)
    cw, sw, tw = extract_multilevel_cubes(world)
    want = {(tuple(c), int(s), int(t)) for c, s, t in zip(cs, ss, ts)}
    got = {(tuple(c), int(s), int(t)) for c, s, t in zip(cw, sw, tw)}
    # UNKNOWN differs by construction: the single map emits coarse UNKNOWN
    # cubes spanning the whole grid, the world per-slab ones. Occupied/free
    # cubes never cross slab boundaries, so those sets must match exactly.
    from gpu_voxels_jax.constants import BitVoxelMeaning as BVM

    unk = int(BVM.eBVM_UNKNOWN)
    assert {x for x in want if x[2] != unk} == {x for x in got if x[2] != unk}


def test_build_meta_robot_and_clear_meaning():
    """GvlNTree adapter surface on the world: build (with free AABB carve),
    insertMetaPointCloud (first-meaning degrade), insertRobotConfiguration
    (self-collision check) and clearBitVoxelMeaning — all equal to the
    single-device map."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud

    devs = _devices()
    rng = np.random.default_rng(61)
    # a compact cluster spanning the slab-3/4 boundary so the free AABB
    # carve crosses devices
    pts = rng.uniform([20, 20, 240], [40, 40, 280], size=(64, 3)).astype(np.float32)

    single = PagedHierarchicalMap(DIMS, 1.0).build(pts, free_bounding_box=True)
    world = ShardedPagedWorld(DIMS, 1.0, devices=devs).build(pts, free_bounding_box=True)
    q = _queries(seed=67)
    assert (world.probe_status(q) == np.asarray(single.probe_status(q))).all()
    assert world.n_tiles() == single.n_tiles()

    # clearBitVoxelMeaning: non-OCCUPIED is a logged no-op; OCCUPIED resets
    world.clear_voxel_meaning(BitVoxelMeaning.eBVM_FREE)
    assert world.n_tiles() == single.n_tiles()
    world.clear_voxel_meaning(BitVoxelMeaning.eBVM_OCCUPIED)
    assert world.n_tiles() == 0

    link0 = rng.uniform([4, 4, 4], [12, 12, 12], size=(32, 3)).astype(np.float32)
    link1 = rng.uniform([30, 30, 400], [40, 40, 440], size=(32, 3)).astype(np.float32)
    mpc = MetaPointCloud.from_clouds([link0, link1], names=("l0", "l1"))

    s2 = PagedHierarchicalMap(DIMS, 1.0)
    _, ok_s = s2.insert_robot_configuration(mpc, with_self_collision_test=True)
    w2 = ShardedPagedWorld(DIMS, 1.0, devices=devs)
    _, ok_w = w2.insert_robot_configuration(mpc, with_self_collision_test=True)
    assert ok_s == ok_w is True
    assert (w2.probe_status(q) == np.asarray(s2.probe_status(q))).all()

    # overlapping links must flag self-collision on both forms
    mpc_clash = MetaPointCloud.from_clouds([link0, link0 + 0.001])
    _, ok_c = ShardedPagedWorld(DIMS, 1.0, devices=devs).insert_robot_configuration(
        mpc_clash, with_self_collision_test=True
    )
    assert ok_c is False


@pytest.mark.parametrize("seed", [101, 202])
@pytest.mark.parametrize("probabilistic", [False, True])
def test_world_stateful_fuzz_vs_single_device(seed, probabilistic):
    """Random op interleavings (occupied/free inserts, cross-slab sensor
    carves, meaning clears) applied to the world AND the fuzz-verified
    single-device map: probe statuses, occupancies, tile counts and collide
    counts must stay EQUAL after every op. Targets the state machine the
    slab decomposition adds on top (per-slab allocators, replicated-ray
    ownership, pin-after-mutation)."""
    devs = _devices()
    rng = np.random.default_rng(seed)
    single = PagedHierarchicalMap(DIMS, 1.0, probabilistic=probabilistic)
    world = ShardedPagedWorld(DIMS, 1.0, probabilistic=probabilistic, devices=devs)
    q = _queries(seed=seed + 1, q=768)

    def check():
        assert world.n_tiles() == single.n_tiles()
        assert (world.probe_status(q) == np.asarray(single.probe_status(q))).all()
        if probabilistic:
            assert (
                world.probe_occupancy(q) == np.asarray(single.probe_occupancy(q))
            ).all()

    for step in range(7):
        op = rng.integers(0, 4)
        if op == 0:  # occupied insert, static or dynamic map flag
            pts = _scene(seed=rng.integers(1e6), n=rng.integers(16, 200))
            static = bool(rng.integers(0, 2))
            single.insert_point_cloud(pts, static_map=static)
            world.insert_point_cloud(pts, static_map=static)
        elif op == 1:  # explicit hard-FREE cells
            pts = _scene(seed=rng.integers(1e6), n=rng.integers(16, 120))
            single.insert_point_cloud(pts, BitVoxelMeaning.eBVM_FREE, static_map=False)
            world.insert_point_cloud(pts, BitVoxelMeaning.eBVM_FREE, static_map=False)
        elif op == 2:  # sensor carve from a random origin (rays cross slabs)
            hits = _scene(seed=rng.integers(1e6), n=rng.integers(16, 96))
            origin = tuple(
                float(v)
                for v in rng.uniform([4, 4, 4], [60, 60, 500], size=3)
            )
            single.insert_point_cloud_with_free_space(hits, origin, max_steps=256)
            world.insert_point_cloud_with_free_space(hits, origin, max_steps=256)
        else:  # occasional full reset via the meaning-clear path
            single.clear_voxel_meaning(BitVoxelMeaning.eBVM_OCCUPIED)
            world.clear_voxel_meaning(BitVoxelMeaning.eBVM_OCCUPIED)
        check()

    assert world.check_tree()
    assert world.collide_with_coords(q) == int(single.collide_with_coords(q))
    cw, uw = world.collide_with_counting_unknown_coords(q)
    cs, us = single.collide_with_counting_unknown_coords(q)
    assert (cw, uw) == (int(cs), int(us))


def test_fractional_side_length_matches_single_device():
    """Round-5 review regression: the world used to translate points by
    z0*side_length in float32 METERS before voxelizing, which moves
    floor(p/side) boundary decisions whenever side_length is not exactly
    representable (0.05 here — the shipped demo's own resolution; ~30% of
    boundary-adjacent samples used to land in a different cell, some vanishing
    from every slab). The fix voxelizes in the GLOBAL frame and shifts in
    integer voxel units (maps/paged.py voxel_offset), so inserts AND carve
    rays must now partition exactly at any resolution."""
    devs = _devices()
    side = 0.05
    rng = np.random.default_rng(3)
    cells = rng.integers([0, 0, 0], [64, 64, 512], size=(600, 3))
    # sample ON voxel boundaries and just around them — the hostile inputs
    jitter = rng.choice([0.0, 1e-4, -1e-4, 0.5], size=(600, 3))
    pts = ((cells + jitter) * side).astype(np.float32)

    single = PagedHierarchicalMap(DIMS, side)
    single.insert_point_cloud(pts)
    world = ShardedPagedWorld(DIMS, side, devices=devs)
    world.insert_point_cloud(pts)

    q = _queries(seed=11)
    assert world.n_tiles() == single.n_tiles()
    assert (world.probe_status(q) == np.asarray(single.probe_status(q))).all()

    # cross-slab sensor carve at the fractional resolution: the global ray
    # geometry must be walked identically, only cell ownership shifted
    hits = ((rng.integers([0, 0, 0], [64, 64, 512], size=(80, 3)) + 0.5) * side).astype(
        np.float32
    )
    origin = (1.6, 1.6, 12.8)
    single2 = PagedHierarchicalMap(DIMS, side)
    single2.insert_point_cloud_with_free_space(hits, origin, max_steps=600)
    world2 = ShardedPagedWorld(DIMS, side, devices=devs)
    world2.insert_point_cloud_with_free_space(hits, origin, max_steps=600)
    assert world2.n_tiles() == single2.n_tiles()
    assert (world2.probe_status(q) == np.asarray(single2.probe_status(q))).all()


def test_out_of_range_probe_clamps_like_single_device():
    """probe/probe_occupancy on coords past the world bounds answer with the
    clamped border cell, exactly like the single-device map's clamped gathers
    (a zeros-initialized no-owner fallback used to return an invalid status
    where occupied=unknown=free=False)."""
    devs = _devices()
    pts = _scene()
    single = PagedHierarchicalMap(DIMS, 1.0, probabilistic=True)
    single.insert_point_cloud(pts)
    world = ShardedPagedWorld(DIMS, 1.0, probabilistic=True, devices=devs)
    world.insert_point_cloud(pts)

    q = np.array(
        [[32, 32, 511], [32, 32, 512], [32, 32, 600], [32, 32, 0], [5, 5, 1000]],
        np.int32,
    )
    assert (world.probe_status(q) == np.asarray(single.probe_status(q))).all()
    assert (world.probe_occupancy(q) == np.asarray(single.probe_occupancy(q))).all()
    occ, unk, free = world.probe(q)
    # every answer decodes to a REAL tri-state (no all-False rows)
    assert (occ | unk | free).all()
