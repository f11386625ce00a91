"""Sharded grid cycle on the 8-device virtual CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp

from gpu_voxels_jax.geometry import generation
from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap
from gpu_voxels_jax.parallel import build_sharded_cycle, make_grid_mesh, sharded_collide_count


def test_sharded_cycle_matches_single_device():
    mesh = make_grid_mesh(8, world=1)
    dims = (32, 32, 32)
    p1 = jnp.asarray(generation.create_box_of_points((2.1,) * 3, (20.1,) * 3, 0.5))
    p2 = jnp.asarray(generation.create_box_of_points((3.1,) * 3, (21.1,) * 3, 0.5))
    fn = build_sharded_cycle(mesh, dims, 1.0, 0.1)
    got = int(fn(p1, p2))
    m1 = ProbVoxelMap.create(dims).insert_point_cloud(p1)
    m2 = ProbVoxelMap.create(dims).insert_point_cloud(p2)
    assert got == int(m1.collide_with(m2, 0.1))
    assert got > 0


def test_sharded_cycle_with_world_axis():
    mesh = make_grid_mesh(8, world=2)
    dims = (16, 16, 16)
    p1 = jnp.asarray(generation.create_box_of_points((1.1,) * 3, (8.1,) * 3, 1.0))
    p2a = jnp.asarray(generation.create_box_of_points((2.1,) * 3, (9.1,) * 3, 1.0))
    p2b = p2a + 100.0  # second world: no overlap
    fn = build_sharded_cycle(mesh, dims, 1.0, 0.1)
    pa = jnp.stack([p1, p1])
    pb = jnp.stack([p2a, p2b])
    counts = np.asarray(fn(pa, pb))
    m1 = ProbVoxelMap.create(dims).insert_point_cloud(p1)
    m2 = ProbVoxelMap.create(dims).insert_point_cloud(p2a)
    assert counts[0] == int(m1.collide_with(m2, 0.1))
    assert counts[1] == 0


def test_sharded_collide_presharded():
    mesh = make_grid_mesh(8, world=1)
    dims = (8, 8, 8)
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(-128, 128, 512).astype(np.int8))
    b = jnp.asarray(rng.integers(-128, 128, 512).astype(np.int8))
    got = int(sharded_collide_count(mesh, a, b, 0, 0))
    expect = int(((np.asarray(a).astype(int) >= 0) & (np.asarray(b).astype(int) >= 0)).sum())
    assert got == expect


def test_sharded_edt_matches_single_device():
    import jax.numpy as jnp
    from gpu_voxels_jax.ops import edt
    from gpu_voxels_jax.parallel.sharded_edt import build_sharded_edt

    dims = (32, 32, 64)  # z sharded over 8 -> slabs of 8
    n = dims[0] * dims[1] * dims[2]
    rng = np.random.default_rng(5)
    mask = np.zeros(n, bool)
    mask[rng.integers(0, n, 300)] = True
    packed = edt.init_from_obstacle_mask(jnp.asarray(mask), dims)

    mesh = make_grid_mesh(8, world=1)
    fn = build_sharded_edt(mesh, dims, coarse_factor=4, fine_steps=(8, 4, 2, 1, 1))
    sharded = fn(packed)
    single = edt.jump_flood_multires(packed, dims)
    d_sh = np.asarray(edt.squared_distance_grid(sharded, dims))
    d_si = np.asarray(edt.squared_distance_grid(single, dims))
    np.testing.assert_array_equal(d_sh, d_si)


def test_sharded_sensor_cycle_matches_single_device():
    import jax.numpy as jnp
    from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap
    from gpu_voxels_jax.ops import raycast
    from gpu_voxels_jax.parallel.sharded import build_sharded_sensor_cycle

    dims = (32, 32, 32)
    rng = np.random.default_rng(7)
    depth = rng.uniform(5.0, 25.0, (12, 16)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    pose[:3, 3] = [0.5, 16.0, 16.0]
    env = ProbVoxelMap.create(dims).insert_point_cloud(
        rng.uniform(0, 32, (500, 3)).astype(np.float32)
    )

    # single device reference
    sensor_map = ProbVoxelMap.create(dims)
    new = raycast.insert_depth_image(
        sensor_map.data, jnp.asarray(depth), jnp.asarray(pose),
        8.0, 8.0, 8.0, 6.0, 1.0, dims,
    )
    from gpu_voxels_jax.constants import float_to_probability
    t = float_to_probability(0.25)
    expect = int(((np.asarray(new).astype(int) >= t) & (np.asarray(env.data).astype(int) >= t)).sum())

    mesh = make_grid_mesh(8, world=1)
    fn = build_sharded_sensor_cycle(mesh, dims, 1.0, 8.0, 8.0, 8.0, 6.0, 0.25)
    got = int(fn(jnp.asarray(depth), jnp.asarray(pose), env.data))
    assert got == expect
    assert got > 0


def test_sharded_bit_cycle_matches_single_device():
    """Z-slab-sharded 256-bit tier: insert + noneButEmpty collide count
    equals the single-device BitVectorVoxelMap exactly."""
    from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap
    from gpu_voxels_jax.parallel import build_sharded_bit_cycle

    dims = (16, 16, 32)
    rng = np.random.default_rng(3)
    pa = rng.uniform(0, 16, (300, 3)).astype(np.float32) * np.array([1, 1, 2], np.float32)
    pb = np.concatenate([pa[:90], rng.uniform(0, 16, (100, 3)).astype(np.float32)])
    mesh = make_grid_mesh(8, world=1)
    fn = build_sharded_bit_cycle(mesh, dims, 1.0)
    got = int(fn(jnp.asarray(pa), jnp.asarray(pb)))
    a = BitVectorVoxelMap.create(dims).insert_point_cloud(pa)
    b = BitVectorVoxelMap.create(dims).insert_point_cloud(pb)
    expect = int(a.collide_with(b))
    assert got == expect and got > 0


def test_sharded_hier_probe_matches_single_device():
    """Sharded hierarchy probe (coarse replicated, level-0 z-sharded)
    counts occupied queries exactly like the single-device pyramid."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap
    from gpu_voxels_jax.parallel import build_sharded_hier_probe

    dims = (16, 16, 64)
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 16, (200, 3)).astype(np.float32) * np.array([1, 1, 4], np.float32)
    hier = HierarchicalBitMap.create(dims).insert_point_cloud(pts)
    qs = np.concatenate(
        [
            np.stack([rng.integers(0, d, 256) for d in dims], axis=1),
            np.floor(pts[:50]),  # guaranteed occupied hits
        ]
    ).astype(np.int32)
    mesh = make_grid_mesh(8, world=1)
    fn = build_sharded_hier_probe(mesh, hier.levels, hier.padded_dims)
    l0 = jax.device_put(hier.pyramid[0], NamedSharding(mesh, P("z")))
    got = int(fn(l0, tuple(hier.pyramid[1:]), jnp.asarray(qs)))
    occ, _, _ = hier.probe(jnp.asarray(qs))
    assert got == int(np.asarray(occ).sum()) and got > 0


def test_sharded_paged_probe_matches_single_device():
    """Sharded paged-octree probe batch (snapshot replicated, queries
    z-sharded): occupied + unknown counts match the single-device
    collide_with_coords / counting-unknown probes exactly."""
    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap, _count_probe_hits
    from gpu_voxels_jax.parallel import build_sharded_paged_probe

    rng = np.random.default_rng(11)
    m = PagedHierarchicalMap((4096, 4096, 4096), 1.0)
    pts = rng.uniform(0, 4096, (1500, 3)).astype(np.float32)
    m.insert_point_cloud(pts)
    qs = np.concatenate(
        [
            rng.integers(0, 4096, (464, 3)),
            np.floor(pts[:48]),  # guaranteed occupied hits
        ]
    ).astype(np.int32)  # 512 queries -> 64 per chip
    mesh = make_grid_mesh(8, world=1)
    fn = build_sharded_paged_probe(mesh)
    snap = m.snapshot()
    occ, unk = fn(snap, jnp.asarray(qs))
    e_occ, e_unk = _count_probe_hits(
        snap, jnp.asarray(qs), jnp.ones((qs.shape[0],), bool), 0, (0, 0, 0)
    )
    assert int(occ) == int(e_occ) and int(occ) > 0
    assert int(unk) == int(e_unk) and int(unk) > 0


def test_sharded_list_collide_matches_single_device():
    """Sharded list x list collide (A's id rows z-sharded, B replicated)
    equals VoxelList.collide_with for both linear and morton id modes."""
    from gpu_voxels_jax.maps.voxellist import VoxelList
    from gpu_voxels_jax.parallel import build_sharded_list_collide

    rng = np.random.default_rng(12)
    dims = (64, 64, 64)
    pa = rng.uniform(0, 64, (300, 3)).astype(np.float32)
    pb = np.concatenate([pa[:80], rng.uniform(0, 64, (150, 3)).astype(np.float32)])
    mesh = make_grid_mesh(8, world=1)
    fn = build_sharded_list_collide(mesh)
    for id_mode in ("linear", "morton"):
        la = VoxelList.create(dims, 1.0, capacity=512, id_mode=id_mode).insert_point_cloud(
            pa, grow=False
        )
        lb = VoxelList.create(dims, 1.0, capacity=512, id_mode=id_mode).insert_point_cloud(
            pb, grow=False
        )
        got = int(fn(la.ids, la.ids_hi, lb.ids, lb.ids_hi))
        expect = int(la.collide_with(lb))
        assert got == expect and got > 0, id_mode


def test_sharded_exact_edt_bit_identical():
    """Z-slab sharded parallel_banding (halo-carried Z flood + local envelope
    sweeps + gathered coarse bounds) must return the exact single-device
    packed output bit-for-bit (the SURVEY §7.11 halo-exchange mandate on the
    flagship exact EDT)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpu_voxels_jax.ops import edt, edt_envelope
    from gpu_voxels_jax.parallel.sharded_edt_exact import (
        build_sharded_parallel_banding,
    )

    mesh = make_grid_mesh(8, world=1)
    dims = (16, 32, 64)  # dzl = 8 per slab
    n = dims[0] * dims[1] * dims[2]
    rng = np.random.default_rng(7)
    mask = np.zeros(n, bool)
    mask[rng.integers(0, n, 200)] = True
    packed = edt.init_from_obstacle_mask(jnp.asarray(mask), dims)

    fn = build_sharded_parallel_banding(mesh, dims, bound_c=8)
    sharded = np.asarray(fn(jax.device_put(packed, NamedSharding(mesh, P("z")))))
    single = np.asarray(edt_envelope.parallel_banding(packed, dims, bound_c=8))
    np.testing.assert_array_equal(sharded, single)

    # an empty grid (no sites anywhere) must stay uninitialised everywhere
    empty = edt.init_from_obstacle_mask(jnp.zeros(n, bool), dims)
    out = np.asarray(fn(jax.device_put(empty, NamedSharding(mesh, P("z")))))
    from gpu_voxels_jax.constants import PBA_UNINITIALISED_PACKED

    assert (out == PBA_UNINITIALISED_PACKED).all()


def test_sharded_sensor_cycle_fractional_side_length():
    """Round-5 review regression: the sharded carve used to translate the
    POSE by z0*side_length in float32 meters, which flips projection boundary
    decisions when side_length is not representable (0.05 here). The fix
    shifts the voxel z INDICES into the global frame (exact integer adds,
    ops/raycast.projective_free_space z_index_offset), so the sharded count
    must equal the single-device one at any resolution."""
    import jax.numpy as jnp
    from gpu_voxels_jax.constants import float_to_probability
    from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap
    from gpu_voxels_jax.ops import raycast
    from gpu_voxels_jax.parallel.sharded import build_sharded_sensor_cycle

    dims = (32, 32, 32)
    side = 0.05
    rng = np.random.default_rng(11)
    depth = (rng.uniform(5.0, 25.0, (12, 16)) * side).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    pose[:3, 3] = np.asarray([0.5, 16.0, 16.0], np.float32) * side
    env = ProbVoxelMap.create(dims, side).insert_point_cloud(
        (rng.uniform(0, 32, (500, 3)) * side).astype(np.float32)
    )

    sensor_map = ProbVoxelMap.create(dims, side)
    new = raycast.insert_depth_image(
        sensor_map.data, jnp.asarray(depth), jnp.asarray(pose),
        8.0, 8.0, 8.0, 6.0, side, dims,
    )
    t = float_to_probability(0.25)
    expect = int(
        ((np.asarray(new).astype(int) >= t) & (np.asarray(env.data).astype(int) >= t)).sum()
    )

    mesh = make_grid_mesh(8, world=1)
    fn = build_sharded_sensor_cycle(mesh, dims, side, 8.0, 8.0, 8.0, 6.0, 0.25)
    got = int(fn(jnp.asarray(depth), jnp.asarray(pose), env.data))
    assert got == expect
    assert got > 0


def test_sharded_exact_edt_interpreted_kernel_on_4_devices():
    """The z-sharded exact EDT with the Triton envelope kernel (interpreted)
    inside shard_map on 4 virtual devices equals the single-device reference
    pipeline bit-for-bit."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpu_voxels_jax.ops import edt, edt_envelope
    from gpu_voxels_jax.parallel.sharded_edt_exact import (
        build_sharded_parallel_banding,
    )

    mesh = make_grid_mesh(4, world=1)
    dims = (16, 16, 32)  # dzl = 8 per slab
    n = dims[0] * dims[1] * dims[2]
    mask = np.zeros(n, bool)
    mask[np.random.default_rng(3).integers(0, n, 40)] = True
    packed = edt.init_from_obstacle_mask(jnp.asarray(mask), dims)
    fn = build_sharded_parallel_banding(mesh, dims, bound_c=8, interpret=True)
    sharded = np.asarray(fn(jax.device_put(packed, NamedSharding(mesh, P("z")))))
    single = np.asarray(edt_envelope.parallel_banding(packed, dims, bound_c=8))
    np.testing.assert_array_equal(sharded, single)


def test_check_multichip_on_4_devices():
    """The four-card check (sharded cycle, sharded exact EDT, first-class
    sharded types collide, ShardedPagedWorld) at its dry-run size."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as g

    out = g.check_multichip(jax.devices()[:4], g._scaled(g.DRYRUN_SIZES, 4), log=lambda *_: None)
    assert out["cycle"] > 0 and out["edt_diff"] == 0 and out["types"] > 0
    assert out["paged_world"] >= 32
