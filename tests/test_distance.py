"""EDT tests: JFA vs brute-force oracle cross-checks (testing_distance.cu)."""
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax.constants import MAX_OBSTACLE_DISTANCE
from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap
from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap
from gpu_voxels_jax.ops import edt

DIMS = (24, 20, 16)


def np_exact_sqdist(obstacles, dims):
    dx, dy, dz = dims
    zz, yy, xx = np.meshgrid(np.arange(dz), np.arange(dy), np.arange(dx), indexing="ij")
    pos = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    obs = np.asarray(obstacles)
    d = ((pos[:, None, :] - obs[None, :, :]) ** 2).sum(-1)
    return d.min(axis=1).reshape(dz, dy, dx)


def random_scene(seed, n_obs=17):
    rng = np.random.default_rng(seed)
    return np.unique(
        np.stack(
            [
                rng.integers(0, DIMS[0], n_obs),
                rng.integers(0, DIMS[1], n_obs),
                rng.integers(0, DIMS[2], n_obs),
            ],
            axis=1,
        ),
        axis=0,
    )


def insert_obstacles(m, obs):
    pts = (obs.astype(np.float32) + 0.5) * m.side_length
    return m.insert_point_cloud(pts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jump_flood_matches_numpy_exact(seed):
    obs = random_scene(seed)
    m = insert_obstacles(DistanceVoxelMap.create(DIMS), obs).jump_flood()
    got = np.asarray(m.squared_distances())
    expect = np_exact_sqdist(obs, DIMS)
    np.testing.assert_array_equal(got, expect)


def test_exact_brute_force_matches_numpy():
    obs = random_scene(7, n_obs=9)
    m = DistanceVoxelMap.create(DIMS).exact_distances(obs.astype(np.int32))
    got = np.asarray(m.squared_distances())
    np.testing.assert_array_equal(got, np_exact_sqdist(obs, DIMS))


def test_cross_algorithm_differences_zero():
    """The reference's oracle: differences3D between all algorithms == 0."""
    obs = random_scene(3)
    jfa = insert_obstacles(DistanceVoxelMap.create(DIMS), obs).jump_flood()
    exact = DistanceVoxelMap.create(DIMS).exact_distances(obs.astype(np.int32))
    assert int(jfa.differences(exact)) == 0
    pba = insert_obstacles(DistanceVoxelMap.create(DIMS), obs).parallel_banding()
    assert int(pba.differences(exact)) == 0
    sep = insert_obstacles(DistanceVoxelMap.create(DIMS), obs).exact_separable()
    assert int(sep.differences(exact)) == 0


@pytest.mark.parametrize("seed,n_obs", [(21, 5), (22, 40), (23, 200), (24, 1)])
def test_multires_jfa_matches_oracle(seed, n_obs):
    from gpu_voxels_jax.ops import edt
    import jax.numpy as jnp

    dims = (32, 32, 32)
    rng = np.random.default_rng(seed)
    obs = np.unique(rng.integers(0, 32, (n_obs, 3)), axis=0)
    mask = np.zeros(32 ** 3, bool)
    lin = obs[:, 2] * 32 * 32 + obs[:, 1] * 32 + obs[:, 0]
    mask[lin] = True
    packed = edt.init_from_obstacle_mask(jnp.asarray(mask), dims)
    out = edt.jump_flood_multires(packed, dims)
    got = np.asarray(edt.squared_distance_grid(out, dims))
    np.testing.assert_array_equal(got, np_exact_sqdist(obs, dims))


@pytest.mark.parametrize("seed", [11, 12])
def test_exact_separable_matches_oracle(seed):
    obs = random_scene(seed, n_obs=23)
    sep = insert_obstacles(DistanceVoxelMap.create(DIMS), obs).exact_separable()
    np.testing.assert_array_equal(
        np.asarray(sep.squared_distances()), np_exact_sqdist(obs, DIMS)
    )


def test_uninitialised_map_distances():
    m = DistanceVoxelMap.create((4, 4, 4))
    d = np.asarray(m.squared_distances())
    assert (d == MAX_OBSTACLE_DISTANCE).all()


def test_queries():
    obs = np.array([[5, 5, 5]], np.int64)
    m = insert_obstacles(DistanceVoxelMap.create(DIMS), obs).jump_flood()
    assert int(m.get_squared_obstacle_distance(5, 5, 5)) == 0
    assert int(m.get_squared_obstacle_distance(8, 5, 5)) == 9
    assert float(m.get_obstacle_distance(5, 9, 5)) == pytest.approx(4.0)
    # batched proximity query
    d = float(m.min_distance_to(np.array([[8.5, 5.5, 5.5], [9.5, 5.5, 5.5]], np.float32)))
    assert d == pytest.approx(3.0)


def test_extract_distances_bytes():
    obs = np.array([[0, 0, 0]], np.int64)
    m = insert_obstacles(DistanceVoxelMap.create((8, 8, 8)), obs).jump_flood()
    free = np.asarray(m.extract_distances()).reshape(8, 8, 8)
    assert free[0, 0, 0] == 0
    assert free[0, 0, 4] == 4
    assert free[4, 4, 4] == int(np.floor(np.sqrt(48)))
    shifted = np.asarray(m.extract_distances(robot_radius=3)).reshape(8, 8, 8)
    assert shifted[0, 0, 4] == 1


def test_manhattan_floodfill():
    obs = np.array([[2, 2, 2]], np.int64)
    m = insert_obstacles(DistanceVoxelMap.create((8, 8, 8)), obs)
    man = np.asarray(m.init_floodfill()).reshape(8, 8, 8)
    assert man[2, 2, 2] == 0
    assert man[2, 2, 5] == 3
    assert man[5, 4, 4] == 3 + 2 + 2


def test_merge_occupied_from_prob_map():
    pts = np.array([[3.5, 3.5, 3.5]], np.float32)
    pm = ProbVoxelMap.create(DIMS).insert_point_cloud(pts)
    m = DistanceVoxelMap.create(DIMS).merge_occupied(pm).jump_flood()
    assert int(m.get_squared_obstacle_distance(3, 3, 3)) == 0
    assert int(m.get_squared_obstacle_distance(3, 3, 5)) == 4


@pytest.mark.parametrize("n_obs", [60, 500])
def test_converged_jfa_exact_at_scale(n_obs):
    """Denser scenes at 64^3 where plain JFA/multires show rare errors; the
    step-1 fixpoint repair must make both exactly match brute force."""
    from gpu_voxels_jax.ops import edt
    import jax.numpy as jnp

    dims = (64, 64, 64)
    rng = np.random.default_rng(n_obs)
    obs = np.unique(rng.integers(0, 64, (n_obs, 3)), axis=0)
    mask = np.zeros(64 ** 3, bool)
    mask[obs[:, 2] * 64 * 64 + obs[:, 1] * 64 + obs[:, 0]] = True
    packed = edt.init_from_obstacle_mask(jnp.asarray(mask), dims)
    expect = np_exact_sqdist(obs, dims)
    for fn in (edt.jump_flood, edt.jump_flood_multires):
        got = np.asarray(edt.squared_distance_grid(fn(packed, dims), dims))
        np.testing.assert_array_equal(got, expect, err_msg=fn.__name__)


def test_parallel_banding_is_exact():
    """The PBA replacement (Pallas envelope sweeps / XLA fallback) must match
    the brute oracle through the public API."""
    obs = random_scene(31, n_obs=40)
    m = insert_obstacles(DistanceVoxelMap.create(DIMS), obs).parallel_banding()
    np.testing.assert_array_equal(
        np.asarray(m.squared_distances()), np_exact_sqdist(obs, DIMS)
    )


def test_envelope_kernel_interpret_mode():
    """Run the Triton envelope kernel in the Pallas interpreter, incl. the
    coarse-bound ring counts — the GPU path's kernel logic, on the CPU."""
    from gpu_voxels_jax.ops import edt, edt_envelope

    dims = (16, 16, 16)
    obs = np.array([[0, 0, 0], [15, 15, 15], [7, 3, 12]], np.int64)
    mask = np.zeros(16 ** 3, bool)
    mask[obs[:, 2] * 256 + obs[:, 1] * 16 + obs[:, 0]] = True
    packed = edt.init_from_obstacle_mask(jnp.asarray(mask), dims)
    out = edt_envelope.parallel_banding(packed, dims, interpret=True)
    got = np.asarray(edt.squared_distance_grid(out, dims))
    np.testing.assert_array_equal(got, np_exact_sqdist(obs, dims))


def test_jump_flood_with_stats_telemetry():
    obs = random_scene(5)
    m = insert_obstacles(DistanceVoxelMap.create(DIMS), obs)
    from gpu_voxels_jax.ops import edt

    out, iters = edt.jump_flood_with_stats(m.data, DIMS)
    assert int(iters) < 64  # converged under the cap
    np.testing.assert_array_equal(
        np.asarray(edt.squared_distance_grid(out, DIMS)), np_exact_sqdist(obs, DIMS)
    )


def test_distance_map_contract_methods():
    """fill_pba_uninit / insertRobotConfiguration / clearBitVoxelMeaning /
    printVoxelMapData on the distance map (the reference stubs the first two
    as unsupported; clearBitVoxelMeaning is a NOP-with-TODO there)."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap

    link = np.array([[1.5, 1.5, 1.5]], np.float32)
    m = DistanceVoxelMap.create((8, 8, 8))
    m2, ok = m.insert_robot_configuration(
        MetaPointCloud.from_clouds([link, link + 2.0]), with_self_collision_test=True
    )
    assert bool(ok)
    d = m2.parallel_banding()
    assert int(d.get_squared_obstacle_distance(1, 1, 1)) == 0
    _, bad = m.insert_robot_configuration(
        MetaPointCloud.from_clouds([link, link]), with_self_collision_test=True
    )
    assert not bool(bad)
    # dump shows only the two obstacle voxels (uninit is the default value)
    out = m2.print_voxel_map_data()
    assert len(out.splitlines()) == 3 and "(1,1,1)" in out and "(3,3,3)" in out
    wiped = m2.clear_voxel_meaning(1).fill_pba_uninit()
    assert not bool(jnp.any(wiped.obstacle_mask()))


@pytest.mark.parametrize(
    "shape,bounded",
    [((2, 40, 24), False), ((2, 40, 24), True), ((3, 20, 36), True), ((1, 64, 8), False)],
)
def test_envelope_pass_kernel_matches_reference(shape, bounded):
    """The Triton envelope kernel (interpreted) equals the full-scan XLA
    pass: non-power-of-two dims, y/x padding, bounded and full ring scans."""
    from gpu_voxels_jax.ops import edt_envelope as ee

    rng = np.random.default_rng(sum(shape))
    g = rng.integers(0, 400, shape).astype(np.int32)
    g = np.where(rng.random(shape) < 0.2, g, ee.MISS).astype(np.int32)
    pay = rng.integers(0, 1 << 30, shape).astype(np.uint32)
    ref_d, ref_p = ee._envelope_xla(jnp.asarray(g), jnp.asarray(pay))
    bound = None
    if bounded:
        # a valid output bound: the reference's per-coarse-cell max output
        c = 8
        d = np.asarray(ref_d)
        d = np.where(d >= ee.MISS, -1, d)
        pads = [(0, -n % c) for n in shape]
        d = np.pad(d, pads, constant_values=-1)
        z, y, x = d.shape
        bound = jnp.asarray(d.reshape(z // c, c, y // c, c, x // c, c).max(axis=(1, 3, 5)))
    got_d, got_p = ee.envelope_pass(jnp.asarray(g), jnp.asarray(pay), bound, interpret=True)
    np.testing.assert_array_equal(np.asarray(got_d), np.asarray(ref_d))
    np.testing.assert_array_equal(np.asarray(got_p), np.asarray(ref_p))
