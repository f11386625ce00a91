"""Sensor insertion + free-space carving tests (vs a numpy Bresenham oracle)."""
import numpy as np
import jax.numpy as jnp

from gpu_voxels_jax.constants import SENSOR_MODEL_FREE, SENSOR_MODEL_OCCUPIED
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_jax.ops import raycast

DIMS = (16, 16, 16)


def test_occupied_hits_accumulate():
    m = ProbVoxelMap.create(DIMS)
    pts = np.array([[4.5, 4.5, 4.5], [4.5, 4.5, 4.5]], np.float32)
    m2 = m.insert_sensor_data(pts, sensor_origin=(0.5, 4.5, 4.5), enable_raycasting=False)
    d = np.asarray(m2.as_3d())
    # two hits: -128 -> clamped add: max(-127, -128+144) = 16
    assert d[4, 4, 4] == min(127, max(-127, -128 + 2 * SENSOR_MODEL_OCCUPIED))
    assert (d != -128).sum() == 1


def test_axis_aligned_ray_marks_free_cells():
    m = ProbVoxelMap.create(DIMS)
    # ray along +x from (0.5,4.5,4.5) to hit at (8.5,4.5,4.5)
    m2 = m.insert_sensor_data(
        np.array([[8.5, 4.5, 4.5]], np.float32), sensor_origin=(0.5, 4.5, 4.5)
    )
    d = np.asarray(m2.as_3d())
    # cells x=0..7 at y=z=4 crossed exactly once -> -128-10 clamped to -127
    for x in range(0, 8):
        assert d[4, 4, x] == -127, x
    assert d[4, 4, 8] == -128 + SENSOR_MODEL_OCCUPIED
    # nothing else touched
    assert (d != -128).sum() == 9


def test_free_space_counts_match_bresenham_dominant_axis():
    origin = np.array([0.5, 0.5, 0.5], np.float32)
    end = np.array([10.5, 5.5, 2.5], np.float32)
    counts = np.asarray(
        raycast.ray_crossing_counts(origin, end[None, :], 1.0, DIMS)
    ).reshape(16, 16, 16)  # [Z,Y,X]
    # dominant axis is x with 10 steps -> 10 visited cells, one per x-column
    assert counts.sum() == 10
    xs = sorted(np.argwhere(counts > 0)[:, 2].tolist())
    assert xs == list(range(0, 10))
    # the endpoint's voxel is NOT carved
    assert counts[2, 5, 10] == 0


def test_cut_real_robot_skips_robot_voxels():
    robot = BitVectorVoxelMap.create(DIMS).insert_point_cloud(
        np.array([[8.5, 4.5, 4.5]], np.float32), 1
    )
    m = ProbVoxelMap.create(DIMS)
    m2 = m.insert_sensor_data(
        np.array([[8.5, 4.5, 4.5]], np.float32),
        sensor_origin=(0.5, 4.5, 4.5),
        enable_raycasting=False,
        cut_real_robot=True,
        robot_map=robot,
    )
    d = np.asarray(m2.as_3d())
    assert d[4, 4, 8] == -128  # hit suppressed


def test_nan_points_are_dropped():
    m = ProbVoxelMap.create(DIMS)
    pts = np.array([[np.nan, np.nan, np.nan], [4.5, 4.5, 4.5]], np.float32)
    m2 = m.insert_sensor_data(pts, sensor_origin=(0.5, 4.5, 4.5), enable_raycasting=False)
    d = np.asarray(m2.as_3d())
    assert (d != -128).sum() == 1


def test_depth_image_backprojection():
    depth = np.zeros((4, 4), np.float32)
    depth[2, 3] = 2.0
    pts = np.asarray(raycast.depth_image_to_point_cloud(depth, fx=2.0, fy=2.0, cx=2.0, cy=2.0))
    valid = pts[np.isfinite(pts).all(axis=1)]
    assert valid.shape == (1, 3)
    np.testing.assert_allclose(valid[0], [(3 - 2) * 2 / 2, (2 - 2) * 2 / 2, 2.0], atol=1e-6)
    assert np.isnan(pts[0]).all()


def test_full_kinect_style_cycle():
    """Config #2 shape: depth image -> insert -> collide vs static env map."""
    import jax

    depth = np.full((48, 64), 6.0, np.float32)
    env_pts = np.array([[6.5, 8.5, 8.5]], np.float32)

    @jax.jit
    def cycle(depth_img):
        pts = raycast.depth_image_to_point_cloud(depth_img, 32.0, 32.0, 32.0, 24.0)
        world = pts + jnp.asarray([8.0, 8.0, 2.0])  # sensor pose: translation
        m = ProbVoxelMap.create(DIMS).insert_sensor_data(
            world, sensor_origin=(8.0, 8.0, 2.0), enable_raycasting=False
        )
        env = ProbVoxelMap.create(DIMS).insert_point_cloud(jnp.asarray(env_pts))
        return m.collide_with(env, 0.7)

    cnt = int(cycle(jnp.asarray(depth)))
    assert cnt in (0, 1)


def test_projective_carving_matches_dda_on_axis_ray():
    """A single axis-aligned ray: projective visibility and the DDA walk
    must carve the same cells (modulo the sensor's own voxel)."""
    from gpu_voxels_jax.sensors import Sensor

    # camera at (0.5, 4.5, 4.5) looking... build a pose mapping camera +z to
    # world +x: R = [[0,0,1],[1,0,0],[0,1,0]] columns = camera axes in world
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    pose[:3, 3] = [0.5, 4.5, 4.5]
    depth = np.full((3, 3), 8.0, np.float32)  # 3x3 image, all rays 8m
    m = ProbVoxelMap.create(DIMS)
    from gpu_voxels_jax.ops import raycast as rc
    new = rc.insert_depth_image(
        m.data, jnp.asarray(depth), jnp.asarray(pose), 300.0, 300.0, 1.5, 1.5, 1.0, DIMS
    )
    d = np.asarray(new).reshape(16, 16, 16)
    # all 9 near-parallel rays hit voxel x=8: 9 * 72 clamps to 127
    assert d[4, 4, 8] == 127
    # voxels x=1..6 on the ray carved free (x=7 is within eps of the hit)
    for x in range(1, 7):
        assert d[4, 4, x] == -127, x
    # far-off voxels untouched
    assert d[10, 10, 10] == -128


def test_projective_invalid_pixels_carve_nothing():
    from gpu_voxels_jax.ops import raycast as rc

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    pose[:3, 3] = [0.5, 4.5, 4.5]
    depth = np.zeros((3, 3), np.float32)  # all invalid
    free = np.asarray(
        rc.projective_free_space(jnp.asarray(depth), jnp.asarray(pose), 300.0, 300.0, 1.5, 1.5, 1.0, DIMS)
    )
    assert free.sum() == 0


def np_projective_carve(depth, pose, fx, fy, cx, cy, side, dims, pool=1,
                        invalid=0.0, eps_vox=1.0):
    """NumPy per-voxel oracle of the projective carve, in the library's
    float32 arithmetic: free iff the voxel centre projects into the image in
    front of the camera and lies eps_vox voxels before the measured depth
    (pool > 1: before the minimum depth of its pool x pool pixel tile)."""
    f32 = np.float32
    dx, dy, dz = dims
    zi, yi, xi = (a.astype(f32) for a in np.meshgrid(
        np.arange(dz), np.arange(dy), np.arange(dx), indexing="ij"))
    pose = np.asarray(pose, f32)
    rot_t, org = pose[:3, :3].T, pose[:3, 3]
    s = f32(side)
    w = [(xi + f32(0.5)) * s - org[0], (yi + f32(0.5)) * s - org[1],
         (zi + f32(0.5)) * s - org[2]]
    sx, sy, sz = (rot_t[r, 0] * w[0] + rot_t[r, 1] * w[1] + rot_t[r, 2] * w[2]
                  for r in range(3))
    in_front = sz > f32(1e-6)
    safe = np.where(in_front, sz, f32(1.0))
    u = np.floor(f32(fx) * sx / safe + f32(cx)).astype(np.int64)
    v = np.floor(f32(fy) * sy / safe + f32(cy)).astype(np.int64)
    h, wd = depth.shape
    in_fov = in_front & (u >= 0) & (u < wd) & (v >= 0) & (v < h)
    ui, vi = np.clip(u, 0, wd - 1), np.clip(v, 0, h - 1)
    if pool > 1:
        dd = np.where(depth == invalid, f32(-3.0e38), depth)
        ph, pw = -(-h // pool), -(-wd // pool)
        dd = np.pad(dd, ((0, ph * pool - h), (0, pw * pool - wd)), constant_values=f32(3.0e38))
        table = dd.reshape(ph, pool, pw, pool).min(axis=(1, 3))
        d, valid = table[vi // pool, ui // pool], True
    else:
        d = depth[vi, ui]
        valid = d != invalid
    return (in_fov & valid & (sz < d - f32(eps_vox) * s)).reshape(-1)


def _carve(depth, pose, dims, pool=1):
    from gpu_voxels_jax.ops import raycast as rc

    return np.asarray(rc.projective_free_space(
        jnp.asarray(depth), jnp.asarray(pose), 52.0, 52.0, 32.0, 24.0, 1.0, dims, pool=pool))


def test_pooled_carve_matches_spec_and_is_conservative():
    """The pooled carve equals its NumPy spec bit-for-bit and never frees a
    voxel the exact per-pixel carve keeps; pool=1 is the exact carve."""
    dims = (64, 64, 64)
    rng = np.random.default_rng(3)
    depth = rng.uniform(10, 50, (48, 64)).astype(np.float32)
    depth[5:9, 10:20] = 0.0  # invalid patch
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [32, 32, 1]
    exact = _carve(depth, pose, dims)
    for pool in (1, 4, 8):
        got = _carve(depth, pose, dims, pool)
        spec = np_projective_carve(depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0, dims, pool=pool)
        np.testing.assert_array_equal(got, spec, err_msg=f"pool={pool}")
        assert not (got & ~exact).any()  # conservative
    np.testing.assert_array_equal(_carve(depth, pose, dims, 1), exact)


def _carve_scenes():
    rng = np.random.default_rng(7)
    # scene 1: smooth + step discontinuity + invalid patch + noise band
    d1 = np.full((48, 64), 40.0, np.float32)
    d1[:, 32:] = 20.0
    d1[10:14, 5:9] = 0.0
    d1[30:34, :] += rng.uniform(-5, 5, (4, 64)).astype(np.float32)
    # scene 2: adversarial per-pixel noise
    d2 = rng.uniform(5, 60, (48, 64)).astype(np.float32)
    d2[d2 < 6] = 0.0
    p1 = np.eye(4, dtype=np.float32)
    p1[:3, 3] = [32, 32, 1]
    th = 0.4  # tilted + shifted camera
    p2 = np.eye(4, dtype=np.float32)
    p2[:3, :3] = np.array(
        [[1, 0, 0], [0, np.cos(th), -np.sin(th)], [0, np.sin(th), np.cos(th)]], np.float32)
    p2[:3, 3] = [20, 45, 3]
    return [(d, p) for d in (d1, d2) for p in (p1, p2)]


def test_exact_band_refinement_carve_bit_identical():
    """The exact carve equals the NumPy per-voxel oracle bit-for-bit across
    depth discontinuities, invalid patches, image edges and an off-axis pose."""
    dims = (64, 64, 64)
    for depth, pose in _carve_scenes():
        got = _carve(depth, pose, dims)
        want = np_projective_carve(depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0, dims)
        np.testing.assert_array_equal(got, want)
        assert want.sum() > 0  # the scenes actually carve


def test_exact_carve_invalid_beam_regions():
    """Large invalid regions carve nothing: the carve equals the NumPy
    oracle, and no voxel seen only through invalid pixels is freed."""
    dims = (64, 64, 64)
    rng = np.random.default_rng(9)
    depth = rng.uniform(5, 60, (48, 64)).astype(np.float32)
    depth[8:40, 16:48] = 0.0  # big invalid block
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [32, 32, 1]
    got = _carve(depth, pose, dims)
    np.testing.assert_array_equal(
        got, np_projective_carve(depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0, dims))
    invalid_only = np_projective_carve(
        np.where(depth == 0.0, np.float32(1e9), np.float32(0.0)), pose,
        52.0, 52.0, 32.0, 24.0, 1.0, dims)
    assert invalid_only.sum() > 0 and not (got & invalid_only).any()


def test_provider_cuts_robot_from_depth_hits():
    """Provider.new_sensor_data(..., robot_map=...) drops the measurements
    that land inside the robot (insertSensorData's cut_real_robot); the rest
    of the frame is fused as without it."""
    from gpu_voxels_jax.providers import Provider
    from gpu_voxels_jax.sensors import Sensor

    dims = (16, 16, 16)
    sensor = Sensor(position=np.array([8.0, 8.0, 0.0], np.float32), data_width=16,
                    data_height=16, fx=8.0, fy=8.0, cx=7.5, cy=7.5)
    depth = np.full((16, 16), 10.25, np.float32)  # a wall at z = 10
    plain = Provider("plain")
    plain.init(ProbVoxelMap.create(dims))
    plain.new_sensor_data(depth, sensor)
    hit = -128 + SENSOR_MODEL_OCCUPIED  # one measurement on an unknown voxel
    occ = np.asarray(plain.map.data) == hit
    wall = np.flatnonzero(occ)
    assert len(wall) > 0
    robot_vox = wall[: len(wall) // 2]
    robot = BitVectorVoxelMap.create(dims).insert_point_cloud(
        np.stack([robot_vox % 16, (robot_vox // 16) % 16, robot_vox // 256], 1).astype(np.float32) + 0.5
    )
    cut = Provider("cut")
    cut.init(ProbVoxelMap.create(dims))
    cut.new_sensor_data(depth, sensor, robot_map=robot)
    occ_cut = np.asarray(cut.map.data) == hit
    assert not occ_cut[robot_vox].any()
    np.testing.assert_array_equal(occ_cut[wall[len(wall) // 2:]], True)
