"""Geometry layer tests (transforms, clouds, generators, file IO)."""
import io
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax.geometry import files, generation, transforms
from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud, PointCloud


def test_box_of_points_matches_reference_counts():
    # testing_voxelmap.cu:118-143 scene: 2.1..4.1 step 0.5 -> 5 per axis
    pts = generation.create_box_of_points((2.1, 2.1, 2.1), (4.1, 4.1, 4.1), 0.5)
    assert pts.shape == (125, 3)
    vox = np.unique(np.floor(pts / 1.0).astype(int), axis=0)
    assert len(vox) == 27  # voxels 2,3,4 per axis


def test_equidistant_points_in_box():
    pts = generation.create_equidistant_points_in_box(10000, (89, 123, 74), 1.0)
    assert len(pts) == 10000
    vox = np.unique(np.floor(pts).astype(int), axis=0)
    assert len(vox) == 10000  # all distinct voxels (that's the point)
    assert (pts % 2.0 == 0.5).all()


def test_checkerboard_no_overlap():
    b, w = generation.create_non_overlapping_3d_checkerboard(500, (33, 33, 33), 1.0)
    vb = set(map(tuple, np.floor(b).astype(int)))
    vw = set(map(tuple, np.floor(w).astype(int)))
    assert not vb & vw


def test_sphere_and_cylinder():
    s = generation.create_sphere_of_points((5, 5, 5), 2.0, 0.5)
    assert (np.linalg.norm(s - 5.0, axis=1) <= 2.0 + 1e-6).all()
    c = generation.create_cylinder_of_points((5, 5, 5), 2.0, 4.0, 0.5)
    assert (np.abs(c[:, 2] - 5.0) <= 2.0 + 1e-6).all()


def test_rpy_convention():
    # yaw 90deg about z: x-axis -> y-axis
    m = transforms.from_rpy(jnp.asarray([0.0, 0.0, np.pi / 2]), jnp.asarray([1.0, 2.0, 3.0]))
    p = transforms.transform_points(m, jnp.asarray([[1.0, 0.0, 0.0]]))
    np.testing.assert_allclose(np.asarray(p), [[1.0, 3.0, 3.0]], atol=1e-6)


def test_rpy_order_is_zyx():
    rpy = np.array([0.3, -0.4, 0.9], np.float32)
    m = np.asarray(transforms.from_rpy(jnp.asarray(rpy)))[:3, :3]
    expect = (
        np.asarray(transforms.rot_z(jnp.float32(rpy[2])))
        @ np.asarray(transforms.rot_y(jnp.float32(rpy[1])))
        @ np.asarray(transforms.rot_x(jnp.float32(rpy[0])))
    )
    np.testing.assert_allclose(m, expect, atol=1e-6)


def test_dh_matrix_revolute_prismatic():
    # revolute: value adds to theta
    m = np.asarray(transforms.dh_matrix(0.1, 0.2, 0.3, 0.4, 0.5))
    mc = np.asarray(transforms.dh_matrix(0.1, 0.7, 0.3, 0.4, 0.0))
    np.testing.assert_allclose(m, mc, atol=1e-6)
    # prismatic: value adds to d
    p = np.asarray(transforms.dh_matrix(0.1, 0.2, 0.3, 0.4, 0.5, transforms.PRISMATIC))
    pc = np.asarray(transforms.dh_matrix(0.6, 0.2, 0.3, 0.4, 0.0, transforms.PRISMATIC))
    np.testing.assert_allclose(p, pc, atol=1e-6)
    # structure: bottom row [0,0,0,1], m[2,0] == 0
    assert m[3].tolist() == [0, 0, 0, 1]
    assert m[2, 0] == 0


def test_invert_roundtrip():
    m = transforms.from_rpy(jnp.asarray([0.3, 0.2, 0.1]), jnp.asarray([4.0, -2.0, 7.0]))
    inv = transforms.invert(m)
    np.testing.assert_allclose(np.asarray(m @ inv), np.eye(4), atol=1e-5)


def test_pointcloud_transform():
    pc = PointCloud.from_numpy([[1, 0, 0], [0, 1, 0]])
    m = transforms.from_translation([10, 20, 30])
    out = np.asarray(pc.transformed(m).points)
    np.testing.assert_allclose(out, [[11, 20, 30], [10, 21, 30]], atol=1e-6)


def test_meta_pointcloud_per_cloud_transform():
    mpc = MetaPointCloud.from_clouds(
        [[[0, 0, 0], [1, 1, 1]], [[2, 2, 2]]], names=("link0", "link1")
    )
    assert mpc.num_clouds == 2 and mpc.accumulated_size == 3
    mats = jnp.stack([transforms.from_translation([1, 0, 0]), transforms.from_translation([0, 5, 0])])
    out = mpc.transformed_per_cloud(mats)
    np.testing.assert_allclose(
        np.asarray(out.points), [[1, 0, 0], [2, 1, 1], [2, 7, 2]], atol=1e-6
    )
    # single-subcloud variant
    out2 = mpc.transformed_sub_cloud(1, transforms.from_translation([0, 0, 9]))
    np.testing.assert_allclose(np.asarray(out2.get_cloud(1)), [[2, 2, 11]], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out2.get_cloud(0)), [[0, 0, 0], [1, 1, 1]], atol=1e-6)


def test_xyz_roundtrip(tmp_path):
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    f = tmp_path / "cloud.xyz"
    files.write_xyz(f, pts)
    back = files.read_xyz(f)
    np.testing.assert_allclose(back, pts, atol=1e-5)


def test_binvox_reader(tmp_path):
    # 4x4x4 grid with 3 occupied voxels, RLE encoded
    header = b"#binvox 1\ndim 4 4 4\ntranslate 1.0 2.0 3.0\nscale 8.0\ndata\n"
    grid = np.zeros(64, dtype=np.uint8)
    grid[0] = 1   # x=0,z=0,y=0
    grid[5] = 1   # index 5 -> x=0, z=1, y=1
    grid[63] = 1  # x=3,z=3,y=3
    # RLE encode
    rle = bytearray()
    i = 0
    while i < 64:
        j = i
        while j < 64 and grid[j] == grid[i] and j - i < 255:
            j += 1
        rle += bytes([grid[i], j - i])
        i = j
    f = tmp_path / "test.binvox"
    f.write_bytes(header + bytes(rle))
    pts = files.read_binvox(f)
    scale = 8.0 / 4
    expect = np.array([[0, 0, 0], [0, 1, 1], [3, 3, 3]], np.float32) * scale + [1, 2, 3]
    np.testing.assert_allclose(np.sort(pts, axis=0), np.sort(expect, axis=0), atol=1e-6)


def test_pcd_ascii_and_binary(tmp_path):
    pts = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9.5]], np.float32)
    ascii_pcd = (
        "# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
        "COUNT 1 1 1\nWIDTH 3\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 3\nDATA ascii\n"
        + "\n".join(" ".join(str(v) for v in row) for row in pts)
    )
    fa = tmp_path / "a.pcd"
    fa.write_text(ascii_pcd)
    np.testing.assert_allclose(files.read_pcd(fa), pts, atol=1e-6)

    bin_header = (
        "# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
        "COUNT 1 1 1\nWIDTH 3\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 3\nDATA binary\n"
    ).encode()
    fb = tmp_path / "b.pcd"
    fb.write_bytes(bin_header + pts.astype("<f4").tobytes())
    np.testing.assert_allclose(files.read_pcd(fb), pts, atol=1e-6)


def test_load_point_cloud_dispatch_and_options(tmp_path):
    pts = np.array([[1, 1, 1], [3, 2, 5]], np.float32)
    f = tmp_path / "c.xyz"
    files.write_xyz(f, pts)
    out = files.load_point_cloud(f, shift_to_zero=True, offset_xyz=(10, 0, 0), scaling=2.0)
    np.testing.assert_allclose(out, [[10, 0, 0], [14, 2, 8]], atol=1e-5)
    with pytest.raises(ValueError):
        files.load_point_cloud(tmp_path / "c.unknown")


def test_to_rpy_both_solutions_round_trip():
    """Matrix3f::toRPY (cuda_matrices.h:285-326): both solution branches
    reconstruct the rotation through createFromRPY."""
    rng = np.random.default_rng(7)
    for _ in range(100):
        rpy = rng.uniform(
            [-np.pi, -np.pi / 2 + 0.01, -np.pi],
            [np.pi, np.pi / 2 - 0.01, np.pi],
        ).astype(np.float32)
        m = transforms.from_rpy(rpy, xp=np)
        for sol in (1, 2):
            r = transforms.to_rpy(m, sol, xp=np)
            assert np.allclose(transforms.from_rpy(r, xp=np), m, atol=1e-5)
        # solution 1 is the exact inverse inside |pitch| < pi/2
        assert np.allclose(transforms.to_rpy(m, 1, xp=np), rpy, atol=1e-5)


def test_to_rpy_gimbal_lock_and_jnp():
    # gimbal locked down (a31 = -1 -> pitch +pi/2, yaw pinned to 0)
    m = transforms.from_rpy(np.array([0.4, np.pi / 2, 0.2], np.float32), xp=np)
    for sol in (1, 2):  # both solutions coincide at the singularity
        r = transforms.to_rpy(m, sol, xp=np)
        assert abs(r[2]) < 1e-6 and abs(r[1] - np.pi / 2) < 1e-4
        assert np.allclose(transforms.from_rpy(r, xp=np), m, atol=1e-4)
    # locked up (a31 = +1 -> pitch -pi/2)
    m2 = transforms.from_rpy(np.array([-0.3, -np.pi / 2, 0.0], np.float32), xp=np)
    r2 = transforms.to_rpy(m2, 1, xp=np)
    assert abs(r2[1] + np.pi / 2) < 1e-4
    assert np.allclose(transforms.from_rpy(r2, xp=np), m2, atol=1e-4)
    # jnp path (jit-safe, batched) agrees with numpy
    batch = np.stack([np.asarray(m), np.asarray(m2)]).astype(np.float32)
    jr = np.asarray(transforms.to_rpy(jnp.asarray(batch), 1))
    nr = np.stack([transforms.to_rpy(b, 1, xp=np) for b in batch])
    assert np.allclose(jr, nr, atol=1e-5)
