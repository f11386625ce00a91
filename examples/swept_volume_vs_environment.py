"""Port of examples/SweptVolumeVsEnvironment.cpp: insert a robot trajectory
as a swept volume (per-step SV bits), then collide a moving obstacle against
it with a windowed swept-volume collider."""
import numpy as np

from gpu_voxels_jax.constants import SV_START
from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap
from gpu_voxels_jax.robot.dh import DHParameters, KinematicChain
from gpu_voxels_jax.robot.swept_volume import insert_swept_volume


def main():
    params = [DHParameters(0, 0, 1.0, 0), DHParameters(0, 0, 1.0, 0)]
    link_clouds = MetaPointCloud.from_clouds(
        [np.linspace([0.1, 0, 0], [0.9, 0, 0], 9).astype(np.float32)] * 2,
        names=("link1", "link2"),
    )
    arm = KinematicChain(["link1", "link2"], params, link_clouds)
    traj = [np.array([t, t / 2], np.float32) for t in np.linspace(0, np.pi / 2, 20)]

    sweep = insert_swept_volume(BitVectorVoxelMap.create((64, 64, 64), 0.125), arm, traj)

    # obstacle appears at t=10's position of the elbow
    arm.set_configuration({"link1": float(traj[10][0]), "link2": float(traj[10][1])})
    obstacle_pts = np.asarray(arm.get_transformed_clouds().points)[:3]
    env = BitVectorVoxelMap.create((64, 64, 64), 0.125).insert_point_cloud(
        obstacle_pts, SV_START + 10
    )

    for window in (0, 2, 5):
        cnt, meanings, _ = sweep.collide_with_types(env, 1.0, sv_window=window)
        print(f"window {window}: {int(cnt)} collisions")
    return int(cnt)


if __name__ == "__main__":
    main()
