"""Port of examples/CountingVoxelList.cpp: noise filtering with a counting
voxel list, then collision against a bit-vector list."""
import numpy as np

from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list, counting_voxel_list


def main():
    rng = np.random.default_rng(0)
    dims = (64, 64, 64)
    # dense cluster (a real object) + scattered single-return noise
    cluster = rng.normal([20, 20, 20], 0.4, (400, 3)).astype(np.float32)
    noise = rng.uniform(0, 64, (200, 3)).astype(np.float32)
    cloud = np.concatenate([cluster, noise])

    cvl = counting_voxel_list(dims).insert_point_cloud(cloud)
    print("voxels before filtering:", int(cvl.count))
    filtered = cvl.remove_underpopulated(5)
    print("voxels after  filtering:", int(filtered.count))

    robot = bit_vector_voxel_list(dims).insert_point_cloud(
        rng.normal([20, 20, 20], 0.5, (100, 3)).astype(np.float32), 50
    )
    print("robot vs filtered:", int(robot.collide_with(filtered)))
    print("robot vs raw     :", int(robot.collide_with(cvl)))
    return int(filtered.count)


if __name__ == "__main__":
    main()
