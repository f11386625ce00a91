"""Port of examples/HeightmapLoader.cpp: terrain heightmap -> voxel map."""
import numpy as np

from gpu_voxels_jax.geometry.heightmap import heightmap_to_point_cloud
from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap


def main():
    # synthetic rolling terrain (the reference loads a PNG via stb_image)
    h, w = 48, 64
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    heights = (3.0 + 2.0 * np.sin(xx / 7.0) * np.cos(yy / 5.0)).astype(np.float32)

    cloud = heightmap_to_point_cloud(heights, pixel_size=1.0, height_scale=1.0)
    m = ProbVoxelMap.create((64, 48, 8)).insert_point_cloud(cloud)
    occupied = int(np.asarray(m.occupied_mask(0.5)).sum())
    print(f"terrain: {len(cloud)} points -> {occupied} occupied voxels")
    return occupied


if __name__ == "__main__":
    main()
