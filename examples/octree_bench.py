"""Port of octree/test/Main_Bench.cpp: hierarchical map build / insert /
intersect benchmarks (vs the dense map as the Octomap-stand-in baseline)."""
import time

import numpy as np

from gpu_voxels_jax.maps.hierarchical import HierarchicalProbMap
from gpu_voxels_jax.maps.voxellist import bit_vector_morton_voxel_list
from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap
from gpu_voxels_jax.utils.perfmon import PerformanceMonitor


def main(dim: int = 128, n_points: int = 50_000):
    import jax

    dims = (dim, dim, dim)
    rng = np.random.default_rng(0)
    cloud = rng.uniform(0, dim, (n_points, 3)).astype(np.float32)
    probe_cloud = rng.uniform(0, dim, (2000, 3)).astype(np.float32)

    pm = PerformanceMonitor.instance()
    pm.enable("bench")

    pm.start("t")
    hier = HierarchicalProbMap.create(dims).insert_point_cloud(cloud)
    jax.block_until_ready(hier.occupancy)
    pm.measure("t", "hier_build_insert", "bench")

    dense = ProbVoxelMap.create(dims).insert_point_cloud(cloud)
    lst = bit_vector_morton_voxel_list(dims).insert_point_cloud(probe_cloud, 50)

    pm.start("t")
    n_hier = int(hier.collide_with(lst))
    pm.measure("t", "hier_intersect_list", "bench")

    pm.start("t")
    n_dense = int(lst.collide_with_dense(dense, 0.5))
    pm.measure("t", "dense_intersect_list", "bench")

    colls, unknown = hier.collide_with_counting_unknown(lst)
    print(f"hier x morton-list: {n_hier} | dense x list: {n_dense} | unknown cells: {int(unknown)}")
    print(pm.summary("bench"))
    assert n_hier == n_dense
    return n_hier


if __name__ == "__main__":
    main()
