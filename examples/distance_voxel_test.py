"""Port of examples/DistanceVoxelTest.cpp: EDT algorithm comparison/bench
driver (jump flood vs exhaustive cross-check + proximity queries)."""
import time

import numpy as np

from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap
from gpu_voxels_jax.utils.perfmon import PerformanceMonitor


def main(dim: int = 64, n_obstacles: int = 100):
    import jax

    dims = (dim, dim, dim)
    rng = np.random.default_rng(0)
    obs = np.unique(rng.integers(0, dim, (n_obstacles, 3)), axis=0)
    pts = (obs + 0.5).astype(np.float32)

    pm = PerformanceMonitor.instance()
    pm.enable("pbatimer")

    m = DistanceVoxelMap.create(dims).insert_point_cloud(pts)
    pm.start("t")
    jfa = m.jump_flood()
    jax.block_until_ready(jfa.data)
    pm.measure("t", "jump_flood", "pbatimer")

    pm.start("t")
    pba = m.parallel_banding()
    jax.block_until_ready(pba.data)
    pm.measure("t", "parallel_banding", "pbatimer")

    exact = DistanceVoxelMap.create(dims).exact_distances(obs.astype(np.int32))
    diff_je = int(jfa.differences(exact))
    diff_pe = int(pba.differences(exact))
    print(f"differences3D(jfa, exact) = {diff_je}")
    print(f"differences3D(pba, exact) = {diff_pe}")

    q = np.array([[dim / 2 + 0.5] * 3], np.float32)
    print("min distance from center:", float(jfa.min_distance_to(q)))
    print(pm.summary("pbatimer"))
    return diff_je + diff_pe


if __name__ == "__main__":
    raise SystemExit(main())
