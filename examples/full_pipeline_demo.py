"""End-to-end integration demo: every subsystem in one tabletop scene.

sense (depth camera -> probabilistic env with free-space carving)
  -> filter (counting list removes sensor noise)
  -> map (hierarchical env for cheap probes; EDT for clearance)
  -> plan (UR10 preset, swept volume along a trajectory, windowed collide,
           motion validity, minimum obstacle distance)
  -> visualize (PLY + HTML export)
"""
from dataclasses import replace as drep

import numpy as np

from gpu_voxels_jax.constants import SV_START
from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap
from gpu_voxels_jax.maps.hierarchical import HierarchicalProbMap
from gpu_voxels_jax.maps.voxellist import counting_voxel_list
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_jax.planning import MotionValidator
from gpu_voxels_jax.planning.validity import HierarchicalValidityChecker
from gpu_voxels_jax.robot.presets import ur_robot
from gpu_voxels_jax.robot.swept_volume import insert_swept_volume_batched
from gpu_voxels_jax.sensors import Sensor

DIMS = (128, 128, 64)
SIDE = 0.04  # 4 cm voxels over a ~5 x 5 x 2.5 m cell


def main():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)

    # --- sense -------------------------------------------------------------
    sensor = Sensor(
        position=np.array([2.56, 2.56, 0.2], np.float32),
        data_width=64,
        data_height=48,
        fx=40.0,
        fy=40.0,
        cx=32.0,
        cy=24.0,
    )
    # wall at ~1.9 m in front of the camera (within the 2.56 m z extent)
    from gpu_voxels_jax.sensors import ReplayDepthSource

    frame = np.full((48, 64), 1.9, np.float32)
    frame += 0.05 * np.sin(np.arange(64))[None, :].astype(np.float32)
    source = ReplayDepthSource(np.stack([frame] * 3))
    env = ProbVoxelMap.create(DIMS, SIDE)
    for _ in range(3):  # a few scans push hits past the occupancy threshold
        # carve_pool=8: the min-pooled conservative carve; 1 would be the
        # exact reference carve
        env = env.insert_depth_image(source.get_frame(), sensor, carve_pool=8)
    occupied = int(np.asarray(env.occupied_mask(0.6)).sum())
    print(f"sense: {occupied} occupied voxels after 3 scans")

    # --- noise filter ------------------------------------------------------
    raw_points = rng.normal([2.5, 2.5, 1.4], [0.5, 0.5, 0.05], (3000, 3)).astype(np.float32)
    noise = rng.uniform(0, 5.0, (300, 3)).astype(np.float32)
    cvl = counting_voxel_list(DIMS, SIDE).insert_point_cloud(np.concatenate([raw_points, noise]))
    solid = cvl.remove_underpopulated(3)
    print(f"filter: {int(cvl.count)} voxels -> {int(solid.count)} after density filter")

    # --- map: hierarchical env + EDT clearance field -----------------------
    table = np.stack(np.meshgrid(
        np.arange(1.8, 3.2, SIDE), np.arange(1.8, 3.2, SIDE), [1.0], indexing="ij"
    ), axis=-1).reshape(-1, 3).astype(np.float32)
    hier = HierarchicalProbMap.create(DIMS, SIDE).insert_point_cloud(table)
    dm = DistanceVoxelMap.create(DIMS, SIDE).merge_occupied(env, 0.6)
    dm = dm.insert_point_cloud(table).parallel_banding()

    # --- plan: UR10 over the table ------------------------------------------
    arm = ur_robot("ur10", spacing=0.03)
    base = jnp.asarray([2.56, 2.56, 1.35])

    class Based:
        def transformed_clouds_for(self, cfg):
            c = arm.transformed_clouds_for(cfg)
            return drep(c, points=c.points + base)

    checker = HierarchicalValidityChecker(hier, Based())
    validator = MotionValidator(checker, resolution=0.1)
    up = np.array([0, -1.2, 1.0, 0, 0, 0, 0], np.float32)
    across = np.array([1.5, -1.2, 1.0, 0, 0, 0, 0], np.float32)
    ok, n = validator.check_motion(up, across)
    print(f"plan: elevated sweep valid={ok} over {n} states")
    down = np.array([0.3, 1.2, 0.3, 0, 0, 0, 0], np.float32)  # dives at the table
    hits = checker.colliding_voxels(down)
    print(f"plan: reaching into the table -> {hits} colliding voxels")

    # swept volume of the valid motion + windowed deconfliction vs a mover
    traj = np.linspace(up, across, 20).astype(np.float32)
    sweep = insert_swept_volume_batched(BitVectorVoxelMap.create(DIMS, SIDE), Based(), traj)
    # the mover shows up exactly where the arm is at step 10
    mid_cloud = np.asarray(Based().transformed_clouds_for(jnp.asarray(traj[10])).points)
    mover = BitVectorVoxelMap.create(DIMS, SIDE).insert_point_cloud(
        mid_cloud[::40], SV_START + 10
    )
    cnt, meanings, _ = sweep.collide_with_types(mover, 1.0, sv_window=2)
    print(f"plan: mover conflicts within +-2 steps: {int(cnt)}")

    # clearance for speed scaling
    tool = np.asarray(Based().transformed_clouds_for(jnp.asarray(up)).points)[-50:]
    clearance = float(dm.min_distance_to(tool))
    print(f"plan: min obstacle clearance at start pose: {clearance:.3f} m")

    # --- visualize -----------------------------------------------------------
    import tempfile
    from pathlib import Path

    from gpu_voxels_jax.vis.export import write_html, write_ply

    out = Path(tempfile.mkdtemp())
    n_cubes = write_ply(out / "scene.ply", env, 0.6)
    write_html(out / "scene.html", {"env": env, "sweep": sweep}, 0.6)
    print(f"visualize: {n_cubes} cubes -> {out}")
    return bool(ok) and hits > 0


if __name__ == "__main__":
    main()
