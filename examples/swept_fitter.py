"""Port of examples/swept_fitter: multi-robot trajectory deconfliction.

The reference fitter (swept_fitter/main.cpp + Fitter.cpp) loads a .traj file
per robot, renders each trajectory's 100-pose interpolation as a swept
volume into its own map (Robot.cpp:115-160), then searches trajectory
ORDERINGS: a schedule assigns each robot one trajectory per time slot, and
slot-mates must not collide (Fitter::fitInternal / Fitter::collides,
Trajectory::collidesWith == areColliding between the two swept maps).

This port runs the same pipeline on two UR10s sharing a workspace:
  * trajectories come from a reference-format .traj file through
    robot.trajectory.load_trajectories (Robot.cpp:45-113 format) with the
    reference's 100 intermediate poses (Robot.cpp:131-133);
  * each trajectory renders as a time-in-bits swept volume via the fused
    batched insert (one program per trajectory);
  * the ordering search is the exact Fitter::fitInternal recursion;
  * on top of the boolean reference answer, the time-in-bits encoding
    answers the finer question the reference cannot: WHEN do conflicting
    trajectories clash, and what start delay deconflicts them
    (collide_with_bitcheck margin windows + shiftLeftSweptVolumeIDs).

Defaults to the reference-scale 256^3 grid; pass dims to run small (the CPU
test mesh uses 96^3).
"""
import os
import tempfile

import numpy as np

from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap
from gpu_voxels_jax.robot.fitter import deconflict_slot, fit_orderings
from gpu_voxels_jax.robot.presets import ur_robot
from gpu_voxels_jax.robot.swept_volume import insert_swept_volume_batched
from gpu_voxels_jax.robot.trajectory import load_trajectories

# two UR10s facing each other across a shared band of workspace
BASES = {
    "UR10_A": np.array([1.30, 1.30, 0.30], np.float32),
    "UR10_B": np.array([1.30, 2.50, 0.30], np.float32),
}

# reference .traj format (Robot.cpp:45-113): per robot, two motions that
# sweep through the shared band (conflict) and two that stay home-side
TRAJ_A = """Trajectory_Num: 2
Joint_Num: 6
Name: A_reach_center
shoulder_pan_joint   0.6   -1.1
shoulder_lift_joint  -0.55 -0.45
elbow_joint          1.15  1.05
wrist_1_joint        0.0   0.0
wrist_2_joint        0.0   0.0
wrist_3_joint        0.0   0.0
Joint_Num: 6
Name: A_home_side
shoulder_pan_joint   1.2   2.2
shoulder_lift_joint  -0.9  -0.7
elbow_joint          1.2   1.0
wrist_1_joint        0.0   0.0
wrist_2_joint        0.0   0.0
wrist_3_joint        0.0   0.0
"""
TRAJ_B = """Trajectory_Num: 2
Joint_Num: 6
Name: B_reach_center
shoulder_pan_joint   -0.6  1.1
shoulder_lift_joint  -0.55 -0.45
elbow_joint          1.15  1.05
wrist_1_joint        0.0   0.0
wrist_2_joint        0.0   0.0
wrist_3_joint        0.0   0.0
Joint_Num: 6
Name: B_home_side
shoulder_pan_joint   -1.2  -2.2
shoulder_lift_joint  -0.9  -0.7
elbow_joint          1.2   1.0
wrist_1_joint        0.0   0.0
wrist_2_joint        0.0   0.0
wrist_3_joint        0.0   0.0
"""


class PlacedUR:
    """A UR chain whose base sits at a world position (Robot + base pose)."""

    def __init__(self, name: str, base):
        self.name = name
        self.base = np.asarray(base, np.float32)
        self.chain = ur_robot("ur10", spacing=0.04)

    def transformed_clouds_for(self, cfg):
        from dataclasses import replace

        import jax.numpy as jnp

        full = jnp.concatenate(
            [jnp.asarray(cfg, jnp.float32), jnp.zeros((1,), jnp.float32)]
        )  # + fixed tool0
        c = self.chain.transformed_clouds_for(full)
        return replace(c, points=c.points + self.base)


def render_swept_volumes(robot, trajs, dims, side, steps):
    """Robot::renderSweptVolumes: one swept map per trajectory, 100-pose
    interpolation, time encoded in SV bits."""
    maps = []
    for t in trajs:
        cfgs = t.interpolate(steps)
        m = insert_swept_volume_batched(
            BitVectorVoxelMap.create(dims, side), robot, cfgs
        )
        maps.append((t.name, m))
    return maps


def fit(robots, all_solutions=True, verbose=True):
    """Fitter::fitInternal ordering search — the library core
    (gpu_voxels_jax.robot.fitter.fit_orderings) plus the example's printing."""
    solutions = fit_orderings(robots, all_solutions=all_solutions)
    if verbose:
        for sol in solutions:
            print("-------------------")
            for (rname, maps), picks in zip(robots, sol):
                print(f"{rname}:  " + " ".join(maps[i][0] for i in picks))
    return solutions


def main(dims=(256, 256, 256), side=0.015, steps=100, window=2, verbose=True):
    d = tempfile.mkdtemp()
    os.makedirs(os.path.join(d, "trajectories"), exist_ok=True)
    for fname, content in (("ur_a.traj", TRAJ_A), ("ur_b.traj", TRAJ_B)):
        with open(os.path.join(d, "trajectories", fname), "w") as f:
            f.write(content)
    # point the loader at the temp trajectories, restoring the caller's
    # model path afterwards (it may be needed for later model loads)
    prev_path = os.environ.get("GPU_VOXELS_MODEL_PATH")
    os.environ["GPU_VOXELS_MODEL_PATH"] = d
    try:
        robots = []
        for name, traj_file in (("UR10_A", "ur_a.traj"), ("UR10_B", "ur_b.traj")):
            r = PlacedUR(name, BASES[name])
            trajs = load_trajectories(traj_file)
            robots.append((name, render_swept_volumes(r, trajs, dims, side, steps)))
    finally:
        if prev_path is None:
            os.environ.pop("GPU_VOXELS_MODEL_PATH", None)
        else:
            os.environ["GPU_VOXELS_MODEL_PATH"] = prev_path

    solutions = fit(robots, all_solutions=True, verbose=verbose)

    # both robots reaching for the center concurrently must clash; the
    # schedules pairing center-reach with home-side must survive
    a_maps = dict(robots[0][1][i] for i in range(len(robots[0][1])))
    b_maps = dict(robots[1][1][i] for i in range(len(robots[1][1])))
    a_center, b_center = a_maps["A_reach_center"], b_maps["B_reach_center"]
    assert int(a_center.collide_with(b_center)) > 0
    assert len(solutions) == 2, solutions  # the two center/home interleavings

    # time-in-bits refinement: per-slot start-delay windows
    # (gpu_voxels_jax.robot.fitter.deconflict_slot — the question the
    # boolean reference fitter cannot ask)
    conflicts0 = int(a_center.collide_with_bitcheck(b_center, margin=window))
    assert conflicts0 > 0, "concurrent starts must conflict in time"
    delays = deconflict_slot([a_center, b_center], margin=window, stride=4)
    assert delays is not None and delays[0] == 0 and delays[1] > 0, delays
    best = delays[1]
    if verbose:
        print(f"delay   0: {conflicts0} time-overlapping conflicts")
        print(f"first conflict-free start delay for {robots[1][0]}: {best} steps")
    return len(solutions), best


if __name__ == "__main__":
    main()
