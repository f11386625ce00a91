"""Port of gvl_ompl_planning/gvl_ompl_planner.cpp — the full planning app.

The reference program builds a 6-DoF UR10 state space with bounds [-pi, pi]
(joint 2 capped at 0), plans with OMPL's LBKPIECE1 over the
GvlOmplPlannerHelper validity callbacks, simplifies with PathSimplifier, and
repeats 5 rounds (20 s budget each, failures tolerated) over the pillar/table
scene — the animated box is present but commented out
(gvl_ompl_planner_helper.cpp:82; opt in with moving_box=True here) —
visualizing each solution as a swept volume (gvl_ompl_planner.cpp:56-160).
Here the planner is the library's own RRT-Connect
(gpu_voxels_jax.planning.RRTConnect): sampling on host, every motion segment
validated in one batched device program.

Facade layout mirrors gvl_ompl_planner_helper.cpp:54-61: myRobotMap /
myEnvironmentMap / myQueryMap probabilistic maps plus a mySolutionMap
bit-voxel list for the swept-volume solution.
"""
from dataclasses import replace

import numpy as np

from gpu_voxels_jax.api import GpuVoxels
from gpu_voxels_jax.constants import SV_START, BitVoxelMeaning, MapType
from gpu_voxels_jax.planning import (
    GvlValidityChecker,
    JointSpace,
    MotionValidator,
    PathSimplifier,
    RRTConnect,
)
from gpu_voxels_jax.robot.presets import ur_robot

BASE = np.array([1.5, 1.5, 0.5], np.float32)  # robot pedestal in the 3x3x2 m world


class PaddedURRobot:
    """6-joint planning view of the 7-link UR chain (tool0 is fixed), based
    at BASE. transformed_clouds_for is traced inside the batched checker;
    the RobotInterface methods let the SAME based robot register with the
    facade, so query/solution inserts land where planning happened."""

    def __init__(self, chain):
        self.chain = chain

    def transformed_clouds_for(self, cfg):
        import jax.numpy as jnp

        full = jnp.concatenate([jnp.asarray(cfg, jnp.float32), jnp.zeros((1,), jnp.float32)])
        c = self.chain.transformed_clouds_for(full)
        return replace(c, points=c.points + BASE)

    # -- RobotInterface delegation (stateful facade path) -------------------
    def set_configuration(self, joint_values):
        self.chain.set_configuration(joint_values)

    def get_configuration(self):
        return self.chain.get_configuration()

    def get_transformed_clouds(self):
        c = self.chain.get_transformed_clouds()
        return replace(c, points=c.points + BASE)


def move_obstacle(gvl: GpuVoxels, x: float, moving_box: bool = False) -> None:
    """moveObstacle (gvl_ompl_planner_helper.cpp:76-90): clear + re-insert
    the scene — two pillars, a table plate, the floor. The animated box is
    commented out in the reference (helper.cpp:82); pass moving_box=True to
    enable it, which makes each round genuinely harder."""
    gvl.clear_map("myEnvironmentMap")
    boxes = [
        ((1.0, 1.0, 0.0), (1.2, 1.2, 1.2)),
        ((1.8, 1.8, 0.0), (2.0, 2.0, 1.2)),
        ((1.1, 1.1, 1.2), (1.9, 1.9, 1.3)),
        ((0.0, 0.0, 0.0), (3.0, 3.0, 0.01)),  # floor
    ]
    if moving_box:
        boxes.insert(0, ((2.0, x, 0.0), (2.2, x + 0.2, 1.2)))
    for lo, hi in boxes:
        gvl.insert_box_into_map(lo, hi, "myEnvironmentMap", BitVoxelMeaning.eBVM_OCCUPIED, 2)


def insert_start_and_goal(gvl: GpuVoxels, robot_name: str, start, goal) -> None:
    """insertStartAndGoal (gvl_ompl_planner_helper.cpp:139-160): both poses
    into the query map as the first two swept-volume meanings."""
    gvl.clear_map("myQueryMap")
    for cfg, meaning in ((start, SV_START), (goal, SV_START + 1)):
        gvl.set_robot_configuration(robot_name, _joint_map(cfg))
        gvl.insert_robot_into_map(robot_name, "myQueryMap", meaning)


_JOINTS = (
    "shoulder_pan_joint", "shoulder_lift_joint", "elbow_joint",
    "wrist_1_joint", "wrist_2_joint", "wrist_3_joint",
)


def _joint_map(cfg) -> dict:
    return dict(zip(_JOINTS, (float(v) for v in cfg)))


def visualize_solution(gvl: GpuVoxels, robot, states: np.ndarray) -> int:
    """visualizeSolution (gvl_ompl_planner_helper.cpp:102-137): every
    interpolated state's robot into the solution list with swept-volume
    meaning SV_START + step % 249 — batched: FK for ALL states in one
    vmapped program, then ONE fused per-point-meaning insert (the
    reference's per-step host loop would recompile per growing list here)."""
    import jax
    import jax.numpy as jnp

    gvl.clear_map("mySolutionMap")
    pts = jax.vmap(lambda c: robot.transformed_clouds_for(c).points)(
        jnp.asarray(states, jnp.float32)
    )
    n_states, n_pts, _ = pts.shape
    meanings = np.repeat(SV_START + (np.arange(n_states) % 249), n_pts)
    gvl.update_map(
        "mySolutionMap",
        lambda m: m.insert_point_cloud_with_meanings(pts.reshape(-1, 3), meanings),
    )
    gvl.visualize_map("mySolutionMap")
    return n_states


def main(rounds: int = 3, seed: int = 7, publish: bool = False, moving_box: bool = False):
    gvl = GpuVoxels()
    gvl.initialize(150, 150, 100, 0.02)  # gvl_ompl_planner_helper.cpp:53
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "myRobotMap")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "myEnvironmentMap")
    gvl.add_map(MapType.MT_BITVECTOR_VOXELLIST, "mySolutionMap")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "myQueryMap")

    chain = ur_robot("ur10", spacing=0.02)
    robot = PaddedURRobot(chain)
    gvl.add_robot_object("myUrdfRobot", robot)  # based at BASE, like planning

    # state space bounds: [-pi, pi], joint 2 capped at 0 (planner.cpp:58-63)
    space = JointSpace.symmetric(6)
    upper = space.upper.copy()
    upper[1] = 0.0
    space = JointSpace(space.lower, upper)

    start = np.array([-1.3, -0.2, 0.0, 0.0, 0.0, 0.0], np.float32)
    goal = np.array([1.3, -0.5, 0.0, 0.0, 0.0, 0.0], np.float32)

    move_obstacle(gvl, 1.0, moving_box)
    checker = GvlValidityChecker(gvl.get_map("myEnvironmentMap"), robot, 0.7)
    validator = MotionValidator(checker, resolution=0.08)
    insert_start_and_goal(gvl, "myUrdfRobot", start, goal)

    simplifier = PathSimplifier(validator, seed=seed)
    successes = 0
    x = 1.0
    for n in range(rounds):
        move_obstacle(gvl, x, moving_box)
        x += 0.1
        checker.env = gvl.get_map("myEnvironmentMap")  # rebind after mutation

        planner = RRTConnect(space, validator, step=1.0, seed=seed + n)
        result = planner.solve(start, goal, max_iters=3000)
        if not result.solved:
            print(f"round {n}: no solution in {result.iterations} iterations")
            continue
        successes += 1
        path = simplifier.simplify(result.path)
        states = path.interpolate(validator.resolution)
        n_steps = visualize_solution(gvl, robot, states)
        print(
            f"round {n}: solved in {result.plan_seconds:.2f}s, "
            f"{result.iterations} iters, {result.motion_checks} motion checks "
            f"({result.states_checked} states), path {len(result.path)} -> "
            f"{len(path)} vertices, swept volume {n_steps} steps"
        )
    if publish:
        gvl.visualize_map("myEnvironmentMap")
        gvl.visualize_map("myQueryMap")
    return successes


if __name__ == "__main__":
    raise SystemExit(0 if main() > 0 else 1)
