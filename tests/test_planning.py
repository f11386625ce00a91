"""RRT-Connect planner + PathSimplifier over the batched validity tier.

The reference delegates planning to OMPL (gvl_ompl_planning/
gvl_ompl_planner.cpp:103-137: LBKPIECE1 solve + PathSimplifier::simplifyMax);
here the planner is part of the library (planning/planner.py), so its
behavior is pinned directly: solutions are collision-free end to end,
deterministic under a seed, and simplification preserves validity.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap
from gpu_voxels_jax.planning import (
    GvlValidityChecker,
    JointSpace,
    MotionValidator,
    Path,
    PathSimplifier,
    RRTConnect,
)


class PointRobot:
    """cfg IS the end-effector position: one point at cfg (3-D task space)."""

    def transformed_clouds_for(self, cfg):
        class _C:
            pass

        c = _C()
        c.points = jnp.asarray(cfg, jnp.float32)[None, :]
        return c


def _wall_world():
    """16^3 @ 1 m: a full y/z wall at x=8 with a 2x2 hole at low y/z, so the
    straight start->goal segment is blocked but a detour exists."""
    ys, zs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    pts = np.stack(
        [np.full(ys.size, 8.5), ys.ravel() + 0.5, zs.ravel() + 0.5], axis=1
    ).astype(np.float32)
    hole = (pts[:, 1] < 3.0) & (pts[:, 2] < 3.0)
    env = ProbVoxelMap.create((16, 16, 16), 1.0).insert_point_cloud(pts[~hole])
    checker = GvlValidityChecker(env, PointRobot(), 0.7)
    validator = MotionValidator(checker, resolution=0.5)
    space = JointSpace(np.zeros(3, np.float32), np.full(3, 16.0, np.float32))
    return space, checker, validator


START = np.array([2.5, 8.5, 8.5], np.float32)
GOAL = np.array([14.5, 8.5, 8.5], np.float32)


def _path_is_free(checker, validator, path):
    states = path.interpolate(validator.resolution)
    return int(checker.batch_colliding_voxels(states).max()) == 0


def test_rrt_connect_solves_wall_world():
    space, checker, validator = _wall_world()
    # the wall genuinely blocks the straight segment
    ok, _ = validator.check_motion(START, GOAL)
    assert not ok
    planner = RRTConnect(space, validator, step=2.0, seed=3)
    result = planner.solve(START, GOAL, max_iters=4000)
    assert result.solved
    np.testing.assert_array_equal(result.path.states[0], START)
    np.testing.assert_array_equal(result.path.states[-1], GOAL)
    assert _path_is_free(checker, validator, result.path)
    assert result.motion_checks > 0
    assert result.states_checked >= result.motion_checks


def test_rrt_connect_deterministic():
    space, _, validator = _wall_world()
    paths = []
    for _ in range(2):
        planner = RRTConnect(space, validator, step=2.0, seed=11)
        r = planner.solve(START, GOAL, max_iters=4000)
        assert r.solved
        paths.append(r.path.states)
    np.testing.assert_array_equal(paths[0], paths[1])


def test_trivial_straight_segment():
    """Free world: solve() returns the 2-state straight path in 0 iterations
    (OMPL would likewise connect immediately)."""
    env = ProbVoxelMap.create((16, 16, 16), 1.0)
    checker = GvlValidityChecker(env, PointRobot(), 0.7)
    validator = MotionValidator(checker, resolution=0.5)
    space = JointSpace(np.zeros(3, np.float32), np.full(3, 16.0, np.float32))
    result = RRTConnect(space, validator, seed=0).solve(START, GOAL)
    assert result.solved and result.iterations == 0
    assert len(result.path) == 2


def test_invalid_endpoint_fails_fast():
    """An in-collision start fails like OMPL's precondition check — no
    iterations are spent."""
    space, _, validator = _wall_world()
    bad = np.array([8.5, 8.5, 8.5], np.float32)  # inside the wall
    result = RRTConnect(space, validator, seed=0).solve(bad, GOAL)
    assert not result.solved and result.iterations == 0
    with pytest.raises(ValueError):
        RRTConnect(space, validator, seed=0).solve([-1.0, 0.0, 0.0], GOAL)


def test_simplifier_preserves_validity_and_endpoints():
    space, checker, validator = _wall_world()
    planner = RRTConnect(space, validator, step=2.0, seed=3)
    result = planner.solve(START, GOAL, max_iters=4000)
    assert result.solved
    simp = PathSimplifier(validator, seed=5)
    out = simp.simplify(result.path)
    np.testing.assert_array_equal(out.states[0], START)
    np.testing.assert_array_equal(out.states[-1], GOAL)
    assert _path_is_free(checker, validator, out)
    assert out.length() <= result.path.length() + 1e-4


def test_joint_space_contract():
    with pytest.raises(ValueError):
        JointSpace(np.ones(3, np.float32), np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        JointSpace(np.zeros((2, 2), np.float32), np.ones((2, 2), np.float32))
    s = JointSpace.symmetric(4, 2.0)
    assert s.dim == 4 and s.contains(np.zeros(4))
    assert not s.contains(np.full(4, 3.0))
    q = s.sample(np.random.default_rng(0))
    assert s.contains(q) and q.dtype == np.float32
    assert s.distance([0, 0, 0, 0], [1, -2, 0.5, 0]) == 2.0


def test_path_interpolate_resolution():
    p = Path(np.array([[0.0, 0.0], [1.0, 0.0]], np.float32))
    states = p.interpolate(0.25)
    assert states.shape == (5, 2)
    np.testing.assert_allclose(np.max(np.abs(np.diff(states, axis=0)), axis=1), 0.25)
    # single-state path: no interpolation
    assert Path(np.zeros((1, 2), np.float32)).interpolate(0.1).shape == (1, 2)
