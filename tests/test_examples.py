"""Every example program runs headlessly and produces sane output."""
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
sys.path.insert(0, str(EXAMPLES))


def _run(name, **kwargs):
    import importlib

    mod = importlib.import_module(name)
    return mod.main(**kwargs)


def test_collisions():
    assert _run("collisions") > 0


def test_swept_volume_vs_environment():
    assert _run("swept_volume_vs_environment") >= 1


def test_robot_vs_environment():
    # the fused live loop (one compiled program per frame) processes every
    # cadenced frame; the full-size loop runs in the GPU tier (tests_gpu)
    out = _run("robot_vs_environment", full_size=False)
    assert out["processed"] >= 5
    assert len(out["counts"]) >= 1


def test_distance_voxel_test():
    assert _run("distance_voxel_test") == 0  # all algorithms agree


def test_counting_voxel_list():
    assert _run("counting_voxel_list") >= 1


def test_shift_vs_transform():
    assert _run("shift_vs_transform") > 0


def test_urdf_loader():
    # the shipped pan_tilt.urdf resolves its mesh reference to the checked-in
    # tilt_link.binvox (252-voxel rod, robot_link.cpp:226 convention): the
    # REAL mesh-file load path, with collisions when the rod sweeps the box
    out = _run("urdf_loader")
    assert out["mesh_points"] == 252
    assert out["total_collisions"] > 0


def test_maps_demo():
    assert _run("maps_demo") > 0


def test_heightmap_demo():
    assert _run("heightmap_demo") > 0


def test_primitive_array():
    assert _run("primitive_array_test") == 10


def test_ompl_planning_demo():
    assert _run("ompl_planning_demo")


def test_ompl_planner_app():
    # one full plan-simplify-visualize round of the planner app (the
    # 3-round moving-obstacle loop runs standalone; one round keeps the
    # suite's time budget)
    import ompl_planner_app

    assert ompl_planner_app.main(rounds=1) == 1


def test_distance_kinect_demo():
    c = _run("distance_kinect_demo")
    assert c is not None and c >= 0.0


def test_octree_bench():
    assert _run("octree_bench") >= 0


def test_full_pipeline_demo():
    assert _run("full_pipeline_demo")


def test_batch_worlds_demo():
    assert _run("batch_worlds_demo") >= 1


def test_swept_fitter():
    """The UR10-pair fitter finds exactly the two valid orderings and a
    nonzero conflict-free start delay (96^3 here; the example defaults to
    the reference-scale 256^3)."""
    import importlib

    mod = importlib.import_module("swept_fitter")
    n_solutions, delay = mod.main(dims=(96, 96, 96), side=0.04, verbose=False)
    assert n_solutions == 2
    assert delay > 0


def test_swept_fitter_three_robots_vs_bruteforce():
    """Fitter::fitInternal is N-robot (Fitter.cpp:71-116): pin the ordering
    search for THREE robots against brute-force enumeration of all slot
    assignments, on synthetic maps with randomized pairwise collisions."""
    import importlib
    import itertools

    import numpy as np

    mod = importlib.import_module("swept_fitter")

    class FakeMap:
        def __init__(self, key, table):
            self.key, self.table = key, table

        def collide_with(self, other):
            return self.table[frozenset((self.key, other.key))]

    rng = np.random.default_rng(5)
    n_robots, n_traj = 3, 2
    keys = [(r, t) for r in range(n_robots) for t in range(n_traj)]
    for _ in range(6):
        table = {
            frozenset((a, b)): int(rng.random() < 0.35)
            for a, b in itertools.combinations(keys, 2)
        }
        table.update({frozenset((k,)): 0 for k in keys})  # self-pairs unused
        robots = [
            (f"R{r}", [(f"R{r}T{t}", FakeMap((r, t), table)) for t in range(n_traj)])
            for r in range(n_robots)
        ]
        got = {tuple(map(tuple, s)) for s in mod.fit(robots, verbose=False)}

        # brute force: per-robot permutations of trajectory order; slot-mates
        # of every earlier robot must not collide (Fitter::collides)
        want = set()
        for perms in itertools.product(
            *[list(itertools.permutations(range(n_traj))) for _ in range(n_robots)]
        ):
            ok = all(
                table[frozenset(((r1, perms[r1][i]), (r2, perms[r2][i])))] == 0
                for i in range(n_traj)
                for r1 in range(n_robots)
                for r2 in range(r1)
            )
            if ok:
                want.add(tuple(map(tuple, perms)))
        assert got == want


def test_tf_interface_demo():
    assert _run("tf_interface_demo") > 0


def test_sharded_world_demo():
    out = _run("sharded_world_demo")
    assert out["devices"] >= 1 and out["tiles"] > 0
    assert out["free_cells"] > 0 and out["unknown_cells"] > 0
