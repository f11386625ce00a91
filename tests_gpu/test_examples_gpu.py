"""Examples on a real GPU.

`tests/test_examples.py` exercises every example headlessly on the virtual
CPU mesh; this tier re-runs a representative subset on the GPU so the
example flows (facade, collide counts, EDT cross-check, fitter search) are
proven against the device backend, not only the CPU. Kept to the fast
parameterizations except the live loop, which runs at the reference's
640x480 -> 256^3 size.
"""
import sys
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
sys.path.insert(0, str(EXAMPLES))


def _run(name, **kwargs):
    import importlib

    mod = importlib.import_module(name)
    return mod.main(**kwargs)


def test_collisions_on_gpu():
    # exact 8000-count linkage scene drives the facade end-to-end
    assert _run("collisions") > 0


def test_distance_voxel_test_on_gpu():
    # PBA/JFA/brute cross-check (testing_distance.cu oracle): 0 differences
    assert _run("distance_voxel_test", dim=64, n_obstacles=100) == 0


def test_octree_bench_on_gpu():
    assert _run("octree_bench", dim=64, n_points=5_000)


def test_live_streaming_loop_sustains_30hz():
    """The LIVE end-to-end loop (RobotVsEnvironment.cpp:163-201 shape):
    StreamingDepthSource at a RealSense-class 60 Hz cadence (latest-wins,
    helpers/Kinect.h:36-70) -> 640x480 exact-carve fusion into a 256^3
    ProbVoxelMap -> animated DH robot insert -> collide -> async visualize
    publish, sustains >= 30 Hz including the publish path."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        os.environ["GPU_VOXELS_VIS_DIR"] = d
        try:
            out = _run("robot_vs_environment", frames=90, live_vis=True)
        finally:
            os.environ.pop("GPU_VOXELS_VIS_DIR", None)
    assert out["processed"] >= 80  # at most a few frames dropped
    assert out["sustained_hz"] >= 30.0, out
    assert max(out["counts"]) >= 0 and len(out["counts"]) == out["processed"]


def test_swept_fitter_on_gpu():
    # the multi-robot deconfliction search finds both valid orderings and a
    # nonzero conflict-free start delay on hardware
    n_solutions, delay = _run(
        "swept_fitter", dims=(96, 96, 96), side=0.04, verbose=False
    )
    assert n_solutions == 2
    assert delay > 0
