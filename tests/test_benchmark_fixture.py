"""Tests-as-benchmarks (reference pattern: testing_fixtures.hpp + PERF_MON).

Run with e.g. `pytest tests/test_benchmark_fixture.py --iteration-count 10
--dim-x 128 --dim-y 128 --dim-z 128 -s` to benchmark; defaults keep it a
fast correctness test. Timings land in the PerformanceMonitor summary.
"""
import numpy as np
import jax

from gpu_voxels_jax.geometry import generation
from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap
from gpu_voxels_jax.utils.perfmon import PerformanceMonitor


def test_collision_benchmark(bench_params, capsys):
    dims = bench_params["dims"]
    n_points = bench_params["number_of_points"]
    iters = bench_params["iteration_count"]

    pm = PerformanceMonitor.instance()
    pm.enable("voxelmap")
    pts = generation.create_equidistant_points_in_box(n_points, dims, 1.0)

    pm.start("collision")
    for _ in range(iters):
        m1 = ProbVoxelMap.create(dims).insert_point_cloud(pts)
        m2 = ProbVoxelMap.create(dims).insert_point_cloud(pts)
        count = m1.collide_with(m2, 0.1)
        assert int(count) == len(pts)
        pm.measure("collision", "collision", "voxelmap", block_on=count)
    summary = pm.summary("voxelmap")
    assert "voxelmap::collision" in summary
    if iters > 1:
        print("\n" + summary)


def test_bench_regression_guard():
    """bench.py's contract check: a broken exact contract (the linkage
    scene's 8000 count) is a regression entry; unmeasured keys (partial run)
    and timing metrics never are."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "bench_mod", Path(__file__).resolve().parent.parent / "bench.py"
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    report = {
        "value": 3.7e11,
        "cycle_hz_512": 100.0,
        "b1_linkage_count": 7999,  # exact contract broken -> regression
        "b2_sensor_fusion_hz": 0,  # "not measured" sentinel: skipped
    }
    regs = bench._check_regressions(report)
    assert [r.split(":")[0] for r in regs] == ["b1_linkage_count"]
    assert bench._check_regressions({"b1_linkage_count": 8000, "value": 1.0}) == []
    assert bench._check_regressions({}) == []  # partial run: no verdict
