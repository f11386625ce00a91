"""Test configuration: run on a virtual 8-device CPU mesh.

The CPU suite runs the plain JAX reference paths and the Pallas kernels in
interpret mode; sharding tests exercise the real shard_map partitioning on 8
virtual CPU devices. The platform is pinned through jax.config as well as
the environment, since a backend is only chosen when a test first uses it.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pytest


def pytest_addoption(parser):
    """Tests double as benchmarks, like the reference's GlobalFixture CLI
    (test/testing_fixtures.hpp:38-110): --iteration-count, --dim-x/y/z,
    --number-of-points select the workload size."""
    parser.addoption("--iteration-count", type=int, default=1)
    parser.addoption("--dim-x", type=int, default=89)
    parser.addoption("--dim-y", type=int, default=123)
    parser.addoption("--dim-z", type=int, default=74)
    parser.addoption("--number-of-points", type=int, default=10000)


@pytest.fixture
def bench_params(request):
    o = request.config.option
    return dict(
        iteration_count=o.iteration_count,
        dims=(o.dim_x, o.dim_y, o.dim_z),
        number_of_points=o.number_of_points,
    )
