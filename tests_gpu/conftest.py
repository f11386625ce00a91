"""Card tier: contracts re-run on a real GPU.

`tests/` runs on a virtual CPU mesh, where the plain JAX references and the
interpreted kernels run. This tier re-runs the key exact contracts where the
compiled GPU kernels and XLA's GPU code run:

    python chip_smoke.py                 # phase 7 runs this tier in-process
    python -m pytest tests_gpu/ -q       # on a machine with a GPU

Every test carries the `gpu` marker and skips (inside a fixture, at run
time) when JAX's backend is not a GPU. `tests/` never collects this tier.
"""
import jax
import pytest


def pytest_collection_modifyitems(config, items):
    for item in items:
        item.add_marker(pytest.mark.gpu)


@pytest.fixture(autouse=True)
def _require_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: this tier checks the compiled GPU paths")
