"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to run
without a GPU."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("phase", chip_smoke.PHASES, ids=lambda f: f.__name__)
def test_phase_tiny_on_cpu(phase):
    line = phase(chip_smoke.TINY, 0, "cpu")
    assert line.startswith("phase ") and "card: cpu" in line


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no GPU" in out.err


def test_alone_without_repo_fails(tmp_path):
    """Copied into an otherwise empty directory, the script exits non-zero
    and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)},
        timeout=300,
    )
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_carve_margin_zero_on_boundary():
    """A voxel whose depth test sits exactly on its threshold has margin 0;
    one far from every boundary has a large margin."""
    from gpu_voxels_jax.sensors import Sensor

    sensor = Sensor(position=np.array([0.5, 0.5, 0.0], np.float32), data_width=4,
                    data_height=4, fx=1.0, fy=1.0, cx=1.5, cy=1.5)
    dims = (1, 1, 4)
    # voxel z=2: centre at 2.5, eps 1 voxel -> boundary when depth == 3.5
    frame = np.full((4, 4), 3.5, np.float32)
    m = chip_smoke.carve_margin_ulps([2], [frame], sensor, 1.0, dims)
    assert m[0] == 0.0
    m = chip_smoke.carve_margin_ulps([0], [np.full((4, 4), 9.0, np.float32)], sensor, 1.0, dims)
    assert m[0] > 1e3
