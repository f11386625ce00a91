"""The backend decision (gpu_voxels_jax.backend) and the GPU path's shape on
the CPU: which implementation each platform gets, and that the Triton EDT
kernel lowers for CUDA."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpu_voxels_jax import backend


@pytest.mark.parametrize(
    "platform,kernel", [("gpu", True), ("cpu", False), ("metal", None), ("rocm", None)]
)
def test_use_kernel_per_platform(platform, kernel):
    """The kernel on "gpu", the plain reference on "cpu", an error elsewhere."""
    if kernel is None:
        with pytest.raises(RuntimeError, match="unsupported platform"):
            backend.use_kernel(platform)
    else:
        assert backend.use_kernel(platform) is kernel


def test_platform_follows_default_device():
    assert backend.platform() == "cpu"
    with jax.default_device(jax.devices("cpu")[1]):
        assert backend.platform() == "cpu"
        assert backend.use_kernel() is False


def test_edt_kernel_lowers_for_cuda(monkeypatch):
    """On a GPU, parallel_banding lowers its envelope passes to Triton kernels
    (cross-lowered here: the Pallas -> Triton lowering runs without a card)."""
    from gpu_voxels_jax.ops import edt_envelope

    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    dims = (64, 48, 40)
    packed = jnp.zeros((dims[0] * dims[1] * dims[2],), jnp.uint32)
    text = (
        jax.jit(lambda p: edt_envelope.parallel_banding(p, dims))
        .trace(packed)
        .lower(lowering_platforms=("cuda",))
        .as_text()
    )
    assert text.count("xla.gpu.triton") == 5  # 3 bound passes + Y + X


def test_cpu_lowering_has_no_kernel():
    from gpu_voxels_jax.ops import edt_envelope

    dims = (16, 16, 16)
    packed = jnp.zeros((16 ** 3,), jnp.uint32)
    text = jax.jit(lambda p: edt_envelope.parallel_banding(p, dims)).lower(packed).as_text()
    assert "triton" not in text
    assert np.asarray(edt_envelope.parallel_banding(packed, dims)).shape == (16 ** 3,)
