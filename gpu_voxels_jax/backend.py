"""The one place that decides which implementation a kernel call site runs.

Every call site that keeps a hand-written kernel asks `use_kernel()`:

* platform ``"gpu"``: the compiled GPU kernel (Pallas through Triton).
* platform ``"cpu"``: the plain JAX reference. This path serves the CPU test
  suite and users who run the library on the CPU.
* any other platform: an error. The library knows no third device, and
  silently taking a slow path there would hide it.

Interpret mode is never chosen here. A kernel runs in the Pallas interpreter
only when its caller passes ``interpret=True``, which only tests do.

The platform is that of the computation being traced: the device set with
``jax.default_device`` when there is one, otherwise JAX's default backend.
So a program traced under ``jax.default_device(jax.devices("cpu")[0])`` in a
GPU process takes the reference path, as it must to run on the CPU.
"""
from __future__ import annotations

import jax

KERNEL_PLATFORMS = ("gpu",)
REFERENCE_PLATFORMS = ("cpu",)


def platform() -> str:
    """Platform the current computation is placed on ("gpu", "cpu", ...)."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    if isinstance(dev, str):
        return jax.devices(dev)[0].platform
    return dev.platform


def use_kernel(platform_name: str | None = None) -> bool:
    """True: run the GPU kernel; False: run the plain JAX reference.

    Raises for a platform that is neither, so no device is served by a path
    nobody chose for it."""
    p = platform() if platform_name is None else platform_name
    if p in KERNEL_PLATFORMS:
        return True
    if p in REFERENCE_PLATFORMS:
        return False
    raise RuntimeError(
        f"unsupported platform {p!r}: gpu_voxels_jax runs its kernels on "
        f"{KERNEL_PLATFORMS} and its plain JAX reference on {REFERENCE_PLATFORMS}"
    )
