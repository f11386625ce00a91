"""Port of examples/PrimitiveArrayTest.cpp: animated primitive overlays."""
import numpy as np

from gpu_voxels_jax.api import GpuVoxels
from gpu_voxels_jax.primitive_array import PrimitiveType


def main():
    gvl = GpuVoxels.get_instance()
    gvl.initialize(64, 64, 64, 0.1)
    gvl.add_primitives(PrimitiveType.ePRIM_SPHERE, "markers")
    for t in range(5):
        centers = np.stack(
            [
                2.0 + np.cos(t / 3.0 + np.arange(10)),
                2.0 + np.sin(t / 3.0 + np.arange(10)),
                np.full(10, 1.0 + 0.1 * t),
            ],
            axis=1,
        ).astype(np.float32)
        gvl.modify_primitives("markers", centers, diameter=0.2)
        gvl.visualize_primitives_array("markers")
    arr = gvl.get_primitives("markers")
    print("primitives:", arr.size, "type:", arr.prim_type.name)
    return arr.size


if __name__ == "__main__":
    main()
