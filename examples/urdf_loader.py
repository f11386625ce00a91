"""Port of examples/URDF_Loader.cpp: load a URDF robot, animate a joint and
collide against an environment map. Defaults to the shipped
examples/models/pan_tilt.urdf, whose tilt link references a mesh resolved to
the same-named tilt_link.binvox next to it (robot_link.cpp:226 convention) —
the real mesh-file load path, not synthetic geometry."""
import sys
from pathlib import Path

import numpy as np

from gpu_voxels_jax.api import GpuVoxels
from gpu_voxels_jax.constants import BitVoxelMeaning, MapType

DEMO_URDF_PATH = Path(__file__).resolve().parent / "models" / "pan_tilt.urdf"


def main(urdf_path=None):
    gvl = GpuVoxels.get_instance()
    gvl.initialize(128, 128, 128, 0.02)
    gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "robot_map")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "env_map")

    if urdf_path is None:
        urdf_path = DEMO_URDF_PATH
    gvl.add_robot("bot", urdf_path)
    robot = gvl.get_robot("bot")
    n_mesh = int(np.asarray(robot.get_transformed_clouds().points).shape[0])
    print(f"loaded {urdf_path}: {n_mesh} mesh-cloud points")

    gvl.insert_box_into_map((1.4, 0.9, 1.4), (1.8, 1.2, 1.8), "env_map", BitVoxelMeaning.eBVM_OCCUPIED)

    base_offset = np.array([1.2, 1.2, 1.0], np.float32)
    total = 0
    for i, pan in enumerate(np.linspace(0, np.pi / 2, 5)):
        gvl.set_robot_configuration("bot", {"pan_joint": float(pan), "tilt_joint": 0.2})
        gvl.clear_map("robot_map")
        clouds = robot.get_transformed_clouds()
        gvl.insert_point_cloud_into_map(np.asarray(clouds.points) + base_offset, "robot_map")
        n = int(gvl.get_map("robot_map").collide_with(gvl.get_map("env_map"), 0.7))
        print(f"pan={pan:.2f}: {n} collisions")
        total += n
    return {"mesh_points": n_mesh, "total_collisions": total}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
