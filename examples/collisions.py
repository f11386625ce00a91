"""Port of examples/Collisions.cpp: two overlapping boxes, collide counts
across map-type combinations."""
import numpy as np

from gpu_voxels_jax.api import GpuVoxels
from gpu_voxels_jax.constants import BitVoxelMeaning, MapType


def main():
    gvl = GpuVoxels.get_instance()
    gvl.initialize(128, 128, 128, 0.01)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "prob_a")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "prob_b")
    gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "bit_a")
    gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "bit_b")

    gvl.insert_box_into_map((0.5, 0.5, 0.5), (1.0, 1.0, 1.0), "prob_a", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map((0.8, 0.8, 0.8), (1.3, 1.3, 1.3), "prob_b", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map((0.5, 0.5, 0.5), (1.0, 1.0, 1.0), "bit_a", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map((0.8, 0.8, 0.8), (1.3, 1.3, 1.3), "bit_b", BitVoxelMeaning.eBVM_OCCUPIED, 1)

    print("prob x prob:", int(gvl.get_map("prob_a").collide_with(gvl.get_map("prob_b"))))
    print("bit  x bit :", int(gvl.get_map("bit_a").collide_with(gvl.get_map("bit_b"))))
    print("bit  x prob:", int(gvl.get_map("bit_a").collide_with(gvl.get_map("prob_b"), 0.7)))
    # the swept-volume types collider only inspects SV bits (4..253), so
    # insert the boxes again with SV meanings for the types check
    from gpu_voxels_jax.constants import SV_START

    gvl.insert_box_into_map((0.5, 0.5, 0.5), (1.0, 1.0, 1.0), "bit_a", SV_START + 1, 1)
    gvl.insert_box_into_map((0.8, 0.8, 0.8), (1.3, 1.3, 1.3), "bit_b", SV_START + 2, 1)
    cnt, meanings, _ = gvl.get_map("bit_a").collide_with_types(gvl.get_map("bit_b"), sv_window=1)
    print("with types :", int(cnt))
    return int(cnt)


if __name__ == "__main__":
    main()
