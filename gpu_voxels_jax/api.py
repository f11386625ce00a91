"""High-level scene facade (reference: gpu_voxels/GpuVoxels.{h,cpp}).

`GpuVoxels` keeps name->map / name->robot / name->primitive-array registries
and offers the reference's convenience surface (GpuVoxels.h:91-415): map
factory over all MapTypes, box/file/robot insertion, robot configuration,
visualization triggers. Maps here are immutable pytrees, so the facade holds
the *current* map value per name and rebinds it after every operation —
user code keeps the familiar stateful style while everything underneath
stays functional and jittable.

Thread safety: per-map recursive locks guard rebinds, mirroring
GpuVoxelsMap::m_mutex (GpuVoxelsMap.h:269).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from .constants import BitVoxelMeaning, MapType
from .geometry import files, generation
from .geometry.pointcloud import MetaPointCloud, PointCloud
from .maps.distance_map import DistanceVoxelMap
from .maps.hierarchical import HierarchicalProbMap  # noqa: F401  (factory)
from .maps.voxellist import VoxelList
from .maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from .primitive_array import PrimitiveArray, PrimitiveType
from .robot.robot import JointValueMap, RobotInterface
from .utils.logging import Gpu_voxels as LOG
from .vis.provider import VisProvider

DEFAULT_LIST_CAPACITY = 0


class GpuVoxels:
    _instance: Optional["GpuVoxels"] = None

    def __init__(self):
        self._dims = None
        self._side_length = None
        self._maps: Dict[str, object] = {}
        self._locks: Dict[str, threading.RLock] = {}
        self._robots: Dict[str, RobotInterface] = {}
        self._prim_arrays: Dict[str, PrimitiveArray] = {}
        self._vis: Dict[str, VisProvider] = {}
        self._meshes: Dict[str, object] = {}  # map name -> jax Mesh (opt-in)

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    def get_instance(cls) -> "GpuVoxels":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def initialize(self, dim_x: int, dim_y: int, dim_z: int, voxel_side_length: float) -> None:
        self._dims = (int(dim_x), int(dim_y), int(dim_z))
        self._side_length = float(voxel_side_length)

    def get_dimensions(self):
        return self._dims

    def get_voxel_side_length(self) -> float:
        return self._side_length

    # -- map registry -----------------------------------------------------------
    def add_map(self, map_type: MapType, map_name: str, capacity: int = DEFAULT_LIST_CAPACITY, mesh=None):
        """addMap factory over all MapTypes (GpuVoxels.cpp:164-270).

        `mesh` (a jax.sharding.Mesh with a 'z' axis) opts the map into
        multi-chip grid sharding: its arrays are laid out over the mesh as
        z-slabs (parallel.shard_map_value) and every facade update re-pins
        the layout, so all public ops on the map run SPMD-distributed. New
        capability vs the single-GPU reference (SURVEY §2.4)."""
        if self._dims is None:
            raise RuntimeError("Call initialize() first")
        if map_name in self._maps:
            raise ValueError(f"map '{map_name}' already exists")
        d, s = self._dims, self._side_length
        mt = MapType(map_type)
        if mt == MapType.MT_PROBAB_VOXELMAP:
            m = ProbVoxelMap.create(d, s)
        elif mt == MapType.MT_BITVECTOR_VOXELMAP:
            m = BitVectorVoxelMap.create(d, s)
        elif mt == MapType.MT_DISTANCE_VOXELMAP:
            m = DistanceVoxelMap.create(d, s)
        elif mt == MapType.MT_BITVECTOR_VOXELLIST:
            m = VoxelList.create(d, s, "bit", capacity, "linear")
        elif mt == MapType.MT_BITVECTOR_MORTON_VOXELLIST:
            m = VoxelList.create(d, s, "bit", capacity, "morton")
        elif mt == MapType.MT_PROBAB_VOXELLIST:
            m = VoxelList.create(d, s, "prob", capacity, "linear")
        elif mt == MapType.MT_PROBAB_MORTON_VOXELLIST:
            m = VoxelList.create(d, s, "prob", capacity, "morton")
        elif mt == MapType.MT_COUNTING_VOXELLIST:
            m = VoxelList.create(d, s, "count", capacity, "linear")
        elif mt in (MapType.MT_PROBAB_OCTREE, MapType.MT_BITVECTOR_OCTREE):
            prob = mt == MapType.MT_PROBAB_OCTREE
            if max(d) > 1024 and all(v % 64 == 0 for v in d):
                # past the dense pyramid's memory wall the paged sparse tier
                # carries the octree (both NTree instantiations,
                # Octree.cu:24-72) at full NTree scale. The host-stateful
                # paged tier shards as one slab map (pool + allocator) per
                # device instead of NamedSharding; it is self-pinning, so no
                # mesh re-pin registration is needed — and it is built
                # DIRECTLY in sharded form (no throwaway single-device map)
                if mesh is not None:
                    from .parallel import ShardedPagedWorld

                    m = ShardedPagedWorld(
                        d, s, prob, devices=list(mesh.devices.reshape(-1))
                    )
                    mesh = None  # already sharded: skip the generic wrap
                else:
                    from .maps.paged import PagedHierarchicalMap

                    m = PagedHierarchicalMap(d, s, probabilistic=prob)
            elif prob:
                m = HierarchicalProbMap.create(d, s)
            else:
                from .maps.hierarchical import HierarchicalBitMap

                m = HierarchicalBitMap.create(d, s)
        else:
            raise NotImplementedError(f"map type {mt}")
        if mesh is not None:
            from .parallel import shard_map_value

            m = shard_map_value(m, mesh)
            self._meshes[map_name] = mesh
        self._maps[map_name] = m
        self._locks[map_name] = threading.RLock()
        self._vis[map_name] = VisProvider(map_name)
        return m

    def del_map(self, map_name: str) -> bool:
        for d in (self._maps, self._locks, self._vis, self._meshes):
            d.pop(map_name, None)
        return True

    def get_map(self, map_name: str):
        return self._maps[map_name]

    def set_map(self, map_name: str, new_map) -> None:
        """Rebind after a functional update (re-pins mesh layouts)."""
        with self._locks[map_name]:
            mesh = self._meshes.get(map_name)
            if mesh is not None:
                from .parallel import reshard_like

                new_map = reshard_like(new_map, mesh)
            self._maps[map_name] = new_map

    def update_map(self, map_name: str, fn):
        """Atomically apply map -> map function; returns the new map.
        Mesh-registered maps are re-pinned to their z-slab layout after the
        update (a no-op view when XLA already preserved the sharding)."""
        with self._locks[map_name]:
            new = fn(self._maps[map_name])
            mesh = self._meshes.get(map_name)
            if mesh is not None:
                from .parallel import reshard_like

                new = reshard_like(new, mesh)
            self._maps[map_name] = new
            return new

    def clear_map(self, map_name: str, voxel_meaning: Optional[BitVoxelMeaning] = None) -> bool:
        if voxel_meaning is None:
            self.update_map(map_name, lambda m: m.clear_map())
        else:
            self.update_map(map_name, lambda m: m.clear_voxel_meaning(int(voxel_meaning)))
        return True

    # -- insertion convenience ---------------------------------------------------
    def insert_point_cloud_into_map(self, cloud, map_name: str, voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> bool:
        pts = cloud.points if isinstance(cloud, PointCloud) else np.asarray(cloud, np.float32)
        self.update_map(map_name, lambda m: m.insert_point_cloud(pts, voxel_meaning))
        return True

    def insert_meta_point_cloud_into_map(self, meta: MetaPointCloud, map_name: str, voxel_meanings: Optional[List[int]] = None) -> bool:
        self.update_map(map_name, lambda m: m.insert_meta_point_cloud(meta, voxel_meanings))
        return True

    def insert_point_cloud_from_file(
        self,
        map_name: str,
        path,
        use_model_path: bool = False,
        voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED,
        shift_to_zero: bool = False,
        offset_xyz=(0.0, 0.0, 0.0),
        scaling: float = 1.0,
    ) -> bool:
        """insertPointCloudFromFile (GpuVoxels.cpp)."""
        pts = files.load_point_cloud(path, use_model_path, shift_to_zero, offset_xyz, scaling)
        return self.insert_point_cloud_into_map(pts, map_name, voxel_meaning)

    def insert_box_into_map(
        self,
        corner_min,
        corner_max,
        map_name: str,
        voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED,
        points_per_voxel: int = 1,
    ) -> bool:
        """insertBoxIntoMap (GpuVoxels.cpp:519-535)."""
        delta = self._side_length / points_per_voxel
        cloud = generation.create_box_of_points(corner_min, corner_max, delta)
        return self.insert_point_cloud_into_map(cloud, map_name, voxel_meaning)

    # -- robots ---------------------------------------------------------------
    def add_robot_dh(self, robot_name: str, link_names, dh_params, link_clouds: MetaPointCloud, **limits) -> bool:
        from .robot.dh import KinematicChain

        self._robots[robot_name] = KinematicChain(link_names, dh_params, link_clouds, **limits)
        return True

    def add_robot(self, robot_name: str, path_to_urdf_file, use_model_path: bool = False) -> bool:
        """addRobot from URDF (GpuVoxels.h:addRobot urdf overload)."""
        from .robot.urdf import UrdfRobot

        path = files.model_path(True) / path_to_urdf_file if use_model_path else path_to_urdf_file
        self._robots[robot_name] = UrdfRobot(path)
        return True

    def add_robot_object(self, robot_name: str, robot: RobotInterface) -> bool:
        self._robots[robot_name] = robot
        return True

    def get_robot(self, robot_name: str) -> RobotInterface:
        return self._robots[robot_name]

    def set_robot_configuration(self, robot_name: str, jointmap: JointValueMap) -> bool:
        self._robots[robot_name].set_configuration(jointmap)
        return True

    def get_robot_configuration(self, robot_name: str) -> JointValueMap:
        return self._robots[robot_name].get_configuration()

    def update_robot_part(self, robot_name: str, link_name: str, pointcloud) -> bool:
        self._robots[robot_name].update_point_cloud(link_name, pointcloud)
        return True

    def insert_robot_into_map(self, robot_name: str, map_name: str, voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> bool:
        """insertRobotIntoMap (GpuVoxels.cpp:499-517)."""
        clouds = self._robots[robot_name].get_transformed_clouds()
        self.update_map(map_name, lambda m: m.insert_point_cloud(clouds.points, voxel_meaning))
        return True

    def insert_robot_into_map_self_collision_aware(
        self, robot_name: str, map_name: str, voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED
    ):
        """Insert + self-collision test (ProbVoxelMap path). Returns the
        traced boolean; fetch it to branch on host."""
        clouds = self._robots[robot_name].get_transformed_clouds()
        result = {}

        def apply(m):
            new, clash = m.insert_meta_point_cloud_with_self_collision_check(clouds, voxel_meaning)
            result["clash"] = clash
            return new

        self.update_map(map_name, apply)
        return result["clash"]

    # -- primitive arrays -----------------------------------------------------
    def add_primitives(self, prim_type: PrimitiveType, array_name: str) -> bool:
        self._prim_arrays[array_name] = PrimitiveArray.create(prim_type)
        return True

    def del_primitives(self, array_name: str) -> bool:
        self._prim_arrays.pop(array_name, None)
        return True

    def modify_primitives(self, array_name: str, positions, diameter=None) -> bool:
        self._prim_arrays[array_name] = self._prim_arrays[array_name].set_points(positions, diameter)
        return True

    def get_primitives(self, array_name: str) -> PrimitiveArray:
        return self._prim_arrays[array_name]

    # -- persistence ---------------------------------------------------------
    def save_map(self, map_name: str, path) -> bool:
        """Map writeToDisk via the facade (reference binary formats)."""
        from .utils import io as map_io

        map_io.write_map(self._maps[map_name], path)
        return True

    def load_map(self, map_name: str, path) -> bool:
        """Map readFromDisk via the facade; rebinds the named map (a
        sharded paged world reloads distributed, onto its own devices)."""
        from .parallel import ShardedPagedWorld
        from .utils import io as map_io

        cur = self._maps.get(map_name)
        if isinstance(cur, ShardedPagedWorld):
            self._maps[map_name] = cur.read_from_disk(path)
            return True
        self._maps[map_name] = map_io.read_map(path)
        self._locks.setdefault(map_name, threading.RLock())
        self._vis.setdefault(map_name, VisProvider(map_name))
        return True

    # -- visualization -----------------------------------------------------------
    def visualize_map(self, map_name: str, force_repaint: bool = True) -> bool:
        return self._vis[map_name].visualize(self._maps[map_name], force_repaint)

    def visualize_primitives_array(self, array_name: str, force_repaint: bool = True) -> bool:
        """Publish a primitive array into the live viewer manifest
        (VisPrimitiveArray, vis_interface/VisPrimitiveArray.h)."""
        import os

        from .vis.serve import publish_primitives

        arr = self._prim_arrays[array_name]
        out_dir = os.environ.get("GPU_VOXELS_VIS_DIR", "/tmp/gpu_voxels_jax_vis")
        publish_primitives(out_dir, array_name, arr)
        LOG.info("primitive array '%s': %d primitives published", array_name, arr.size)
        return True


# reference-style camelCase method aliases (addMap, insertPointCloud, ...)
from . import compat as _compat  # noqa: E402

_compat.install()
