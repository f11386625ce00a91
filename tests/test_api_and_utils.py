"""GVL facade, disk IO, perfmon, config, vis export, primitives, planning."""
import json
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax.api import GpuVoxels
from gpu_voxels_jax.constants import BitVoxelMeaning, MapType
from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list
from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap
from gpu_voxels_jax.primitive_array import PrimitiveType
from gpu_voxels_jax.utils import io as map_io
from gpu_voxels_jax.utils.config import ConfigManager
from gpu_voxels_jax.utils.perfmon import PerformanceMonitor


def fresh_gvl():
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(150, 150, 150, 0.01)
    return gvl


def test_linkage_scene_through_facade():
    """The gvl_linkage_test flow end-to-end through the facade."""
    gvl = fresh_gvl()
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "myFirstMap")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "mySecondMap")
    center, box, overlap = np.array([0.5] * 3), np.array([0.4] * 3), np.array([0.1] * 3)
    c1 = center - overlap
    c2 = c1 + box
    c3 = center + overlap
    c4 = c3 - box
    gvl.insert_box_into_map(c1, c2, "myFirstMap", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map(c4, c3, "mySecondMap", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    n = int(gvl.get_map("myFirstMap").collide_with(gvl.get_map("mySecondMap")))
    # overlap region [0.4,0.6]^3 at 0.01 voxels -> 20^3 (float32 point
    # accumulation ends the second box just below 0.6); verified against an
    # independent numpy voxelization
    assert n == 8000


def test_facade_map_factory_all_types():
    gvl = fresh_gvl()
    for mt in MapType:
        gvl.add_map(mt, f"m_{mt.name}")
    assert int(np.asarray(gvl.get_map("m_MT_PROBAB_VOXELMAP").data).size) == 150 ** 3


def test_facade_robot_and_primitives(tmp_path):
    gvl = fresh_gvl()
    from gpu_voxels_jax.robot.dh import DHParameters, KinematicChain

    clouds = MetaPointCloud.from_clouds([[[0.25, 0.0, 0.0]]], names=("link1",))
    gvl.add_robot_dh("arm", ["link1"], [DHParameters(0, 0, 0.5, 0)], clouds)
    gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "robotmap")
    gvl.set_robot_configuration("arm", {"link1": 0.0})
    gvl.insert_robot_into_map("arm", "robotmap", BitVoxelMeaning.eBVM_OCCUPIED)
    assert int(gvl.get_map("robotmap").collide_with(gvl.get_map("robotmap"))) == 1

    gvl.add_primitives(PrimitiveType.ePRIM_SPHERE, "spheres")
    gvl.modify_primitives("spheres", np.array([[1, 2, 3]], np.float32), diameter=0.5)
    assert gvl.get_primitives("spheres").size == 1

    gvl.clear_map("robotmap")
    assert int(gvl.get_map("robotmap").collide_with(gvl.get_map("robotmap"))) == 0


def test_voxelmap_disk_roundtrip(tmp_path):
    pts = np.array([[2.5, 3.5, 4.5]], np.float32)
    for make in (
        lambda: ProbVoxelMap.create((8, 8, 8)).insert_point_cloud(pts),
        lambda: BitVectorVoxelMap.create((8, 8, 8)).insert_point_cloud(pts, 77),
        lambda: DistanceVoxelMap.create((8, 8, 8)).insert_point_cloud(pts),
    ):
        m = make()
        f = tmp_path / "m.bin"
        map_io.write_voxel_map(m, f)
        back = map_io.read_voxel_map(f)
        assert type(back) is type(m)
        assert back.dims == m.dims and back.side_length == m.side_length
        np.testing.assert_array_equal(np.asarray(back.data), np.asarray(m.data))


def test_voxelmap_disk_format_is_reference_binary(tmp_path):
    m = ProbVoxelMap.create((4, 4, 4), 0.25).insert_point_cloud(
        np.array([[0.1, 0.1, 0.1]], np.float32)
    )
    f = tmp_path / "m.bin"
    map_io.write_voxel_map(m, f)
    raw = f.read_bytes()
    # int32 MapType | float32 side | 3x uint32 dims | int8[64]
    assert len(raw) == 4 + 4 + 12 + 64
    assert np.frombuffer(raw[:4], "<i4")[0] == int(MapType.MT_PROBAB_VOXELMAP)
    assert np.frombuffer(raw[4:8], "<f4")[0] == np.float32(0.25)
    assert np.frombuffer(raw[8:20], "<u4").tolist() == [4, 4, 4]
    assert np.frombuffer(raw[20:], "i1")[0] == 127


def test_voxellist_disk_roundtrip(tmp_path):
    lst = bit_vector_voxel_list((16, 16, 16)).insert_point_cloud(
        np.array([[1.5, 2.5, 3.5], [4.5, 5.5, 6.5]], np.float32), 50
    )
    f = tmp_path / "l.bin"
    map_io.write_voxel_list(lst, f)
    back = map_io.read_voxel_list(f)
    assert int(back.count) == 2
    np.testing.assert_array_equal(np.asarray(back.ids[:2]), np.asarray(lst.ids[:2]))
    np.testing.assert_array_equal(np.asarray(back.payload[:, :2]), np.asarray(lst.payload[:, :2]))


def test_perfmon():
    PerformanceMonitor.initialize()
    pm = PerformanceMonitor.instance()
    pm.enable("test")
    pm.start("t")
    pm.measure("t", "phase1", "test")
    pm.add_data("counts", 42.0, "test")
    pm.measure("t", "phase1", "disabled_prefix")
    s = pm.summary("test")
    assert "test::phase1" in s and "test::counts" in s
    assert pm.series("counts", "test") == [42.0]
    assert pm.series("phase1", "disabled_prefix") == []


def test_config_manager(tmp_path):
    ConfigManager._instance = None
    cm = ConfigManager.instance()
    cm.set("/scene/dimX", 64)
    assert cm.get("/scene/dimX", int) == 64
    seen = []
    cm.observe("/scene", lambda k, v: seen.append((k, v)))
    cm.set("/scene/dimY", 32)
    assert seen == [("/scene/dimY", 32)]
    xml = tmp_path / "cfg.xml"
    xml.write_text("<cfg><camera><fov>90</fov></camera></cfg>")
    cm.load_xml(xml)
    assert cm.get("/cfg/camera/fov", int) == 90
    cm.add_parameter("--dim-z", "/scene/dimZ", type_=int)
    cm.parse(["--dim-z", "77"])
    assert cm.get("/scene/dimZ", int) == 77
    batch = cm.get_batch([("/scene/dimX", int, 0), ("/missing", str, "d")])
    assert batch == {"/scene/dimX": 64, "/missing": "d"}


def test_vis_extract_and_export(tmp_path):
    from gpu_voxels_jax.vis import extract_cubes, occupied_coords
    from gpu_voxels_jax.vis.export import write_html, write_ply

    m = BitVectorVoxelMap.create((8, 8, 8), 0.5).insert_point_cloud(
        np.array([[1.25, 1.25, 1.25]], np.float32), 50
    )
    coords = occupied_coords(m)
    assert coords.tolist() == [[2, 2, 2]]
    centers, types = extract_cubes(m)
    np.testing.assert_allclose(centers, [[1.25, 1.25, 1.25]])
    assert types.tolist() == [50]
    n = write_ply(tmp_path / "m.ply", m)
    assert n == 1 and (tmp_path / "m.ply").exists()
    write_html(tmp_path / "m.html", {"m": m})
    assert "InstancedMesh" in (tmp_path / "m.html").read_text()


def test_vis_provider_change_detection(tmp_path):
    from gpu_voxels_jax.vis.provider import VisProvider

    m = ProbVoxelMap.create((8, 8, 8)).insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32))
    vp = VisProvider("env", tmp_path)
    assert vp.visualize(m, force_repaint=False)
    assert not vp.visualize(m, force_repaint=False)  # unchanged
    assert vp.visualize(m, force_repaint=True)


def test_planning_validity():
    from gpu_voxels_jax.planning import GvlValidityChecker, MotionValidator
    from gpu_voxels_jax.robot.dh import DHParameters, KinematicChain

    params = [DHParameters(0, 0, 1.0, 0)]
    clouds = MetaPointCloud.from_clouds([[[1.0, 0.0, 0.0]]], names=("l1",))
    arm = KinematicChain(["l1"], params, clouds)
    # obstacle at the +x pose of the end effector (cloud transforms by
    # identity for link1 -> always at (1,0,0)); env occupied at (1,0,0)
    env = ProbVoxelMap.create((8, 8, 8), 0.5).insert_point_cloud(
        np.array([[1.0, 0.1, 0.1]], np.float32)
    )
    checker = GvlValidityChecker(env, arm, 0.7)
    assert not checker.is_valid(jnp.asarray([0.0]))
    # empty env -> valid
    free_env = ProbVoxelMap.create((8, 8, 8), 0.5)
    checker2 = GvlValidityChecker(free_env, arm, 0.7)
    assert checker2.is_valid(jnp.asarray([0.0]))
    mv = MotionValidator(checker2, resolution=0.1)
    ok, n = mv.check_motion([0.0], [1.0])
    assert ok and n >= 10


def test_hierarchical_disk_roundtrip(tmp_path):
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap

    pts = np.array([[2.5, 3.5, 4.5]], np.float32)
    for cls in (HierarchicalProbMap, HierarchicalBitMap):
        h = cls.create((16, 16, 16)).insert_point_cloud(pts)
        f = tmp_path / "h.bin"
        map_io.write_hierarchical_map(h, f)
        back = map_io.read_hierarchical_map(f)
        assert type(back) is type(h)
        assert back.dims == h.dims and back.levels == h.levels
        if cls is HierarchicalBitMap:
            np.testing.assert_array_equal(np.asarray(back.status), np.asarray(h.status))
        else:
            np.testing.assert_array_equal(np.asarray(back.occupancy), np.asarray(h.occupancy))
        for a, b in zip(back.pyramid, h.pyramid):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_hierarchical_ascii_roundtrip(tmp_path):
    """NTree::serialize's ascii mode (NTree.hpp:3283-3400) equivalent: the
    dense octree tier roundtrips through the human-readable format."""
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap

    pts = np.array([[2.5, 3.5, 4.5], [9.5, 1.5, 0.5]], np.float32)
    for cls in (HierarchicalProbMap, HierarchicalBitMap):
        h = cls.create((16, 16, 16), side_length=0.3).insert_point_cloud(pts / 3)
        f = tmp_path / "h.txt"
        map_io.write_hierarchical_map(h, f, ascii=True)
        assert f.read_bytes().startswith(b"GPU_VOXELS_JAX_OCTREE ascii")
        back = map_io.read_hierarchical_map(f)
        assert type(back) is type(h)
        assert back.dims == h.dims and back.levels == h.levels
        # the on-disk side_length is float32 (binary header parity)
        assert back.side_length == float(np.float32(h.side_length))
        if cls is HierarchicalBitMap:
            np.testing.assert_array_equal(np.asarray(back.status), np.asarray(h.status))
        else:
            np.testing.assert_array_equal(
                np.asarray(back.occupancy), np.asarray(h.occupancy)
            )


@pytest.mark.parametrize("kind", ["hier_prob", "hier_bit", "paged_bit"])
def test_ascii_octree_with_former_header_loads(tmp_path, kind):
    """Ascii octree files written under the package's former name carry
    another first line over the same body; read_hierarchical_map still
    loads them."""
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap

    pts = np.array([[2.5, 3.5, 4.5], [9.5, 1.5, 0.5]], np.float32) / 3
    f = tmp_path / "former.txt"
    if kind == "paged_bit":
        m = PagedHierarchicalMap((64, 64, 64), 0.3)
        m.insert_point_cloud(pts)
        map_io.write_paged_map(m, f, ascii=True)
    else:
        cls = HierarchicalProbMap if kind == "hier_prob" else HierarchicalBitMap
        m = cls.create((16, 16, 16), side_length=0.3).insert_point_cloud(pts)
        map_io.write_hierarchical_map(m, f, ascii=True)
    raw = f.read_bytes()
    assert raw.startswith(map_io._ASCII_MAGIC + b"\n")
    f.write_bytes(map_io._FORMER_ASCII_MAGIC + raw[len(map_io._ASCII_MAGIC):])
    back = map_io.read_hierarchical_map(f)
    assert type(back) is type(m) and back.dims == m.dims
    if kind == "paged_bit":
        assert back.n_tiles() == m.n_tiles() > 0
        np.testing.assert_array_equal(
            np.asarray(back.pool[: back.n_tiles()]), np.asarray(m.pool[: m.n_tiles()])
        )
    else:
        for a, b in zip(back.pyramid, m.pyramid):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_former_package_name_is_an_alias(monkeypatch):
    """The former import name returns gpu_voxels_jax's own module objects,
    after a DeprecationWarning."""
    import importlib
    import sys

    import gpu_voxels_jax
    from gpu_voxels_jax.ops import collide

    former = "gpu_voxels_tpu"
    for name in [n for n in sys.modules if n.split(".")[0] == former]:
        monkeypatch.delitem(sys.modules, name)
    with pytest.warns(DeprecationWarning, match="gpu_voxels_jax"):
        pkg = importlib.import_module(former)
    assert pkg is gpu_voxels_jax
    assert importlib.import_module(former + ".ops.collide") is collide
    assert collide.__spec__.name == "gpu_voxels_jax.ops.collide"
    old = importlib.import_module(former + ".maps.voxelmap")
    assert old.ProbVoxelMap is ProbVoxelMap
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(former + ".no_such_module")


def test_hierarchical_validity_checker():
    from gpu_voxels_jax.maps.hierarchical import HierarchicalProbMap
    from gpu_voxels_jax.planning import MotionValidator
    from gpu_voxels_jax.planning.validity import HierarchicalValidityChecker
    from gpu_voxels_jax.robot.dh import DHParameters, KinematicChain

    params = [DHParameters(0, 0, 0.0, 0), DHParameters(0, 0, 1.0, 0), DHParameters(0, 0, 0.0, 0)]
    clouds = MetaPointCloud.from_clouds(
        [np.linspace([4.1, 4.0, 4.0], [4.9, 4.0, 4.0], 5).astype(np.float32)], names=("fore",)
    )
    # cloud on "fore" sees joints 1+2... but cloud coords here are absolute;
    # use a simple 1-link arm whose cloud rotates about the origin instead
    params = [DHParameters(0, 0, 0.0, 0), DHParameters(0, 0, 0.0, 0)]
    clouds = MetaPointCloud.from_clouds(
        [np.linspace([1.1, 0.0, 0.0], [1.9, 0.0, 0.0], 5).astype(np.float32)], names=("l2",)
    )
    arm = KinematicChain(["l1", "l2"], params, clouds)

    class Based:
        def transformed_clouds_for(self, cfg):
            import jax.numpy as jnp
            from dataclasses import replace

            full = jnp.concatenate([jnp.asarray(cfg, jnp.float32), jnp.zeros((1,))])
            c = arm.transformed_clouds_for(full)
            return replace(c, points=c.points + jnp.asarray([4.0, 4.0, 4.0]))

    env = HierarchicalProbMap.create((16, 16, 16), 0.5).insert_point_cloud(
        np.array([[5.8, 4.1, 4.1]], np.float32)
    )
    checker = HierarchicalValidityChecker(env, Based())
    assert checker.colliding_voxels(np.array([0.0], np.float32)) >= 1  # +x blocked
    assert checker.colliding_voxels(np.array([np.pi / 2], np.float32)) == 0
    mv = MotionValidator(checker, resolution=0.1)
    ok, _ = mv.check_motion([np.pi / 2], [np.pi])
    assert ok
    bad, _ = mv.check_motion([-0.5], [0.5])
    assert not bad


def test_camelcase_compat_aliases():
    """Reference-spelled API names resolve (migration compatibility)."""
    gvl = fresh_gvl()
    gvl.addMap(MapType.MT_PROBAB_VOXELMAP, "camelA")
    gvl.addMap(MapType.MT_PROBAB_VOXELMAP, "camelB")
    gvl.insertBoxIntoMap((0.4,) * 3, (0.8,) * 3, "camelA", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insertBoxIntoMap((0.2,) * 3, (0.6,) * 3, "camelB", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    assert int(gvl.getMap("camelA").collideWith(gvl.getMap("camelB"))) == 8000
    m = ProbVoxelMap.create((8, 8, 8)).insertPointCloud(
        np.array([[1.5, 1.5, 1.5]], np.float32)
    )
    assert bool(m.collisionCheck(m, 0.5))
    from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap

    d = DistanceVoxelMap.create((8, 8, 8)).insertPointCloud(
        np.array([[1.5, 1.5, 1.5]], np.float32)
    ).parallelBanding3D()
    assert int(d.getSquaredObstacleDistance(1, 1, 3)) == 4


def test_compat_alias_tables_fully_install():
    """Every declared camelCase alias actually installs somewhere.

    Guards against the alias tables over-claiming: compat._apply silently
    skips classes lacking the snake_case target (an alias like
    clearBitVoxelMeaning legitimately exists only on bit-typed maps), so
    a typo'd or removed target would otherwise vanish without a failure.
    Each (camel, snake) row must have >=1 class in its application set
    carrying the snake method, and every such class must expose the camel
    spelling too."""
    import gpu_voxels_jax.api  # triggers compat.install()
    from gpu_voxels_jax import compat
    from gpu_voxels_jax.api import GpuVoxels
    from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap
    from gpu_voxels_jax.maps.hierarchical import (
        HierarchicalBitMap,
        HierarchicalProbMap,
    )
    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap
    from gpu_voxels_jax.maps.voxellist import VoxelList
    from gpu_voxels_jax.maps.voxelmap import (
        BitVectorVoxelMap,
        CountingVoxelMap,
        ProbVoxelMap,
    )

    from gpu_voxels_jax.parallel.paged_world import ShardedPagedWorld

    map_classes = (
        ProbVoxelMap, BitVectorVoxelMap, CountingVoxelMap,
        HierarchicalProbMap, HierarchicalBitMap, PagedHierarchicalMap,
        DistanceVoxelMap, ShardedPagedWorld,
    )
    tables = [
        (compat._FACADE_ALIASES, (GpuVoxels,)),
        (compat._MAP_ALIASES, map_classes),
        (compat._LIST_ALIASES, (VoxelList,)),
        (compat._DISTANCE_ALIASES, (DistanceVoxelMap,)),
    ]
    for aliases, classes in tables:
        for camel, snake in aliases.items():
            holders = [c for c in classes if hasattr(c, snake)]
            assert holders, f"{camel} -> {snake}: no target class has it"
            for c in holders:
                assert hasattr(c, camel), f"{c.__name__}.{camel} not installed"


def test_morton_voxel_list_disk_roundtrip(tmp_path):
    """Morton lists persist 64-bit ids (the reference's MortonVoxelList id
    type); membership must survive a disk round trip, incl. coords >= 1024."""
    from gpu_voxels_jax.maps.voxellist import bit_vector_morton_voxel_list

    pts = np.array([[2000.5, 1500.5, 1030.5], [3.5, 4.5, 5.5]], np.float32)
    lst = bit_vector_morton_voxel_list((4096, 4096, 4096)).insert_point_cloud(pts, 50)
    f = tmp_path / "morton.bin"
    map_io.write_voxel_list(lst, f)
    back = map_io.read_voxel_list(f)
    assert int(back.count) == 2
    np.testing.assert_array_equal(
        np.asarray(back.entry_coords()[:2]), np.asarray(lst.entry_coords()[:2])
    )
    assert int(back.collide_with(lst)) == 2


def test_vis_config_xml_roundtrip(tmp_path):
    """VisConfig = the XMLInterpreter equivalent: per-meaning colors and
    visibility, camera presets, slicing (gpu_visualization/XMLInterpreter.*)."""
    from gpu_voxels_jax.vis.config import VisConfig

    xml = tmp_path / "vis.xml"
    xml.write_text(
        "<visconfig>"
        "<camera name='top'><position>0 0 100</position><target>32 32 0</target></camera>"
        "<meaning id='10'><color>255 0 0</color></meaning>"
        "<meaning id='4'><visible>false</visible></meaning>"
        "<slice axis='z' min='0' max='16'/>"
        "<background>0 0 0</background>"
        "</visconfig>"
    )
    cfg = VisConfig.from_xml(xml)
    assert cfg.meaning_colors[10] == (255, 0, 0)
    assert cfg.visible(4) is False and cfg.visible(10) is True
    assert cfg.cameras[0].name == "top" and cfg.cameras[0].position == (0.0, 0.0, 100.0)
    assert cfg.slice_keep((5, 5, 10)) and not cfg.slice_keep((5, 5, 20))
    p = cfg.publish(tmp_path)
    d = json.loads(p.read_text())
    assert d["meaning_colors"]["10"] == [255, 0, 0]
    assert d["slice"]["axis"] == "z" and d["slice"]["max"] == 16.0
    # the served page consumes these fields
    from gpu_voxels_jax.vis import serve

    assert "visconfig.json" in serve.INDEX and "slice" in serve.INDEX


def test_per_map_write_read_disk_contract(tmp_path):
    """writeToDisk/readFromDisk on the map objects themselves
    (GpuVoxelsMap.h:200-209) — every tier, camelCase aliases included, and
    the reference's map-type-mismatch rejection."""
    import pytest

    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap
    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap
    from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list

    pts = np.array([[1.5, 2.5, 3.5], [4.5, 5.5, 6.5]], np.float32)

    m = ProbVoxelMap.create((8, 8, 8)).insert_point_cloud(pts)
    assert m.writeToDisk(tmp_path / "p.bin")  # camelCase alias is installed
    m2 = ProbVoxelMap.create((8, 8, 8)).readFromDisk(tmp_path / "p.bin")
    np.testing.assert_array_equal(np.asarray(m2.data), np.asarray(m.data))

    lst = bit_vector_voxel_list((8, 8, 8)).insert_point_cloud(pts, 50)
    assert lst.write_to_disk(tmp_path / "l.bin")
    l2 = bit_vector_voxel_list((8, 8, 8)).read_from_disk(tmp_path / "l.bin")
    assert int(l2.collide_with(lst)) == 2

    h = HierarchicalBitMap.create((32, 32, 32)).insert_point_cloud(pts)
    assert h.write_to_disk(tmp_path / "h.bin")
    h2 = HierarchicalBitMap.create((32, 32, 32)).read_from_disk(tmp_path / "h.bin")
    assert bool(h2.probe(jnp.asarray([[1, 2, 3]], jnp.int32))[0][0])

    pg = PagedHierarchicalMap((4096, 4096, 4096), 1.0)
    pg.insert_point_cloud(pts * 100)
    assert pg.write_to_disk(tmp_path / "pg.bin")
    pg2 = PagedHierarchicalMap((4096, 4096, 4096), 1.0).read_from_disk(tmp_path / "pg.bin")
    assert pg2.n_tiles() == pg.n_tiles()

    # loading the wrong map type raises (reference logs + returns false)
    with pytest.raises(ValueError):
        ProbVoxelMap.create((8, 8, 8)).read_from_disk(tmp_path / "l.bin")


def test_primitive_array_reaches_viewer_manifest(tmp_path, monkeypatch):
    """visualizePrimitivesArray publishes spheres/cuboids into the live
    viewer manifest (VisPrimitiveArray equivalent)."""
    import json

    monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path))
    gvl = fresh_gvl()
    gvl.add_primitives(PrimitiveType.ePRIM_SPHERE, "balls")
    gvl.modify_primitives("balls", np.array([[1, 2, 3], [4, 5, 6]], np.float32), diameter=0.5)
    assert gvl.visualize_primitives_array("balls")
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert "balls" in manifest["maps"]
    layer = json.loads((tmp_path / "balls.cubes.json").read_text())
    assert layer["prim"] == "sphere"
    assert layer["centers"] == [[1, 2, 3], [4, 5, 6]]
    assert layer["scales"] == [0.5, 0.5]


def test_facade_update_map_is_thread_atomic():
    """The reference guards every map with a recursive mutex
    (GpuVoxelsMap.h:269, dual-lock in binary ops TemplateVoxelMap.hpp:491-493);
    here update_map is the atomic read-modify-write. Concurrent inserts from
    many threads must all land — a racy rebind would drop updates."""
    import threading

    import numpy as np

    from gpu_voxels_jax.api import GpuVoxels, MapType

    GpuVoxels._instance = None
    g = GpuVoxels.get_instance()
    g.initialize(32, 32, 32, 1.0)
    g.add_map(MapType.MT_BITVECTOR_VOXELMAP, "shared")
    # distinct voxel per (thread, i): x = t, y = i, z = 7
    n_threads, n_each = 8, 12

    def worker(t):
        for i in range(n_each):
            pt = np.array([[t + 0.5, i + 0.5, 7.5]], np.float32)
            g.insert_point_cloud_into_map(pt, "shared", 10)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    m = g.get_map("shared")
    assert int(m.collide_with(m)) == n_threads * n_each
