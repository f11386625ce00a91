"""Auxiliary subsystems: tf helper, sensors, converters, heightmap."""
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax import converters
from gpu_voxels_jax.geometry import heightmap, transforms
from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_jax.sensors import ReplayDepthSource, Sensor, SensorModel, SyntheticDepthSource
from gpu_voxels_jax.utils.tf_helper import TfHelper


def test_tf_helper_chain_lookup():
    tf = TfHelper()
    tf.publish(transforms.from_translation([1, 0, 0], xp=np), "world", "base")
    tf.publish(transforms.from_translation([0, 2, 0], xp=np), "base", "camera")
    m = tf.lookup("world", "camera")
    np.testing.assert_allclose(m[:3, 3], [1, 2, 0], atol=1e-6)
    inv = tf.lookup("camera", "world")
    np.testing.assert_allclose(inv[:3, 3], [-1, -2, 0], atol=1e-6)
    assert tf.lookup("world", "unknown") is None
    np.testing.assert_allclose(tf.lookup("base", "base"), np.eye(4))


def test_sensor_depth_processing():
    s = Sensor(
        position=np.array([1, 2, 3], np.float32),
        data_width=8,
        data_height=6,
        fx=4.0,
        fy=4.0,
        cx=4.0,
        cy=3.0,
    )
    depth = np.zeros((6, 8), np.float32)
    depth[3, 4] = 2.0
    pts = np.asarray(s.process_depth_image(depth))
    valid = pts[np.isfinite(pts).all(axis=1)]
    np.testing.assert_allclose(valid, [[1, 2, 5]], atol=1e-6)


def test_depth_sources():
    s = Sensor(data_width=16, data_height=12)
    src = SyntheticDepthSource(s)
    f1, f2 = src.get_frame(), src.get_frame()
    assert f1.shape == (12, 16) and not np.array_equal(f1, f2)
    rp = ReplayDepthSource(np.stack([f1, f2]))
    np.testing.assert_array_equal(rp.get_frame(), f1)
    np.testing.assert_array_equal(rp.get_frame(), f2)
    np.testing.assert_array_equal(rp.get_frame(), f1)
    assert SensorModel().initial_probability == 72


def test_streaming_depth_source_cadence():
    """StreamingDepthSource reproduces the Kinect grabber's timing contract
    (helpers/Kinect.h:36-70): frames become due at the cadence, early polls
    return None, slow consumers DROP missed frames (latest wins)."""
    import time

    from gpu_voxels_jax.sensors import StreamingDepthSource

    frames = [np.full((2, 2), float(i), np.float32) for i in range(100)]
    src = StreamingDepthSource(frames, hz=200.0)
    f0 = src.get_frame()
    assert float(f0[0, 0]) == 0.0
    assert src.get_frame() is None  # polled again immediately: not due yet
    f1 = src.wait_for_frame(timeout_s=1.0)  # blocks until due
    assert f1 is not None and float(f1[0, 0]) >= 1.0
    time.sleep(5.5 / 200.0)  # sleep past ~5 frames: they are dropped
    fn = src.get_frame()
    assert fn is not None and float(fn[0, 0]) >= float(f1[0, 0]) + 4
    # non-loop sources exhaust
    short = StreamingDepthSource(frames[:2], hz=1000.0, loop=False)
    assert short.wait_for_frame(0.1) is not None  # frame 0
    time.sleep(3.0 / 1000.0)
    assert short.get_frame() is None  # past the recording: exhausted
    assert short.wait_for_frame(0.01) is None


def test_socket_depth_source_roundtrip():
    """Length-prefixed float32 frames over TCP land in the latest-wins
    buffer; get_frame() returns each new frame once."""
    import socket
    import threading
    import time

    from gpu_voxels_jax.sensors import SocketDepthSource

    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    port = server.getsockname()[1]
    sent = [np.arange(6, dtype=np.float32).reshape(2, 3) + i for i in range(3)]

    def producer():
        conn, _ = server.accept()
        for f in sent:
            SocketDepthSource.send_frame(conn, f)
        conn.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    src = SocketDepthSource("127.0.0.1", port)
    deadline = time.monotonic() + 5.0
    got = []
    while len(got) < 1 and time.monotonic() < deadline:
        f = src.get_frame()
        if f is not None:
            got.append(f)
        time.sleep(0.01)
    t.join(5.0)
    # drain whatever arrived after the producer finished
    f = src.get_frame()
    if f is not None:
        got.append(f)
    assert got, "no frame arrived over the socket"
    last = got[-1]
    assert last.shape == (2, 3)
    assert any(np.array_equal(last, s) for s in sent)
    assert src.get_frame() is None  # same frame is never handed out twice
    src.close()


def test_async_vis_publisher(tmp_path):
    """AsyncVisPublisher: publish() is non-blocking and latest-wins; flush
    drains; the newest published map is what lands on disk."""
    from gpu_voxels_jax.vis.provider import AsyncVisPublisher

    m1 = ProbVoxelMap.create((8, 8, 8), 1.0).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5]], np.float32)
    )
    m2 = m1.insert_point_cloud(np.array([[4.5, 4.5, 4.5]], np.float32))
    pub = AsyncVisPublisher("live", out_dir=tmp_path)
    for _ in range(5):
        pub.publish(m1)
    pub.publish(m2)
    assert pub.flush(timeout_s=30.0)
    pub.stop()
    assert pub.frames_painted >= 1  # latest-wins: far fewer paints than publishes
    ply = (tmp_path / "live.ply").read_text()
    assert "4.5" in ply or "vertex" in ply  # snapshot of the newest map exists


def test_async_vis_publisher_warns_when_worker_dies(tmp_path):
    """A dead worker must not fail silently: the first publish() after the
    worker exception warns eagerly (round-4 advisor — a live loop would
    otherwise fill the mailbox forever), and flush() re-raises."""
    import warnings

    import pytest

    from gpu_voxels_jax.vis.provider import AsyncVisPublisher

    m = ProbVoxelMap.create((8, 8, 8), 1.0).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5]], np.float32)
    )
    pub = AsyncVisPublisher("dies", out_dir=tmp_path)
    boom = RuntimeError("paint failed")

    def exploding(_m, force_repaint=False):
        raise boom

    pub.provider.visualize = exploding
    pub.publish(m)
    pub._thread.join(30.0)  # worker exits on the exception
    assert pub._error is boom
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pub.publish(m)  # first publish after death: eager warning
        pub.publish(m)  # subsequent publishes stay silent
    msgs = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "worker died" in str(msgs[0].message)
    with pytest.raises(RuntimeError, match="paint failed"):
        pub.flush(timeout_s=5.0)


def test_provider_live_vis_and_async_collide(tmp_path, monkeypatch):
    """Provider(live_vis=True): visualize() is O(1) publish; collide_async
    returns a device scalar equal to collide()."""
    monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path))
    from gpu_voxels_jax.providers import Provider

    env = Provider("env_live", live_vis=True)
    env.init(
        ProbVoxelMap.create((16, 16, 16), 1.0).insert_point_cloud(
            np.array([[8.5, 8.5, 4.5]], np.float32)
        )
    )
    robot = Provider("robot_live")
    robot.init(
        BitVectorVoxelMap.create((16, 16, 16), 1.0).insert_point_cloud(
            np.array([[8.5, 8.5, 4.5]], np.float32)
        )
    )
    robot.set_collide_with(env, coll_threshold=0.7)
    assert robot.collide() == 1
    assert int(robot.collide_async()) == 1
    env.visualize()
    assert env.finish_visualization() >= 1
    assert (tmp_path / "env_live.ply").exists()


def test_device_compaction_matches_nonzero():
    """ops/compact: device stream compaction (the Extract kernel's
    ballot+prefix-sum, Extract.h:50, as one XLA pass) is byte-identical to
    np.flatnonzero, with capacity truncation and exact overflow counts —
    visualization readback fetches O(occupied), never the O(N) mask."""
    import jax.numpy as jnp

    from gpu_voxels_jax.ops.compact import compact_indices, compacted_nonzero
    from gpu_voxels_jax.vis.extract import occupied_coords

    rng = np.random.default_rng(11)
    mask = rng.random(50_000) < 0.02
    np.testing.assert_array_equal(
        compacted_nonzero(jnp.asarray(mask)), np.flatnonzero(mask)
    )
    np.testing.assert_array_equal(
        compacted_nonzero(jnp.asarray(mask), capacity=7), np.flatnonzero(mask)[:7]
    )
    count, _ = compact_indices(jnp.asarray(mask), 7)
    assert int(count) == int(mask.sum())  # total count survives truncation
    assert compacted_nonzero(jnp.zeros(256, bool)).size == 0

    # occupied_coords goes through the device path and stays exact
    pts = rng.uniform(0, 24, (500, 3)).astype(np.float32)
    m = ProbVoxelMap.create((24, 24, 24), 1.0).insert_point_cloud(pts)
    co = occupied_coords(m, 0.5)
    assert len(co) == int(np.asarray(m.occupied_mask(0.5)).sum())
    dx, dy, _ = m.dims
    lin = co[:, 2] * dx * dy + co[:, 1] * dx + co[:, 0]
    assert bool(np.asarray(m.occupied_mask(0.5))[lin].all())


def test_converters_roundtrip():
    pts = np.array([[3.5, 3.5, 3.5]], np.float32)
    dm = DistanceVoxelMap.create((16, 16, 16)).insert_point_cloud(pts).jump_flood()
    pm = converters.distance_map_to_prob_map(dm, clearance=2.0)
    occ = np.asarray(pm.as_3d())
    assert occ[3, 3, 3] == 127 and occ[3, 3, 5] == 127 and occ[3, 3, 6] == -127
    bm = converters.distance_map_to_bit_map(dm, clearance=0.0)
    assert int(np.asarray(bm.occupied_mask()).sum()) == 1
    pm2 = converters.bit_map_to_prob_map(bm)
    assert int(np.asarray(pm2.occupied_mask(0.5)).sum()) == 1
    bm2 = converters.prob_map_to_bit_map(pm2)
    assert int(np.asarray(bm2.occupied_mask()).sum()) == 1


def test_heightmap_extrusion():
    h = np.array([[0, 2], [1, 0]], np.float32)
    pts = heightmap.heightmap_to_point_cloud(h, pixel_size=1.0)
    m = ProbVoxelMap.create((2, 2, 3)).insert_point_cloud(pts + 0.25)
    occ = np.asarray(m.occupied_mask(0.5)).reshape(3, 2, 2)  # [Z,Y,X]
    assert occ[0].all()  # ground layer everywhere
    assert occ[2, 0, 1] and not occ[2, 1, 0]  # only the h=2 column reaches z=2


def test_heightmap_npy_loader(tmp_path):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.save(tmp_path / "h.npy", arr)
    back = heightmap.load_height_array(tmp_path / "h.npy")
    np.testing.assert_array_equal(back, arr)


def test_provider_contract():
    from gpu_voxels_jax.providers import Provider
    from gpu_voxels_jax.sensors import Sensor, SyntheticDepthSource

    sensor = Sensor(position=np.array([8.0, 8.0, 0.2], np.float32), data_width=16,
                    data_height=12, fx=10.0, fy=10.0, cx=8.0, cy=6.0)
    env = Provider("env")
    env.init(ProbVoxelMap.create((16, 16, 16), 1.0))
    robot = Provider("robot")
    robot.init(BitVectorVoxelMap.create((16, 16, 16), 1.0).insert_point_cloud(
        np.array([[8.5, 8.5, 4.5]], np.float32)))
    robot.set_collide_with(env)
    src = SyntheticDepthSource(sensor)
    assert env.wait_for_new_data(src, sensor)
    assert robot.collide() >= 0


def test_provider_collide_non_dense_maps():
    """Provider.collide must NOT pass coll_threshold positionally: only the
    dense-map signature has it 2nd — octree tiers take min_level there and
    lists take offset, so a positional 1.0 probed the wrong pyramid level /
    shifted every coordinate (round-4 advisor, providers.py)."""
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap
    from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list
    from gpu_voxels_jax.providers import Provider

    pts = np.array([[2.5, 2.5, 2.5], [5.5, 5.5, 5.5]], np.float32)
    env = Provider("env_nd")
    env.init(ProbVoxelMap.create((16, 16, 16), 1.0).insert_point_cloud(pts))

    # list tier: a positional threshold binds to offset=(1,1,1)-ish -> shift
    lst = Provider("lst_nd")
    lst.init(bit_vector_voxel_list((16, 16, 16)).insert_point_cloud(pts, 20))
    lst.set_collide_with(env)
    assert lst.collide() == 2

    # octree tier: a positional 1.0 binds to min_level -> wrong pyramid level
    hier = Provider("hier_nd")
    hier.init(HierarchicalBitMap.create((16, 16, 16), 1.0).insert_point_cloud(pts))
    hier.set_collide_with(env)
    assert hier.collide() == 2

    # dense tier still honors the threshold keyword
    dense = Provider("dense_nd")
    dense.init(ProbVoxelMap.create((16, 16, 16), 1.0).insert_point_cloud(pts))
    dense.set_collide_with(env, coll_threshold=1.0)
    assert dense.collide() == 2


def test_collide_with_type_mask():
    from gpu_voxels_jax import bitops
    from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list

    pts = np.array([[2.5, 2.5, 2.5], [4.5, 4.5, 4.5]], np.float32)
    lst = bit_vector_voxel_list((8, 8, 8)).insert_point_cloud(pts[:1], 50)
    lst = lst.insert_point_cloud(pts[1:], 60)
    env = ProbVoxelMap.create((8, 8, 8)).insert_point_cloud(pts)
    mask50 = np.asarray(bitops.set_bit(bitops.zeros(()), 50))
    mask70 = np.asarray(bitops.set_bit(bitops.zeros(()), 70))
    assert int(lst.collide_with_type_mask(env, mask50, 0.5)) == 1
    assert int(lst.collide_with_type_mask(env, mask70, 0.5)) == 0
    both = np.asarray(bitops.set_bit(bitops.set_bit(bitops.zeros(()), 50), 60))
    assert int(lst.collide_with_type_mask(env, both, 0.5)) == 2


def test_counting_list_subtract_bit_list():
    """subtractFromCountingVoxelList: remove bit-list voxels (e.g. the robot)
    from a counting list before density filtering."""
    from gpu_voxels_jax.maps.voxellist import bit_vector_voxel_list, counting_voxel_list

    pts = np.array([[1.5, 1.5, 1.5], [2.5, 2.5, 2.5]], np.float32)
    c = counting_voxel_list((8, 8, 8)).insert_point_cloud(pts)
    robot = bit_vector_voxel_list((8, 8, 8)).insert_point_cloud(pts[:1], 50)
    out = c.subtract(robot)
    assert int(out.count) == 1
    coords = np.asarray(out.coords_from_ids(out.ids[:1]))
    assert coords[0].tolist() == [2, 2, 2]


def test_facade_save_load(tmp_path):
    from gpu_voxels_jax.api import GpuVoxels
    from gpu_voxels_jax.constants import MapType

    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(16, 16, 16, 1.0)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "env")
    gvl.insert_point_cloud_into_map(np.array([[3.5, 3.5, 3.5]], np.float32), "env")
    gvl.save_map("env", tmp_path / "env.bin")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "env2")
    gvl.load_map("env2", tmp_path / "env.bin")
    assert int(gvl.get_map("env2").collide_with(gvl.get_map("env"), 0.5)) == 1


def test_live_viewer_publish_and_serve(tmp_path):
    import json as _json
    import threading
    import urllib.request
    from http.server import HTTPServer, SimpleHTTPRequestHandler

    from gpu_voxels_jax.vis.provider import VisProvider
    from gpu_voxels_jax.vis.serve import INDEX, publish_cubes

    m = ProbVoxelMap.create((8, 8, 8)).insert_point_cloud(
        np.array([[1.5, 1.5, 1.5]], np.float32)
    )
    vp = VisProvider("env", tmp_path)
    vp.visualize(m)
    manifest = _json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["maps"] == ["env"]
    cubes = _json.loads((tmp_path / "env.cubes.json").read_text())
    assert cubes["centers"] == [[1.5, 1.5, 1.5]]

    # serve and fetch over HTTP (ephemeral port)
    (tmp_path / "index.html").write_text(INDEX)

    class Handler(SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(tmp_path), **k)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/env.cubes.json").read()
        assert _json.loads(body)["side"] == 1.0
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/index.html").read()
        assert b"InstancedMesh" in page
        # the offline fallback renderer ships in the page (air-gapped hosts
        # can't reach the three.js CDN) and precedes the module script
        assert b"startFallback" in page
        assert page.index(b"window.startFallback") < page.index(b"unpkg.com")
    finally:
        srv.shutdown()


def test_vis_extract_morton_list_past_1024():
    """occupied_coords must decode 60-bit morton ids with the high word —
    cubes rendered at coords mod 1024 silently draw the wrong scene."""
    import numpy as np

    from gpu_voxels_jax.maps.voxellist import VoxelList
    from gpu_voxels_jax.vis import extract

    dims = (4096, 4096, 4096)
    lst = VoxelList.create(dims, 1.0, kind="bit", capacity=8, id_mode="morton")
    lst = lst.insert_point_cloud(np.array([[2000.5, 1030.5, 3000.5]], np.float32))
    coords = extract.occupied_coords(lst)
    np.testing.assert_array_equal(coords, np.array([[2000, 1030, 3000]], np.int32))


def test_publish_cubes_includes_types(tmp_path):
    """The viewer payload must carry per-voxel meaning ids — the
    meaning_colors/meaning_visible config and click-to-inspect consume them."""
    import json

    import numpy as np

    from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap
    from gpu_voxels_jax.vis.serve import publish_cubes

    m = BitVectorVoxelMap.create((16, 16, 16), 1.0).insert_point_cloud(
        np.array([[3.5, 3.5, 3.5]], np.float32), 20
    )
    publish_cubes(tmp_path, "m", m, 0.5)
    payload = json.loads((tmp_path / "m.cubes.json").read_text())
    assert payload["types"] == [20]
    assert len(payload["centers"]) == 1


def test_visualize_hierarchical_and_paged_maps(tmp_path):
    """visualizeMap works for every map tier — extract falls back to each
    tier's extract_occupied_coords and the provider fingerprints the right
    ground-truth array."""
    import numpy as np

    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
    from gpu_voxels_jax.maps.paged import PagedHierarchicalMap
    from gpu_voxels_jax.vis.provider import VisProvider

    pts = np.array([[5.5, 6.5, 7.5]], np.float32)
    maps = {
        "hp": HierarchicalProbMap.create((64, 64, 64)).insert_point_cloud(pts),
        "hb": HierarchicalBitMap.create((64, 64, 64)).insert_point_cloud(pts),
        "pg": PagedHierarchicalMap((128, 128, 128)).insert_point_cloud(pts),
    }
    for name, m in maps.items():
        vp = VisProvider(name, out_dir=tmp_path)
        assert vp.visualize(m)
        import json

        payload = json.loads((tmp_path / f"{name}.cubes.json").read_text())
        # hierarchical tiers publish MULTI-LEVEL cubes: the single occupied
        # voxel is a unit cube; coarse FREE/UNKNOWN context cubes carry
        # per-cube scales > 1 (the VisNTree extractCubes contract)
        occ = [
            c for c, t in zip(payload["centers"], payload["types"]) if t == 1
        ]
        assert occ == [[5.5, 6.5, 7.5]], name
        assert "scales" in payload and max(payload["scales"]) > 1.0, name


def test_hierarchical_extract_honors_threshold():
    """occupied_coords on the probabilistic hierarchy must respect the
    caller's threshold (the status pyramid's fixed probe threshold is the
    octree PROBE contract, not the visualization contract)."""
    import numpy as np

    from gpu_voxels_jax.maps.hierarchical import HierarchicalProbMap
    from gpu_voxels_jax.vis.extract import occupied_coords

    h = HierarchicalProbMap.create((64, 64, 64))
    h = h.insert_point_cloud(np.array([[5.5, 6.5, 7.5]], np.float32))  # +127
    # threshold 0.5 -> included; 0.9999.. -> excluded only above +127? use
    # update to a mid value instead: carve one voxel to a low occupancy
    h2 = h.insert_point_cloud(np.array([[9.5, 9.5, 9.5]], np.float32), meaning=0)  # FREE = -127
    assert len(occupied_coords(h2, 0.5)) == 1  # only the +127 voxel
    assert len(occupied_coords(h2, 0.0)) >= 1


def test_voxellist_visualize_fingerprint_tracks_ids(tmp_path):
    """force_repaint=False must republish when a fixed-capacity list's ids
    change even though the payload bytes are identical."""
    import numpy as np

    from gpu_voxels_jax.maps.voxellist import VoxelList
    from gpu_voxels_jax.vis.provider import VisProvider

    vp = VisProvider("lst", out_dir=tmp_path)
    l1 = VoxelList.create((64, 64, 64), 1.0, kind="bit", capacity=4)
    l1 = l1.insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32), grow=False)
    assert vp.visualize(l1, force_repaint=False)
    # same payload (one occupied entry, same meaning), different voxel
    l2 = VoxelList.create((64, 64, 64), 1.0, kind="bit", capacity=4)
    l2 = l2.insert_point_cloud(np.array([[2.5, 1.5, 1.5]], np.float32), grow=False)
    assert vp.visualize(l2, force_repaint=False)  # ids changed -> repaint
    assert not vp.visualize(l2, force_repaint=False)  # unchanged -> skip


def test_jitcache_configuration(monkeypatch, tmp_path):
    """enable_persistent_cache leaves a set JAX_COMPILATION_CACHE_DIR to JAX
    (no directory set in code) and otherwise uses the fixed
    <repo>/.jax_cache; safe to call repeatedly."""
    import jax

    from gpu_voxels_jax.utils import jitcache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        assert jitcache.enable_persistent_cache() == str(tmp_path / "cache")
        assert jax.config.jax_compilation_cache_dir == "sentinel"  # untouched

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        default = jitcache.enable_persistent_cache()
        assert default == str(jitcache.DEFAULT_DIR)
        assert default.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == default
        assert jitcache.enable_persistent_cache() == default  # idempotent
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
