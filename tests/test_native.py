"""Native C++ fast-path tests (builds the library with the baked toolchain)."""
import numpy as np
import pytest

from gpu_voxels_jax.utils import native


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available() and not native.build():
        pytest.skip("native toolchain unavailable")


def test_parse_xyz_matches_python():
    text = b"1.5 2.25 -3.0\n4 5 6\n# comment token\n7.5 8.5 9.5 extra 1 2\n"
    pts = native.parse_xyz(text)
    # the C parser skips non-numeric tokens, like the reference's iss >> x
    flat = pts.reshape(-1)
    assert flat[:9].tolist() == [1.5, 2.25, -3.0, 4, 5, 6, 7.5, 8.5, 9.5]


def test_binvox_rle_decode():
    rle = bytes([1, 3, 0, 5, 1, 2])
    out = native.binvox_rle_decode(rle, 10)
    assert out.tolist() == [1, 1, 1, 0, 0, 0, 0, 0, 1, 1]


def test_binvox_rle_points_matches_dense_decode():
    """Direct RLE->coords must equal dense-decode + nonzero, same order."""
    rng = np.random.default_rng(7)
    depth = height = width = 8
    size = depth * height * width
    grid = (rng.uniform(size=size) < 0.3).astype(np.uint8)
    # build an RLE stream (runs capped at 255 like the format requires)
    rle = []
    i = 0
    while i < size:
        v = grid[i]
        run = 1
        while i + run < size and grid[i + run] == v and run < 255:
            run += 1
        rle += [int(v), run]
        i += run
    rle = bytes(rle)
    dense = native.binvox_rle_decode(rle, size)
    np.testing.assert_array_equal(dense, grid)
    x, z, y = np.nonzero(dense.reshape(depth, height, width) == 1)
    expect = np.stack([x, y, z], axis=1).astype(np.int32)
    got = native.binvox_rle_points(rle, size, height, width)
    np.testing.assert_array_equal(got, expect)


def test_load_point_clouds_batch(tmp_path):
    from gpu_voxels_jax.geometry import files

    rng = np.random.default_rng(1)
    paths = []
    ptss = []
    for i in range(5):
        pts = rng.normal(size=(50 + i, 3)).astype(np.float32)
        p = tmp_path / f"c{i}.xyz"
        files.write_xyz(p, pts)
        paths.append(p)
        ptss.append(pts)
    out = files.load_point_clouds(paths, scaling=2.0)
    assert len(out) == 5
    for got, pts in zip(out, ptss):
        np.testing.assert_allclose(got, 2.0 * pts, atol=1e-4)
    assert files.load_point_clouds([]) == []


def test_file_reader_uses_native_path(tmp_path):
    from gpu_voxels_jax.geometry import files

    pts = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    f = tmp_path / "c.xyz"
    files.write_xyz(f, pts)
    assert files._native is not None and files._native.available()
    back = files.read_xyz(f)
    np.testing.assert_allclose(back, pts, atol=1e-5)


def test_bit_planes_stream_roundtrip_and_byte_identity(tmp_path):
    """The streaming snapshot writer (gv_write_bit_planes) produces files
    byte-identical to the numpy interleave at a nonzero offset, across
    chunk-boundary sizes, and gv_read_bit_planes inverts it exactly."""
    rng = np.random.default_rng(3)
    for n in (1, 7, 1 << 18, (1 << 18) + 5):
        planes = rng.integers(0, 2**32, size=(8, n), dtype=np.uint32)
        p1 = tmp_path / f"nat_{n}.bin"
        with open(p1, "wb") as f:
            f.write(b"HDR!")  # nonzero body offset, like the map header
            f.flush()
            assert native.write_bit_planes(planes, f.fileno(), f.tell())
        expect = (
            np.ascontiguousarray(planes.astype("<u4").T).view(np.uint8).tobytes()
        )
        got = p1.read_bytes()
        assert got[:4] == b"HDR!" and got[4:] == expect
        with open(p1, "rb") as f:
            back = native.read_bit_planes(n, f.fileno(), 4)
        np.testing.assert_array_equal(back, planes)


def test_voxel_map_disk_native_matches_numpy(tmp_path, monkeypatch):
    """write_map through the native streamer emits byte-identical files to
    the pure-numpy fallback, and read_map loads either file identically."""
    from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap
    from gpu_voxels_jax.utils import io as gio

    m = BitVectorVoxelMap.create((8, 8, 8), 1.0)
    pts = np.array([[1.5, 2.5, 3.5], [4.5, 5.5, 6.5]], np.float32)
    m = m.insert_point_cloud(pts, 17)
    p_nat, p_py = tmp_path / "a.bin", tmp_path / "b.bin"
    assert native.available()
    gio.write_map(m, p_nat)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", True)
    assert not native.available()
    gio.write_map(m, p_py)
    assert p_nat.read_bytes() == p_py.read_bytes()
    back_py = gio.read_map(p_py)  # numpy read path
    monkeypatch.setattr(native, "_load_attempted", False)
    assert native.available()
    back_nat = gio.read_map(p_nat)  # native read path
    np.testing.assert_array_equal(np.asarray(back_nat.data), np.asarray(m.data))
    np.testing.assert_array_equal(np.asarray(back_py.data), np.asarray(back_nat.data))
