"""Map disk serialization, binary-compatible with the reference.

VoxelMap format (TemplateVoxelMap.hpp:666-713):
    int32 MapType | float32 side_length | 3 x uint32 dims | raw voxel array
where the raw array is the device layout: int8 occupancy (prob), uint32
packed coords (distance), or 32 bytes/voxel little-endian bit vector (bit
maps, voxel-major — converted from/to this framework's plane-major planes).

VoxelList format (TemplateVoxelList.hpp:445-535):
    int32 MapType | 3 x uint32 ref dims | float32 side_length | uint32 count
    | ids | coords (3 x uint32 each) | voxel payloads
"""
from __future__ import annotations

import numpy as np

from ..constants import MapType

_HEADER = np.dtype([("map_type", "<i4"), ("side_length", "<f4"), ("dims", "<u4", 3)])


def _planes_to_voxel_bytes(planes: np.ndarray) -> np.ndarray:
    """uint32[8, N] plane-major -> uint8[N, 32] voxel-major (reference layout)."""
    return np.ascontiguousarray(planes.astype("<u4").T).view(np.uint8).reshape(-1, 32)


def _voxel_bytes_to_planes(raw: np.ndarray, n: int) -> np.ndarray:
    return np.ascontiguousarray(raw.reshape(n, 8 * 4).view("<u4").T)


def _write_planes_body(f, planes: np.ndarray) -> None:
    """Write the voxel-major 32-byte-record body for plane-major uint32[8,N]
    planes at f's current position. Native tier (gv_write_bit_planes)
    streams the interleave through one 8 MiB chunk; the numpy fallback
    materializes the transposed copy (fine below ~1 GiB)."""
    from . import native

    n = planes.shape[1]
    if n:
        f.flush()  # pwrite bypasses the Python buffer
        if native.available() and native.write_bit_planes(planes, f.fileno(), f.tell()):
            f.seek(f.tell() + n * 32)
            return
    _planes_to_voxel_bytes(planes).tofile(f)


def _read_planes_body(f, n: int) -> np.ndarray:
    """Read n voxel-major 32-byte records at f's current position into
    plane-major uint32[8, n] (reverse of _write_planes_body)."""
    from . import native

    if n and native.available():
        pos = f.tell()
        planes = native.read_bit_planes(n, f.fileno(), pos)
        if planes is not None:
            f.seek(pos + n * 32)
            return planes
    raw = np.frombuffer(f.read(n * 32), np.uint8, n * 32)
    return _voxel_bytes_to_planes(raw, n)


def write_voxel_map(m, path) -> None:
    import jax.numpy as jnp  # noqa: F401

    from ..maps.distance_map import DistanceVoxelMap
    from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap

    if not isinstance(
        m, (ProbVoxelMap, CountingVoxelMap, BitVectorVoxelMap, DistanceVoxelMap)
    ):
        raise TypeError(type(m))
    data = np.asarray(m.data)
    header = np.zeros((), dtype=_HEADER)
    header["map_type"] = int(m.map_type)
    header["side_length"] = m.side_length
    header["dims"] = m.dims
    with open(path, "wb") as f:
        f.write(header.tobytes())
        if isinstance(m, BitVectorVoxelMap):
            _write_planes_body(f, data)
        elif isinstance(m, DistanceVoxelMap):
            np.asarray(data, "<u4").tofile(f)
        else:
            np.asarray(data, np.int8).tofile(f)


def read_voxel_map(path):
    from ..maps.distance_map import DistanceVoxelMap
    from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap
    import jax.numpy as jnp

    with open(path, "rb") as f:
        header = np.frombuffer(f.read(_HEADER.itemsize), dtype=_HEADER)[0]
        map_type = MapType(int(header["map_type"]))
        side = float(header["side_length"])
        dims = tuple(int(v) for v in header["dims"])
        n = dims[0] * dims[1] * dims[2]
        if map_type == MapType.MT_PROBAB_VOXELMAP:
            data = np.frombuffer(f.read(n), np.int8, n)
            return ProbVoxelMap(jnp.asarray(data), dims, side)
        if map_type == MapType.MT_BITVECTOR_VOXELMAP:
            planes = _read_planes_body(f, n)
            return BitVectorVoxelMap.from_planes(jnp.asarray(planes), dims, side)
        if map_type == MapType.MT_DISTANCE_VOXELMAP:
            data = np.frombuffer(f.read(n * 4), "<u4", n)
            return DistanceVoxelMap(jnp.asarray(data), dims, side)
        if map_type == MapType.MT_COUNTING_VOXELLIST:
            data = np.frombuffer(f.read(n), np.int8, n)
            return CountingVoxelMap(jnp.asarray(data), dims, side)
    raise ValueError(f"unknown map type {map_type}")


_ASCII_MAGIC = b"GPU_VOXELS_JAX_OCTREE ascii v1"
# the header that releases under the package's former name wrote (same
# length, same body); such files still load
_FORMER_ASCII_MAGIC = b"GPU_VOXELS_TPU_OCTREE ascii v1"
_ASCII_MAGICS = (_ASCII_MAGIC, _FORMER_ASCII_MAGIC)


def _write_octree_ascii_header(f, map_type: int, side_length: float, dims, levels: int):
    f.write(_ASCII_MAGIC + b"\n")
    # side_length is float32 in the binary header; hex keeps the roundtrip exact
    f.write(
        (
            f"map_type {map_type}\n"
            f"side_length {float(np.float32(side_length)).hex()}\n"
            f"dims {dims[0]} {dims[1]} {dims[2]}\n"
            f"levels {levels}\n"
        ).encode()
    )


def write_hierarchical_map(h, path, ascii: bool = False) -> None:
    """NTree::serialize equivalent (NTree.hpp:3283-3400, which supports both
    a binary and an ascii mode): persist the fine ground-truth grid +
    metadata; the pyramid is an invariant rebuilt on load. The probabilistic
    tier's ground truth is the int8 occupancy grid, the deterministic tier's
    the uint8 status grid. ascii=True writes the human-readable variant
    (read back by the same read_hierarchical_map)."""
    from ..maps.hierarchical import HierarchicalBitMap

    fine = np.asarray(
        h.status if isinstance(h, HierarchicalBitMap) else h.occupancy
    )
    if ascii:
        with open(path, "wb") as f:
            _write_octree_ascii_header(f, int(h.map_type), h.side_length, h.dims, h.levels)
            f.write(("shape %d %d %d\n" % fine.shape).encode())
            np.savetxt(f, fine.reshape(fine.shape[0], -1), fmt="%d")
        return
    header = np.zeros((), dtype=_HEADER)
    header["map_type"] = int(h.map_type)
    header["side_length"] = h.side_length
    header["dims"] = h.dims
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.int32(h.levels).tobytes())
        f.write(np.asarray(fine.shape, "<i4").tobytes())
        fine.tofile(f)


def write_paged_map(m, path, ascii: bool = False) -> None:
    """Sparse paged tier serialization (NTree::serialize analogue for
    octree-scale worlds; NTree.hpp:3283-3400 bin/ascii). Ground truth is the
    tile pool + the block list; the page directory, summaries and pyramid
    are invariants rebuilt on load. The levels field is written NEGATIVE to
    distinguish this body from the dense hierarchical format sharing
    MT_BITVECTOR_OCTREE. The probabilistic tier (MT_PROBAB_OCTREE header)
    persists the int8 log-odds pool instead of the derived status pool."""
    n = m.n_tiles()
    slot_block = np.asarray(m.slot_block[:n], "<i4")
    pool = (
        np.asarray(m.occ_pool[:n], np.int8)
        if m.probabilistic
        else np.asarray(m.pool[:n], np.uint8)
    )
    if ascii:
        with open(path, "wb") as f:
            _write_octree_ascii_header(
                f, int(m.map_type), m.side_length, m.dims, -m.fine_levels
            )
            f.write(f"tiles {n}\n".encode())
            if n:
                # one line per tile: block coords then the 512 cell values
                np.savetxt(
                    f,
                    np.concatenate([slot_block, pool.astype("<i4")], axis=1),
                    fmt="%d",
                )
        return
    header = np.zeros((), dtype=_HEADER)
    header["map_type"] = int(m.map_type)
    header["side_length"] = m.side_length
    header["dims"] = m.dims
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.int32(-m.fine_levels).tobytes())
        f.write(np.int32(n).tobytes())
        slot_block.tofile(f)
        pool.tofile(f)


def _read_octree_ascii(path):
    """Read back either octree tier's ascii serialization."""
    import jax.numpy as jnp

    from ..maps.hierarchical import (
        HierarchicalBitMap,
        HierarchicalProbMap,
        _build_pyramid,
        _status_from_occupancy,
    )

    with open(path, "rb") as f:
        assert f.readline().strip() in _ASCII_MAGICS
        fields = {}
        for _ in range(4):
            k, v = f.readline().decode().split(None, 1)
            fields[k] = v.strip()
        map_type = MapType(int(fields["map_type"]))
        side = float.fromhex(fields["side_length"])
        dims = tuple(int(v) for v in fields["dims"].split())
        levels = int(fields["levels"])
        parts = f.readline().decode().split()
        kind, args = parts[0], [int(v) for v in parts[1:]]
        if levels < 0:  # paged body
            from ..maps.paged import TILE, PagedHierarchicalMap

            prob = map_type == MapType.MT_PROBAB_OCTREE
            n = args[0]
            body = (
                np.loadtxt(f, dtype=np.int64, ndmin=2)
                if n
                else np.zeros((0, 3 + TILE), np.int64)
            )
            slot_block = body[:, :3].astype(np.int32)
            pool = body[:, 3:].astype(np.int8 if prob else np.uint8)
            m = PagedHierarchicalMap(dims, side, probabilistic=prob)
            if n:
                m._allocate(slot_block)
                if prob:
                    m.occ_pool = m.occ_pool.at[:n].set(jnp.asarray(pool))
                    m.pool = m.pool.at[:n].set(_status_from_occupancy(m.occ_pool[:n]))
                else:
                    m.pool = m.pool.at[:n].set(jnp.asarray(pool))
                m._rebuild_coarse()
            return m
        # dense body: kind == "shape", args are the 3 extents
        assert kind == "shape" and len(args) == 3
        shape = tuple(args)
        fine = np.loadtxt(f, dtype=np.int64, ndmin=2).reshape(shape)
    if map_type == MapType.MT_BITVECTOR_OCTREE:
        s0 = jnp.asarray(fine.astype(np.uint8))
        return HierarchicalBitMap(tuple(_build_pyramid(s0, levels)), dims, side, levels)
    occ_j = jnp.asarray(fine.astype(np.int8))
    pyr = tuple(_build_pyramid(_status_from_occupancy(occ_j), levels))
    return HierarchicalProbMap(occ_j, pyr, dims, side, levels)


def read_hierarchical_map(path):
    import jax.numpy as jnp

    from ..maps.hierarchical import (
        HierarchicalBitMap,
        HierarchicalProbMap,
        _build_pyramid,
        _status_from_occupancy,
    )

    with open(path, "rb") as f:
        if f.read(len(_ASCII_MAGIC)) in _ASCII_MAGICS:
            return _read_octree_ascii(path)
        f.seek(0)
        header = np.frombuffer(f.read(_HEADER.itemsize), dtype=_HEADER)[0]
        levels = int(np.frombuffer(f.read(4), "<i4")[0])
        if levels < 0:  # sparse paged body (write_paged_map)
            from ..maps.paged import TILE, PagedHierarchicalMap

            prob = MapType(int(header["map_type"])) == MapType.MT_PROBAB_OCTREE
            n = int(np.frombuffer(f.read(4), "<i4")[0])
            slot_block = np.frombuffer(f.read(n * 12), "<i4").reshape(n, 3)
            body = np.frombuffer(
                f.read(n * TILE), np.int8 if prob else np.uint8
            ).reshape(n, TILE)
            m = PagedHierarchicalMap(
                tuple(int(v) for v in header["dims"]),
                float(header["side_length"]),
                probabilistic=prob,
            )
            if n:
                # allocating in slot order reproduces the original slot and
                # page numbering exactly
                m._allocate(slot_block)
                if prob:
                    m.occ_pool = m.occ_pool.at[:n].set(jnp.asarray(body))
                    m.pool = m.pool.at[:n].set(_status_from_occupancy(m.occ_pool[:n]))
                else:
                    m.pool = m.pool.at[:n].set(jnp.asarray(body))
                m._rebuild_coarse()
            return m
        shape = tuple(np.frombuffer(f.read(12), "<i4"))
        raw = f.read()
    map_type = MapType(int(header["map_type"]))
    dims = tuple(int(v) for v in header["dims"])
    side = float(header["side_length"])
    if map_type == MapType.MT_BITVECTOR_OCTREE:
        s0 = jnp.asarray(np.frombuffer(raw, np.uint8).reshape(shape))
        pyr = tuple(_build_pyramid(s0, levels))
        return HierarchicalBitMap(pyr, dims, side, levels)
    occ_j = jnp.asarray(np.frombuffer(raw, np.int8).reshape(shape))
    pyr = tuple(_build_pyramid(_status_from_occupancy(occ_j), levels))
    return HierarchicalProbMap(occ_j, pyr, dims, side, levels)


def write_voxel_list(lst, path) -> None:
    from ..maps.voxellist import KIND_BIT

    n = int(lst.count)
    if lst.id_mode == "morton":
        # the reference's MortonVoxelList ids are uint64 (morton_code60):
        # recombine the (hi30, lo30) pair on the host
        hi = np.asarray(lst.ids_hi[:n]).astype("<u8")
        lo = np.asarray(lst.ids[:n]).astype("<u8")
        ids = ((hi << 30) | lo).astype("<u8")
    else:
        ids = np.asarray(lst.ids[:n]).astype("<u4")
    coords = np.asarray(
        lst.coords_from_ids(lst.ids[:n], lst.ids_hi[:n])
    ).astype("<u4")
    with open(path, "wb") as f:
        f.write(np.int32(int(lst.map_type)).tobytes())
        f.write(np.asarray(lst.dims, "<u4").tobytes())
        f.write(np.float32(lst.side_length).tobytes())
        f.write(np.uint32(n).tobytes())
        f.write(ids.tobytes())
        f.write(coords.tobytes())
        if lst.kind == KIND_BIT:
            _write_planes_body(f, np.asarray(lst.payload[:, :n]))
        else:
            np.asarray(lst.payload[:n], np.int8).tofile(f)


def read_voxel_list(path):
    import jax.numpy as jnp

    from ..maps.voxellist import KIND_BIT, KIND_COUNT, KIND_PROB, VoxelList

    with open(path, "rb") as f:
        map_type = MapType(int(np.frombuffer(f.read(4), "<i4")[0]))
        dims = tuple(int(v) for v in np.frombuffer(f.read(12), "<u4"))
        side = float(np.frombuffer(f.read(4), "<f4")[0])
        n = int(np.frombuffer(f.read(4), "<u4")[0])
        morton_ids = map_type in (
            MapType.MT_BITVECTOR_MORTON_VOXELLIST,
            MapType.MT_PROBAB_MORTON_VOXELLIST,
        )
        if morton_ids:
            ids64 = np.frombuffer(f.read(8 * n), "<u8")
            ids = (ids64 & np.uint64((1 << 30) - 1)).astype("<u4")
            ids_hi = (ids64 >> np.uint64(30)).astype("<u4")
        else:
            ids = np.frombuffer(f.read(4 * n), "<u4")
            ids_hi = np.zeros(n, "<u4")
        _coords = np.frombuffer(f.read(12 * n), "<u4").reshape(n, 3)
        kind = {
            MapType.MT_BITVECTOR_VOXELLIST: KIND_BIT,
            MapType.MT_BITVECTOR_MORTON_VOXELLIST: KIND_BIT,
            MapType.MT_PROBAB_VOXELLIST: KIND_PROB,
            MapType.MT_PROBAB_MORTON_VOXELLIST: KIND_PROB,
            MapType.MT_COUNTING_VOXELLIST: KIND_COUNT,
        }[map_type]
        if kind == KIND_BIT:
            payload_np = _read_planes_body(f, n) if n else np.zeros((8, 0), "<u4")
        else:
            payload_np = np.frombuffer(f.read(n), np.int8, n)
    id_mode = "morton" if map_type in (
        MapType.MT_BITVECTOR_MORTON_VOXELLIST,
        MapType.MT_PROBAB_MORTON_VOXELLIST,
    ) else "linear"
    lst = VoxelList.create(dims, side, kind, n, id_mode, map_type)
    if n == 0:
        return lst
    payload = jnp.asarray(payload_np)
    from dataclasses import replace

    return replace(
        lst,
        ids=jnp.asarray(ids),
        ids_hi=jnp.asarray(ids_hi),
        payload=payload,
        count=jnp.int32(n),
    )


def write_map(m, path) -> None:
    """Single-map writeToDisk dispatch (GpuVoxelsMap.h:200-204): every map
    type serializes to its reference binary format."""
    from ..maps.hierarchical import _PyramidQueries
    from ..maps.paged import PagedHierarchicalMap
    from ..maps.voxellist import VoxelList
    from ..parallel.paged_world import ShardedPagedWorld

    if isinstance(m, VoxelList):
        write_voxel_list(m, path)
    elif isinstance(m, ShardedPagedWorld):
        # gathered to the single-device layout: same bytes either way
        write_paged_map(m.to_paged_map(), path)
    elif isinstance(m, PagedHierarchicalMap):
        write_paged_map(m, path)
    elif isinstance(m, _PyramidQueries):
        write_hierarchical_map(m, path)
    else:
        write_voxel_map(m, path)


def read_map(path):
    """Single-map readFromDisk dispatch on the file's MapType header
    (GpuVoxelsMap.h:205-209). Returns the loaded map instance."""
    with open(path, "rb") as f:
        map_type = MapType(int(np.frombuffer(f.read(4), "<i4")[0]))
    if map_type in (MapType.MT_PROBAB_OCTREE, MapType.MT_BITVECTOR_OCTREE):
        return read_hierarchical_map(path)
    if map_type in (
        MapType.MT_BITVECTOR_VOXELLIST,
        MapType.MT_BITVECTOR_MORTON_VOXELLIST,
        MapType.MT_PROBAB_VOXELLIST,
        MapType.MT_PROBAB_MORTON_VOXELLIST,
        MapType.MT_COUNTING_VOXELLIST,
    ):
        return read_voxel_list(path)
    return read_voxel_map(path)


class DiskIO:
    """writeToDisk/readFromDisk map contract (GpuVoxelsMap.h:200-209),
    mixed into every map tier. Immutable pytree maps cannot refill in
    place, so read_from_disk returns the loaded instance (the repo-wide
    operations-return-new-instances convention); a MapType mismatch raises
    where the reference logs and returns false."""

    def write_to_disk(self, path) -> bool:
        write_map(self, path)
        return True

    def read_from_disk(self, path):
        m = read_map(path)
        if int(m.map_type) != int(self.map_type):
            raise ValueError(
                f"file holds {MapType(int(m.map_type)).name}, "
                f"map is {MapType(int(self.map_type)).name}"
            )
        return m
