"""BitVector<256> semantics tests (mirrors reference test/testing_bitvector.cu)."""
import numpy as np
import jax.numpy as jnp
import pytest

from gpu_voxels_jax import bitops
from gpu_voxels_jax.constants import BitVoxelMeaning, SV_START


def np_bytes_from_planes(planes):
    """uint32[8] -> uint8[32] little-endian (reference byte layout)."""
    return np.frombuffer(np.asarray(planes, dtype="<u4").tobytes(), dtype=np.uint8)


def planes_from_bits(bit_indices, shape_suffix=()):
    v = bitops.zeros(shape_suffix)
    for b in bit_indices:
        v = bitops.set_bit(v, b)
    return v


def test_set_get_clear_bit():
    v = bitops.zeros(())
    for b in [0, 1, 31, 32, 63, 100, 255]:
        v = bitops.set_bit(v, b)
        assert bool(bitops.get_bit(v, b))
    v = bitops.clear_bit(v, 100)
    assert not bool(bitops.get_bit(v, 100))
    assert bool(bitops.get_bit(v, 63))


def test_none_but_empty_ignores_free_bit():
    v = planes_from_bits([int(BitVoxelMeaning.eBVM_FREE)])
    assert bool(bitops.none_but_empty(v))
    assert not bool(bitops.is_zero(v))
    v2 = planes_from_bits([0, 7])
    assert not bool(bitops.none_but_empty(v2))
    v3 = planes_from_bits([200])
    assert not bool(bitops.none_but_empty(v3))


def test_bitwise_ops_and_equality():
    a = planes_from_bits([1, 40, 250])
    b = planes_from_bits([40, 99])
    ored = bitops.bv_or(a, b)
    for bit in [1, 40, 99, 250]:
        assert bool(bitops.get_bit(ored, bit))
    anded = bitops.bv_and(a, b)
    assert bool(bitops.get_bit(anded, 40))
    assert not bool(bitops.get_bit(anded, 1))
    assert bool(bitops.bv_equal(a, a))
    assert not bool(bitops.bv_equal(a, b))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    planes = jnp.asarray(rng.integers(0, 2**32, size=(8, 5), dtype=np.uint64).astype(np.uint32))
    bits = bitops.unpack(planes)
    assert bits.shape == (5, 256)
    repacked = bitops.pack(bits)
    np.testing.assert_array_equal(np.asarray(repacked), np.asarray(planes))


@pytest.mark.parametrize("shift", [1, 4, 8, 13, 32, 37, 56])
def test_perform_left_shift_semantics(shift):
    """bit b of result == bit (b+shift) of input; low nibble cleared."""
    rng = np.random.default_rng(shift)
    words = rng.integers(0, 2**32, size=(8, 3), dtype=np.uint64).astype(np.uint32)
    planes = jnp.asarray(words)
    out = bitops.perform_left_shift(planes, shift)
    in_bits = np.asarray(bitops.unpack(planes))
    out_bits = np.asarray(bitops.unpack(out))
    expected = np.zeros_like(in_bits)
    expected[..., : 256 - shift] = in_bits[..., shift:]
    expected[..., 0:4] = False  # byte0 & 0b11110000
    np.testing.assert_array_equal(out_bits, expected)


def test_perform_left_shift_swept_volume_usage():
    """A swept-volume ID at bit SV_START+k moves to SV_START+k-s."""
    v = planes_from_bits([SV_START + 10])
    out = bitops.perform_left_shift(v, 3)
    assert bool(bitops.get_bit(out, SV_START + 7))
    assert not bool(bitops.get_bit(out, SV_START + 10))


@pytest.mark.parametrize("margin,sv_offset", [(0, 0), (1, 0), (2, 0), (5, 0), (2, 3), (2, 8), (3, 12), (1, 37)])
def test_bit_margin_collision_check_matches_reference_oracle(margin, sv_offset):
    rng = np.random.default_rng(margin * 101 + sv_offset)
    n = 16
    v1 = rng.integers(0, 2**32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    v2 = rng.integers(0, 2**32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    # make them sparse so both hit and miss cases occur
    v1 &= rng.integers(0, 2**32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    v1 &= rng.integers(0, 2**32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    v2 &= rng.integers(0, 2**32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    v2 &= rng.integers(0, 2**32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    coll0 = rng.integers(0, 2**32, size=(8, n), dtype=np.uint64).astype(np.uint32)

    hit, coll = bitops.bit_margin_collision_check(
        jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(coll0), margin, sv_offset
    )
    hit = np.asarray(hit)
    coll = np.asarray(coll)
    for i in range(n):
        exp_hit, exp_coll_bytes = bitops.bit_margin_collision_check_np(
            np_bytes_from_planes(v1[:, i]),
            np_bytes_from_planes(v2[:, i]),
            np_bytes_from_planes(coll0[:, i]),
            margin,
            sv_offset,
        )
        got_bytes = np_bytes_from_planes(coll[:, i])
        np.testing.assert_array_equal(got_bytes, exp_coll_bytes, err_msg=f"voxel {i}")
        assert bool(hit[i]) == bool(exp_hit)


@pytest.mark.parametrize("margin", [0, 1, 2, 5, 20, 24])
def test_packed_margin_check_matches_unpacked(margin):
    rng = np.random.default_rng(margin)
    n = 64
    mk = lambda: jnp.asarray(
        (rng.integers(0, 2**32, (8, n), dtype=np.uint64)
         & rng.integers(0, 2**32, (8, n), dtype=np.uint64)
         & rng.integers(0, 2**32, (8, n), dtype=np.uint64)).astype(np.uint32)
    )
    v1, v2 = mk(), mk()
    hit_p, coll_p = bitops.bit_margin_collision_check_packed(v1, v2, margin)
    hit_u, coll_u = bitops.bit_margin_collision_check(
        v1, v2, bitops.zeros((n,)), margin, 0
    )
    np.testing.assert_array_equal(np.asarray(coll_p), np.asarray(coll_u))
    np.testing.assert_array_equal(np.asarray(hit_p), np.asarray(hit_u))


def test_or_reduce():
    a = planes_from_bits([3], shape_suffix=(4,))
    b = bitops.set_bit(bitops.zeros((4,)), 77)
    stacked = a | b
    red = bitops.or_reduce(stacked, axis=0)
    assert bool(bitops.get_bit(red, 3)) and bool(bitops.get_bit(red, 77))


@pytest.mark.parametrize("case", range(12))
def test_bit_margin_fuzz_vs_byte_oracle(case):
    """Broader fuzz of the margin check against the byte-level reference
    transcription (margins and offsets across the supported envelope)."""
    rng = np.random.default_rng(1000 + case)
    margin = int(rng.integers(0, 7))
    sv_offset = int(rng.integers(0, 60))
    if (sv_offset // 8) + margin > 24:
        sv_offset = 8 * (24 - margin)
    n = 8
    mk = lambda: (rng.integers(0, 2**32, (8, n), dtype=np.uint64)
                  & rng.integers(0, 2**32, (8, n), dtype=np.uint64)).astype(np.uint32)
    v1, v2, coll0 = mk(), mk(), mk()
    hit, coll = bitops.bit_margin_collision_check(
        jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(coll0), margin, sv_offset
    )
    for i in range(n):
        exp_hit, exp_bytes = bitops.bit_margin_collision_check_np(
            np_bytes_from_planes(v1[:, i]),
            np_bytes_from_planes(v2[:, i]),
            np_bytes_from_planes(coll0[:, i]),
            margin,
            sv_offset,
        )
        np.testing.assert_array_equal(
            np_bytes_from_planes(np.asarray(coll)[:, i]), exp_bytes,
            err_msg=f"case {case} margin {margin} sv {sv_offset} voxel {i}",
        )
        assert bool(np.asarray(hit)[i]) == bool(exp_hit)


def test_packed_full_margin_check_entire_domain():
    """bit_margin_collision_check_packed_full must match the byte-level
    reference oracle over the FULL domain (any margin < 32, any sv_offset),
    including the uint64-buffer truncation the reference exhibits for
    margin + sv_offset//8 > 24 (BitVector.h:415-471)."""
    import numpy as np
    import jax.numpy as jnp
    from gpu_voxels_jax import bitops

    rng = np.random.default_rng(42)

    def to_planes(b):
        return jnp.asarray(np.frombuffer(b.tobytes(), np.uint32).copy()).reshape(8, 1)

    def to_bytes(p):
        return np.frombuffer(np.asarray(p[:, 0]).tobytes(), np.uint8)

    for margin in [0, 2, 5, 24, 25, 28, 31]:
        for sv_offset in [0, 3, 4, 7, 8, 12, 16, 31, 40, 56]:
            v1 = rng.integers(0, 256, 32, dtype=np.uint8)
            v2 = rng.integers(0, 256, 32, dtype=np.uint8)
            c0 = rng.integers(0, 256, 32, dtype=np.uint8)
            _, expect = bitops.bit_margin_collision_check_np(v1, v2, c0, margin, sv_offset)
            _, got = bitops.bit_margin_collision_check_packed_full(
                to_planes(v1), to_planes(v2), to_planes(c0), margin, sv_offset
            )
            np.testing.assert_array_equal(
                to_bytes(got), expect, err_msg=f"margin={margin} sv_offset={sv_offset}"
            )


def test_packed_fastpath_delegates_beyond_24():
    """margin > 24 on the sv_offset==0 fast path must reproduce the
    reference's buffer truncation instead of raising."""
    import numpy as np
    import jax.numpy as jnp
    from gpu_voxels_jax import bitops

    rng = np.random.default_rng(7)
    v1 = rng.integers(0, 256, 32, dtype=np.uint8)
    v2 = rng.integers(0, 256, 32, dtype=np.uint8)
    zero = np.zeros(32, np.uint8)

    def to_planes(b):
        return jnp.asarray(np.frombuffer(b.tobytes(), np.uint32).copy()).reshape(8, 1)

    any_np, _ = bitops.bit_margin_collision_check_np(v1, v2, zero, 28, 0)
    any_packed, _ = bitops.bit_margin_collision_check_packed(to_planes(v1), to_planes(v2), 28)
    assert bool(any_packed[0]) == bool(any_np)


@pytest.mark.parametrize("margin", range(9))
def test_collide_types_matches_byte_oracle(margin):
    """collideWithTypes bit x bit (count, colliding-meanings OR, eBVM_COLLISION
    marking) equals the byte-level BitVector.h:415-471 oracle per voxel."""
    from gpu_voxels_jax.ops import collide

    rng = np.random.default_rng(100 + margin)
    n = 96
    v1 = rng.integers(0, 256, (n, 32), dtype=np.uint8) * (rng.random((n, 1)) < 0.5)
    v2 = rng.integers(0, 256, (n, 32), dtype=np.uint8) * (rng.random((n, 1)) < 0.5)
    v1, v2 = v1.astype(np.uint8), v2.astype(np.uint8)

    def planes(v):
        return jnp.asarray((v.reshape(n, 8, 4).astype(np.uint32)
                            @ (256 ** np.arange(4)).astype(np.uint32)).T)

    hits, recs = [], []
    for i in range(n):
        h, rec = bitops.bit_margin_collision_check_np(v1[i], v2[i], np.zeros(32, np.uint8), margin, 0)
        hits.append(bool(h))
        recs.append(rec if h else np.zeros(32, np.uint8))
    hits = np.asarray(hits)
    want_meanings = np.bitwise_or.reduce(np.stack(recs), axis=0)
    cnt, meanings, marked = collide.collide_with_types_bit_bit(planes(v1), planes(v2), margin)
    assert int(cnt) == int(hits.sum())
    got_bytes = np.asarray(meanings).astype("<u4").view(np.uint8)
    np.testing.assert_array_equal(got_bytes, want_meanings)
    want_p0 = np.asarray(planes(v1))[0] | np.where(hits, np.uint32(4), np.uint32(0))
    np.testing.assert_array_equal(np.asarray(marked)[0], want_p0)
