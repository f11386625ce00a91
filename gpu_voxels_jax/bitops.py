"""256-bit voxel bit-vector operations on packed uint32 planes.

A BitVector<256> (reference: helpers/BitVector.h) is represented as 8 uint32
"planes" along a leading axis: ``planes[p]`` holds bits ``[32*p, 32*p+32)``.
Plane-major layout keeps the (large) voxel axis contiguous so every
operation below vectorizes on the VPU; nothing here ever leaves the device.

All functions are shape-polymorphic over trailing axes: inputs are
``uint32[8, ...]`` and operate elementwise per voxel.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .constants import NUM_BIT_PLANES, SV_END, SV_START

UINT32 = jnp.uint32


def zeros(shape_suffix, dtype=UINT32):
    """An all-clear bit vector array of shape [8, *shape_suffix]."""
    return jnp.zeros((NUM_BIT_PLANES,) + tuple(shape_suffix), dtype=dtype)


def bit_plane(meaning: int) -> int:
    return int(meaning) >> 5


def bit_word(meaning: int) -> int:
    """uint32 word with only the bit for `meaning` set (within its plane)."""
    return 1 << (int(meaning) & 31)


def set_bit(planes: jnp.ndarray, meaning: int) -> jnp.ndarray:
    """BitVector::setBit for every voxel (BitVector.h:222-228)."""
    p = bit_plane(meaning)
    return planes.at[p].set(planes[p] | UINT32(bit_word(meaning)))


def clear_bit(planes: jnp.ndarray, meaning: int) -> jnp.ndarray:
    p = bit_plane(meaning)
    return planes.at[p].set(planes[p] & UINT32(~bit_word(meaning) & 0xFFFFFFFF))


def get_bit(planes: jnp.ndarray, meaning: int) -> jnp.ndarray:
    p = bit_plane(meaning)
    return (planes[p] & UINT32(bit_word(meaning))) != 0


def is_zero(planes: jnp.ndarray) -> jnp.ndarray:
    """BitVector::isZero (BitVector.h:162-172)."""
    return jnp.all(planes == 0, axis=0)


def masked_fold(planes: jnp.ndarray) -> jnp.ndarray:
    """OR of every meaning bit except eBVM_FREE (plane-0 bit 0) — the
    single-sweep core of noneButEmpty (BitVector.h:184-198; the reference
    masks byte 0 with 254).

    Formulated as ONE broadcast-masked OR-reduce over the plane axis: the
    per-plane bit-0 mask rides the reduce input, so XLA fuses the whole
    fold into a single sweep. The earlier `planes[0] & m | reduce(planes[1:])`
    form materialized the planes[1:] slice as a copy of 7/8 of the map.
    """
    nplanes = planes.shape[0]
    mask = jnp.asarray(
        [0xFFFFFFFE] + [0xFFFFFFFF] * (nplanes - 1), jnp.uint32
    ).reshape((nplanes,) + (1,) * (planes.ndim - 1))
    return jnp.bitwise_or.reduce(planes & mask, axis=0)


def nonzero_u32(v: jnp.ndarray) -> jnp.ndarray:
    """uint32 0/1 of (v != 0) computed arithmetically (or/neg/shift): keeps
    count reductions on the integer path."""
    return (v | (jnp.uint32(0) - v)) >> jnp.uint32(31)


def none_but_empty(planes: jnp.ndarray) -> jnp.ndarray:
    """True if no bit except eBVM_FREE (bit 0) is set (BitVector.h:184-198)."""
    return masked_fold(planes) == 0


def occupied(planes: jnp.ndarray) -> jnp.ndarray:
    """Dense-collide occupancy: !noneButEmpty (DefaultCollider.hpp:76-81)."""
    return masked_fold(planes) != 0


def bv_or(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return a | b


def bv_and(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return a & b


def bv_not(a: jnp.ndarray) -> jnp.ndarray:
    return ~a


def bv_equal(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=0)


def or_reduce(planes: jnp.ndarray, axis: int) -> jnp.ndarray:
    """OR-reduce bit vectors over a voxel axis (thrust BitvectorOr reduce).

    `axis` indexes into the trailing (voxel) axes, i.e. axis=0 reduces the
    first axis after the plane axis.
    """
    return jnp.bitwise_or.reduce(planes, axis=axis + 1)


def or_reduce_words_spmd(x: jnp.ndarray) -> jnp.ndarray:
    """Bitwise-OR reduction over the LAST axis that stays legal on sharded
    inputs (first-class map sharding, parallel/shard_value.py).

    A plain `jnp.bitwise_or.reduce` over an axis sharded across the mesh
    makes GSPMD emit `AllReduce(or: u32)`, which XLA's CPU backend (the
    virtual test mesh) does not implement. Instead: one LOCAL reshape-reduce
    over an unsharded minor axis collapses N to a 256-row partial (one pass
    over the data, same cost as before), then a log-step halving OR over
    those 256 rows — tiny elementwise slices whose resharding uses plain
    collective-permute/gather. Single-device lowering is unchanged in cost.
    """
    n = x.shape[-1]
    k = 256  # >= any mesh axis; 256/nz whole rows per shard keeps stage 1 local
    if n >= 2 * k:
        pad = (-n) % k
        if pad:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        x = x.reshape(x.shape[:-1] + (k, (n + pad) // k))
        x = jnp.bitwise_or.reduce(x, axis=-1)
    m = x.shape[-1]
    p2 = 1 << (m - 1).bit_length()
    if p2 != m:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, p2 - m)])
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] | x[..., h:]
    return x[..., 0]


def perform_left_shift(planes: jnp.ndarray, shift_size: int) -> jnp.ndarray:
    """Shift every bit vector's bits toward lower indices by `shift_size`.

    Exact semantics of performLeftShift (BitVector.h:361-402): bit b of the
    result is bit (b + shift_size) of the input (zeros shifted in at the top,
    shift limited to 56 by the reference's 64-bit buffer), then bits 0..3 of
    byte 0 are cleared so only swept-volume meanings survive in the low byte.
    """
    if not (0 <= shift_size <= 56):
        raise ValueError("shift size must be in [0, 56] (BitVector.h:361)")
    q, r = divmod(int(shift_size), 32)
    out = []
    nplanes = planes.shape[0]
    zero = jnp.zeros_like(planes[0])
    for p in range(nplanes):
        lo = planes[p + q] if (p + q) < nplanes else zero
        if r == 0:
            word = lo
        else:
            hi = planes[p + q + 1] if (p + q + 1) < nplanes else zero
            word = (lo >> UINT32(r)) | (hi << UINT32(32 - r))
        out.append(word)
    out[0] = out[0] & UINT32(0xFFFFFFF0)  # mask byte 0 with 0b11110000
    return jnp.stack(out, axis=0)


def shift_bits(planes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Whole-vector bit shift: result bit b = input bit (b + k), zero fill.

    Positive k shifts toward lower indices. No masking (unlike
    perform_left_shift, which clears the non-SV nibble).
    """
    k = int(k)
    if k == 0:
        return planes
    nplanes = planes.shape[0]
    zero = jnp.zeros_like(planes[0])
    out = []
    if k > 0:
        q, r = divmod(k, 32)
        for p in range(nplanes):
            lo = planes[p + q] if (p + q) < nplanes else zero
            if r == 0:
                word = lo
            else:
                hi = planes[p + q + 1] if (p + q + 1) < nplanes else zero
                word = (lo >> UINT32(r)) | (hi << UINT32(32 - r))
            out.append(word)
    else:
        q, r = divmod(-k, 32)
        for p in range(nplanes):
            hi = planes[p - q] if (p - q) >= 0 else zero
            if r == 0:
                word = hi
            else:
                lo = planes[p - q - 1] if (p - q - 1) >= 0 else zero
                word = (hi << UINT32(r)) | (lo >> UINT32(32 - r))
            out.append(word)
    return jnp.stack(out, axis=0)


def bit_margin_collision_check_packed(
    v1: jnp.ndarray, v2: jnp.ndarray, margin: int
):
    """Fast packed bitMarginCollisionCheck for sv_offset == 0.

    Equivalent to bit_margin_collision_check(..., sv_offset=0) but without
    unpacking to bools: collisions = v1 & OR_{s in [-margin, margin]}
    shift_bits(v2 & ~0xF, s). Verified equivalent in tests.
    """
    if margin > 24:
        # beyond 24 the reference's 64-bit sliding buffer drops matches for
        # high in-byte bit positions; the full-domain path reproduces that
        _, collisions = bit_margin_collision_check_packed_full(
            v1, v2, zeros(v1.shape[1:]), margin, 0
        )
        return ~is_zero(collisions), collisions
    v2m = v2.at[0].set(v2[0] & UINT32(0xFFFFFFF0))  # mask non-SV nibble
    # one OR over 2*margin+1 shifts of v2m: XLA fuses it into a single pass
    # (a doubling chain of dependent shifts measured slower on the GPU)
    window = v2m
    for s in range(1, margin + 1):
        window = window | shift_bits(v2m, s) | shift_bits(v2m, -s)
    collisions = v1 & window
    return ~is_zero(collisions), collisions


def _bitpos_mask(predicate) -> np.ndarray:
    """uint32[8] constant with bit b set iff predicate(b)."""
    words = np.zeros(NUM_BIT_PLANES, np.uint32)
    for b in range(NUM_BIT_PLANES * 32):
        if predicate(b):
            words[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    return words


def bit_margin_collision_check_packed_full(
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    collisions: jnp.ndarray,
    margin: int,
    sv_offset: int,
):
    """Packed bitMarginCollisionCheck (BitVector.h:415-471) over the full
    reference domain: any margin < 32, any sv_offset — never unpacks to
    bool[..., 256], so it is safe on dense 512^3 grids.

    Faithful to every 64-bit-buffer quirk of the reference:
      * v1 byte B is buffered at bit p = 32 - margin + sv_offset//8; window
        shift s matches v2 at buffer position p + s + j (j = in-byte bit).
        Positions > 63 overflow the uint64 and the match is DROPPED — that is
        exactly "j > 31 + margin - sv_offset//8 - s", a per-s constant mask.
      * the 4 initially buffered v2 bytes sit one byte higher than refilled
        ones when the scan starts at byte 1 (sv_offset%8 >= 4), and v2 byte 4
        then never enters the buffer (regions A/B with shifts DA/DB).
      * records land at bit + sv_offset//8, truncated to the byte; only bytes
        touched by the scan overwrite `collisions`.

    Returns (any_collision bool[...], collisions uint32[8, ...]).
    """
    if margin >= 32:
        raise ValueError("margin must be < 32 (BitVector.h:428-432)")
    sv_offset = int(sv_offset)
    byte_off = sv_offset % 8
    bit_off = sv_offset // 8
    first_bit = SV_START + byte_off
    first_byte = first_bit >> 3

    v2m = v2.at[0].set(v2[0] & UINT32(0xFFFFFFF0))  # mask non-SV nibble
    nbits = NUM_BIT_PLANES * 32
    shape = (NUM_BIT_PLANES,) + (1,) * (v1.ndim - 1)
    region_a = jnp.asarray(_bitpos_mask(lambda b: b < 32)).reshape(shape)
    region_b = jnp.asarray(
        _bitpos_mask(lambda b: b >= 8 * (4 + first_byte))
    ).reshape(shape)
    v2a = v2m & region_a
    v2b = v2m & region_b
    DA = bit_off - margin - 8 * first_byte
    DB = bit_off - margin

    matched = jnp.zeros_like(v1)
    for s in range(2 * margin + 1):
        j_max = 31 + margin - bit_off - s  # uint64 overflow cutoff
        if j_max < 0:
            continue
        win = shift_bits(v2a, DA + s) | shift_bits(v2b, DB + s)
        hit = v1 & win
        if j_max < 7:
            jm = jnp.asarray(_bitpos_mask(lambda b: (b & 7) <= j_max)).reshape(shape)
            hit = hit & jm
        matched = matched | hit

    # record at bit + bit_off, only if it stays inside the bit's byte
    stays = jnp.asarray(_bitpos_mask(lambda b: (b & 7) + bit_off < 8)).reshape(shape)
    recorded = shift_bits(matched & stays, -bit_off)
    written_bytes = {i >> 3 for i in range(first_bit, SV_END, 8)}
    written = jnp.asarray(
        _bitpos_mask(lambda b: (b >> 3) in written_bytes)
    ).reshape(shape)
    out = (recorded & written) | (collisions & ~written)
    return ~is_zero(out), out


# ---------------------------------------------------------------------------
# Unpacked (bool) representation: used by the margin collision check, whose
# byte-level quirks are easiest to reproduce exactly on an unpacked axis.
# ---------------------------------------------------------------------------

def unpack(planes: jnp.ndarray) -> jnp.ndarray:
    """uint32[8, ...] -> bool[..., 256] (bit index along the last axis)."""
    nplanes = planes.shape[0]
    # [8, ...] -> [..., 8]
    moved = jnp.moveaxis(planes, 0, -1)
    shifts = jnp.arange(32, dtype=UINT32)
    bits = (moved[..., :, None] >> shifts) & UINT32(1)  # [..., 8, 32]
    return bits.reshape(moved.shape[:-1] + (nplanes * 32,)).astype(bool)


def pack(bits: jnp.ndarray) -> jnp.ndarray:
    """bool[..., 256] -> uint32[8, ...]."""
    n = bits.shape[-1]
    nplanes = n // 32
    words = bits.reshape(bits.shape[:-1] + (nplanes, 32)).astype(UINT32)
    shifts = jnp.arange(32, dtype=UINT32)
    packed = jnp.sum(words << shifts, axis=-1, dtype=UINT32)  # [..., 8]
    return jnp.moveaxis(packed, -1, 0)


def bit_margin_collision_check(
    v1: jnp.ndarray,
    v2: jnp.ndarray,
    collisions: jnp.ndarray,
    margin: int,
    sv_offset: int,
):
    """Swept-volume windowed collision check (BitVector.h:415-471), vectorized.

    Replicates the reference algorithm exactly, including its byte-level
    quirks:
      * v2's bits 0..3 are masked out before the check;
      * v1 bytes are scanned starting at bit (4 + sv_offset%8) stepping by 8,
        i.e. starting at byte (4 + sv_offset%8)//8 and covering each byte once
        up to bit eBVM_SWEPT_VOLUME_END;
      * a v1 bit at position b collides with v2 bits in a window
        [b + D, b + D + 2*margin]; the shift D differs between the 4 initially
        buffered v2 bytes and later refilled ones. When the scan starts at
        byte 1 (sv_offset%8 >= 4), the reference's refill index skips v2
        byte 4 entirely and refilled bytes land one byte lower in the buffer:
        D = sv_offset//8 - margin - 8 for v2 bits 0..31 and
        D = sv_offset//8 - margin for v2 bits >= 40 (byte 4 never matched).
        For scans starting at byte 0 both regions share
        D = sv_offset//8 - margin. (The reference uses sv_offset//8 as a
        *bit* shift; we reproduce that quirk.)
      * the colliding-bit record is written at position b + sv_offset//8 but
        only if it stays inside b's byte (uint8 truncation in the reference);
      * bytes in the scanned range of `collisions` are overwritten, others keep
        their previous value.

    Args:
      v1, v2: uint32[8, ...] bit vectors.
      collisions: uint32[8, ...] aggregate (bytes in range get overwritten).
      margin: window half-width in bits (< 32).
      sv_offset: bit offset added to v1 before colliding.
    Returns:
      (any_collision: bool[...], collisions_out: uint32[8, ...])
    """
    if margin >= 32:
        raise ValueError("margin must be < 32 (BitVector.h:428-432)")
    sv_offset = int(sv_offset)
    byte_off = sv_offset % 8  # loop start offset (in bits, reference quirk)
    bit_off = sv_offset // 8  # in-byte output shift (reference quirk)
    if bit_off + margin > 24:
        # Beyond this the reference's 64-bit buffer cannot hold the window and
        # results depend on refill timing; not reproduced.
        raise ValueError("sv_offset//8 + margin must be <= 24")

    b1 = unpack(v1)  # [..., 256]
    b2 = unpack(v2)
    nbits = b1.shape[-1]
    # Mask non-SV bits of v2's first byte (bits 0..4).
    mask2 = np.ones(nbits, dtype=bool)
    mask2[0:4] = False
    b2 = b2 & jnp.asarray(mask2)

    first_bit = SV_START + byte_off
    first_byte = first_bit >> 3
    # Region A: the 4 initially buffered v2 bytes. Region B: refilled bytes
    # (v2 byte 4+first_byte onward; byte 4 is skipped when first_byte == 1).
    region_a = np.zeros(nbits, dtype=bool)
    region_a[0:32] = True
    region_b = np.zeros(nbits, dtype=bool)
    region_b[8 * (4 + first_byte):] = True
    DA = bit_off - margin - 8 * first_byte
    DB = bit_off - margin

    def shifted(arr, k):
        # arr shifted so result[b] = arr[b + k] (zeros outside)
        if k == 0:
            return arr
        pad = [(0, 0)] * (arr.ndim - 1)
        if k > 0:
            return jnp.pad(arr[..., k:], pad + [(0, k)])
        return jnp.pad(arr[..., :k], pad + [(-k, 0)])

    b2a = b2 & jnp.asarray(region_a)
    b2b = b2 & jnp.asarray(region_b)
    window = jnp.zeros_like(b2)
    for s in range(2 * margin + 1):
        window = window | shifted(b2a, DA + s) | shifted(b2b, DB + s)
    matched = b1 & window  # [..., 256] at v1 bit positions

    # Record at position b + bit_off, only if it stays within b's byte.
    bitpos = np.arange(nbits)
    stays = (bitpos % 8) + bit_off < 8
    recorded = shifted(matched & jnp.asarray(stays), -bit_off)

    # Bytes written by the loop: byte(i>>3) for i in range(first_bit, SV_END, 8)
    written = np.zeros(nbits, dtype=bool)
    for i in range(first_bit, SV_END, 8):
        byte = i >> 3
        written[byte * 8 : byte * 8 + 8] = True
    cbits = unpack(collisions)
    cbits = jnp.where(jnp.asarray(written), recorded, cbits)
    out = pack(cbits)
    return ~is_zero(out), out


def bit_margin_collision_check_np(v1_bytes, v2_bytes, coll_bytes, margin, sv_offset):
    """Byte-level numpy oracle replicating BitVector.h:415-471 verbatim.

    Operates on uint8[32] arrays (single voxel). Used only by tests to verify
    the vectorized implementation against the reference algorithm.
    """
    v1_bytes = np.asarray(v1_bytes, dtype=np.uint8)
    v2_bytes = np.asarray(v2_bytes, dtype=np.uint8)
    coll = np.array(coll_bytes, dtype=np.uint8, copy=True)
    num_bits = 8 * len(v1_bytes)
    buffer_half = 32
    buf = np.uint64(0)
    for byte_nr in range(4):
        ib = int(v2_bytes[byte_nr])
        if byte_nr == 0:
            ib &= 0b11110000
        buf = np.uint64(buf + (np.uint64(ib) << np.uint64(buffer_half + byte_nr * 8)))
    byte_offset = sv_offset % 8
    bit_offset = sv_offset // 8
    i = SV_START + byte_offset
    while i < SV_END:
        byte = 0
        m64 = (1 << 64) - 1  # C++ uint64 wraparound (shifts past bit 63 drop)
        byte_1 = np.uint64(
            (int(v1_bytes[i >> 3]) << (buffer_half - margin + bit_offset)) & m64
        )
        for _ in range(2 * margin + 1):
            shift_back = buffer_half - margin + (_)
            byte |= int((int(byte_1) & int(buf)) >> shift_back) & 0xFF
            byte_1 = np.uint64((int(byte_1) << 1) & m64)
        coll[i >> 3] = byte
        buf = np.uint64(int(buf) >> 8)
        if i < num_bits - buffer_half:
            buf = np.uint64(int(buf) + (int(v2_bytes[(i + buffer_half) >> 3]) << 56))
        i += 8
    return (coll != 0).any(), coll
