"""Dense map x dense map collision reductions (XLA formulation).

Equivalents of voxelmap/kernels/VoxelMapOperations.hpp:78-239
(kernelCollideVoxelMaps / ...Debug / ...Bitvector). The CUDA version does a
grid-stride sweep with shared-memory block reductions and finishes the sum on
the host; here each variant is a single fused element-wise compare + device
reduction with no host round trip, which XLA compiles to one streaming pass
on the GPU. They work for any grid size. The margin-window types collide
also has a one-pass Triton kernel (ops/collide_triton), chosen through
gpu_voxels_jax.backend.

Offset semantics replicate collisionCheckWithCounterRelativeTransform
(TemplateVoxelMap.hpp:486-519): the *left* map's base pointer is shifted by
the signed linear offset, i.e. collide(left[i+off], right[i]); indices where
either side is out of range contribute nothing.
"""
from __future__ import annotations

import jax.numpy as jnp

from .. import backend, bitops
from ..constants import MAX_PROBABILITY
from . import collide_triton
from .insert import linear_offset

INT32 = jnp.int32


def _types_kernel(n, margin, sv_offset, interpret=False) -> bool:
    """Whether a margin-window types collide runs the Triton kernel."""
    return collide_triton.supported(n, margin, sv_offset) and (
        interpret or backend.use_kernel()
    )


def _offset_slices(n: int, off: int):
    """Valid flat ranges for collide(left[i+off], right[i])."""
    off = int(off)
    if off >= 0:
        return slice(off, n), slice(0, n - off)
    return slice(0, n + off), slice(-off, n)


def _slice_flat(arr, sl):
    return arr[..., sl]  # works for [N] and [8, N]


def prob_occupied(data, threshold) -> jnp.ndarray:
    return data.astype(INT32) >= jnp.asarray(threshold, INT32)


def count_prob_prob(a, b, t1, t2, dims=None, offset=(0, 0, 0)) -> jnp.ndarray:
    """Counting collide, prob x prob (DefaultCollider thresholds)."""
    n = a.shape[-1]
    off = linear_offset(offset, dims) if dims else 0
    sa, sb = _offset_slices(n, off)
    hit = prob_occupied(a[sa], t1) & prob_occupied(b[sb], t2)
    return jnp.sum(hit, dtype=jnp.uint32)


def count_bit_bit(a_planes, b_planes, dims=None, offset=(0, 0, 0)) -> jnp.ndarray:
    """Counting collide, bit x bit: both !noneButEmpty (DefaultCollider.hpp:76-81).

    Two masked folds + an arithmetic 0/1 AND-count: one fused sweep over
    each map's planes."""
    n = a_planes.shape[-1]
    off = linear_offset(offset, dims) if dims else 0
    sa, sb = _offset_slices(n, off)
    fa = bitops.masked_fold(a_planes[:, sa])
    fb = bitops.masked_fold(b_planes[:, sb])
    return jnp.sum(bitops.nonzero_u32(fa) & bitops.nonzero_u32(fb), dtype=jnp.uint32)


def count_prob_bit(prob, t1, bit_planes, dims=None, offset=(0, 0, 0)) -> jnp.ndarray:
    """prob x bit: occupancy >= t && !noneButEmpty (DefaultCollider.hpp:60-73)."""
    n = prob.shape[-1]
    off = linear_offset(offset, dims) if dims else 0
    sa, sb = _offset_slices(n, off)
    hit = prob_occupied(prob[sa], t1) & bitops.occupied(bit_planes[:, sb])
    return jnp.sum(hit, dtype=jnp.uint32)


def count_occ_occ(occ_a, occ_b, dims=None, offset=(0, 0, 0)) -> jnp.ndarray:
    """Counting collide over maintained occupancy summaries (uint8[N] 0/1,
    kept coherent by every BitVectorVoxelMap mutation): plain bit x bit
    collision is exactly both-!noneButEmpty (DefaultCollider.hpp:76-81), so
    the summaries alone answer it — a 2N-byte sweep instead of the 64N-byte
    plane fold (~30x less HBM traffic)."""
    n = occ_a.shape[-1]
    off = linear_offset(offset, dims) if dims else 0
    sa, sb = _offset_slices(n, off)
    return jnp.sum(occ_a[sa] & occ_b[sb], dtype=jnp.uint32)


def count_prob_occ(prob, t1, occ_b, dims=None, offset=(0, 0, 0)) -> jnp.ndarray:
    """prob x bit through the bit side's occupancy summary (same contract as
    count_prob_bit; reads N bytes instead of the 32N-byte plane fold)."""
    n = prob.shape[-1]
    off = linear_offset(offset, dims) if dims else 0
    sa, sb = _offset_slices(n, off)
    hit = prob_occupied(prob[sa], t1) & (occ_b[sb] != 0)
    return jnp.sum(hit, dtype=jnp.uint32)


def any_collision(hit_count) -> jnp.ndarray:
    return hit_count > 0


def _shift3d(mask: jnp.ndarray, offset) -> jnp.ndarray:
    """Geometric offset: out[z,y,x] = mask[z+oz, y+oy, x+ox], False outside."""
    ox, oy, oz = (int(v) for v in offset)
    out = mask
    for axis, o in ((0, oz), (1, oy), (2, ox)):
        if o == 0:
            continue
        n = out.shape[axis]
        sl = [slice(None)] * 3
        pad = [(0, 0)] * 3
        if o > 0:
            sl[axis] = slice(min(o, n), n)
            pad[axis] = (0, min(o, n))
        else:
            sl[axis] = slice(0, max(n + o, 0))
            pad[axis] = (n - max(n + o, 0), 0)
        out = jnp.pad(out[tuple(sl)], pad)
    return out


def or_pool(mask3d: jnp.ndarray, level: int) -> jnp.ndarray:
    """OR-pool a [Z, Y, X] bool mask over 2^level cubes (pad with False)."""
    s = 1 << int(level)
    if s == 1:
        return mask3d
    pads = [(0, -d % s) for d in mask3d.shape]
    m = jnp.pad(mask3d, pads)
    zz, yy, xx = m.shape
    return m.reshape(zz // s, s, yy // s, s, xx // s, s).any(axis=(1, 3, 5))


def count_with_resolution(mask_a, mask_b, resolution_level: int, dims, offset=(0, 0, 0)):
    """collideWithResolution for dense maps (CollisionInterfaces.h:37-127).

    The reference declares this mixin for every map pairing but only GvlNTree
    implements it — and those bodies bounds-check resolution_level and then
    ignore it (GvlNTree.hpp:179-221 forward to intersect_sparse at full
    resolution). Here the *documented* contract ("resolution_level = 0
    delivers the highest accuracy whereas each increase halves the
    resolution", CollisionInterfaces.h:56) is implemented for real: occupancy
    is OR-pooled over 2^level cubes and collisions are counted between coarse
    cells. The offset stays in fine-voxel units and is applied geometrically
    to the left map before pooling (left[i+off] vs right[i]); unlike the
    fine-level base-pointer shift (TemplateVoxelMap.hpp:486-519) it does not
    bleed across axis boundaries.
    """
    x, y, z = dims
    a = _shift3d(mask_a.reshape(z, y, x), offset)
    b = mask_b.reshape(z, y, x)
    lvl = int(resolution_level)
    return jnp.sum(or_pool(a, lvl) & or_pool(b, lvl), dtype=jnp.uint32)


def count_and_mark_prob(a, b, t1, t2, dims=None, offset=(0, 0, 0)):
    """kernelCollideVoxelMapsDebug semantics for prob maps: count collisions
    AND insert eBVM_COLLISION (occupancy=127) into the left map's colliding
    voxels (VoxelMapOperations.hpp:129-184). Returns (count, new_left)."""
    n = a.shape[-1]
    off = linear_offset(offset, dims) if dims else 0
    sa, sb = _offset_slices(n, off)
    hit = prob_occupied(a[sa], t1) & prob_occupied(b[sb], t2)
    marked = jnp.where(hit, jnp.int8(MAX_PROBABILITY), a[sa])
    new_a = a.at[sa].set(marked)
    return jnp.sum(hit, dtype=jnp.uint32), new_a


def count_and_mark_bit(a_planes, b_planes, dims=None, offset=(0, 0, 0)):
    """Debug-kernel semantics for bit maps: mark eBVM_COLLISION (bit 2)."""
    n = a_planes.shape[-1]
    off = linear_offset(offset, dims) if dims else 0
    sa, sb = _offset_slices(n, off)
    hit = bitops.occupied(a_planes[:, sa]) & bitops.occupied(b_planes[:, sb])
    plane0 = a_planes[0, sa]
    plane0 = jnp.where(hit, plane0 | bitops.UINT32(1 << 2), plane0)
    new_a = a_planes.at[0, sa].set(plane0)
    return jnp.sum(hit, dtype=jnp.uint32), new_a


def collide_with_types_bit_bit(
    a_planes, b_planes, margin: int = 0, sv_offset: int = 0, mark_collisions: bool = True,
    *, interpret: bool = False,
):
    """kernelCollideVoxelMapsBitvector with SVCollider (BitVoxelMap.hpp:85-135).

    Per voxel: windowed swept-volume check bitMarginCollisionCheck(a, b,
    margin, sv_offset); colliding voxels get eBVM_COLLISION set in the left
    map; the per-voxel colliding-bit records are OR-reduced into one
    BitVector. Returns (count, meanings uint32[8], new_left).

    Deviation from CUDA: the reference reuses one uninitialized per-thread
    temp vector across its grid-stride loop, so a voxel's record can leak
    stale bytes from a previous voxel of the same thread before the block-OR;
    we give every voxel a fresh zero record (the sane reading, and
    order-independent).

    On the GPU, calls that ops/collide_triton covers run its one-pass Triton
    kernel (interpret=True: in the Pallas interpreter); every other call runs
    the plain XLA form `_types_xla`.
    """
    n = a_planes.shape[-1]
    if _types_kernel(n, margin, sv_offset, interpret):
        return collide_triton.collide_types(
            a_planes, b_planes, margin, mark=bool(mark_collisions), interpret=interpret
        )
    return _types_xla(a_planes, b_planes, margin, sv_offset, mark_collisions)


def _types_xla(a_planes, b_planes, margin=0, sv_offset=0, mark_collisions=True):
    """collide_with_types_bit_bit in plain XLA, on any device: the CPU path,
    and what the Triton kernel is checked against."""
    n = a_planes.shape[-1]
    if sv_offset == 0 and margin <= 24:
        hit, records = bitops.bit_margin_collision_check_packed(a_planes, b_planes, margin)
    else:
        # full-domain packed path: stays in uint32 planes (never unpacks to
        # bool[..., 256]), so dense swept-volume collides work at 512^3
        zero = bitops.zeros((n,))
        hit, records = bitops.bit_margin_collision_check_packed_full(
            a_planes, b_planes, zero, margin, sv_offset
        )
    # the mask is redundant (records are zero where there is no hit) but
    # keeps XLA's GPU fusion of the OR-reduce cheap: without it the window
    # is recomputed inside the reduction (22.7 vs 3.8 ms at 256^3, margin 8,
    # H100, PERF.md)
    records = jnp.where(hit[None, :], records, jnp.zeros_like(records))
    meanings = bitops.or_reduce_words_spmd(records)  # SPMD-safe (sharded maps)
    count = jnp.sum(hit, dtype=jnp.uint32)
    if mark_collisions:
        plane0 = jnp.where(hit, a_planes[0] | bitops.UINT32(1 << 2), a_planes[0])
        a_planes = a_planes.at[0].set(plane0)
    return count, meanings, a_planes


def collide_with_types_bit_prob(
    bit_planes, prob, t, mark_collisions: bool = True
):
    """SVCollider bit x prob (SVCollider.hpp:98-118): collision when the prob
    voxel passes the threshold and the bit voxel is !noneButEmpty; the bit
    voxel's full vector is OR'd into the colliding-meanings record."""
    hit = prob_occupied(prob, t) & bitops.occupied(bit_planes)
    masked = jnp.where(hit[None, :], bit_planes, jnp.zeros_like(bit_planes))
    meanings = bitops.or_reduce_words_spmd(masked)  # SPMD-safe (sharded maps)
    count = jnp.sum(hit, dtype=jnp.uint32)
    if mark_collisions:
        plane0 = jnp.where(hit, bit_planes[0] | bitops.UINT32(1 << 2), bit_planes[0])
        bit_planes = bit_planes.at[0].set(plane0)
    return count, meanings, bit_planes
