"""Exact EDT via min-plus envelope sweeps (the PBA replacement).

The reference's parallelBanding3D (voxelmap/DistanceVoxelMap.hpp:251-345,
kernels VoxelMapOperationsPBA.h:61-107) computes the exact 3D EDT as a Z
flood followed by two per-axis lower-envelope phases with banded merges.
Here each envelope phase is a dense min-plus sweep:

    out[y, x] = min_q ((y - q)^2 + g[q, x])        (one pass per axis)

On the GPU the sweep is a Pallas kernel through Triton: one block per
(z slice, x strip, y tile) keeps its output tile's best distance and payload
in registers and scans candidate rows in 8-row chunks, ring-ordered by
distance from the tile. How many rings each tile needs is precomputed from a
coarse (1/8-resolution) EDT upper bound; each block loads its own count from
an int32 array, so the kernel is a straight fori loop with no data-dependent
exit. Each candidate row is a broadcast add + compare + two selects over the
tile; the winning site's packed coordinates ride along through the selects.

On the CPU the same pass runs as `_envelope_xla`, the plain reference: a
full scan over all candidate rows. Both keep the lexicographic minimum of
(squared distance, packed site), so the result does not depend on the order
in which candidate rows are visited: kernel, reference and the z-sharded
pipeline return the same packed sites, not only the same distances.

Bound correctness: a candidate row q can only improve a tile cell whose
final value is v if (y-q)^2 <= v, so any upper bound on the pass's *output*
bounds the rings to scan. Pass-specific candidate sets matter: the Y pass
only sees sites in the same x-plane, so its bound comes from a per-fine-x
semi-coarse EDT; the X pass sees all sites, so a full coarse 3D EDT bounds
it. Cells whose output is MISS (no candidate at all) are correct at any ring
count and contribute nothing to the tile bound.

All distance math runs in f32: finite squared distances are <= 4*1023^2
< 2^24, so every value and comparison is exact. MISS (no site) is 2^27,
also exactly representable; INF marks "no site found yet".
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .. import backend
from ..constants import (
    PBA_UNINITIALISED_COORD,
    PBA_UNINITIALISED_PACKED,
)

Dims = Tuple[int, int, int]
I32 = jnp.int32
U32 = jnp.uint32
F32 = jnp.float32

MISS = 1 << 27  # internal "no site" squared distance (int32/f32-exact)
_INF = 3.0e8  # > MISS + any in-grid offset; python float so kernels don't capture tracers
# output tile per block (powers of two; TILE_Y a multiple of _CHUNK). Full
# 512^3 ring scans on an H100 measured within 4% across 16x128, 32x64,
# 32x128 and 64x64 (PERF.md)
TILE_Y = 32
TX = 128
_CHUNK = 8  # candidate-row scan granularity (one ring step)
_C = 8  # coarsening factor for the bound grids
_NUM_WARPS = 4


def _envelope_xla(
    g2: jnp.ndarray, payload: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference envelope along axis 1 (full scan over candidate rows):
    the CPU path, and the plain version the GPU kernel is checked against."""
    dz, dy, dx = g2.shape
    yrow = jax.lax.broadcasted_iota(I32, (1, dy, 1), 1).astype(F32)
    inf_f = jnp.float32(_INF)
    miss_f = jnp.float32(MISS)

    def body(q, carry):
        bd, bp = carry
        grow = jax.lax.dynamic_slice_in_dim(g2, q, 1, axis=1).astype(F32)
        grow = jnp.where(grow >= miss_f, inf_f, grow)
        prow = jax.lax.dynamic_slice_in_dim(payload, q, 1, axis=1)
        dy_q = yrow - q.astype(F32)
        cand = dy_q * dy_q + grow
        take = (cand < bd) | ((cand == bd) & (prow < bp))
        return jnp.where(take, cand, bd), jnp.where(take, prow, bp)

    bd0 = jnp.full((dz, dy, dx), inf_f)
    bp0 = jnp.full((dz, dy, dx), jnp.uint32(PBA_UNINITIALISED_PACKED))
    bd, bp = jax.lax.fori_loop(0, dy, body, (bd0, bp0))
    valid = bd < miss_f
    return (
        jnp.where(valid, bd.astype(I32), I32(MISS)),
        jnp.where(valid, bp, jnp.uint32(PBA_UNINITIALISED_PACKED)),
    )


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pow2_at_least(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def _ring_order(C: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tile-relative chunk offsets sorted by their minimum possible squared
    row distance to a TILE_Y-row tile (monotone floors enable tight ring
    counts). Offset o maps tile k to chunk k*TC + o."""
    TC = TILE_Y // _CHUNK

    def floor_d(o: int) -> int:
        if 0 <= o < TC:
            return 0
        if o >= TC:
            return (_CHUNK * (o - TC) + 1) ** 2
        return (-_CHUNK * o - 7) ** 2

    offs = sorted(range(-(C - 1), C), key=lambda o: (floor_d(o), abs(o)))
    return (
        np.asarray(offs, np.int32),
        np.asarray([floor_d(o) for o in offs], np.int64),
    )


def _envelope_kernel(
    rings_ref, order_ref, g_ref, p_ref, od_ref, op_ref, *, n_yt, nxb, C, tx
):
    """One block: output tile rows [k*TILE_Y, (k+1)*TILE_Y) of x strip j in
    z slice i. g_ref int32[dz, dyp, dxp] (>= MISS marks "no site"), p_ref
    int32[dz, dyp, dxp] packed site payloads (uint32 bits); both stay in
    device memory and each candidate row is loaded as one [1, tx] slice (a
    z slice's strip is small enough to stay in L2 across the y tiles)."""
    i = pl.program_id(0)
    j = pl.program_id(1)
    k = pl.program_id(2)
    miss_f = jnp.float32(MISS)
    inf_f = jnp.float32(_INF)
    x0 = pl.multiple_of(j * tx, tx)
    tb = k * (TILE_Y // _CHUNK)
    rings = rings_ref[(i * nxb + j) * n_yt + k]
    ycol = (jax.lax.broadcasted_iota(I32, (TILE_Y, 1), 0) + k * TILE_Y).astype(F32)

    def body(r, carry):
        bd, bp = carry
        cidx = tb + order_ref[r]
        dead = (cidx < 0) | (cidx >= C)
        q0 = jnp.clip(cidx, 0, C - 1) * _CHUNK
        for jj in range(_CHUNK):
            q = q0 + jj
            g = g_ref[i, pl.ds(q, 1), pl.ds(x0, tx)].astype(F32)  # [1, tx]
            g = jnp.where(dead | (g >= miss_f), inf_f, g)
            p = p_ref[i, pl.ds(q, 1), pl.ds(x0, tx)]
            dy_q = ycol - q.astype(F32)
            cand = dy_q * dy_q + g  # [TILE_Y, 1] + [1, tx]
            # payloads are < 2^30, so the signed compare orders them as uint32
            take = (cand < bd) | ((cand == bd) & (p < bp))
            bd = jnp.where(take, cand, bd)
            bp = jnp.where(take, p, bp)
        return bd, bp

    bd0 = jnp.full((TILE_Y, tx), inf_f)
    bp0 = jnp.full((TILE_Y, tx), I32(PBA_UNINITIALISED_PACKED))
    bd, bp = jax.lax.fori_loop(0, rings, body, (bd0, bp0))
    valid = bd < miss_f
    od_ref[...] = jnp.where(valid, bd.astype(I32), I32(MISS))
    op_ref[...] = jnp.where(valid, bp, bp0)


def _ring_counts(bound, dz, n_yt, nxb, tx, bound_c, floors):
    """int32[dz * nxb * n_yt]: rings each (z, x strip, y tile) block scans —
    the number of ring floors at or below the per-tile max of the coarse
    output bound (0 where the bound says the whole tile's output is MISS)."""
    cz, cyc, cxc = bound.shape
    ty_c = TILE_Y // bound_c  # coarse cells per y tile
    tx_c = tx // bound_c  # coarse cells per x strip
    pyc = _round_up(max(cyc, n_yt * ty_c), ty_c)
    pxc = _round_up(max(cxc, nxb * tx_c), tx_c)
    b = jnp.full((cz, pyc, pxc), I32(-1)).at[:, :cyc, :cxc].set(bound)
    b = b.reshape(cz, pyc // ty_c, ty_c, pxc // tx_c, tx_c)
    b = jnp.max(jnp.max(b, axis=4), axis=2)[:, :n_yt, :nxb]
    # expand coarse z rows to fine z slices
    b = jnp.repeat(b, bound_c, axis=0)[:dz]  # [dz, n_yt, nxb]
    rcount = jnp.searchsorted(
        jnp.asarray(floors, np.int32), b.reshape(-1), side="right"
    ).astype(I32)
    rcount = jnp.where(b.reshape(-1) < 0, I32(0), rcount)
    return rcount.reshape(dz, n_yt, nxb).transpose(0, 2, 1).reshape(-1)


def envelope_pass(
    g2: jnp.ndarray,
    payload: jnp.ndarray,
    bound: jnp.ndarray | None = None,
    *,
    bound_c: int = _C,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lower envelope along axis 1 of [dz, dy, dx] grids.

    g2 int32 (MISS convention), payload uint32. `bound` is an optional int32
    upper bound on this pass's *output* at 1/bound_c resolution in every axis
    ([cdiv(dz,c), cdiv(dy,c), cdiv(dx,c)]), with -1 meaning "output there is
    MISS" (contributes nothing). Without it every tile scans all rings.
    Returns (d2 int32 [dz,dy,dx], payload uint32 [dz,dy,dx]).

    The Triton kernel runs where `backend.use_kernel()` says so, or in the
    Pallas interpreter when `interpret=True`; otherwise the plain full-scan
    reference `_envelope_xla` runs (it ignores `bound`, which never changes
    the result).
    """
    if not (interpret or backend.use_kernel()):
        return _envelope_xla(g2, payload)
    dz, dy, dx = g2.shape
    tx = min(_pow2_at_least(max(dx, bound_c)), TX)
    dyp = _round_up(dy, TILE_Y)
    dxp = _round_up(dx, tx)
    pay = jax.lax.bitcast_convert_type(payload.astype(U32), I32)
    if dyp != dy or dxp != dx:
        pad = ((0, 0), (0, dyp - dy), (0, dxp - dx))
        g2 = jnp.pad(g2, pad, constant_values=MISS)
        pay = jnp.pad(pay, pad)  # never selected: padded rows are MISS

    C = dyp // _CHUNK
    n_yt = dyp // TILE_Y
    nxb = dxp // tx
    order, floors = _ring_order(C)
    if bound is None:
        rings = jnp.full((dz * nxb * n_yt,), I32(len(order)))
    else:
        rings = _ring_counts(bound, dz, n_yt, nxb, tx, bound_c, floors)

    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    out_spec = pl.BlockSpec((None, TILE_Y, tx), lambda i, j, k: (i, k, j))
    od, op = pl.pallas_call(
        functools.partial(
            _envelope_kernel, n_yt=n_yt, nxb=nxb, C=C, tx=tx
        ),
        grid=(dz, nxb, n_yt),
        in_specs=[any_spec] * 4,
        out_specs=[out_spec, out_spec],
        out_shape=(
            jax.ShapeDtypeStruct((dz, dyp, dxp), I32),
            jax.ShapeDtypeStruct((dz, dyp, dxp), I32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="edt_envelope",
    )(rings, jnp.asarray(order), g2, pay)
    od = od[:, :dy, :dx]
    op = jax.lax.bitcast_convert_type(op[:, :dy, :dx], U32)
    return od, op


def _nearest_scan(flag: jnp.ndarray, axis0_size: int):
    """For a [S, ...] bool array: per position s, squared distance along axis
    0 to the nearest True (MISS if none) plus its index. Two lax.scans —
    PBA phase 1 (kernelPBAphase1FloodZ analogue)."""
    S = flag.shape[0]
    BIG = jnp.int32(2**30)
    sidx = jax.lax.broadcasted_iota(I32, flag.shape, 0)
    marked = jnp.where(flag, sidx, BIG)

    def fwd(carry, row):
        best = jnp.where(row < BIG, row, carry)
        return best, best

    init = jnp.full(flag.shape[1:], BIG)
    _, down = jax.lax.scan(fwd, init, marked)
    _, up = jax.lax.scan(fwd, init, marked[::-1])
    up = up[::-1]
    dd = jnp.where(down < BIG, (sidx - down) ** 2, MISS)
    du = jnp.where(up < BIG, (up - sidx) ** 2, MISS)
    take_down = dd <= du
    near = jnp.where(take_down, down, up)
    d2 = jnp.minimum(jnp.minimum(dd, du), MISS).astype(I32)
    return d2, near


def _block_any(mask: jnp.ndarray, axes=(0, 1, 2), c: int = _C) -> jnp.ndarray:
    """OR-reduce an [A,B,C] bool mask by factor c (a power of two) along the
    given axes (strided pairwise ORs, one axis at a time)."""
    m = mask
    halvings = c.bit_length() - 1
    for ax in axes:
        pad = (-m.shape[ax]) % c
        if pad:
            padding = [(0, 0)] * 3
            padding[ax] = (0, pad)
            m = jnp.pad(m, padding, constant_values=False)
        for _ in range(halvings):
            sl0 = [slice(None)] * 3
            sl1 = [slice(None)] * 3
            sl0[ax] = slice(0, None, 2)
            sl1[ax] = slice(1, None, 2)
            m = m[tuple(sl0)] | m[tuple(sl1)]
    return m


def _bound_from_d2(d2c: jnp.ndarray, n_axes: int, c: int = _C) -> jnp.ndarray:
    """Upper bound on the fine squared distance given the 1/c-resolution
    coarse squared index distance d2c over n_axes axes: each axis offset a
    satisfies sum a_i^2 = d2c, fine offset per axis <= c*a_i + (c-1), so
    fine_d2 <= c^2*d2c + 2c(c-1)*sum(a_i) + (c-1)^2*n
            <= c^2*d2c + 2c(c-1)*sqrt(n*d2c) + (c-1)^2*n.
    A smaller c gives tighter bounds (fewer rings to scan) at a c^3-larger
    coarse-EDT cost. MISS coarse cells map to -1 ("output is MISS,
    constrains nothing")."""
    miss = (d2c >= MISS) | (d2c < 0)
    d = jnp.maximum(d2c, 0).astype(jnp.float32)
    bound = (
        float(c * c) * d
        + float(2 * c * (c - 1)) * jnp.ceil(jnp.sqrt(jnp.float32(n_axes) * d))
        + float((c - 1) * (c - 1)) * n_axes
    )
    return jnp.where(miss, I32(-1), bound.astype(I32))


def parallel_banding(
    packed_flat: jnp.ndarray,
    dims: Dims,
    *,
    bound_c: int = _C,
    interpret: bool = False,
) -> jnp.ndarray:
    """Exact 3D EDT: PBA phase 1 as Z scans, phases 2/3 as min-plus envelope
    sweeps with coarse-EDT ring bounds (replaces parallelBanding3D,
    DistanceVoxelMap.hpp:279, with identical distances — tests cross-check
    vs the brute oracle). XLA transposes the grids between the passes.

    bound_c is the coarsening factor of the ring-bound grids: a smaller one
    tightens the bounds (fewer rings) at a bound_c^3-larger coarse EDT.
    interpret=True runs the envelope kernel in the Pallas interpreter (tests).
    """
    ep = functools.partial(envelope_pass, bound_c=bound_c, interpret=interpret)
    return _banding(packed_flat, dims, ep, bound_c)


def parallel_banding_reference(packed_flat: jnp.ndarray, dims: Dims) -> jnp.ndarray:
    """The same pipeline with the plain full-scan `_envelope_xla` for every
    pass, on any device: what the GPU kernel's results are checked against."""
    return _banding(packed_flat, dims, lambda g2, pay, bound=None: _envelope_xla(g2, pay), _C)


def _banding(packed_flat: jnp.ndarray, dims: Dims, ep, bound_c: int) -> jnp.ndarray:
    """parallel_banding's body; `ep(g2, payload, bound=None)` is the envelope
    pass to use."""
    dx, dy, dz = dims
    grid = packed_flat.reshape(dz, dy, dx).astype(U32)
    ox, oy, oz = grid & U32(0x3FF), (grid >> U32(10)) & U32(0x3FF), grid >> U32(20)
    pz = jax.lax.broadcasted_iota(I32, (dz, dy, dx), 0)
    py = jax.lax.broadcasted_iota(I32, (dz, dy, dx), 1)
    px = jax.lax.broadcasted_iota(I32, (dz, dy, dx), 2)
    is_site = (
        (ox.astype(I32) == px) & (oy.astype(I32) == py) & (oz.astype(I32) == pz)
    ) & (ox != U32(PBA_UNINITIALISED_COORD))

    # --- phase 1: nearest site along Z per (y, x) column (two scans) -------
    g1, near_z = _nearest_scan(is_site, dz)
    near_z_c = jnp.clip(near_z, 0, PBA_UNINITIALISED_COORD).astype(U32)
    pay1 = px.astype(U32) | (py.astype(U32) << U32(10)) | (near_z_c << U32(20))

    # --- ring bounds for the Y pass (per-fine-x semi-coarse 2D EDT: the Y
    # pass only sees sites sharing the query's x) ----------------------------
    semi = _block_any(is_site, axes=(0, 1), c=bound_c)  # [cz, cy, dx]
    d1s, _ = _nearest_scan(semi, semi.shape[0])  # along cz
    d2s, _ = ep(d1s, jnp.zeros(semi.shape, U32))  # along cy (full scan; small grid)
    boundY = _bound_from_d2(_max_x_blocks(d2s, bound_c), 2, bound_c)

    # --- phase 2: envelope along Y, then to the X pass's layout [dz, dx, dy]
    d2, pay2 = ep(g1, pay1, boundY)
    d2t = jnp.transpose(d2, (0, 2, 1))
    pay2t = jnp.transpose(pay2, (0, 2, 1))

    # --- ring bounds for the X pass (full coarse 3D EDT) ---------------------
    cmask = _block_any(is_site, axes=(0, 1, 2), c=bound_c)  # [cz, cy, cx]
    boundX = _coarse_bound_x(cmask, bound_c, ep)  # [cz, cx, cy]

    # --- phase 3: envelope along X (transposed layout, same kernel) ----------
    d3t, pay3t = ep(d2t, pay2t, boundX)
    outt = jnp.where(d3t >= MISS, jnp.uint32(PBA_UNINITIALISED_PACKED), pay3t)
    return jnp.transpose(outt, (0, 2, 1)).reshape(-1)


def _coarse_bound_x(cmask: jnp.ndarray, bound_c: int, ep) -> jnp.ndarray:
    """X-pass ring bound on the transposed layout ([cz, cx, cy]) from the
    full coarse 3D EDT of the coarse site mask cmask [cz, cy, cx] (`ep` is
    the envelope pass to use)."""
    c1, _ = _nearest_scan(cmask, cmask.shape[0])
    zero_pay = jnp.zeros(cmask.shape, U32)
    c2, _ = ep(c1, zero_pay)  # along cy
    c3t, _ = ep(jnp.transpose(c2, (0, 2, 1)), jnp.transpose(zero_pay, (0, 2, 1)))
    return _bound_from_d2(c3t, 3, bound_c)


def _max_x_blocks(d2s: jnp.ndarray, c: int = _C) -> jnp.ndarray:
    """[cz, cy, dx] per-fine-x values -> [cz, cy, cdiv(dx,c)] per-block max
    with MISS treated as -inf (a MISS output constrains no rings)."""
    v = jnp.where(d2s >= MISS, I32(-1), d2s)
    pad = (-v.shape[2]) % c
    if pad:
        v = jnp.pad(v, ((0, 0), (0, 0), (0, pad)), constant_values=-1)
    for _ in range(c.bit_length() - 1):
        v = jnp.maximum(v[:, :, 0::2], v[:, :, 1::2])
    return v
