"""Euclidean distance transforms on dense voxel grids.

Equivalents of voxelmap/DistanceVoxelMap.{h,hpp} + kernels/VoxelMapOperations*.
The reference offers three algorithms (exact brute force, jump flood, PBA);
tests cross-check them (testing_distance.cu:79-119). Here:

  * exact_distances: brute force vs an explicit obstacle list — the oracle
    (kernelExactDistances3D, VoxelMapOperations.h:454-456).
  * jump_flood: 3D JFA over the packed-coordinate grid, log2(maxdim) rounds
    of 26-neighbor min-merges (kernelJumpFlood3D, VoxelMapOperations.h:448),
    each round a fused elementwise pass. `extra_rounds` adds 1+JFA passes
    (step-1 refinements) which remove JFA's rare inexact cells.
  * manhattan_distance: exact separable L1 transform (init_floodfill
    analogue) via 6 directional scans.

Grids hold DistanceVoxel-packed uint32 values: x | y<<10 | z<<20, with
uninitialised = 1023 per field (DistanceVoxel.hpp:31-101); distances to
uninitialised voxels are MAX_OBSTACLE_DISTANCE (DistanceVoxel.hpp:39-54).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..constants import (
    MAX_OBSTACLE_DISTANCE,
    PBA_UNINITIALISED_COORD,
    PBA_UNINITIALISED_PACKED,
)

Dims = Tuple[int, int, int]
U32 = jnp.uint32
I32 = jnp.int32


def pack(x, y, z) -> jnp.ndarray:
    return (
        jnp.asarray(x, U32)
        | (jnp.asarray(y, U32) << U32(10))
        | (jnp.asarray(z, U32) << U32(20))
    )


def unpack(packed) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    p = jnp.asarray(packed, U32)
    return p & U32(0x3FF), (p >> U32(10)) & U32(0x3FF), p >> U32(20)


def _position_grids(dims: Dims):
    dx, dy, dz = dims
    z = jax.lax.broadcasted_iota(I32, (dz, dy, dx), 0)
    y = jax.lax.broadcasted_iota(I32, (dz, dy, dx), 1)
    x = jax.lax.broadcasted_iota(I32, (dz, dy, dx), 2)
    return x, y, z


def squared_distance_grid(packed_grid: jnp.ndarray, dims: Dims) -> jnp.ndarray:
    """int32[Z,Y,X]: squared distance to the stored obstacle; uninitialised
    voxels give MAX_OBSTACLE_DISTANCE (DistanceVoxel::squaredObstacleDistance)."""
    dx, dy, dz = dims
    g = packed_grid.reshape(dz, dy, dx)
    ox, oy, oz = unpack(g)
    px, py, pz = _position_grids(dims)
    uninit = (ox == PBA_UNINITIALISED_COORD) | (oy == PBA_UNINITIALISED_COORD) | (oz == PBA_UNINITIALISED_COORD)
    d = (
        (px - ox.astype(I32)) ** 2
        + (py - oy.astype(I32)) ** 2
        + (pz - oz.astype(I32)) ** 2
    )
    return jnp.where(uninit, I32(MAX_OBSTACLE_DISTANCE), d)


def init_from_obstacle_mask(mask_flat: jnp.ndarray, dims: Dims) -> jnp.ndarray:
    """uint32[N]: obstacle voxels hold their own coords, others uninit."""
    dx, dy, dz = dims
    px, py, pz = _position_grids(dims)
    own = pack(px, py, pz).reshape(-1)
    return jnp.where(mask_flat, own, U32(PBA_UNINITIALISED_PACKED))


def exact_distances(obstacle_coords: jnp.ndarray, dims: Dims) -> jnp.ndarray:
    """Brute-force oracle: nearest of M obstacle coords per voxel.

    obstacle_coords: int32[M, 3] (x,y,z); invalid rows marked x==1023.
    Returns packed uint32[N]. O(N*M) — use on small scenes/tests only,
    like the reference's exactDistances3D.
    """
    dx, dy, dz = dims
    px, py, pz = _position_grids(dims)
    pos = jnp.stack([px, py, pz], axis=-1).reshape(-1, 3)  # [N,3]
    obs = jnp.asarray(obstacle_coords, I32)  # [M,3]
    valid = obs[:, 0] != PBA_UNINITIALISED_COORD

    def per_voxel(p):
        d = jnp.sum((obs - p[None, :]) ** 2, axis=-1)
        d = jnp.where(valid, d, MAX_OBSTACLE_DISTANCE)
        i = jnp.argmin(d)
        best = obs[i]
        hit = d[i] < MAX_OBSTACLE_DISTANCE
        return jnp.where(
            hit,
            pack(best[0].astype(U32), best[1].astype(U32), best[2].astype(U32)),
            U32(PBA_UNINITIALISED_PACKED),
        )

    return jax.lax.map(per_voxel, pos, batch_size=4096)


def _merge(best_packed, best_d2, cand_packed, dims):
    """Keep the closer of current best and candidate (strictly closer wins,
    like updateMinVoxel)."""
    dx, dy, dz = dims
    cx, cy, cz = unpack(cand_packed)
    px, py, pz = _position_grids(dims)
    uninit = (cx == PBA_UNINITIALISED_COORD) | (cy == PBA_UNINITIALISED_COORD) | (cz == PBA_UNINITIALISED_COORD)
    d2 = (
        (px - cx.astype(I32)) ** 2 + (py - cy.astype(I32)) ** 2 + (pz - cz.astype(I32)) ** 2
    )
    d2 = jnp.where(uninit, I32(MAX_OBSTACLE_DISTANCE), d2)
    take = d2 < best_d2
    return jnp.where(take, cand_packed, best_packed), jnp.where(take, d2, best_d2)


_NEIGHBORS = [
    (ox, oy, oz)
    for ox in (-1, 0, 1)
    for oy in (-1, 0, 1)
    for oz in (-1, 0, 1)
    if (ox, oy, oz) != (0, 0, 0)
]


def _shift3d(grid, off, fill):
    """grid shifted so result[p] = grid[p + off] (zeros -> fill outside)."""
    oz, oy, ox = off[2], off[1], off[0]
    g = grid
    for axis, o in ((0, oz), (1, oy), (2, ox)):
        if o == 0:
            continue
        g = jnp.roll(g, -o, axis=axis)
        idx = [slice(None)] * 3
        if o > 0:
            idx[axis] = slice(g.shape[axis] - o, None)
        else:
            idx[axis] = slice(0, -o)
        g = g.at[tuple(idx)].set(fill)
    return g


def _jfa_round(grid: jnp.ndarray, best_d2: jnp.ndarray, s: int, dims: Dims):
    """One JFA round: merge all 26 neighbors at step s in one fused pass.

    The grid is padded once (uninitialised border) so every neighbor is a
    static slice of one array — XLA fuses the whole round into a single
    sweep instead of materializing 26 shifted copies. (The exact EDT's
    kernel lives in the envelope sweeps, ops/edt_envelope.py.)
    """
    dz, dy, dx = grid.shape
    p = jnp.pad(grid, s, constant_values=int(PBA_UNINITIALISED_PACKED))
    px, py, pz = _position_grids(dims)
    for off in _NEIGHBORS:
        ox, oy, oz = off
        cand = jax.lax.slice(
            p,
            (s + oz * s, s + oy * s, s + ox * s),
            (s + oz * s + dz, s + oy * s + dy, s + ox * s + dx),
        )
        cx, cy, cz = unpack(cand)
        # any coord == 1023 marks uninitialised, like the reference
        # (DistanceVoxel.hpp:39-54; 1024-wide grids lose coordinate 1023)
        un = (cx == PBA_UNINITIALISED_COORD) | (cy == PBA_UNINITIALISED_COORD) | (cz == PBA_UNINITIALISED_COORD)
        d2 = (
            (px - cx.astype(I32)) ** 2
            + (py - cy.astype(I32)) ** 2
            + (pz - cz.astype(I32)) ** 2
        )
        d2 = jnp.where(un, I32(MAX_OBSTACLE_DISTANCE), d2)
        take = d2 < best_d2
        grid = jnp.where(take, cand, grid)
        best_d2 = jnp.where(take, d2, best_d2)
    return grid, best_d2


def _converge_step1(grid, best_d2, dims, max_iters: int = 64):
    """Iterate step-1 rounds to a fixpoint: every cell's result becomes a
    local optimum w.r.t. its 26 neighbors' sites. Repairs the rare isolated
    errors both JFA and its multiresolution variant can leave (the correct
    site always reaches an erroneous cell through its neighbors because
    Voronoi cells of point sites are connected).

    The loop is capped at max_iters (worst-case scenes would otherwise give
    unpredictable latency); returns (grid, d2, iterations_used). Callers can
    surface iterations_used == max_iters as "did not converge" telemetry —
    see jump_flood_with_stats."""

    def cond(state):
        _, _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        g, d, _, it = state
        g2, d2 = _jfa_round(g, d, 1, dims)
        return g2, d2, jnp.any(d2 != d), it + 1

    grid, best_d2, _, iters = jax.lax.while_loop(
        cond, body, (grid, best_d2, jnp.bool_(True), jnp.int32(0))
    )
    return grid, best_d2, iters


def _jfa_steps(dims: Dims, extra_rounds: int):
    """The JFA step schedule: pow2 ramp down from max(dims)/2 plus
    extra_rounds step-1 refinement passes (shared by jump_flood and
    jump_flood_with_stats so the telemetry variant cannot drift)."""
    step = 1
    while step * 2 < max(dims):
        step *= 2
    steps = []
    s = step
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.extend([1] * int(extra_rounds))
    return steps


def jump_flood(
    packed_flat: jnp.ndarray, dims: Dims, extra_rounds: int = 1, converge: bool = True
) -> jnp.ndarray:
    """3D jump flooding over the packed grid (jumpFlood3D,
    DistanceVoxelMap.hpp:136). extra_rounds appends step-1 JFA+k refinement
    passes; converge=True then iterates step-1 rounds to a fixpoint,
    repairing JFA's rare inexact cells."""
    dx, dy, dz = dims
    grid = packed_flat.reshape(dz, dy, dx)
    best_d2 = squared_distance_grid(packed_flat, dims)
    for s in _jfa_steps(dims, extra_rounds):
        grid, best_d2 = _jfa_round(grid, best_d2, s, dims)
    if converge:
        grid, best_d2, _ = _converge_step1(grid, best_d2, dims)
    return grid.reshape(-1)


def jump_flood_with_stats(
    packed_flat: jnp.ndarray, dims: Dims, extra_rounds: int = 1, max_iters: int = 64
):
    """jump_flood + fixpoint-repair telemetry: returns (packed, repair_iters).

    repair_iters == max_iters means the repair loop hit its cap without
    converging (result may be inexact) — surface it in perf monitoring."""
    dx, dy, dz = dims
    grid = packed_flat.reshape(dz, dy, dx)
    best_d2 = squared_distance_grid(packed_flat, dims)
    for s in _jfa_steps(dims, extra_rounds):
        grid, best_d2 = _jfa_round(grid, best_d2, s, dims)
    grid, best_d2, iters = _converge_step1(grid, best_d2, dims, max_iters)
    return grid.reshape(-1), iters


def jump_flood_multires(
    packed_flat: jnp.ndarray,
    dims: Dims,
    coarse_factor: int = 4,
    fine_steps=(8, 4, 2, 1, 1, 1),
) -> jnp.ndarray:
    """Multi-resolution jump flooding: full JFA on a coarse grid (1/c^3 of
    the work) seeds the fine grid, which then needs only short-range rounds.

    The long-range JFA rounds dominate the flat algorithm's bandwidth (each
    round reads the grid 26x); running them at 1/64 resolution makes their
    cost negligible, and the fine refinement steps cover the coarse answer's
    localization error. Empirically exact on cross-checked scenes (tests
    compare against the brute oracle); `jump_flood` remains the
    straightforward fallback.
    """
    dx, dy, dz = dims
    c = coarse_factor
    if dx % c or dy % c or dz % c:
        return jump_flood(packed_flat, dims)
    grid = packed_flat.reshape(dz, dy, dx)
    d2 = squared_distance_grid(packed_flat, dims)

    # --- coarsen: per c^3 block keep the site closest to the block center ---
    # (pairwise strided min-merges, one axis at a time, rather than one 6D
    # reshape)
    cxg, cyg, czg = unpack(grid)
    # doubled coordinates keep the half-integer block center exact:
    # 2*center = 2*(voxel//c)*c + (c-1)
    px, py, pz = _position_grids(dims)
    bx = (px // c) * (2 * c) + (c - 1)
    by = (py // c) * (2 * c) + (c - 1)
    bz = (pz // c) * (2 * c) + (c - 1)
    uninit = (cxg == PBA_UNINITIALISED_COORD) | (cyg == PBA_UNINITIALISED_COORD) | (czg == PBA_UNINITIALISED_COORD)
    dd = (
        (2 * cxg.astype(I32) - bx) ** 2
        + (2 * cyg.astype(I32) - by) ** 2
        + (2 * czg.astype(I32) - bz) ** 2
    )
    dd = jnp.where(uninit, I32(MAX_OBSTACLE_DISTANCE), dd)
    coarse_sites, dd_c = grid, dd
    halvings = 0
    cc = c
    while cc > 1:
        cc //= 2
        halvings += 1
    for axis in (2, 1, 0):
        for _ in range(halvings):
            sl0 = [slice(None)] * 3
            sl1 = [slice(None)] * 3
            sl0[axis] = slice(0, None, 2)
            sl1[axis] = slice(1, None, 2)
            s0, s1 = coarse_sites[tuple(sl0)], coarse_sites[tuple(sl1)]
            d0, d1 = dd_c[tuple(sl0)], dd_c[tuple(sl1)]
            take = d1 < d0
            coarse_sites = jnp.where(take, s1, s0)
            dd_c = jnp.where(take, d1, d0)

    # --- coarse JFA: sites keep FINE coordinates; positions are block centers
    cdims = (dx // c, dy // c, dz // c)

    def coarse_d2(cand):
        sx, sy, sz = unpack(cand)
        un = (sx == PBA_UNINITIALISED_COORD) | (sy == PBA_UNINITIALISED_COORD) | (sz == PBA_UNINITIALISED_COORD)
        px = jax.lax.broadcasted_iota(I32, cand.shape, 2) * c * 2 + (c - 1)
        py = jax.lax.broadcasted_iota(I32, cand.shape, 1) * c * 2 + (c - 1)
        pz = jax.lax.broadcasted_iota(I32, cand.shape, 0) * c * 2 + (c - 1)
        val = (
            (2 * sx.astype(I32) - px) ** 2
            + (2 * sy.astype(I32) - py) ** 2
            + (2 * sz.astype(I32) - pz) ** 2
        )
        return jnp.where(un, I32(MAX_OBSTACLE_DISTANCE), val)

    cg = coarse_sites
    cbest = coarse_d2(cg)
    step = 1
    while step * 2 < max(cdims):
        step *= 2
    s = step
    while s >= 1:
        for off in _NEIGHBORS:
            cand = _shift3d(cg, (off[0] * s, off[1] * s, off[2] * s), U32(PBA_UNINITIALISED_PACKED))
            nd = coarse_d2(cand)
            take = nd < cbest
            cg = jnp.where(take, cand, cg)
            cbest = jnp.where(take, nd, cbest)
        s //= 2

    # --- upsample: every fine voxel adopts its block's coarse site ----------
    up = jnp.repeat(jnp.repeat(jnp.repeat(cg, c, axis=0), c, axis=1), c, axis=2)
    grid, d2 = _merge(grid, d2, up, dims)

    # --- short-range fine refinement + fixpoint repair -----------------------
    for s in fine_steps:
        grid, d2 = _jfa_round(grid, d2, s, dims)
    grid, d2, _ = _converge_step1(grid, d2, dims)
    return grid.reshape(-1)


def _envelope_pass_1d(g2: jnp.ndarray, sites: jnp.ndarray):
    """Exact 1D distance transform with parabolic costs, batched over lines.

    Computes out[x] = min_q ((x - q)^2 + g2[q]) plus the argmin's payload for
    every line in the batch — the same problem PBA phase 2/3 solves with
    banded merges (VoxelMapOperationsPBA.hpp). Uses Meijster's all-integer
    lower-envelope algorithm as a lax.scan over positions, vectorized across
    all lines, with a masked while_loop for the amortized pops.

    g2:    int32[L, n]  squared cost per candidate; MAX_OBSTACLE_DISTANCE
                         marks "no site for this column"
    sites: int32[L, n]  payload to carry (packed obstacle coords)
    returns (out_d2 int32[L, n], out_sites int32[L, n])
    """
    L, n = g2.shape
    # all-int32 arithmetic (x64 is disabled in JAX by default): MISS is a
    # finite "no site" stand-in; real d2 <= 3*1023^2 ~ 3.1e6 << MISS, and
    # worst-case intermediates (n^2 + MISS) stay within int32
    MISS = jnp.int32(1 << 27)
    g2l = jnp.where(g2.astype(jnp.int32) >= MISS, MISS, g2.astype(jnp.int32))

    lines = jnp.arange(L)

    def f(x, i, g):  # parabola value at x for center i with offset g[i]
        d = x - i
        return d * d + g

    def sep(i, u, gi, gu):
        """Last x where parabola i beats u (Meijster Sep), integer floor."""
        num = u * u - i * i + gu - gi
        den = 2 * (u - i)
        return jnp.floor_divide(num, den)

    s0 = jnp.zeros((L, n), jnp.int32)  # stack of parabola centers
    t0 = jnp.zeros((L, n), jnp.int32)  # first winning x per stack entry
    q0 = jnp.zeros((L,), jnp.int32)  # top index

    def g_at(pos):
        return jnp.take_along_axis(g2l, pos.astype(jnp.int32)[:, None], axis=1)[:, 0]

    def step(carry, u):
        s, t, q = carry
        gu = g2l[:, u]
        u64 = u.astype(jnp.int32)

        def pop_cond(state):
            _, _, _, active = state
            return jnp.any(active)

        def pop_body(state):
            s, t, q, active = state
            sq = jnp.take_along_axis(s, q[:, None], axis=1)[:, 0]
            tq = jnp.take_along_axis(t, q[:, None], axis=1)[:, 0]
            worse = f(tq, sq, g_at(sq)) > f(tq, u64, gu)
            do_pop = active & worse & (q >= 0)
            q = jnp.where(do_pop, q - 1, q)
            # once popped to -1 or the top survives, stop for that line
            active = do_pop & (q >= 0)
            return s, t, q, active

        s, t, q, _ = jax.lax.while_loop(pop_cond, pop_body, (s, t, q, q >= 0))
        # lines where q dropped below 0: restart stack with u
        restart = q < 0
        q_safe = jnp.maximum(q, 0)
        sq = jnp.take_along_axis(s, q_safe[:, None], axis=1)[:, 0]
        gi = jnp.take_along_axis(g2l, sq[:, None], axis=1)[:, 0]
        w = 1 + sep(sq, u64, gi, gu)
        push = (~restart) & (w < n)
        newq = jnp.where(restart, 0, jnp.where(push, q + 1, q))
        newval_s = jnp.where(restart | push, u64, jnp.take_along_axis(s, newq[:, None], axis=1)[:, 0])
        newval_t = jnp.where(restart, 0, jnp.where(push, w, jnp.take_along_axis(t, newq[:, None], axis=1)[:, 0])).astype(jnp.int32)
        s = s.at[lines, newq].set(newval_s)
        t = t.at[lines, newq].set(newval_t)
        return (s, t, newq), None

    (s, t, q), _ = jax.lax.scan(step, (s0, t0, q0), jnp.arange(1, n))
    # u = 0 seeds the stack implicitly (s0/t0 zeros), so scan starts at 1.

    # evaluation: k(x) = index of last stack entry with t[k] <= x
    idx_k = jnp.arange(n)[None, :]
    t_masked = jnp.where(idx_k <= q[:, None], t, jnp.int32(2**31 - 1))
    xs = jnp.arange(n, dtype=jnp.int32)

    def per_line(tl, sl):
        k = jnp.searchsorted(tl, xs, side="right") - 1
        k = jnp.clip(k, 0, n - 1)
        return sl[k]

    centers = jax.vmap(per_line)(t_masked, s)  # int32[L, n]
    x = xs[None, :]
    gv = jnp.take_along_axis(g2l, centers, axis=1)
    d2 = (x - centers) ** 2 + gv
    d2 = jnp.where(d2 >= MISS, jnp.int32(MAX_OBSTACLE_DISTANCE), d2)
    out_sites = jnp.take_along_axis(sites, centers, axis=1)
    return d2, out_sites


def exact_separable(packed_flat: jnp.ndarray, dims: Dims) -> jnp.ndarray:
    """Exact 3D EDT via three separable passes (the PBA algorithm's math,
    reformulated: phase 1 = two axis scans, phases 2/3 = batched lower
    envelopes). Returns packed nearest-obstacle coords like the PBA kernels.

    Replaces parallelBanding3D (DistanceVoxelMap.hpp:279) with identical
    results; tests cross-check against the brute-force oracle.
    """
    dx, dy, dz = dims
    grid = packed_flat.reshape(dz, dy, dx)
    ox, oy, oz = unpack(grid)
    is_site = squared_distance_grid(packed_flat, dims).reshape(dz, dy, dx) == 0

    # --- phase 1: nearest site along Z per (y, x) column (two scans) -------
    BIG = jnp.int32(2**30)
    zidx = jax.lax.broadcasted_iota(jnp.int32, (dz, dy, dx), 0)
    site_z = jnp.where(is_site, zidx, BIG)

    def fwd(carry, row):
        best = jnp.where(row < BIG, row, carry)
        return best, best

    _, down = jax.lax.scan(fwd, jnp.full((dy, dx), BIG), site_z)
    _, up = jax.lax.scan(fwd, jnp.full((dy, dx), BIG), site_z[::-1])
    up = up[::-1]
    dd = jnp.where(down < BIG, (zidx - down) ** 2, MAX_OBSTACLE_DISTANCE)
    du = jnp.where(up < BIG, (up - zidx) ** 2, MAX_OBSTACLE_DISTANCE)
    take_down = dd <= du
    near_z = jnp.where(take_down, down, up)
    g2 = jnp.where(jnp.minimum(dd, du) < MAX_OBSTACLE_DISTANCE,
                   (zidx - near_z) ** 2, MAX_OBSTACLE_DISTANCE).astype(jnp.int32)
    # carry packed (x, y, near_z) as the site payload
    px = jax.lax.broadcasted_iota(jnp.int32, (dz, dy, dx), 2)
    py = jax.lax.broadcasted_iota(jnp.int32, (dz, dy, dx), 1)
    near_z_c = jnp.clip(near_z, 0, PBA_UNINITIALISED_COORD)
    site1 = pack(px.astype(jnp.uint32), py.astype(jnp.uint32), near_z_c.astype(jnp.uint32)).astype(jnp.int32)

    # --- phase 2: envelope along Y (lines are (z, x) pairs) ----------------
    # reorder [Z,Y,X] -> [Z*X, Y]
    g2_y = jnp.transpose(g2, (0, 2, 1)).reshape(dz * dx, dy)
    s_y = jnp.transpose(site1, (0, 2, 1)).reshape(dz * dx, dy)
    d2_y, s2_y = _envelope_pass_1d(g2_y, s_y)
    d2 = jnp.transpose(d2_y.reshape(dz, dx, dy), (0, 2, 1))
    s2 = jnp.transpose(s2_y.reshape(dz, dx, dy), (0, 2, 1))

    # --- phase 3: envelope along X (lines are (z, y) pairs) ----------------
    g2_x = d2.reshape(dz * dy, dx)
    s_x = s2.reshape(dz * dy, dx)
    d3_x, s3_x = _envelope_pass_1d(g2_x, s_x)
    s3 = s3_x.reshape(dz, dy, dx)
    d3 = d3_x.reshape(dz, dy, dx)

    # assemble packed coords: phase-2/3 sites carry (orig_x, y*, z*) packed;
    # the final x* is the envelope argmin's own x coordinate
    sx, sy, sz = unpack(s3.astype(jnp.uint32))
    # s3 rows came from lines along X: the argmin position within the line is
    # encoded by the site's x field of THAT column's phase-2 payload; x of
    # the payload is the column x it came from, which is exactly x*.
    out = pack(sx, sy, sz)
    uninit = d3 >= MAX_OBSTACLE_DISTANCE
    out = jnp.where(uninit, jnp.uint32(PBA_UNINITIALISED_PACKED), out)
    return out.reshape(-1)


def differences(packed_a: jnp.ndarray, packed_b: jnp.ndarray, dims: Dims) -> jnp.ndarray:
    """differences3D (DistanceVoxelMap.hpp:723): count voxels whose squared
    obstacle distances disagree."""
    da = squared_distance_grid(packed_a, dims)
    db = squared_distance_grid(packed_b, dims)
    return jnp.sum(da != db, dtype=jnp.uint32)


def extract_byte_distances(packed_flat: jnp.ndarray, dims: Dims, robot_radius: int = 0) -> jnp.ndarray:
    """extract_distances thrust functor (DistanceVoxel.h:154-205): int8
    free-space per voxel = clamp(sqrt(d2) - robot_radius? , ..., 127).

    The reference returns min(127, floor(sqrt(d2))) and flags obstacle cells
    with 0; robot_radius shifts the usable free space."""
    d2 = squared_distance_grid(packed_flat, dims).astype(jnp.float32)
    free = jnp.floor(jnp.sqrt(jnp.where(d2 >= MAX_OBSTACLE_DISTANCE, jnp.float32(127 * 127), d2)))
    free = jnp.clip(free - robot_radius, 0, 127)
    return free.astype(jnp.int8).reshape(-1)


def manhattan_distance(obstacle_mask_flat: jnp.ndarray, dims: Dims, cap: int = 32767) -> jnp.ndarray:
    """Exact separable L1 distance transform (init_floodfill analogue,
    DistanceVoxelMap.h getManhattanDistances): 2 directional scans per axis."""
    dx, dy, dz = dims
    big = I32(cap)
    d = jnp.where(obstacle_mask_flat.reshape(dz, dy, dx), I32(0), big)

    def sweep(dist, axis):
        def fwd(carry, row):
            carry = jnp.minimum(carry + 1, row)
            return carry, carry

        moved = jnp.moveaxis(dist, axis, 0)
        _, f = jax.lax.scan(fwd, jnp.full(moved.shape[1:], big, I32), moved)
        _, b = jax.lax.scan(fwd, jnp.full(moved.shape[1:], big, I32), moved[::-1])
        out = jnp.minimum(f, b[::-1])
        return jnp.moveaxis(out, 0, axis)

    for axis in (0, 1, 2):
        d = sweep(d, axis)
    return jnp.minimum(d, big).reshape(-1)
