#!/usr/bin/env python3
"""Drive the voxel engine's sense -> insert -> collide -> distance loop once on
one GPU, through its public entry points at the reference's sizes, and check
every result.

    python chip_smoke.py [--seed N]     # one GPU: phases 1-7
    python chip_smoke.py --four-cards   # only the multi-device paths, on 4 GPUs

All inputs are generated from --seed. Each phase prints one line: its first
call (compilation included), its steady time (median of 5 calls after the
first, each ended by block_until_ready), its check against the reference with
the number of differing elements, and the card. The script exits non-zero and
prints no result when JAX finds no GPU or any check fails; otherwise its last
line is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Sizes:
    link_dims: tuple = (128, 128, 128)  # gvl_linkage_test
    cloud_dims: tuple = (512, 512, 512)
    cloud_points: int = 307_200  # one 640x480 frame
    sensor_dims: tuple = (256, 256, 256)
    image: tuple = (480, 640)  # (h, w)
    frames: int = 8
    sv_dims: tuple = (256, 256, 256)
    sv_steps: int = 64
    edt_dims: tuple = (512, 512, 512)
    edt_obstacles: int = 20_000
    edt_checks: int = 1_000
    val_dims: tuple = (1024, 1024, 1024)
    val_env_points: int = 200_000
    val_poses: int = 315
    reps: int = 5


FULL = Sizes()
# the same phases at a size the CPU test suite can afford
TINY = Sizes(
    cloud_dims=(32, 32, 32), cloud_points=2_000, sensor_dims=(32, 32, 32),
    image=(48, 64), frames=2, sv_dims=(32, 32, 32), sv_steps=8,
    edt_dims=(24, 24, 24), edt_obstacles=20, edt_checks=50,
    val_dims=(64, 64, 64), val_env_points=4_000, val_poses=16, reps=1,
)
SENSOR_EXTENT = 5.12  # metres covered by the sensor / swept-volume maps


def _block(x):
    import jax

    return jax.block_until_ready(x)


def timed(fn, reps: int):
    """(result of the first call, first-call seconds, steady seconds)."""
    t0 = time.perf_counter()
    out = _block(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn())
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times) if times else first


def _line(n, name, first, steady, check, card, unit_div=1, unit="call"):
    return (
        f"phase {n} {name}: first {first:.3f} s (compile included), steady "
        f"{steady / unit_div * 1e3:.3f} ms/{unit}; {check}; card: {card}"
    )


def _cpu():
    import jax

    return jax.default_device(jax.devices("cpu")[0])


# -- phase 1 ------------------------------------------------------------------
def phase_linkage(sz: Sizes, seed: int, card: str) -> str:
    """gvl_linkage_test through the GpuVoxels facade: two overlapping box
    clouds in 128^3 prob maps collide in exactly 20^3 = 8000 voxels."""
    from gpu_voxels_jax.api import GpuVoxels
    from gpu_voxels_jax.constants import BitVoxelMeaning, MapType

    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(*sz.link_dims, 0.01)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "a")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "b")
    occ = BitVoxelMeaning.eBVM_OCCUPIED
    gvl.insert_box_into_map((0.4, 0.4, 0.4), (0.8, 0.8, 0.8), "a", occ, 1)
    gvl.insert_box_into_map((0.2, 0.2, 0.2), (0.6, 0.6, 0.6), "b", occ, 1)
    count, first, steady = timed(
        lambda: gvl.get_map("a").collide_with(gvl.get_map("b"), 0.1), sz.reps
    )
    count = int(count)
    assert count == 8000, f"linkage count {count} != 8000"
    return _line(1, "linkage 128^3", first, steady, f"count {count} == 8000 (0 differing)", card)


# -- phase 2 ------------------------------------------------------------------
def voxel_set(points: np.ndarray, side: float, dims) -> np.ndarray:
    """NumPy oracle: sorted unique linear indices of the in-map voxels hit by
    float32 points (the same float32 floor(p * (1/side)) as the library)."""
    recip = np.float32(1.0 / float(side))
    c = np.floor(points.astype(np.float32) * recip).astype(np.int64)
    ok = np.all((c >= 0) & (c < np.asarray(dims)), axis=1)
    c = c[ok]
    return np.unique(c[:, 2] * dims[0] * dims[1] + c[:, 1] * dims[0] + c[:, 0])


def phase_insert_collide(sz: Sizes, seed: int, card: str) -> str:
    """Two 307,200-point clouds inserted into 512^3 prob maps and collided;
    the count equals the NumPy voxel-set intersection."""
    import jax.numpy as jnp

    from gpu_voxels_jax.maps.voxelmap import ProbVoxelMap

    rng = np.random.default_rng(seed)
    dims = sz.cloud_dims
    hi = np.asarray(dims, np.float32)
    # a dense block shared by both clouds plus independent uniform points
    p1 = rng.uniform(0, 1, (sz.cloud_points, 3)).astype(np.float32) * hi
    p2 = rng.uniform(0, 1, (sz.cloud_points, 3)).astype(np.float32) * hi
    block = (rng.uniform(0.3, 0.45, (sz.cloud_points // 2, 3)) * hi).astype(np.float32)
    p1[: len(block)] = block
    p2[: len(block)] = block + np.float32(0.5)
    j1, j2 = jnp.asarray(p1), jnp.asarray(p2)

    def cycle():
        m1 = ProbVoxelMap.create(dims, 1.0).insert_point_cloud(j1)
        m2 = ProbVoxelMap.create(dims, 1.0).insert_point_cloud(j2)
        return m1.collide_with(m2, 0.5)

    count, first, steady = timed(cycle, sz.reps)
    count = int(count)
    want = len(np.intersect1d(voxel_set(p1, 1.0, dims), voxel_set(p2, 1.0, dims)))
    assert count == want and want > 0, f"collide count {count} != oracle {want}"
    return _line(
        2, f"insert->collide {dims[0]}^3", first, steady,
        f"count {count} == NumPy oracle {want} ({abs(count - want)} differing)", card,
    )


# -- phase 3 ------------------------------------------------------------------
def _scene(sz: Sizes):
    """Sensor, robot boxes and the carve's geometry at the sensor map size."""
    from gpu_voxels_jax.sensors import Sensor

    h, w = sz.image
    k = w / 640.0
    sensor = Sensor(
        position=np.array([2.56, 2.56, 0.1], np.float32),
        data_width=w, data_height=h, fx=525.0 * k, fy=525.0 * k,
        cx=(w - 1) / 2.0, cy=(h - 1) / 2.0,
    )
    side = SENSOR_EXTENT / sz.sensor_dims[0]
    return sensor, side


def _box(lo, hi, step):
    ax = [np.arange(lo[i], hi[i], step, dtype=np.float32) for i in range(3)]
    return np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)


def depth_frames(sensor, n: int, rng) -> list:
    """A wall at 4 m, a box moving across at 2.5 m, the robot's front face
    at 1.01 m (where the cut-out robot box projects) and an invalid patch."""
    h, w = sensor.data_height, sensor.data_width
    frames = []
    for t in range(n):
        d = np.full((h, w), 4.0, np.float32)
        x0 = int((0.2 + 0.05 * t) * w) % (w // 2)
        d[h // 4: 3 * h // 4, x0: x0 + w // 3] = 2.5
        u0, u1 = (int(sensor.fx * (x - 2.56) / 1.01 + sensor.cx) for x in (2.40, 2.70))
        v0, v1 = (int(sensor.fy * (y - 2.56) / 1.01 + sensor.cy) for y in (2.40, 2.70))
        d[v0:v1, u0:u1] = 1.01
        d[: h // 16, : w // 16] = 0.0  # invalid measurements carve nothing
        d += rng.normal(0, 0.003, (h, w)).astype(np.float32) * (d > 0)
        frames.append(d)
    return frames


def carve_margin_ulps(idx, frames, sensor, side, dims) -> np.ndarray:
    """For flat voxel indices idx: the smallest distance, in float32 ulps, of
    any of the carve's float decisions (pixel column, pixel row, depth test)
    to its boundary over the frames, with the carve's float32 arithmetic
    replayed in NumPy. A voxel that two backends carve differently must sit
    within rounding of a boundary: its margin is at most 1 ulp."""
    f32 = np.float32
    dx, dy, _ = dims
    idx = np.asarray(idx, np.int64)
    z, rem = np.divmod(idx, dx * dy)
    y, x = np.divmod(rem, dx)
    pose = np.asarray(sensor.pose(), f32)
    rot_t, org = pose[:3, :3].T, pose[:3, 3]
    s = f32(side)
    wv = [(c.astype(f32) + f32(0.5)) * s - org[i] for i, c in enumerate((x, y, z))]
    sx, sy, sz = (rot_t[r, 0] * wv[0] + rot_t[r, 1] * wv[1] + rot_t[r, 2] * wv[2] for r in range(3))
    safe = np.where(sz > f32(1e-6), sz, f32(1.0))
    ur = f32(sensor.fx) * sx / safe + f32(sensor.cx)
    vr = f32(sensor.fy) * sy / safe + f32(sensor.cy)
    h, w = frames[0].shape
    ui = np.clip(np.floor(ur).astype(np.int64), 0, w - 1)
    vi = np.clip(np.floor(vr).astype(np.int64), 0, h - 1)

    def ulps(v, boundary):
        return np.abs(v - boundary) / np.spacing(np.maximum(np.abs(v), np.abs(boundary)))

    best = np.minimum(ulps(ur, np.round(ur)), ulps(vr, np.round(vr)))
    best = np.minimum(best, ulps(sz, f32(1e-6)))
    for d in frames:
        thr = d[vi, ui] - s  # the carve's eps of one voxel
        best = np.minimum(best, ulps(sz, thr))
    return best


def phase_sensor_loop(sz: Sizes, seed: int, card: str) -> str:
    """Provider fuses 8 depth frames into a 256^3 prob map (robot cut out),
    then the robot provider collides with it; once with the exact carve and
    once with carve_pool=8. Each result is compared with the same program
    on the CPU backend in this process."""
    import jax
    import jax.numpy as jnp

    from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
    from gpu_voxels_jax.providers import Provider

    rng = np.random.default_rng(seed)
    sensor, side = _scene(sz)
    dims = sz.sensor_dims
    frames = depth_frames(sensor, sz.frames, rng)
    cut_pts = _box((2.40, 2.40, 1.10), (2.70, 2.70, 1.50), side / 2)
    rob_pts = _box((1.80, 2.20, 2.50), (2.40, 2.90, 2.70), side / 2)
    n = dims[0] * dims[1] * dims[2]

    def run(pool):
        frames_dev = [jnp.asarray(f) for f in frames]
        cut = BitVectorVoxelMap.create(dims, side).insert_point_cloud(cut_pts)
        env = Provider("env", carve_pool=pool)
        env.init(ProbVoxelMap.create(dims, side))
        for f in frames_dev:
            env.new_sensor_data(f, sensor, robot_map=cut)
        rob = Provider("robot")
        rob.init(BitVectorVoxelMap.create(dims, side).insert_point_cloud(rob_pts))
        rob.set_collide_with(env, coll_threshold=0.7)
        return env.map.data, rob.collide_async()

    lines = []
    for pool in (1, 8):
        (occ, count), first, steady = timed(lambda: run(pool), sz.reps)
        with _cpu():
            occ_c, count_c = jax.device_get(run(pool))
        occ, count = np.asarray(occ), int(count)
        diff = np.flatnonzero(occ != occ_c)
        margins = carve_margin_ulps(diff, frames, sensor, side, dims)
        worst = float(margins.max()) if len(diff) else 0.0
        assert len(diff) <= n // 1_000_000, f"carve differs in {len(diff)} of {n} voxels"
        assert worst <= 1.0, f"a differing voxel sits {worst:.2f} ulps from its boundary"
        assert count == int(count_c) and count > 0, f"robot collide {count} != CPU {int(count_c)}"
        lines.append(_line(
            3, f"sensor loop {sz.image[1]}x{sz.image[0]} -> {dims[0]}^3 carve_pool={pool}",
            first, steady,
            f"robot collide {count} == CPU; occupancy differs from CPU in {len(diff)} "
            f"of {n} voxels, each within {worst:.2f} ulp of its boundary",
            card, unit_div=sz.frames, unit="frame",
        ))
    return "\n".join(lines)


# -- phase 4 ------------------------------------------------------------------
def ur10_swept_pair(sz: Sizes, seed: int):
    """A function building two 64-step UR10 swept volumes (the second robot
    0.8 m along x, running the mirrored trajectory) in sv_dims bit maps."""
    import jax.numpy as jnp

    from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap
    from gpu_voxels_jax.robot.presets import ur_robot
    from gpu_voxels_jax.robot.swept_volume import insert_swept_volume_batched

    side = SENSOR_EXTENT / sz.sv_dims[0]
    dims = sz.sv_dims
    chain = ur_robot("ur10", spacing=0.02)

    class Placed:
        def __init__(self, base):
            self.base = jnp.asarray(base, jnp.float32)

        def transformed_clouds_for(self, cfg):
            c = chain.transformed_clouds_for(jnp.concatenate([cfg, jnp.zeros((1,), jnp.float32)]))
            return dataclasses.replace(c, points=c.points + self.base)

    rng = np.random.default_rng(seed)
    jitter = rng.uniform(-0.05, 0.05, 6).astype(np.float32)
    traj_a = np.linspace([0.3, -0.5, 0.5, 0, 0, 0], [-1.2, -0.2, 1.0, 0.4, 0.3, 0],
                         sz.sv_steps).astype(np.float32) + jitter
    traj_b = traj_a[::-1] * np.float32(-1.0)

    def build():
        a = insert_swept_volume_batched(
            BitVectorVoxelMap.create(dims, side), Placed([2.56, 2.56, 0.5]), traj_a)
        b = insert_swept_volume_batched(
            BitVectorVoxelMap.create(dims, side), Placed([3.36, 2.56, 0.5]), traj_b)
        return a, b

    return build


def phase_swept_volume(sz: Sizes, seed: int, card: str) -> str:
    """64-step UR10 swept volume into a 256^3 BitVectorVoxelMap, then
    collideWithTypes against a second UR10's swept volume at margin 0 and 8.
    Count, meanings and marked plane equal the CPU backend's."""
    import jax

    build = ur10_swept_pair(sz, seed)

    def run():
        a, b = build()
        return [a.collide_with_types(b, sv_window=m) for m in (0, 8)]

    out, first, steady = timed(run, sz.reps)
    with _cpu():
        ref = jax.device_get(run())
    checks = []
    for (cnt, mean, marked), (cnt_c, mean_c, marked_c), m in zip(out, ref, (0, 8)):
        nd_mean = int((np.asarray(mean) != np.asarray(mean_c)).sum())
        nd_mark = int((np.asarray(marked.data[0]) != np.asarray(marked_c.data[0])).sum())
        assert int(cnt) == int(cnt_c) and nd_mean == 0 and nd_mark == 0, (
            f"margin {m}: count {int(cnt)} vs CPU {int(cnt_c)}, {nd_mean} meaning words "
            f"and {nd_mark} marked-plane words differ")
        checks.append(f"margin {m}: count {int(cnt)} == CPU, meanings and marked plane "
                      f"identical (0 differing)")
    assert int(out[1][0]) > 0, "the two swept volumes never meet"
    return _line(4, f"UR10 {sz.sv_steps}-step swept volume {sz.sv_dims[0]}^3", first, steady,
                 "; ".join(checks), card)


# -- phase 5 ------------------------------------------------------------------
def phase_edt(sz: Sizes, seed: int, card: str) -> str:
    """Exact EDT (DistanceVoxelMap.parallel_banding) at 512^3 with 20k
    obstacles: identical to the plain full-scan pipeline on the same device,
    and equal to a NumPy brute force on 1,000 random voxels."""
    import jax.numpy as jnp

    from gpu_voxels_jax.maps.distance_map import DistanceVoxelMap
    from gpu_voxels_jax.ops import edt, edt_envelope

    rng = np.random.default_rng(seed)
    dims = sz.edt_dims
    obs = np.unique(rng.integers(0, dims[0], (sz.edt_obstacles, 3)), axis=0)
    m = DistanceVoxelMap.create(dims).insert_point_cloud(obs.astype(np.float32) + 0.5)
    pba, first, steady = timed(m.parallel_banding, sz.reps)
    ref = edt_envelope.parallel_banding_reference(m.data, dims)
    got = np.asarray(pba.data)
    n_diff = int((got != np.asarray(ref)).sum())
    assert n_diff == 0, f"EDT differs from the full-scan reference in {n_diff} voxels"

    q = rng.integers(0, dims[0], (sz.edt_checks, 3))
    lin = q[:, 2] * dims[0] * dims[1] + q[:, 1] * dims[0] + q[:, 0]
    d2 = np.asarray(edt.squared_distance_grid(jnp.asarray(got), dims)).reshape(-1)[lin]
    want = np.empty(len(q), np.int64)
    for i in range(0, len(q), 100):
        dd = obs[None, :, :] - q[i: i + 100, None, :]
        want[i: i + 100] = (dd * dd).sum(-1).min(1)
    n_bad = int((d2.astype(np.int64) != want).sum())
    assert n_bad == 0, f"{n_bad} of {len(q)} sampled distances differ from brute force"
    return _line(
        5, f"exact EDT {dims[0]}^3 / {len(obs)} obstacles", first, steady,
        f"packed sites == full-scan reference ({n_diff} differing); "
        f"{len(q)} sampled distances == NumPy brute force ({n_bad} differing)", card,
    )


# -- phase 6 ------------------------------------------------------------------
def phase_validity(sz: Sizes, seed: int, card: str) -> str:
    """315 robot poses against a 1024^3 HierarchicalBitMap through
    planning.validity; colliding-voxel counts equal a NumPy oracle."""
    from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_jax.maps.hierarchical import HierarchicalBitMap
    from gpu_voxels_jax.planning.validity import HierarchicalValidityChecker

    rng = np.random.default_rng(seed)
    dims = sz.val_dims
    n = dims[0]
    half = sz.val_env_points // 2
    env_pts = np.concatenate([
        rng.uniform(0, n, (half, 3)),
        rng.uniform(0.44 * n, 0.56 * n, (half, 3)),  # a dense obstacle block
    ]).astype(np.float32)
    env = HierarchicalBitMap.create(dims).insert_point_cloud(env_pts)
    robot_pts = rng.uniform(-4, 4, (400, 3)).astype(np.float32)
    robot = MetaPointCloud.from_clouds([robot_pts], names=("body",))

    class Translated:
        def transformed_clouds_for(self, cfg):
            return dataclasses.replace(robot, points=robot.points + cfg)

    k = sz.val_poses // 2
    states = np.concatenate([
        rng.uniform(0.1 * n, 0.9 * n, (sz.val_poses - k, 3)),
        rng.uniform(0.42 * n, 0.58 * n, (k, 3)),
    ]).astype(np.float32)
    checker = HierarchicalValidityChecker(env, Translated())
    got, first, steady = timed(lambda: checker.batch_colliding_voxels(states), sz.reps)
    env_set = voxel_set(env_pts, 1.0, dims)
    want = np.array([np.isin(voxel_set(robot_pts + s, 1.0, dims), env_set).sum() for s in states])
    n_diff = int((np.asarray(got) != want).sum())
    assert n_diff == 0 and want.sum() > 0, f"{n_diff} of {len(states)} pose counts differ"
    return _line(
        6, f"motion validity {n}^3, {len(states)} poses", first, steady,
        f"{int((want > 0).sum())} colliding poses, counts == NumPy oracle ({n_diff} differing)",
        card,
    )


# -- phase 7 ------------------------------------------------------------------
class _Tally:
    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_card_tier(card: str) -> str:
    """The card-only test tier (tests_gpu/, marker `gpu`), in this process."""
    import pytest

    tally = _Tally()
    t0 = time.perf_counter()
    rc = pytest.main([str(REPO / "tests_gpu"), "-q", "-p", "no:cacheprovider"], plugins=[tally])
    c = tally.counts
    assert rc == 0 and c["failed"] == 0 and c["skipped"] == 0 and c["passed"] > 0, (
        f"card tier: rc {rc}, {c}")
    return (f"phase 7 card tier: {c['passed']} passed, 0 failed, 0 skipped in "
            f"{time.perf_counter() - t0:.1f} s; card: {card}")


PHASES = (phase_linkage, phase_insert_collide, phase_sensor_loop,
          phase_swept_volume, phase_edt, phase_validity)


def nvidia_smi() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's backend is {jax.default_backend()!r}", file=sys.stderr)
        return 2
    cards = nvidia_smi()
    print("\n".join(cards), flush=True)
    card = cards[0]
    sys.path.insert(0, str(REPO))
    from gpu_voxels_jax.utils.jitcache import enable_persistent_cache

    enable_persistent_cache()
    devices = jax.devices()
    if args.four_cards:
        import __graft_entry__

        assert len(devices) >= 4, f"--four-cards needs 4 GPUs, JAX sees {len(devices)}"
        devices = devices[:4]
        t0 = time.perf_counter()
        __graft_entry__.check_multichip(devices, __graft_entry__.FULL_SIZES, args.seed)
        print(f"four-card paths equal the single-card results in "
              f"{time.perf_counter() - t0:.1f} s; cards: {'; '.join(cards[:4])}", flush=True)
    else:
        for phase in PHASES:
            print(phase(FULL, args.seed, card), flush=True)
        print(phase_card_tier(card), flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
