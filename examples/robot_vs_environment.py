"""Port of examples/RobotVsEnvironment.cpp:163-201: the LIVE sensor loop.

A StreamingDepthSource paces Kinect-shaped frames at real sensor cadence
(helpers/Kinect.h:36-70 latest-wins contract); every frame drives the public
API end-to-end, fused into ONE compiled program per frame (maps
are jittable pytrees and the @compiled methods inline — SURVEY §2.4's
whole-cycle-jit prescription; the reference makes the same calls as separate
kernel launches, RobotVsEnvironment.cpp:163-201):

    source.wait_for_frame      -> frame due at cadence (latest wins)
    frame_step (one dispatch)  -> ProbVoxelMap.insert_depth_image (EXACT
                                  per-pixel carve, reference insertSensorData
                                  semantics) + DH FK + BitVectorVoxelMap
                                  insert + collide count
    counts fetch in batches    -> host fetches overlap the next frames'
                                  device compute
    Provider.visualize         -> AsyncVisPublisher (latest-wins worker
                                  thread = the reference's cheap IPC publish;
                                  vis_max_cubes bounds each snapshot fetch)

The default scene is the reference's: 640x480 frames into a 256^3 map.
full_size=False shrinks it to 64x48 into 64^3 so the CPU test suite stays
fast. Depth frames are pre-staged on device, so the loop measures the
pipeline and not the frame upload.
"""
import time

import numpy as np
import jax
import jax.numpy as jnp

from gpu_voxels_jax.geometry.pointcloud import MetaPointCloud
from gpu_voxels_jax.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_jax.providers import Provider
from gpu_voxels_jax.robot.dh import DHParameters, KinematicChain
from gpu_voxels_jax.sensors import Sensor, StreamingDepthSource

def make_robot(reach: float):
    seg = reach / 2.0
    params = [DHParameters(0, 0, seg, 0), DHParameters(0, 0, seg, 0)]
    clouds = MetaPointCloud.from_clouds(
        [np.linspace([0.05 * seg, 0, 0], [0.95 * seg, 0, 0], 27).astype(np.float32)] * 2,
        names=("link1", "link2"),
    )
    return KinematicChain(["link1", "link2"], params, clouds)


def make_frames(sensor: Sensor, n: int = 8, seed: int = 0):
    """A short synthetic recording (moving box in front of a wall), staged on
    device once — the StreamingDepthSource then replays it at cadence."""
    rng = np.random.default_rng(seed)
    h, w = sensor.data_height, sensor.data_width
    frames = []
    for t in range(n):
        d = np.full((h, w), 4.0, np.float32)
        x0 = int((0.2 + 0.05 * t) * w) % (w // 2)
        d[h // 4 : 3 * h // 4, x0 : x0 + w // 3] = 2.5
        d += rng.normal(0, 0.003, (h, w)).astype(np.float32)
        frames.append(jnp.asarray(d))
    return frames


def main(frames: int = None, hz: float = None, live_vis: bool = False,
         fetch_every: int = 8, full_size: bool = True):
    if full_size:
        dims, side = (256, 256, 256), 0.02
        sensor = Sensor(position=np.array([2.56, 2.56, 0.1], np.float32))
        n_frames = 60 if frames is None else frames
        # RealSense-class 60 Hz source; latest-wins drops what the loop
        # can't keep up with
        hz = 60.0 if hz is None else hz
    else:
        dims, side = (64, 64, 64), 0.05
        sensor = Sensor(
            position=np.array([1.6, 1.6, 0.1], np.float32),
            data_width=64, data_height=48, fx=52.5, fy=52.5, cx=31.5, cy=23.5,
        )
        n_frames = 6 if frames is None else frames
        hz = 120.0 if hz is None else hz  # don't let a CPU test sleep at 30 Hz

    source = StreamingDepthSource(make_frames(sensor), hz=hz)

    # publish budget: each viewer snapshot fetch is O(max_cubes), so the
    # worker's readbacks cannot monopolize the host link against the loop
    env = Provider("env", carve_pool=1, live_vis=live_vis, vis_max_cubes=65536)
    env.init(ProbVoxelMap.create(dims, side))

    extent = dims[0] * side
    robot = make_robot(reach=0.45 * extent)
    base = jnp.asarray([extent / 2, extent / 2, extent / 2], jnp.float32)

    rob = Provider("robot", live_vis=live_vis, vis_max_cubes=65536)
    rob.set_collide_with(env, coll_threshold=0.7)

    # THE frame program: the whole sense -> insert -> FK -> insert -> collide
    # cycle traces into ONE compiled program (SURVEY's whole-cycle-jit
    # prescription; the @compiled map methods inline). The camera is fixed,
    # so the closed-over sensor pose becomes a compile-time constant — one
    # dispatch per frame instead of three.
    @jax.jit
    def frame_step(env_map, depth, joints):
        env2 = env_map.insert_depth_image(depth, sensor)
        clouds = robot.transformed_clouds_for(joints)
        rob2 = BitVectorVoxelMap.create(dims, side).insert_point_cloud(
            clouds.points + base
        )
        return env2, rob2, rob2.collide_with(env2, 0.7)

    # warm the compile caches outside the timed loop, including the count-batch stack program and the publish path's
    # compaction/gather buckets
    e0, r0, c0 = frame_step(
        env.map, source._frames[0], jnp.zeros((2,), jnp.float32)
    )
    np.asarray(jnp.stack([c0] * fetch_every))
    env.map, rob.map = e0, r0
    if live_vis:
        env.visualize()
        rob.visualize()
        env.finish_visualization()
        rob.finish_visualization()
    env.init(ProbVoxelMap.create(dims, side))

    def _stash(batch, stacks):
        arr = jnp.stack(batch)
        try:
            arr.copy_to_host_async()  # overlap the fetch with compute
        except Exception:
            pass  # backend without async host copies: fetched at the end
        stacks.append(arr)

    stacks, pending, processed = [], [], 0
    t0 = time.perf_counter()
    for i in range(n_frames):
        depth = source.wait_for_frame(timeout_s=2.0 / hz + 0.5)
        if depth is None:
            continue
        env.map, rob.map, cnt = frame_step(
            env.map, depth, jnp.asarray([i * 0.1, i * 0.05], jnp.float32)
        )
        pending.append(cnt)
        if live_vis:
            # O(1) async publish (latest-wins mailbox); headless runs skip
            # visualization entirely — the sync VisProvider export is the
            # offline/pull path, not a per-frame producer cost
            env.visualize()
            rob.visualize()
        processed += 1
        if len(pending) >= fetch_every:
            _stash(pending, stacks)
            pending = []
    # force the LAST frame's count before the clock stops: every frame's
    # insert/collide chains on the previous one, so this syncs the pipeline
    if pending or stacks:
        int(pending[-1] if pending else stacks[-1][-1])
    elapsed = time.perf_counter() - t0
    if pending:
        _stash(pending, stacks)
    counts = [int(v) for a in stacks for v in np.asarray(a)] or [0]
    sustained = processed / elapsed

    painted = env.finish_visualization() + rob.finish_visualization() if live_vis else 0
    print(
        f"{processed}/{n_frames} frames in {elapsed:.2f} s = {sustained:.1f} Hz "
        f"sustained (source cadence {hz:.0f} Hz, exact carve, "
        f"collisions min/max {min(counts)}/{max(counts)}"
        + (f", {painted} snapshots painted" if live_vis else "")
        + ")"
    )
    return {"sustained_hz": sustained, "processed": processed, "counts": counts,
            "painted": painted}


if __name__ == "__main__":
    main(live_vis=True)
