"""Live visualizer process (reference: gpu_visualization/ viewer app).

The CUDA viewer is a separate process reading shared GPU memory; the
equivalent here is a separate process reading the VisProvider's published
snapshots. `python -m gpu_voxels_jax.vis.serve [dir] [port]` serves a
self-refreshing three.js page over HTTP: the library process keeps calling
`GpuVoxels.visualize_map` (or VisProvider.visualize) and the browser follows
along — same architecture, shared files instead of CUDA IPC.
"""
from __future__ import annotations

import json
import os
import sys
import time
from http.server import HTTPServer, SimpleHTTPRequestHandler
from pathlib import Path

# the live page re-reads the published snapshots this often
POLL_S = 1.0

INDEX = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>gpu_voxels_jax live</title>
<style>body{margin:0;background:#111;color:#eee;font-family:sans-serif}
#hud{position:absolute;top:8px;left:8px;z-index:2;background:#000a;padding:8px;border-radius:6px;max-width:320px}
#hud label{display:block;font-size:12px} #hud input[type=range]{width:120px;vertical-align:middle}
#maps label{display:inline-block;margin-right:8px}</style></head>
<body><div id="hud">gpu_voxels_jax live — <span id="status">loading</span>
  <div id="maps"></div>
  <div>slice <select id="axis"><option>none</option><option>x</option><option>y</option><option>z</option></select>
    min <input type="range" id="smin" min="0" max="1024" value="0">
    max <input type="range" id="smax" min="0" max="1024" value="1024"></div>
  <div>camera <span id="cams"></span></div>
  <div id="info" style="font-size:12px;color:#9cf">click a voxel to inspect</div>
</div>
<canvas id="c"></canvas>
<script>
// Self-contained fallback renderer: the primary path imports three.js from a
// CDN, which air-gapped deployments (and the reference's lab networks) may
// not reach. If the module script hasn't initialized shortly after load, draw
// the same published layers with a 2D-canvas isometric projection instead —
// map toggles, meaning colors/visibility, slicing and click-to-inspect keep
// working, only orbit shading is lost.
window.startFallback = function () {
  if (window.__fallback_on) return; window.__fallback_on = true;
  // own canvas: touching #c's context would break a late-arriving WebGL init
  document.getElementById('c').style.display = 'none';
  const canvas = document.createElement('canvas');
  document.body.appendChild(canvas);
  const ctx = canvas.getContext('2d');
  canvas.width = innerWidth; canvas.height = innerHeight;
  let layers = [], cfg = {}, mapVisible = {}, drawn = [];
  let yaw = Math.PI / 4, pitch = 0.6, zoom = 0, panX = 0, panY = 0;
  const axisSel = document.getElementById('axis');
  const smin = document.getElementById('smin'), smax = document.getElementById('smax');
  function proj(c, rot) {
    const x = c[0] * rot.ca - c[1] * rot.sa, y = c[0] * rot.sa + c[1] * rot.ca;
    return [x, y * rot.cp - c[2] * rot.sp, y * rot.sp + c[2] * rot.cp];
  }
  function draw() {
    ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
    const rot = {ca: Math.cos(yaw), sa: Math.sin(yaw), cp: Math.cos(pitch), sp: Math.sin(pitch)};
    const ax = {x: 0, y: 1, z: 2}[axisSel.value];
    const lo = +smin.value, hi = +smax.value;
    const colors = cfg.meaning_colors || {}, visible = cfg.meaning_visible || {};
    const pts = []; let total = 0, minX = 1e30, maxX = -1e30, minY = 1e30, maxY = -1e30;
    for (const layer of layers) {
      if (mapVisible[layer.name] === false) continue;
      layer.centers.forEach((c, i) => {
        const t = layer.types ? layer.types[i] : null;
        if (t !== null && visible[String(t)] === false) return;
        if (ax !== undefined && (c[ax] < lo || c[ax] > hi)) return;
        const p = proj(c, rot);
        const col = (t !== null && colors[String(t)]) ? colors[String(t)] : layer.colors[i];
        pts.push({p, col, layer, i, c, t});
        minX = Math.min(minX, p[0]); maxX = Math.max(maxX, p[0]);
        minY = Math.min(minY, p[2]); maxY = Math.max(maxY, p[2]);
        total++;
      });
    }
    drawn = [];
    if (total) {
      const s = Math.exp(zoom) * 0.8 * Math.min(
        canvas.width / Math.max(maxX - minX, 1e-6),
        canvas.height / Math.max(maxY - minY, 1e-6));
      const ox = canvas.width / 2 - s * (minX + maxX) / 2 + panX;
      const oy = canvas.height / 2 + s * (minY + maxY) / 2 + panY;
      pts.sort((a, b) => a.p[1] - b.p[1]);
      for (const q of pts) {
        const px = ox + s * q.p[0], py = oy - s * q.p[2];
        const sz = q.layer.scales ? q.layer.scales[q.i] : q.layer.side;
        const r = Math.max(2, s * sz * 0.9);
        ctx.fillStyle = `rgb(${q.col[0]},${q.col[1]},${q.col[2]})`;
        ctx.fillRect(px - r / 2, py - r / 2, r, r);
        drawn.push({px, py, q});
      }
    }
    document.getElementById('status').textContent =
      `${layers.length} maps, ${total} cubes (offline 2D renderer)`;
  }
  canvas.addEventListener('mousemove', ev => {
    if (ev.buttons & 1) { yaw += ev.movementX * 0.01; pitch += ev.movementY * 0.01; draw(); }
  });
  canvas.addEventListener('wheel', ev => { zoom -= ev.deltaY * 0.001; draw(); ev.preventDefault(); });
  canvas.addEventListener('click', ev => {
    let best = null, bd = 144;
    for (const d of drawn) {
      const dd = (d.px - ev.clientX) ** 2 + (d.py - ev.clientY) ** 2;
      if (dd < bd) { bd = dd; best = d; }
    }
    const info = document.getElementById('info');
    if (!best) { info.textContent = 'click a voxel to inspect'; return; }
    const q = best.q, vox = q.c.map(v => Math.floor(v / q.layer.side));
    info.textContent = `${q.layer.name}: voxel (${vox.join(', ')}) center ` +
      `(${q.c.map(v => v.toFixed(3)).join(', ')})` + (q.t !== null ? ` meaning ${q.t}` : '');
  });
  [axisSel, smin, smax].forEach(e => e.oninput = draw);
  async function refresh() {
    try {
      try { cfg = await (await fetch('visconfig.json', {cache: 'no-store'})).json(); } catch (e) {}
      const manifest = await (await fetch('manifest.json', {cache: 'no-store'})).json();
      const ls = [];
      for (const name of manifest.maps) {
        const l = await (await fetch(name + '.cubes.json', {cache: 'no-store'})).json();
        l.name = name; ls.push(l);
      }
      layers = ls;
      const md = document.getElementById('maps'); md.innerHTML = '';
      layers.forEach(l => {
        const lab = document.createElement('label');
        const cb = document.createElement('input'); cb.type = 'checkbox';
        cb.checked = mapVisible[l.name] !== false;
        cb.onchange = () => { mapVisible[l.name] = cb.checked; draw(); };
        lab.appendChild(cb); lab.appendChild(document.createTextNode(l.name));
        md.appendChild(lab);
      });
      draw();
    } catch (e) { document.getElementById('status').textContent = 'waiting for data'; }
  }
  setInterval(refresh, __POLL_MS__); refresh();
};
setTimeout(() => { if (!window.__three_ok) window.startFallback(); }, 2500);
</script>
<script type="module">
import * as THREE from 'https://unpkg.com/three@0.160.0/build/three.module.js';
import {OrbitControls} from 'https://unpkg.com/three@0.160.0/examples/jsm/controls/OrbitControls.js';
window.__three_ok = true;  // imports resolved: stand the offline fallback down NOW
const renderer = new THREE.WebGLRenderer({canvas: document.getElementById('c')});
renderer.setSize(window.innerWidth, window.innerHeight);
const scene = new THREE.Scene();
const camera = new THREE.PerspectiveCamera(60, innerWidth/innerHeight, 0.01, 10000);
addEventListener('resize', () => {
  renderer.setSize(innerWidth, innerHeight);
  camera.aspect = innerWidth / innerHeight; camera.updateProjectionMatrix();
});
camera.position.set(40, 40, 40);
const controls = new OrbitControls(camera, renderer.domElement);
scene.add(new THREE.AmbientLight(0xffffff, 0.7));
const dl = new THREE.DirectionalLight(0xffffff, 1.2); dl.position.set(1,2,3); scene.add(dl);
let meshes = [], layersCache = [], cfg = {}, mapVisible = {};
const axisSel = document.getElementById('axis');
const smin = document.getElementById('smin'), smax = document.getElementById('smax');
function applyCfg() {
  // visconfig.json = the XMLInterpreter equivalent: colors per meaning,
  // visibility, slicing, camera presets, background
  if (cfg.background) renderer.setClearColor(new THREE.Color(...cfg.background.map(v=>v/255)));
  const cams = document.getElementById('cams'); cams.innerHTML = '';
  (cfg.cameras || []).forEach(c => {
    const b = document.createElement('button'); b.textContent = c.name;
    b.onclick = () => { camera.position.set(...c.position); controls.target.set(...c.target); controls.update(); };
    cams.appendChild(b);
  });
  if (cfg.slice && cfg.slice.axis) {
    axisSel.value = cfg.slice.axis;
    if (cfg.slice.min > -1e29) smin.value = cfg.slice.min;
    if (cfg.slice.max < 1e29) smax.value = cfg.slice.max;
  }
}
function rebuild() {
  meshes.forEach(m => scene.remove(m)); meshes = [];
  let total = 0;
  const ax = {x: 0, y: 1, z: 2}[axisSel.value];
  const lo = +smin.value, hi = +smax.value;
  const colors = (cfg.meaning_colors || {}), visible = (cfg.meaning_visible || {});
  for (const layer of layersCache) {
    if (mapVisible[layer.name] === false) continue;
    const keep = [];
    layer.centers.forEach((c, i) => {
      const t = layer.types ? layer.types[i] : 0;
      if (visible[String(t)] === false) return;
      if (ax !== undefined && (c[ax] < lo || c[ax] > hi)) return;
      keep.push(i);
    });
    // primitive-array layers (VisPrimitiveArray equivalent): unit geometry
    // scaled per instance by its own diameter; voxel layers: uniform cubes
    const geo = layer.prim === 'sphere'
      ? new THREE.SphereGeometry(0.5, 12, 8)
      : new THREE.BoxGeometry(layer.side, layer.side, layer.side);
    const mesh = new THREE.InstancedMesh(geo, new THREE.MeshLambertMaterial(), keep.length);
    const mtx = new THREE.Matrix4();
    keep.forEach((i, j) => {
      const c = layer.centers[i];
      if (layer.scales) {
        const s = layer.prim === 'sphere' ? layer.scales[i] : layer.scales[i] / layer.side;
        mtx.makeScale(s, s, s);
      } else { mtx.identity(); }
      mtx.setPosition(c[0], c[1], c[2]); mesh.setMatrixAt(j, mtx);
      const t = layer.types ? String(layer.types[i]) : null;
      const col = (t && colors[t]) ? colors[t] : layer.colors[i];
      mesh.setColorAt(j, new THREE.Color(col[0]/255, col[1]/255, col[2]/255));
    });
    mesh.userData = {name: layer.name, keep, layer};
    scene.add(mesh); meshes.push(mesh); total += keep.length;
  }
  document.getElementById('status').textContent = `${layersCache.length} maps, ${total} cubes`;
}
[axisSel, smin, smax].forEach(e => e.oninput = rebuild);
// click-to-inspect (the reference viewer's voxel inspection): raycast the
// instanced cubes, report map / voxel coords / meaning id
const raycaster = new THREE.Raycaster(), mouse = new THREE.Vector2();
renderer.domElement.addEventListener('click', ev => {
  mouse.x = (ev.clientX / innerWidth) * 2 - 1;
  mouse.y = -(ev.clientY / innerHeight) * 2 + 1;
  raycaster.setFromCamera(mouse, camera);
  const hits = raycaster.intersectObjects(meshes, false);
  const info = document.getElementById('info');
  if (!hits.length || hits[0].instanceId === undefined) { info.textContent = 'click a voxel to inspect'; return; }
  const h = hits[0], ud = h.object.userData, i = ud.keep[h.instanceId];
  const c = ud.layer.centers[i], side = ud.layer.side;
  const vox = c.map(v => Math.floor(v / side));
  const t = ud.layer.types ? ud.layer.types[i] : null;
  info.textContent = `${ud.name}: voxel (${vox.join(', ')}) center (${c.map(v=>v.toFixed(3)).join(', ')})` +
    (t !== null ? ` meaning ${t}` : '');
});
let cfgSeen = '';
async function refresh() {
  try {
    // re-apply the config only when its contents change — a 1 Hz re-apply
    // would snap the user's live slice/camera controls back every second
    try {
      const txt = await (await fetch('visconfig.json', {cache:'no-store'})).text();
      if (txt !== cfgSeen) { cfgSeen = txt; cfg = JSON.parse(txt); applyCfg(); }
    } catch (e) {}
    const manifest = await (await fetch('manifest.json', {cache: 'no-store'})).json();
    const layers = [];
    for (const name of manifest.maps) {
      const l = await (await fetch(name + '.cubes.json', {cache: 'no-store'})).json();
      l.name = name; layers.push(l);
    }
    layersCache = layers;
    const md = document.getElementById('maps');
    md.innerHTML = '';
    layers.forEach(l => {
      const lab = document.createElement('label');
      const cb = document.createElement('input'); cb.type = 'checkbox';
      cb.checked = mapVisible[l.name] !== false;
      cb.onchange = () => { mapVisible[l.name] = cb.checked; rebuild(); };
      lab.appendChild(cb); lab.appendChild(document.createTextNode(l.name));
      md.appendChild(lab);
    });
    rebuild();
  } catch (e) { document.getElementById('status').textContent = 'waiting for data'; }
}
setInterval(refresh, __POLL_MS__); refresh();
(function animate(){ requestAnimationFrame(animate); renderer.render(scene, camera); })();
</script></body></html>""".replace("__POLL_MS__", str(int(POLL_S * 1000)))


def _write_layer(out_dir, name: str, payload: dict) -> None:
    """Write one viewer layer + register it in the manifest."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cubes.json").write_text(json.dumps(payload))
    manifest = {"maps": [], "ts": time.strftime("%H:%M:%S")}
    mf = out / "manifest.json"
    if mf.exists():
        try:
            manifest["maps"] = json.loads(mf.read_text()).get("maps", [])
        except json.JSONDecodeError:
            pass
    if name not in manifest["maps"]:
        manifest["maps"].append(name)
    mf.write_text(json.dumps(manifest))


def publish_cubes(out_dir, name: str, m, threshold: float = 0.5, cubes=None) -> None:
    """Write a map snapshot consumable by the live viewer. `cubes` accepts a
    precomputed extract result — (centers, types) or (centers, types,
    scales) for multi-level octree cubes (extract_multilevel_cubes) —
    so publishers extract once for several writers."""
    import numpy as np

    from .export import colors_for
    from .extract import extract_cubes

    if cubes is None:
        cubes = extract_cubes(m, threshold)
    centers, types = cubes[0], cubes[1]
    payload = dict(
        side=float(m.side_length),
        centers=np.round(centers, 4).tolist(),
        colors=colors_for(types).tolist(),
        # per-voxel meaning ids: drive the viewer's meaning_colors /
        # meaning_visible config and click-to-inspect
        types=np.asarray(types).astype(np.int64).tolist(),
    )
    if len(cubes) > 2 and cubes[2] is not None:
        payload["scales"] = np.round(np.asarray(cubes[2], np.float64), 4).tolist()
    _write_layer(out_dir, name, payload)


def publish_distance_layer(out_dir, name: str, m, axis: str = "z", index=None) -> None:
    """Publish a distance-field gradient slice of a DistanceVoxelMap — the
    reference viewer's distance-dependent coloring
    (gpu_visualization/Visualizer.cu distance drawmodes). One voxel plane,
    each cell colored red (obstacle) through blue (far free space)."""
    import numpy as np

    from .export import distance_colors
    from .extract import extract_distance_slice

    coords, dist = extract_distance_slice(m, axis=axis, index=index)
    centers = (coords.astype(np.float64) + 0.5) * float(m.side_length)
    payload = dict(
        side=float(m.side_length),
        centers=np.round(centers, 4).tolist(),
        colors=distance_colors(dist).tolist(),
        values=np.round(dist.astype(np.float64), 4).tolist(),
    )
    _write_layer(out_dir, name, payload)


def publish_primitives(out_dir, name: str, prim) -> None:
    """Publish a PrimitiveArray overlay to the live viewer (the
    VisPrimitiveArray path, vis_interface/VisPrimitiveArray.h): spheres or
    cuboids at their positions, each scaled by its own diameter."""
    import numpy as np

    from ..primitive_array import PrimitiveType

    pd = np.asarray(prim.positions_diameters, np.float32)
    sphere = prim.prim_type == PrimitiveType.ePRIM_SPHERE
    color = [255, 170, 40] if sphere else [80, 200, 255]
    payload = dict(
        side=1.0,
        prim="sphere" if sphere else "cuboid",
        centers=np.round(pd[:, :3], 4).tolist(),
        scales=np.round(pd[:, 3], 4).tolist(),
        colors=[color] * len(pd),
    )
    _write_layer(out_dir, name, payload)


def serve(directory, port: int = 8321) -> None:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / "index.html").write_text(INDEX)

    class Handler(SimpleHTTPRequestHandler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, directory=str(d), **kwargs)

        def log_message(self, *args):
            pass

    print(f"serving {d} at http://localhost:{port}")
    HTTPServer(("0.0.0.0", port), Handler).serve_forever()


def main() -> None:
    """Console entry point (`gvtpu-viewer [dir] [port]`)."""
    directory = sys.argv[1] if len(sys.argv) > 1 else os.environ.get(
        "GPU_VOXELS_VIS_DIR", "/tmp/gpu_voxels_jax_vis"
    )
    port = int(sys.argv[2]) if len(sys.argv) > 2 else 8321
    serve(directory, port)


if __name__ == "__main__":
    main()
