"""Visualization exporters: PLY point/cube clouds and a self-contained
three.js HTML viewer (the reference's OpenGL viewer equivalent, offline).
"""
from __future__ import annotations

import json
import numpy as np

from .extract import extract_cubes

# a compact meaning->color map mimicking the visualizer's defaults
_PALETTE = [
    (255, 255, 255),  # free
    (0, 200, 0),  # occupied
    (255, 0, 0),  # collision
    (120, 120, 120),  # unknown
]


def _color_for(t: int):
    if t < len(_PALETTE):
        return _PALETTE[t]
    # swept volume ids cycle through a hue wheel
    h = (t * 29) % 360 / 60.0
    c = 255
    x = int(255 * (1 - abs(h % 2 - 1)))
    return [(c, x, 0), (x, c, 0), (0, c, x), (0, x, c), (x, 0, c), (c, 0, x)][int(h) % 6]


def colors_for(types) -> np.ndarray:
    """uint8[K,3] viewer colors of K voxel meanings (one _color_for call per
    distinct meaning)."""
    types = np.asarray(types).reshape(-1)
    if not len(types):
        return np.zeros((0, 3), np.uint8)
    uniq, inv = np.unique(types, return_inverse=True)
    return np.asarray([_color_for(int(t)) for t in uniq], np.uint8)[inv]


def distance_colors(dist: np.ndarray) -> np.ndarray:
    """uint8[K,3] gradient colors for metric distances — the reference
    viewer's distance-dependent DistanceVoxel coloring
    (gpu_visualization/Visualizer.cu distance drawmodes): obstacles (d=0)
    red, ramping through yellow/green to blue at the farthest distance."""
    d = np.asarray(dist, np.float64)
    finite = np.isfinite(d)
    dmax = float(d[finite].max()) if finite.any() and d[finite].max() > 0 else 1.0
    t = np.clip(np.where(finite, d, dmax) / dmax, 0.0, 1.0)  # 0 obstacle .. 1 far
    # piecewise ramp red -> yellow -> green -> cyan -> blue
    seg = np.clip(t * 4.0, 0.0, 4.0)
    r = np.clip(2.0 - seg, 0.0, 1.0)
    g = np.clip(np.minimum(seg, 4.0 - seg), 0.0, 1.0)
    b = np.clip(seg - 2.0, 0.0, 1.0)
    return (np.stack([r, g, b], axis=1) * 255).astype(np.uint8)


def write_ply(path, m, threshold: float = 0.5, cubes=None) -> int:
    """Occupied voxel centers as a colored PLY point cloud.

    `cubes` accepts a precomputed extract_cubes(m, threshold) result —
    (centers, types) or (centers, types, scales); the point cloud drops
    per-cube scales — so publishers extracting once can feed several
    writers."""
    if cubes is None:
        cubes = extract_cubes(m, threshold)
    centers, types = cubes[0], cubes[1]
    colors = colors_for(types)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(centers)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for c, col in zip(centers, colors):
            f.write(f"{c[0]} {c[1]} {c[2]} {col[0]} {col[1]} {col[2]}\n")
    return len(centers)


def write_html(path, maps: dict, threshold: float = 0.5, title: str = "gpu_voxels_jax", cubes=None) -> None:
    """Standalone HTML viewer: voxel cubes as three.js instanced meshes.

    `maps` is {name: map}; each map becomes a toggleable cube layer.
    `cubes` optionally maps name -> precomputed extract_cubes result.
    """
    layers = []
    for name, m in maps.items():
        cs = cubes[name] if cubes and name in cubes else extract_cubes(m, threshold)
        centers, types = cs[0], cs[1]
        colors = colors_for(types).tolist()
        layer = dict(
            name=name,
            side=float(m.side_length),
            centers=np.round(centers, 4).tolist(),
            colors=colors,
        )
        if len(cs) > 2 and cs[2] is not None:  # multi-level: per-cube edge
            layer["scales"] = np.round(np.asarray(cs[2], np.float64), 4).tolist()
        layers.append(layer)
    payload = json.dumps(layers)
    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{margin:0;background:#111;color:#eee;font-family:sans-serif}}
#hud{{position:absolute;top:8px;left:8px}}</style></head>
<body><div id="hud">{title}</div><canvas id="c"></canvas>
<script type="module">
import * as THREE from 'https://unpkg.com/three@0.160.0/build/three.module.js';
import {{OrbitControls}} from 'https://unpkg.com/three@0.160.0/examples/jsm/controls/OrbitControls.js';
const layers = {payload};
const renderer = new THREE.WebGLRenderer({{canvas: document.getElementById('c')}});
renderer.setSize(window.innerWidth, window.innerHeight);
const scene = new THREE.Scene();
const camera = new THREE.PerspectiveCamera(60, innerWidth/innerHeight, 0.01, 10000);
camera.position.set(40, 40, 40);
new OrbitControls(camera, renderer.domElement);
scene.add(new THREE.AmbientLight(0xffffff, 0.7));
const dl = new THREE.DirectionalLight(0xffffff, 1.2); dl.position.set(1,2,3); scene.add(dl);
for (const layer of layers) {{
  const geo = new THREE.BoxGeometry(layer.side, layer.side, layer.side);
  const mat = new THREE.MeshLambertMaterial();
  const mesh = new THREE.InstancedMesh(geo, mat, layer.centers.length);
  const mtx = new THREE.Matrix4();
  layer.centers.forEach((c, i) => {{
    if (layer.scales) {{ const s = layer.scales[i] / layer.side; mtx.makeScale(s, s, s); }}
    else {{ mtx.identity(); }}
    mtx.setPosition(c[0], c[1], c[2]); mesh.setMatrixAt(i, mtx);
    const col = layer.colors[i];
    mesh.setColorAt(i, new THREE.Color(col[0]/255, col[1]/255, col[2]/255));
  }});
  scene.add(mesh);
}}
(function animate() {{ requestAnimationFrame(animate); renderer.render(scene, camera); }})();
</script></body></html>"""
    with open(path, "w") as f:
        f.write(html)
