"""Self-contained interactive 3D viewer (the RViz-profile equivalent).

The reference ships an RViz profile (ros/rviz/kinematic_icp.rviz) with
displays for the ``frame`` / ``keypoints`` / ``local_map`` clouds, two
Odometry trails and a voxel-grid marker, wired into the launch files via
``visualize:=true``.  A ROS-free deployment has no RViz, so the
equivalent here is a single HTML file with the same
layers rendered by inline JavaScript (orbit / pan / zoom, per-layer
toggles, point-size control) — it opens in any browser with **no network
access and no external assets**, so it can be scp'd out of a fleet machine
and double-clicked.

Layers mirror the RViz display list:
  * ``local_map``   — map point cloud (white/gray, like the rviz Local Map)
  * ``frame``       — current deskewed scan (blue)
  * ``keypoints``   — ICP source keypoints (red, larger)
  * ``trajectory``  — estimated odometry trail (green polyline)
  * ``reference``   — optional second trail (orange; wheel odom / gt)
  * ``voxel_grid``  — optional wireframe segments (utils.visualization)

Typical use::

    from kinematic_icp_tpu_torch.utils import viewer
    viewer.write_html_viewer("run.html",
                             local_map=map_points_nx3,
                             trajectory=poses_fx4x4,
                             keypoints=kp_nx3)

or from the CLI: ``python -m kinematic_icp_tpu_torch.run_odometry bag.mcap
--visualize`` (writes ``<bag>_kinematic_icp_view.html`` next to the TUM
trajectory, the same toggle the reference launch files expose).  The
default title is the JAX package's, so both write the same file.
"""

from __future__ import annotations

import json

import numpy as np

#: cap per layer; the canvas renderer stays interactive to ~300K points but
#: files get large — callers can pre-subsample for more.
MAX_POINTS_PER_LAYER = 200_000

_LAYER_STYLE = {
    "local_map": dict(color="#c8c8d0", size=1),
    "frame": dict(color="#4d8fe0", size=1),
    "keypoints": dict(color="#e0564d", size=3),
    "trajectory": dict(color="#3dba6f", size=2, line=True),
    "reference": dict(color="#e0a63d", size=2, line=True),
    "voxel_grid": dict(color="#6b6b78", size=1, segments=True),
}

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#101014;color:#d8d8e0;font:13px sans-serif;
      overflow:hidden}
 #hud{position:absolute;top:8px;left:8px;background:#1a1a22cc;padding:8px
      12px;border-radius:6px;user-select:none}
 #hud label{display:block;margin:2px 0;cursor:pointer}
 #hud input[type=range]{vertical-align:middle;width:90px}
 canvas{display:block}
 .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
     margin-right:6px;vertical-align:middle}
</style></head><body>
<canvas id="c"></canvas><div id="hud"><b>__TITLE__</b><br></div>
<script>
"use strict";
const DATA = __DATA__;
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
const hud = document.getElementById("hud");
let yaw = -0.9, pitch = 0.5, dist = 0, cx = 0, cy = 0, cz = 0, psz = 1;
// center / scale from data bounds
{
  let lo = [1e30, 1e30, 1e30], hi = [-1e30, -1e30, -1e30];
  for (const l of DATA.layers) {
    const p = l.pts;
    for (let i = 0; i < p.length; i += 3)
      for (let a = 0; a < 3; a++) {
        if (p[i + a] < lo[a]) lo[a] = p[i + a];
        if (p[i + a] > hi[a]) hi[a] = p[i + a];
      }
  }
  cx = (lo[0] + hi[0]) / 2; cy = (lo[1] + hi[1]) / 2; cz = (lo[2] + hi[2]) / 2;
  dist = 1.6 * Math.max(hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2], 1);
}
for (const l of DATA.layers) {
  const lab = document.createElement("label");
  lab.innerHTML = `<input type="checkbox" checked> <span class="sw" style="background:${l.color}"></span>${l.name} <small>(${l.pts.length/3|0})</small>`;
  lab.firstChild.onchange = e => { l.on = e.target.checked; draw(); };
  l.on = true; hud.appendChild(lab);
}
{
  const lab = document.createElement("label");
  lab.innerHTML = `point size <input type="range" min="1" max="6" value="1">`;
  lab.querySelector("input").oninput = e => { psz = +e.target.value; draw(); };
  hud.appendChild(lab);
  const tip = document.createElement("small");
  tip.textContent = "drag: orbit · shift-drag: pan · wheel: zoom";
  hud.appendChild(tip);
}
function draw() {
  const w = cv.width = innerWidth, h = cv.height = innerHeight;
  ctx.fillStyle = "#101014"; ctx.fillRect(0, 0, w, h);
  const sy = Math.sin(yaw), cyw = Math.cos(yaw);
  const sp = Math.sin(pitch), cp = Math.cos(pitch);
  const f = 1.2 * Math.min(w, h), img = ctx.getImageData(0, 0, w, h);
  const px = img.data;
  const proj = (x, y, z) => {
    x -= cx; y -= cy; z -= cz;
    const x1 = cyw * x + sy * y, y1 = -sy * x + cyw * y;
    const y2 = cp * y1 + sp * z, z2 = -sp * y1 + cp * z;
    const zc = x1 + dist;
    if (zc <= 0.05) return null;
    return [w / 2 + f * y2 / zc, h / 2 - f * z2 / zc, zc];
  };
  for (const l of DATA.layers) {
    if (!l.on) continue;
    const p = l.pts, r = parseInt(l.color.slice(1, 3), 16),
          g = parseInt(l.color.slice(3, 5), 16),
          b = parseInt(l.color.slice(5, 7), 16);
    if (l.line || l.segments) {
      ctx.strokeStyle = l.color; ctx.lineWidth = l.size * 0.75;
      ctx.putImageData(img, 0, 0); ctx.beginPath();
      const step = l.segments ? 6 : 3;
      for (let i = 0; i + step - 1 < p.length; i += step) {
        const a = proj(p[i], p[i + 1], p[i + 2]);
        const bq = l.segments
          ? proj(p[i + 3], p[i + 4], p[i + 5])
          : (i + 5 < p.length ? proj(p[i + 3], p[i + 4], p[i + 5]) : null);
        if (a && bq) { ctx.moveTo(a[0], a[1]); ctx.lineTo(bq[0], bq[1]); }
      }
      ctx.stroke();
      const fresh = ctx.getImageData(0, 0, w, h);
      px.set(fresh.data);
      continue;
    }
    const s = Math.max(1, Math.round(l.size * psz / 2));
    for (let i = 0; i < p.length; i += 3) {
      const q = proj(p[i], p[i + 1], p[i + 2]);
      if (!q) continue;
      const X = q[0] | 0, Y = q[1] | 0;
      for (let dy = 0; dy < s; dy++) for (let dx = 0; dx < s; dx++) {
        const xx = X + dx, yy = Y + dy;
        if (xx < 0 || yy < 0 || xx >= w || yy >= h) continue;
        const o = 4 * (yy * w + xx);
        px[o] = r; px[o + 1] = g; px[o + 2] = b; px[o + 3] = 255;
      }
    }
  }
  ctx.putImageData(img, 0, 0);
}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {
    const k = dist / (1.2 * Math.min(innerWidth, innerHeight));
    const sy = Math.sin(yaw), cyw = Math.cos(yaw);
    cx += k * (dx * -sy);  cy += k * (-dx * cyw); cz += k * dy;
  } else { yaw += dx * 0.008; pitch += dy * 0.008; }
  drag = [e.clientX, e.clientY, drag[2]]; draw();
};
cv.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); draw(); };
window.onresize = draw;
draw();
</script></body></html>
"""


def _layer_points(name: str, value) -> np.ndarray:
    a = np.asarray(value, np.float64)
    if name in ("trajectory", "reference") and a.ndim == 3:
        a = a[:, :3, 3]  # (F, 4, 4) poses -> translations
    a = a.reshape(-1, a.shape[-1])[:, :3].astype(np.float32)
    if name == "voxel_grid":
        a = a.reshape(-1, 3)  # segment endpoints interleaved
        if len(a) % 2:
            a = a[:-1]
    if len(a) > MAX_POINTS_PER_LAYER:
        if name == "voxel_grid":
            # subsample whole segments: pick start rows, keep their ends
            starts = np.linspace(0, len(a) // 2 - 1,
                                 MAX_POINTS_PER_LAYER // 2).astype(int) * 2
            idx = np.stack([starts, starts + 1], axis=1).reshape(-1)
        else:
            idx = np.linspace(0, len(a) - 1, MAX_POINTS_PER_LAYER).astype(int)
        a = a[idx]
    return a


def write_html_viewer(path, title: str = "kinematic-icp-tpu", **layers):
    """Write a standalone interactive HTML viewer.

    Keyword layers (any subset): ``local_map``, ``frame``, ``keypoints``
    as (N, 3) arrays; ``trajectory``, ``reference`` as (F, 4, 4) pose
    arrays or (F, 3) translations; ``voxel_grid`` as (S, 2, 3) segment
    endpoints (see ``utils.visualization.voxel_wireframe``).
    Unknown layer names render as generic white points.
    """
    out = []
    for name, value in layers.items():
        if value is None:
            continue
        pts = _layer_points(name, value)
        if pts.size == 0:
            continue
        style = _LAYER_STYLE.get(name, dict(color="#ffffff", size=1))
        out.append({
            "name": name,
            "pts": [round(float(v), 3) for v in pts.reshape(-1)],
            **style,
        })
    if not out:
        raise ValueError("no non-empty layers given")
    html = (_HTML
            .replace("__TITLE__", title)
            .replace("__DATA__", json.dumps({"layers": out})))
    with open(path, "w") as f:
        f.write(html)
    return path
