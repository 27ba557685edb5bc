"""Self-contained HTML motion player.

The port's own copy of ``diffsheg_tpu/viz/player.py`` (numpy only).

The reference vendors a JS mocap web player with pymo
(reference datasets/pymo/mocapplayer/ — served via
``pymo/mocapplayer/playURL.html``) for eyeballing generated BVH.  This is
this repository's equivalent, redesigned instead of vendored: the host side
runs our vectorized FK once (geometry/bvh.py::forward_kinematics) and
embeds world-space joint positions into ONE dependency-free HTML file —
no server, no three.js, no network: open the file and press play.

Player features: play/pause (space), frame scrubber, speed control, drag
to orbit, wheel to zoom, optional per-frame face blendshape bars from the
exported face JSON (geometry/face.py layout, the ARKit-52 surface the
reference writes in ddpm_beat_trainer.py:1003-1030).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
  :root { color-scheme: dark; }
  body { margin: 0; background: #14161a; color: #d8dce2;
         font: 13px/1.4 system-ui, sans-serif; }
  #bar { display: flex; gap: .75em; align-items: center;
         padding: .5em .75em; background: #1c1f26; }
  #bar button { background: #2a2f3a; color: inherit; border: 0;
                border-radius: 4px; padding: .3em .9em; cursor: pointer; }
  #bar input[type=range] { flex: 1; }
  canvas { display: block; }
  #face { position: absolute; right: 8px; top: 48px; width: 220px;
          background: #1c1f26cc; border-radius: 6px; padding: 6px 8px; }
  #face div { display: flex; align-items: center; gap: 6px;
              font-size: 11px; }
  #face i { display: inline-block; height: 7px; background: #5b8dd9;
            border-radius: 3px; }
  #hud { opacity: .7; min-width: 9em; text-align: right; }
</style></head><body>
<div id="bar">
  <button id="play">Pause</button>
  <input id="seek" type="range" min="0" value="0" step="1">
  <select id="speed">
    <option value="0.25">0.25x</option><option value="0.5">0.5x</option>
    <option value="1" selected>1x</option><option value="2">2x</option>
  </select>
  <span id="hud"></span>
</div>
<canvas id="cv"></canvas>
<div id="face" hidden></div>
<script>
"use strict";
const D = __DATA__;
const T = D.positions.length, J = D.positions[0].length;
const cv = document.getElementById("cv"), ctx = cv.getContext("2d");
const seek = document.getElementById("seek"), hud = document.getElementById("hud");
const playBtn = document.getElementById("play");
const faceBox = document.getElementById("face");
seek.max = T - 1;

// center + scale from the full clip so the camera never jumps
let mn = [1e9, 1e9, 1e9], mx = [-1e9, -1e9, -1e9];
for (const fr of D.positions) for (const p of fr)
  for (let a = 0; a < 3; a++) {
    mn[a] = Math.min(mn[a], p[a]); mx[a] = Math.max(mx[a], p[a]);
  }
const ctr = [0, 1, 2].map(a => (mn[a] + mx[a]) / 2);
const span = Math.max(mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2], 1e-6);

let frame = 0, playing = true, yaw = 0.6, pitch = 0.25, zoom = 1;
let speed = 1, acc = 0, last = performance.now();

function resize() {
  cv.width = innerWidth; cv.height = innerHeight - 44;
}
addEventListener("resize", () => { resize(); draw(); });
resize();

function project(p) {
  const x = (p[0] - ctr[0]) / span, y = (p[1] - ctr[1]) / span,
        z = (p[2] - ctr[2]) / span;
  const cx = Math.cos(yaw), sx = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const rx = cx * x + sx * z, rz = -sx * x + cx * z;
  const ry = cp * y - sp * rz;
  const s = Math.min(cv.width, cv.height) * 0.8 * zoom;
  return [cv.width / 2 + rx * s, cv.height * 0.55 - ry * s];
}

function draw() {
  ctx.clearRect(0, 0, cv.width, cv.height);
  const pos = D.positions[frame], pts = pos.map(project);
  ctx.strokeStyle = "#5b8dd9"; ctx.lineWidth = 2; ctx.beginPath();
  for (let j = 0; j < J; j++) {
    const par = D.parents[j];
    if (par < 0) continue;
    ctx.moveTo(pts[par][0], pts[par][1]);
    ctx.lineTo(pts[j][0], pts[j][1]);
  }
  ctx.stroke();
  ctx.fillStyle = "#e8b34b";
  for (const [x, y] of pts) { ctx.fillRect(x - 2, y - 2, 4, 4); }
  hud.textContent = `${frame + 1}/${T} @ ${D.fps} fps`;
  seek.value = frame;
  if (D.face) {
    faceBox.hidden = false;
    const w = D.face[frame], rows = [];
    const order = w.map((v, i) => [v, i]).sort((a, b) => b[0] - a[0]);
    for (const [v, i] of order.slice(0, 8))
      rows.push(`<div><span style="width:9em;overflow:hidden">` +
                `${D.face_names[i]}</span>` +
                `<i style="width:${Math.max(1, v * 90)}px"></i></div>`);
    faceBox.innerHTML = rows.join("");
  }
}

function tick(now) {
  if (playing) {
    acc += (now - last) / 1000 * D.fps * speed;
    const adv = Math.floor(acc);
    if (adv > 0) { frame = (frame + adv) % T; acc -= adv; draw(); }
  }
  last = now;
  requestAnimationFrame(tick);
}

playBtn.onclick = () => {
  playing = !playing; playBtn.textContent = playing ? "Pause" : "Play";
};
addEventListener("keydown", e => {
  if (e.code === "Space") { e.preventDefault(); playBtn.onclick(); }
});
seek.oninput = () => { frame = +seek.value; draw(); };
document.getElementById("speed").onchange = e => { speed = +e.target.value; };
let drag = null;
cv.onpointerdown = e => { drag = [e.clientX, e.clientY]; };
addEventListener("pointerup", () => { drag = null; });
addEventListener("pointermove", e => {
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.01;
  pitch = Math.max(-1.4, Math.min(1.4, pitch + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY]; draw();
});
cv.onwheel = e => {
  e.preventDefault();
  zoom = Math.max(0.2, Math.min(8, zoom * (e.deltaY < 0 ? 1.1 : 0.9)));
  draw();
};
draw();
requestAnimationFrame(tick);
</script></body></html>
"""


def export_player_html(
    positions: np.ndarray,            # (T, J, 3) world-space joint positions
    parents: Sequence[int],           # (J,) parent index per joint, -1 = root
    fps: float,
    out_path: str,
    title: str = "diffsheg_tpu motion",
    face: Optional[np.ndarray] = None,        # (T, F) blendshape weights
    face_names: Optional[Sequence[str]] = None,
) -> str:
    """Write a dependency-free single-file HTML player; returns the path."""
    positions = np.asarray(positions, np.float64)
    T, J, _ = positions.shape
    # fail fast host-side: an empty clip would only surface as a TypeError
    # inside the embedded JS (a blank page with no diagnostic)
    assert T > 0, "cannot build a player for a zero-frame clip"
    assert len(parents) == J, (len(parents), J)
    data = {
        "positions": np.round(positions, 3).tolist(),
        "parents": [int(p) for p in parents],
        "fps": round(float(fps), 3),
    }
    if face is not None:
        face = np.asarray(face, np.float64)
        assert face.shape[0] == T, (face.shape, T)
        data["face"] = np.round(face, 3).tolist()
        data["face_names"] = (list(face_names) if face_names is not None
                              else [f"bs_{i}" for i in range(face.shape[1])])
    else:
        data["face"] = None
        data["face_names"] = None
    html = _TEMPLATE.replace("__TITLE__", title).replace(
        "__DATA__", json.dumps(data, separators=(",", ":")))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def export_bvh_player(
    bvh_path: str,
    out_path: str,
    face_json: Optional[str] = None,
    stride: int = 1,
) -> str:
    """BVH file -> HTML player (the ``cli view`` backend).

    Runs the vectorized FK once on the host; ``stride`` subsamples frames
    to bound the embedded payload for long clips.
    """
    from diffsheg_tpu_torch.geometry.bvh import forward_kinematics, parse_bvh_file

    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    data = parse_bvh_file(bvh_path)
    pos = forward_kinematics(data)[::stride]
    # BVH Y-up: keep as-is (the player treats axis 1 as up)
    parents = [j.parent for j in data.joints]
    face = names = None
    if face_json:
        with open(face_json) as f:
            raw = json.load(f)
        names = raw["names"]
        frames = raw["frames"]
        face = np.asarray([fr["weights"] for fr in frames])[::stride]
        n = min(len(face), len(pos))
        face, pos = face[:n], pos[:n]
    return export_player_html(
        pos, parents, data.fps / stride, out_path,
        title=os.path.basename(bvh_path), face=face, face_names=names)
