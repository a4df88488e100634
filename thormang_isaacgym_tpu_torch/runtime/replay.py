"""State logging and host-side replay rendering: the viewer's offline half.
Port of ``thormang_isaacgym_tpu/runtime/replay.py`` (the reference's video
capture, ``train.py:114-121`` RecordVideo, headless).

- :class:`StateLogger` records ``q`` snapshots of chosen envs during any
  rollout and saves them as the JAX package's npz (``qs``, ``dt``): a file
  written by either package loads in the other.
- :func:`render_html` writes a self-contained HTML replay (a canvas
  orthographic three-view, no network), the JAX package's page and payload.
- :func:`render_video` writes an animated GIF of one orthographic view.
  The JAX package draws it with matplotlib; the port draws the same
  schematic (spheres as circles, capsules and cylinders as thick segments,
  boxes as squares of 0.8 x the half-size norm, the ground line) with
  ``PIL.ImageDraw``, and the frame geometry is :func:`frame_shapes`'s.

Geometry comes from the port's forward kinematics (``_geom_frames``), one
q row at a time on the CPU.

Usage:
    log = StateLogger(env.task.model)
    for ...: state = env.step(state, a); log.add(state.q[0].cpu().numpy())
    log.save("traj.npz"); render_html(log, "traj.html"); render_video(log, "traj.gif")
"""
from __future__ import annotations

import json

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.core import quat as Q
from thormang_isaacgym_tpu_torch.models.robot import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE, RobotModel,
)
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics, geom_world_poses

VIEWS = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}


class StateLogger:
    def __init__(self, model: RobotModel, dt: float = 1 / 30):
        self.model = model
        self.dt = dt
        self.qs: list[np.ndarray] = []

    def add(self, q):
        q = q.detach().cpu().numpy() if isinstance(q, torch.Tensor) else q
        self.qs.append(np.asarray(q, np.float32).copy())

    def __len__(self):
        return len(self.qs)

    def save(self, path: str):
        np.savez(path, qs=np.stack(self.qs), dt=np.float32(self.dt))

    @staticmethod
    def load(model: RobotModel, path: str) -> "StateLogger":
        with np.load(path) as z:
            log = StateLogger(model, float(z["dt"]))
            log.qs = list(z["qs"])
        return log


def _geom_frames(model: RobotModel, q: np.ndarray):
    """Per-geom world (pos, quat, type, size) for one q row (numpy, CPU)."""
    qt = torch.as_tensor(np.asarray(q, np.float32))[None]
    frames = forward_kinematics(model, qt, qt.new_zeros(1, model.nv))
    pos, quat, _, _ = geom_world_poses(model, frames)
    pos, quat = pos[0].numpy(), quat[0].numpy()
    return [(pos[i], quat[i], g.gtype, g.size) for i, g in enumerate(model.geoms)]


def _axis_z(gq: np.ndarray) -> np.ndarray:
    """The geom's local z axis in the world (capsules and cylinders lie
    along it, the contact kernels' convention)."""
    return Q.rotate(torch.as_tensor(gq), torch.tensor([0.0, 0.0, 1.0])).numpy()


def encode_geoms(model: RobotModel, q: np.ndarray) -> list:
    """One q row's geoms as the HTML pages' JSON rows: a sphere
    ``[0, x, y, z, r]``, a capsule or cylinder ``[1, a (3), b (3), r]`` (its
    segment's ends), a box ``[2, x, y, z, hx, hy, hz]``; positions rounded
    to 4 decimals."""
    geoms = []
    for gp, gq, gtype, size in _geom_frames(model, q):
        if gtype == GEOM_SPHERE:
            geoms.append([0, *np.round(gp, 4).tolist(), float(size[0])])
        elif gtype in (GEOM_CAPSULE, GEOM_CYLINDER):
            axis = _axis_z(gq)
            h = float(size[1])
            a, b = gp - axis * h, gp + axis * h
            geoms.append([1, *np.round(a, 4).tolist(), *np.round(b, 4).tolist(), float(size[0])])
        elif gtype == GEOM_BOX:
            geoms.append([2, *np.round(gp, 4).tolist(), *[float(s) for s in size]])
    return geoms


def render_html(log: StateLogger, path: str, every: int = 1, title: str | None = None):
    """Write a standalone HTML replay of the logged trajectory."""
    model = log.model
    frames = [encode_geoms(model, q) for q in log.qs[::every]]
    html = _TEMPLATE.replace("__DATA__", json.dumps(frames)).replace(
        "__TITLE__", title or model.name).replace("__DT__", str(log.dt * every))
    with open(path, "w") as f:
        f.write(html)
    return path


def frame_shapes(geoms: list, view: str = "xz") -> list:
    """The schematic of one frame's geoms (``_geom_frames`` rows) in the
    world units of plane `view`: ``("circle", x, y, r)`` for a sphere,
    ``("segment", ax, ay, bx, by, r)`` for a capsule or cylinder (its axis,
    r its radius), ``("square", x, y, h)`` for a box (half side h = 0.8 x
    the norm of its half sizes)."""
    ix, iy = VIEWS[view]
    out = []
    for gp, gq, gtype, size in geoms:
        if gtype == GEOM_SPHERE:
            out.append(("circle", float(gp[ix]), float(gp[iy]), float(size[0])))
        elif gtype in (GEOM_CAPSULE, GEOM_CYLINDER):
            axis = _axis_z(gq)
            a, b = gp - axis * size[1], gp + axis * size[1]
            out.append(("segment", float(a[ix]), float(a[iy]), float(b[ix]), float(b[iy]),
                        float(size[0])))
        else:
            out.append(("square", float(gp[ix]), float(gp[iy]),
                        float(np.linalg.norm(size)) * 0.8))
    return out


def render_video(log: StateLogger, path: str, every: int = 1, view: str = "xz",
                 size=(360, 270), lim: float | None = None, title: str | None = None):
    """Write an animated GIF of the logged trajectory, one frame for every
    `every`-th state: the orthographic schematic of ``frame_shapes`` in
    plane `view` ("xy", "xz" or "yz"), a fixed camera over the whole
    trajectory (centre the mean geom position, half span `lim`, default
    1.3 x the largest distance from it and at least 0.5 m), the ground line
    in the vertical views, `size` pixels (JAX's 4.8 x 3.6 in at 75 dpi)."""
    from PIL import Image, ImageDraw

    frames_geoms = [_geom_frames(log.model, q) for q in log.qs[::every]]
    pts = np.asarray([g[0] for geoms in frames_geoms for g in geoms])
    c = pts.mean(axis=0)
    if lim is None:
        lim = max(float(np.abs(pts - c).max()) * 1.3, 0.5)
    ix, iy = VIEWS[view]
    w, h = size
    scale = min(w, h) / (2.0 * lim)           # pixels per metre, equal aspect

    def px(x, y):
        return (w / 2 + (x - c[ix]) * scale, h / 2 - (y - c[iy]) * scale)

    images = []
    for geoms in frames_geoms:
        im = Image.new("RGB", size, "white")
        d = ImageDraw.Draw(im)
        if view in ("xz", "yz"):
            y0 = px(0.0, 0.0)[1]
            d.line([(0, y0), (w, y0)], fill="#888888", width=1)
        for shape in frame_shapes(geoms, view):
            kind = shape[0]
            if kind == "circle":
                (x, y), r = px(shape[1], shape[2]), shape[3] * scale
                d.ellipse([x - r, y - r, x + r, y + r], fill="#4a90d9", outline="#1b4f8a")
            elif kind == "segment":
                a, b = px(shape[1], shape[2]), px(shape[3], shape[4])
                d.line([a, b], fill="#4a90d9", width=max(int(round(2 * shape[5] * scale)), 2),
                       joint="curve")
            else:
                (x, y), r = px(shape[1], shape[2]), shape[3] * scale
                d.rectangle([x - r, y - r, x + r, y + r], fill="#e0a84a", outline="#8a5f1b")
        d.text((4, 2), title or log.model.name, fill="black")
        images.append(im)
    ms = max(int(1000 * log.dt * every), 20)
    images[0].save(path, save_all=True, append_images=images[1:], duration=ms, loop=0)
    return path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__ replay</title>
<style>body{font-family:monospace;background:#111;color:#ddd}
canvas{background:#1a1a1f;margin:4px}</style></head>
<body><h3>__TITLE__ replay</h3>
<div><canvas id="xy" width="420" height="420"></canvas>
<canvas id="xz" width="420" height="420"></canvas>
<canvas id="yz" width="420" height="420"></canvas></div>
<input id="t" type="range" min="0" max="0" value="0" style="width:800px">
<span id="lbl"></span>
<button id="play">play</button>
<script>
const F=__DATA__, dt=__DT__;
const sl=document.getElementById('t'); sl.max=F.length-1;
const lbl=document.getElementById('lbl');
// world bounds
let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
for(const fr of F) for(const g of fr){
  const c = g[0]==1 ? [(g[1]+g[4])/2,(g[2]+g[5])/2,(g[3]+g[6])/2] : [g[1],g[2],g[3]];
  for(let k=0;k<3;k++){lo[k]=Math.min(lo[k],c[k]-0.3);hi[k]=Math.max(hi[k],c[k]+0.3);}}
const span=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2]);
function proj(p, ax, ay){ // world -> canvas
  return [ (p[ax]-lo[ax])/span*400+10, 410-(p[ay]-lo[ay])/span*400 ]; }
function draw(){
  const i=+sl.value; lbl.textContent=(i*dt).toFixed(2)+' s';
  for(const [id,ax,ay] of [['xy',0,1],['xz',0,2],['yz',1,2]]){
    const ctx=document.getElementById(id).getContext('2d');
    ctx.clearRect(0,0,420,420);
    ctx.fillStyle='#666'; ctx.fillText(id,5,12);
    if(id!=='xy'){ // ground line at z=0
      const y0=410-(0-lo[2])/span*400;
      ctx.strokeStyle='#333'; ctx.beginPath();
      ctx.moveTo(0,y0); ctx.lineTo(420,y0); ctx.stroke(); }
    ctx.strokeStyle='#7ec8e3'; ctx.fillStyle='rgba(126,200,227,0.25)';
    for(const g of F[i]){
      const s=400/span;
      if(g[0]==0){ const [x,y]=proj([g[1],g[2],g[3]],ax,ay);
        ctx.beginPath(); ctx.arc(x,y,Math.max(g[4]*s,1.5),0,7); ctx.fill(); ctx.stroke();
      } else if(g[0]==1){ const a=proj([g[1],g[2],g[3]],ax,ay), b=proj([g[4],g[5],g[6]],ax,ay);
        ctx.lineWidth=Math.max(g[7]*2*s,2); ctx.beginPath();
        ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke(); ctx.lineWidth=1;
      } else { const [x,y]=proj([g[1],g[2],g[3]],ax,ay);
        const hx=g[4+ax]*s, hy=g[4+ay]*s;
        ctx.fillRect(x-hx,y-hy,2*hx,2*hy); ctx.strokeRect(x-hx,y-hy,2*hx,2*hy); }
    }
  }
}
sl.oninput=draw; draw();
let timer=null;
document.getElementById('play').onclick=()=>{
  if(timer){clearInterval(timer);timer=null;return;}
  timer=setInterval(()=>{sl.value=(+sl.value+1)%F.length;draw();},dt*1000);};
</script></body></html>
"""
