"""Live interactive viewer: the in-loop half of the viewer. Port of
``thormang_isaacgym_tpu/runtime/viewer.py`` (the reference's Vulkan viewer,
``vec_task.py:225-252,408-440``).

A card's host has no display, so the viewer serves the same interaction over
a local HTTP socket: any browser on (or forwarded to) the host is the
window.

- :class:`LiveViewer` starts a localhost HTTP server in a daemon thread.
  ``GET /`` serves a self-contained page (the replay's orthographic
  three-view canvas, polling), ``GET /state`` the latest frame as JSON
  (``runtime/replay.py encode_geoms`` rows, the debug lines, dt and the sync
  flag), ``POST /key`` enqueues a keyboard event.
- ``subscribe_keyboard_event(key, name)`` / ``query_events()``: the
  reference's ``subscribe_viewer_keyboard_event`` /
  ``query_viewer_action_events``; only subscribed keys are reported, as
  ``(name, key)``.
- ``render(state)``, once per control step as the reference's
  ``render()``: reads env ``env_index``'s q row from the device once and
  publishes its geometry (forward kinematics on the CPU), honours the V-key
  frame-rate sync, raises :class:`ViewerClosed` after ESC.
- ``add_debug_line(a, b)``: ``gym.add_lines``; cleared each frame.

Usage (the reference's env loop):
    viewer = LiveViewer(env)          # prints the URL
    viewer.subscribe_keyboard_event("r", "reset")
    while ...:
        state = env.step(state, actions)
        for name, key in viewer.query_events():
            ...
        viewer.render(state)          # raises ViewerClosed on ESC
    viewer.close()
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from thormang_isaacgym_tpu_torch.runtime.replay import encode_geoms


class ViewerClosed(Exception):
    """Raised by render() after the user pressed ESC (the reference's
    query_viewer_has_closed -> sys.exit path, vec_task.py:410-411)."""


class LiveViewer:
    def __init__(self, env, env_index: int = 0, port: int = 0,
                 announce: bool = True):
        self.env = env
        self.model = env.task.model
        self.env_index = env_index
        self.dt = float(getattr(env.task.sim_params, "dt", 1 / 60))
        self.enable_viewer_sync = True        # the reference's V toggle
        self._events: list = []
        self._subs: dict = {"escape": "QUIT", "v": "toggle_viewer_sync"}
        self._lines: list = []
        self._frame: list = []
        self._closed = False
        self._lock = threading.Lock()
        self._last_render = 0.0

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_):
                pass

            def _send(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/state"):
                    with viewer._lock:
                        body = json.dumps(
                            {"geoms": viewer._frame,
                             "lines": viewer._lines,
                             "dt": viewer.dt,
                             "sync": viewer.enable_viewer_sync}).encode()
                    self._send(body, "application/json")
                else:
                    self._send(_PAGE.replace(
                        "__TITLE__", viewer.model.name).encode(),
                        "text/html")

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                key = json.loads(self.rfile.read(n) or b"{}").get("key", "")
                key = str(key).lower()
                with viewer._lock:
                    if key == "escape":
                        viewer._closed = True
                    if key == "v":
                        viewer.enable_viewer_sync = \
                            not viewer.enable_viewer_sync
                    name = viewer._subs.get(key)
                    if name is not None:
                        viewer._events.append((name, key))
                self._send(b"{}", "application/json")

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}/"
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        if announce:
            print(f"live viewer: {self.url} "
                  f"(ESC quit, V toggle sync; subscribe more keys via "
                  f"subscribe_keyboard_event)")

    # -- reference API surface (vec_task.py:246-252,408-440) ------------
    def subscribe_keyboard_event(self, key: str, action_name: str):
        with self._lock:
            self._subs[str(key).lower()] = action_name

    def query_events(self):
        """Drain subscribed (action_name, key) events since last call."""
        with self._lock:
            ev, self._events = self._events, []
        return ev

    def add_debug_line(self, a, b, color=(1.0, 0.3, 0.3)):
        self._lines.append([*np.round(np.asarray(a, np.float64), 4),
                            *np.round(np.asarray(b, np.float64), 4),
                            *color[:3]])

    def clear_lines(self):
        self._lines = []

    def render(self, state):
        """Publish the current frame; throttle to real time when viewer
        sync is on; raise ViewerClosed after ESC."""
        if self._closed:
            raise ViewerClosed
        geoms = encode_geoms(self.model, state.q[self.env_index].detach().cpu().numpy())
        with self._lock:
            self._frame = geoms
        if self.enable_viewer_sync:
            now = time.monotonic()
            wait = self.dt - (now - self._last_render)
            if 0 < wait < 1.0:
                time.sleep(wait)
            self._last_render = time.monotonic()
        self.clear_lines()

    def close(self):
        self._server.shutdown()
        self._server.server_close()


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__ live</title>
<style>body{font-family:monospace;background:#111;color:#ddd}
canvas{background:#1a1a1f;margin:4px}</style></head>
<body><h3>__TITLE__ live <span id=st></span></h3>
<div><canvas id="xy" width="420" height="420"></canvas>
<canvas id="xz" width="420" height="420"></canvas>
<canvas id="yz" width="420" height="420"></canvas></div>
<p>keys: ESC quit · V toggle sync · others forwarded to subscriptions</p>
<script>
let lo=[-1,-1,-0.2], hi=[1,1,1.8];
function fit(geoms){
  lo=[1e9,1e9,1e9]; hi=[-1e9,-1e9,-1e9];
  for(const g of geoms){
    const c = g[0]==1 ? [(g[1]+g[4])/2,(g[2]+g[5])/2,(g[3]+g[6])/2]
                      : [g[1],g[2],g[3]];
    for(let k=0;k<3;k++){lo[k]=Math.min(lo[k],c[k]-0.3);
                         hi[k]=Math.max(hi[k],c[k]+0.3);}}}
function draw(d){
  if(d.geoms.length) fit(d.geoms);
  const span=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],0.1);
  const proj=(p,ax,ay)=>[(p[ax]-lo[ax])/span*400+10,
                         410-(p[ay]-lo[ay])/span*400];
  for(const [id,ax,ay] of [['xy',0,1],['xz',0,2],['yz',1,2]]){
    const ctx=document.getElementById(id).getContext('2d');
    ctx.clearRect(0,0,420,420); ctx.fillStyle='#666'; ctx.fillText(id,5,12);
    const s=400/span;
    ctx.strokeStyle='#7ec8e3'; ctx.fillStyle='rgba(126,200,227,0.25)';
    for(const g of d.geoms){
      if(g[0]==0){ const [x,y]=proj([g[1],g[2],g[3]],ax,ay);
        ctx.beginPath(); ctx.arc(x,y,Math.max(g[4]*s,1.5),0,7);
        ctx.fill(); ctx.stroke();
      } else if(g[0]==1){ const a=proj([g[1],g[2],g[3]],ax,ay),
                                b=proj([g[4],g[5],g[6]],ax,ay);
        ctx.lineWidth=Math.max(g[7]*2*s,2); ctx.beginPath();
        ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
        ctx.stroke(); ctx.lineWidth=1;
      } else { const [x,y]=proj([g[1],g[2],g[3]],ax,ay);
        const hx=g[4+ax]*s, hy=g[4+ay]*s;
        ctx.fillRect(x-hx,y-hy,2*hx,2*hy);
        ctx.strokeRect(x-hx,y-hy,2*hx,2*hy); }}
    ctx.strokeStyle='#e37e7e';
    for(const l of d.lines){ const a=proj([l[0],l[1],l[2]],ax,ay),
                                   b=proj([l[3],l[4],l[5]],ax,ay);
      ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
      ctx.stroke(); }}
  document.getElementById('st').textContent =
    d.sync ? '(sync)' : '(free-run)';
}
async function tick(){
  try{ const d=await (await fetch('/state')).json(); draw(d);
  }catch(e){ document.getElementById('st').textContent='(closed)'; return; }
  setTimeout(tick, 50);
}
document.addEventListener('keydown', ev=>{
  fetch('/key',{method:'POST',body:JSON.stringify({key:ev.key})});});
tick();
</script></body></html>
"""
