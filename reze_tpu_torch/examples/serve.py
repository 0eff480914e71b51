"""An HTTP viewer: a stdlib server renders a frame on each request and a
self-contained page draws it on a canvas, sends pointer drags (orbit,
pan with the right button or shift, zoom with the wheel) and shows the
engine's stats. Any browser is the display.

    python -m reze_tpu_torch.examples.serve --written-flagship \
        [--port 8321] [--size 480x360] [--no-anim]

Routes:
    /        the canvas, input and stats page
    /frame   advance one step (dt: the wall time since the last frame, at
             most 0.1 s) and return the frame as PNG
    /input   pointer deltas: ?orbit=dx,dy | ?pan=dx,dy | ?zoom=dy
    /stats   the engine's stats as JSON (fps, frame ms, memory, overflow
             counters)

``--port 0`` binds a free port. ``main`` returns the server, not yet
serving; run as a module, it serves until interrupted.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..core.types import EngineConfig
from ..engine import Engine
from ..formats import image
from . import device_of, parse, parser, scene

PAGE = """<!doctype html>
<meta charset="utf-8"><title>reze-tpu-torch live</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;
      border-radius:6px;white-space:pre;pointer-events:none}
 canvas{display:block;margin:0 auto;cursor:grab}
</style>
<canvas id=c width=%W% height=%H%></canvas>
<div id=hud>connecting…</div>
<script>
const c=document.getElementById('c'),x=c.getContext('2d'),hud=document.getElementById('hud');
let drag=null,btn=0,frames=0,t0=performance.now();
c.onpointerdown=e=>{drag=[e.clientX,e.clientY];btn=e.button;c.setPointerCapture(e.pointerId)};
c.onpointerup=()=>drag=null;
c.onpointermove=e=>{
  if(!drag)return;const dx=e.clientX-drag[0],dy=e.clientY-drag[1];drag=[e.clientX,e.clientY];
  const mode=(btn===2||e.shiftKey)?'pan':'orbit';
  fetch(`/input?${mode}=${dx},${dy}`);
};
c.oncontextmenu=e=>e.preventDefault();
c.onwheel=e=>{e.preventDefault();fetch(`/input?zoom=${e.deltaY}`)};
async function loop(){
  for(;;){
    const r=await fetch('/frame');const b=await r.blob();
    const img=await createImageBitmap(b);x.drawImage(img,0,0);frames++;
    if(frames%10===0){
      const s=await (await fetch('/stats')).json();
      const fps=frames/((performance.now()-t0)/1000);
      hud.textContent=`display ${fps.toFixed(1)} fps | engine ${s.fps.toFixed(1)} fps `+
        `(${s.frame_time.toFixed(1)} ms)\\nmem ~${s.gpu_memory.toFixed(0)} MB | `+
        `pair ovf ${s.pair_overflow} | contact ovf ${s.contact_overflow}`;
    }
  }
}
loop();
</script>"""


def main(argv=None) -> ThreadingHTTPServer:
    """Load, render one warm-up frame and bind the server -> the server
    (``server.engine`` is its Engine); call ``serve_forever`` on it."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--size", default="480x360")
    ap.add_argument("--no-anim", action="store_true")
    args = parse(ap, argv)
    dev = device_of(args)
    w, h = (int(v) for v in args.size.split("x"))
    cfg = EngineConfig(width=w, height=h, camera_distance=13.5, camera_target=(0.0, 17.1, 0.0),
                       max_tris_per_bin=4096)
    eng = Engine(cfg, device=dev)
    with scene(args) as (pmx, vmd):
        eng.load_model(pmx)
        if not args.no_anim:
            eng.load_animation(vmd)
    if not args.no_anim:
        eng.play_animation()
    lock = threading.Lock()
    last = {"t": time.perf_counter()}
    print("warm-up render...", flush=True)
    eng.render(0.0)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            u = urlparse(self.path)
            q = parse_qs(u.query)
            if u.path == "/":
                page = PAGE.replace("%W%", str(w)).replace("%H%", str(h))
                self._send(200, "text/html", page.encode())
            elif u.path == "/frame":
                with lock:
                    now = time.perf_counter()
                    dt = min(now - last["t"], 0.1)
                    last["t"] = now
                    frame = eng.render(dt)
                self._send(200, "image/png", image.encode_png(frame))
            elif u.path == "/input":
                with lock:
                    cam = eng.camera
                    if "orbit" in q:
                        dx, dy = (float(v) for v in q["orbit"][0].split(","))
                        eng.camera = cam.orbit(dx, dy)
                    elif "pan" in q:
                        dx, dy = (float(v) for v in q["pan"][0].split(","))
                        eng.camera = cam.pan(dx, dy)
                    elif "zoom" in q:
                        eng.camera = cam.zoom(float(q["zoom"][0]))
                self._send(200, "text/plain", b"ok")
            elif u.path == "/stats":
                with lock:
                    s = eng.get_stats()
                self._send(200, "application/json", json.dumps({
                    "fps": s.fps, "frame_time": s.frame_time, "gpu_memory": s.gpu_memory,
                    "pair_overflow": s.pair_overflow,
                    "contact_overflow": s.contact_overflow}).encode())
            else:
                self._send(404, "text/plain", b"not found")

    server = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    server.engine = eng
    print(f"serving on http://127.0.0.1:{server.server_address[1]} ({dev})", flush=True)
    return server


if __name__ == "__main__":
    srv = main(sys.argv[1:])
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
