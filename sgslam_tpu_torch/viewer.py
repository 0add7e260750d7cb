"""Live interactive viewer: a zero-dependency HTTP server streaming the
tracked frame (keypoint/box overlay), the top-down map, and the occupancy
grid as they evolve.

Own copy of `sgslam_tpu/viewer.py` for the port (the role of the
reference's viewer windows as a browser view): the SLAM process publishes
rendered PNGs into a double buffer on its own thread (throttled by
`every`); a stdlib http.server thread serves an auto-refreshing page plus
/frame.png, /map.png, /occ.png and /stats.json, and only ever copies
bytes. It binds 127.0.0.1.
"""

from __future__ import annotations

import json
import threading

import numpy as np

from . import viz
from .io import native


def _png_bytes(img: np.ndarray) -> bytes:
    """Encode RGB/gray uint8 -> PNG via the native codec (tmp-free)."""
    import os
    import tempfile

    # the native codec writes files; keep it simple and small
    with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
        path = f.name
    try:
        native.png_write(path, img)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


class LiveViewer:
    """Publish-side handle + HTTP server (start/stop)."""

    def __init__(self, port: int = 8765, every: int = 5):
        self.port = port
        self.every = every
        self._lock = threading.Lock()
        self._images: dict[str, bytes] = {}
        self._stats: dict = {}
        self._n = 0
        self._httpd = None
        self._thread = None

    # ---- publisher API (called from the SLAM loop) ----
    def publish_frame(self, gray, xy=None, valid=None, culled=None,
                      person_boxes=None, object_boxes=None):
        self._n += 1
        if self._n % self.every:
            return
        img = viz.draw_frame(gray, xy=xy, valid=valid,
                             culled=culled, person_boxes=person_boxes,
                             object_boxes=object_boxes)
        data = _png_bytes(img)
        with self._lock:
            self._images["frame.png"] = data

    def publish_map(self, map_state, trajectory_cw=None):
        img = viz.draw_map_topdown(map_state, trajectory_cw=trajectory_cw)
        data = _png_bytes(img)
        with self._lock:
            self._images["map.png"] = data

    def publish_occupancy(self, logodds_2d):
        img = viz.occupancy_to_image(logodds_2d)
        data = _png_bytes(img)
        with self._lock:
            self._images["occ.png"] = data

    def publish_stats(self, **stats):
        with self._lock:
            self._stats.update(stats)

    # ---- HTTP side ----
    _PAGE = b"""<!doctype html><html><head><title>sgslam_tpu_torch</title>
<style>body{background:#111;color:#ddd;font-family:monospace}
img{image-rendering:pixelated;border:1px solid #333;margin:4px}</style>
<script>
async function tick(){
 for (const id of ['frame','map','occ']){
  const el=document.getElementById(id);
  el.src='/'+id+'.png?t='+Date.now();
 }
 try{const r=await fetch('/stats.json');
     document.getElementById('stats').textContent=
       JSON.stringify(await r.json());}catch(e){}
}
setInterval(tick, 500);
</script></head><body>
<h3>sgslam_tpu_torch live viewer</h3><div id=stats></div>
<img id=frame><img id=map><img id=occ>
</body></html>"""

    def start(self):
        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0].lstrip("/")
                if path in ("", "index.html"):
                    body, ctype = outer._PAGE, "text/html"
                elif path == "stats.json":
                    with outer._lock:
                        body = json.dumps(outer._stats).encode()
                    ctype = "application/json"
                else:
                    with outer._lock:
                        body = outer._images.get(path)
                    ctype = "image/png"
                    if body is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        import http.server as hs
        import socketserver

        class Server(socketserver.ThreadingMixIn, hs.HTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = Server(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]   # resolved if port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None
