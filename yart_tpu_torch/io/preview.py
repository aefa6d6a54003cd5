"""Live progressive preview over HTTP.

Port of `yart_tpu/io/preview.py`. The reference's viewer is a macOS Metal +
SDL2 window (src/frontend/metal-sdl2/main.cpp:18-310); a renderer on a
headless card host serves instead an auto-refreshing page with the latest
tonemapped frame (PNG), the render's progress and client-side pan / zoom,
from `http.server` in a thread of the rendering process. Frames are
encoded with the port's own `io/image.py` `encode_png` (no PIL). The
server binds to loopback unless given another host. Push frames with
`update()` from the renderer's `on_wave` / `on_chunk` callbacks.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from yart_tpu_torch.io.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>yart-tpu live view</title><style>
 body { margin:0; background:#111; color:#ccc; font:13px monospace; overflow:hidden; }
 #bar { position:fixed; top:0; left:0; right:0; padding:6px 10px; background:#000a; }
 #wrap { position:absolute; inset:0; display:flex; align-items:center; justify-content:center; }
 img { image-rendering:pixelated; transform-origin:center center; }
</style></head><body>
<div id="wrap"><img id="im" src="/frame.png"></div><div id="bar">connecting…</div>
<script>
let zoom = 1, px = 0, py = 0, drag = null;
const im = document.getElementById('im'), bar = document.getElementById('bar');
function apply() { im.style.transform = `translate(${px}px,${py}px) scale(${zoom})`; }
addEventListener('wheel', e => { zoom *= Math.exp(-e.deltaY * 0.001); apply(); });
addEventListener('mousedown', e => drag = [e.clientX - px, e.clientY - py]);
addEventListener('mousemove', e => { if (drag) { px = e.clientX - drag[0]; py = e.clientY - drag[1]; apply(); } });
addEventListener('mouseup', () => drag = null);
async function tick() {
  try {
    const st = await (await fetch('/status')).json();
    bar.textContent = `wave ${st.wave}  ${st.samples_taken}/${st.total_samples} spp  ` +
                      `${st.mrays.toFixed(2)} Mrays/s  ${st.time.toFixed(1)}s` +
                      (st.done ? '  [done]' : '');
    if (st.frame !== window._f) { window._f = st.frame; im.src = '/frame.png?' + st.frame; }
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class PreviewServer:
    """Serve the latest preview frame; `update()` is thread-safe."""

    def __init__(self, port: int = 8000, host: str = "127.0.0.1"):
        # Loopback by default: a render must not be exposed on every
        # interface of a shared host unless asked (host="0.0.0.0").
        self._lock = threading.Lock()
        self._png = b""
        self._status = {
            "wave": 0, "samples_taken": 0, "total_samples": 0,
            "mrays": 0.0, "time": 0.0, "frame": 0, "done": False,
        }
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with outer._lock:
                        body = outer._png
                    ctype = "image/png"
                elif self.path.startswith("/status"):
                    with outer._lock:
                        body = json.dumps(outer._status).encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def update(self, display_rgb, wave_data=None, done: bool = False):
        """display_rgb: [H, W, 3] floats in [0, 1] (the tonemapper's output,
        as `write_png` takes it); `wave_data` a WaveData for the status."""
        png = encode_png(display_rgb)
        with self._lock:
            self._png = png
            self._status["frame"] += 1
            self._status["done"] = done
            if wave_data is not None:
                self._status.update(
                    wave=wave_data.wave,
                    samples_taken=wave_data.samples_taken,
                    total_samples=wave_data.total_samples,
                    mrays=wave_data.rays / max(wave_data.time, 1e-9) / 1e6,
                    time=wave_data.time,
                )

    def close(self):
        self._server.shutdown()
        self._server.server_close()
