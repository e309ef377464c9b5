"""Live viewer: the reference's SDL window (src/main.cc:81-208) as a local
HTTP page.  Counterpart of ``tools/live_viewer.py``.

Endpoints:

* ``/``          the viewer page: the frame stream, an FPS overlay over
                 5-frame windows (main.cc:21,106-200), WASD keys and mouse
                 drag to look (each event renders again), click to run the
                 debug probe (its narration goes to the server's stdout,
                 main.cc:181-186);
* ``/stream``    multipart/x-mixed-replace PNG stream of the frames;
* ``/frame.png`` the latest frame;
* ``/stats``     ``{"fps": ..., "frames": ..., "render_ms": ...}``
                 (``render_ms``: the last window's mean render + encode
                 ms a frame);
* ``/key?k=w``, ``/mouse?dx=..&dy=..``, ``/click?x=..&y=..``: the controls.

Run::

    python -m raytracer_tpu_torch.live_viewer -c WORLD.json [--port 8787]
        [--width 320 --height 240] [--device cuda]
    python -m raytracer_tpu_torch.live_viewer -c WORLD.json --selftest

``--device`` defaults to ``cuda`` and does not fall back to the CPU
(``--device cpu`` asks for it).  The first frame is rendered before the
server starts, so the CUDA kernel library is built and loaded before any
handler thread runs.  The render thread renders a snapshot of the camera
taken under the lock; every camera and render call runs under an explicit
device guard, so nothing depends on a thread's current CUDA device.
``--selftest`` starts the server, fetches the page and a frame, sends a
key and a mouse move, waits until at least two frames were rendered and
the PNG changed, prints ``selftest OK`` and exits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time

from raytracer_tpu_torch.cli import SAMPLE_PERIOD, FpsWindow

SELFTEST_TIMEOUT_S = 300.0  # the moved camera's frame must arrive by then

PAGE = """<!doctype html>
<html><head><title>raytracer-tpu live</title><style>
body { background:#111; color:#eee; font-family:monospace; margin:0 }
#wrap { position:relative; display:inline-block }
#fps { position:absolute; top:6px; left:8px; color:#0f0;
       text-shadow:1px 1px 2px #000; font-size:16px }
img { display:block; image-rendering:pixelated }
p { margin:6px 8px }
</style></head><body>
<div id="wrap"><img id="view" src="/stream"><div id="fps">FPS: --</div></div>
<p>wasd: move &nbsp; drag: look &nbsp; click: debug ray (server console)</p>
<script>
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  document.getElementById('fps').textContent = 'FPS: ' + s.fps.toFixed(1);
}, 500);
document.addEventListener('keydown', e => {
  if ('wasd'.includes(e.key)) fetch('/key?k=' + e.key);
});
let drag = null;
const img = document.getElementById('view');
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', e => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  fetch(`/mouse?dx=${dx}&dy=${dy}`);
});
img.addEventListener('click', e => {
  const r = img.getBoundingClientRect();
  fetch(`/click?x=${Math.round(e.clientX - r.left)}` +
        `&y=${Math.round(e.clientY - r.top)}`);
});
</script></body></html>"""


class Viewer:
    """The world, its camera and the latest frame; the camera, the frame
    and the counters are read and written under ``lock``."""

    def __init__(self, config: str, width: int, height: int, device: str):
        import raytracer_tpu_torch as rtt
        from raytracer_tpu_torch.builder import scale_camera
        from raytracer_tpu_torch.cli import _device

        self.device = _device(device)
        world = rtt.generate(config)
        cfg = world.config
        cam = world.camera
        if width:
            cam = scale_camera(cam, width, cfg.width)
            cfg = cfg.replace(width=width)
        if height:
            cfg = cfg.replace(height=height)
        self.cfg = cfg.replace(engine="cuda")
        self.scene = rtt.to_device(world.scene, self.device)
        self.camera = rtt.to_device(cam, self.device)
        self.lock = threading.Lock()
        self.png = b""
        self.fps = 0.0
        self.render_ms = 0.0
        self.frames = 0
        self.dirty = threading.Event()
        self.stopping = threading.Event()

    def on_device(self):
        """A guard that makes ``self.device`` the thread's current CUDA
        device (kernel launches go to the current device)."""
        if self.device.type == "cuda":
            import torch

            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def render_once(self) -> bytes:
        """Render the camera as it is now, encode it and publish it."""
        import torch

        from raytracer_tpu_torch.pngio import encode_png
        from raytracer_tpu_torch.render import render_frame
        from raytracer_tpu_torch.render.engine import frame_to_u8

        with self.lock:
            cam = self.camera
        with self.on_device(), torch.no_grad():
            img = frame_to_u8(render_frame(self.scene, cam, self.cfg))
            png = encode_png(img.cpu().numpy()[..., :3], level=1)
        with self.lock:
            self.png = png
            self.frames += 1
        return png

    def loop(self):
        """Render whenever the camera changed, until ``stopping`` is set;
        FPS over ``SAMPLE_PERIOD``-frame windows."""
        window, busy = FpsWindow(), 0.0
        while True:
            self.dirty.wait()
            if self.stopping.is_set():
                return
            self.dirty.clear()
            t = time.perf_counter()
            self.render_once()
            busy += time.perf_counter() - t
            fps = window.tick()
            if fps is not None:
                with self.lock:
                    self.fps = fps
                    self.render_ms = busy / SAMPLE_PERIOD * 1e3
                busy = 0.0

    # -- controls (reference: WASD translate, mouse motion rotates) ------
    def key(self, k: str):
        from raytracer_tpu_torch import camera_motion as cm

        if k not in ("w", "a", "s", "d"):
            raise ValueError(f"key {k!r}: one of w, a, s, d")
        with self.lock, self.on_device():
            self.camera = cm.key_move(self.camera, k)
        self.dirty.set()

    def mouse(self, dx: float, dy: float):
        from raytracer_tpu_torch import camera_motion as cm

        with self.lock, self.on_device():
            self.camera = cm.mouse_look(self.camera, dx, dy)
        self.dirty.set()

    def click(self, x: int, y: int):
        from raytracer_tpu_torch.debug import debug_cast

        if not (0 <= x < self.cfg.width and 0 <= y < self.cfg.height):
            raise ValueError(f"pixel ({x}, {y}) outside the "
                             f"{self.cfg.width}x{self.cfg.height} frame")
        with self.lock:
            cam = self.camera
        print(f"debug ray at ({x}, {y}):", flush=True)
        with self.on_device():
            debug_cast(self.scene, cam, self.cfg, x, y)


def serve(viewer: Viewer, port: int):
    """The HTTP server on 127.0.0.1:``port`` and the render thread, both
    started here (``serve_forever`` in a thread of its own).  Returns
    ``stop()``, which shuts both down and joins them."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self):
            self.send_response(200)
            self.send_header("Content-Type",
                             "multipart/x-mixed-replace; boundary=frame")
            self.end_headers()
            last = -1
            try:
                while True:
                    with viewer.lock:
                        png, n = viewer.png, viewer.frames
                    if n != last and png:
                        last = n
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/png\r\n"
                            + f"Content-Length: {len(png)}\r\n\r\n".encode()
                            + png + b"\r\n")
                    time.sleep(0.02)
            except (BrokenPipeError, ConnectionResetError):
                return

        def do_GET(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)
            try:
                if u.path == "/":
                    self._send(200, "text/html", PAGE.encode())
                elif u.path == "/frame.png":
                    with viewer.lock:
                        png = viewer.png
                    self._send(200, "image/png", png)
                elif u.path == "/stats":
                    with viewer.lock:
                        body = json.dumps({"fps": viewer.fps,
                                           "frames": viewer.frames,
                                           "render_ms": viewer.render_ms})
                    self._send(200, "application/json", body.encode())
                elif u.path == "/stream":
                    self._stream()
                elif u.path == "/key":
                    viewer.key(q.get("k", ["w"])[0])
                    self._send(200, "text/plain", b"ok")
                elif u.path == "/mouse":
                    viewer.mouse(float(q.get("dx", [0])[0]),
                                 float(q.get("dy", [0])[0]))
                    self._send(200, "text/plain", b"ok")
                elif u.path == "/click":
                    viewer.click(int(q.get("x", [0])[0]),
                                 int(q.get("y", [0])[0]))
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(404, "text/plain", b"not found")
            except ValueError as e:  # a malformed control from the page
                self._send(400, "text/plain", str(e).encode())

    srv = ThreadingHTTPServer(("127.0.0.1", port), H)
    srv.daemon_threads = True  # open /stream connections end with the process
    threads = [threading.Thread(target=viewer.loop),
               threading.Thread(target=srv.serve_forever)]
    for t in threads:
        t.start()
    print(f"live viewer on http://127.0.0.1:{port}/ "
          f"({viewer.cfg.width}x{viewer.cfg.height}, {viewer.cfg.engine} "
          f"engine, {viewer.device})", flush=True)

    def stop():
        srv.shutdown()
        srv.server_close()
        viewer.stopping.set()
        viewer.dirty.set()  # wake the render thread
        for t in threads:
            t.join()

    return stop


def selftest(viewer: Viewer, port: int) -> dict:
    """Page, frame, two moves, then wait for the moved frame: at least two
    frames rendered and a PNG that differs from the first.  Returns the
    stats; raises on a failed check."""
    import urllib.request

    base = f"http://127.0.0.1:{port}"

    def get(path):
        with urllib.request.urlopen(base + path) as r:
            return r.read()

    page = get("/")
    if b"raytracer-tpu live" not in page:
        raise AssertionError("the page lacks its title")
    png = get("/frame.png")
    if png[:8] != b"\x89PNG\r\n\x1a\n" or len(png) <= 100:
        raise AssertionError(f"/frame.png: {png[:16]!r}, {len(png)} bytes")
    get("/key?k=w")
    get("/mouse?dx=5&dy=0")
    deadline = time.perf_counter() + SELFTEST_TIMEOUT_S
    while True:  # the moved camera's frame
        stats = json.loads(get("/stats"))
        png2 = get("/frame.png")
        if stats["frames"] >= 2 and png2 != png and not viewer.dirty.is_set():
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"no moved frame in {SELFTEST_TIMEOUT_S} "
                                 f"s: {stats}")
        time.sleep(0.05)
    # SAMPLE_PERIOD moves more, each after the frame before it, so that one
    # FPS window fills
    for i in range(SAMPLE_PERIOD):
        before = stats["frames"]
        get(f"/mouse?dx={-1 if i % 2 else 1}&dy=0")
        while stats["frames"] == before:
            if time.perf_counter() > deadline:
                raise AssertionError(f"a move rendered no frame: {stats}")
            time.sleep(0.01)
            stats = json.loads(get("/stats"))
    return json.loads(get("/stats"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda; no "
                         "fallback to the CPU)")
    ap.add_argument("--selftest", action="store_true",
                    help="start, fetch page/frame/stats/controls, exit")
    args = ap.parse_args(argv)

    viewer = Viewer(args.config, args.width, args.height, args.device)
    viewer.render_once()
    stop = serve(viewer, args.port)
    try:
        if args.selftest:
            stats = selftest(viewer, args.port)
            print(f"selftest OK: frames={stats['frames']} "
                  f"fps={stats['fps']:.2f} render_ms={stats['render_ms']:.3f}",
                  flush=True)
            return 0
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        pass
    finally:
        stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
