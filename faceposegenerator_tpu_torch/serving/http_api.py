"""A small HTTP JSON API over `SamplerServer`, on the standard library
(port of `faceposegenerator_tpu/serving/http_api.py`).

POST /generate   {"prompt": str, "negative_prompt"?: str, "seed"?: int,
                  "lora_id"?: str, "output"?: "png_base64" | "none"}
    → {"seed", "lora_id", "queue_s", "batch_s", "image"?: base64 PNG}
GET  /stats      → the server's statistics
GET  /healthz    → {"ok": true}

A full queue answers 429 with Retry-After, a bad request 400, a server
that is shut down 503, a request that outlives its wait 504. Each
connection's handler thread waits on its request's Future while the card's
work stays on the engine's one worker thread, so concurrent requests
coalesce into batches.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .engine import GenerationRequest, QueueFull, SamplerServer


def _png_b64(image) -> str:
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_handler(server: SamplerServer):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for key, value in headers:
                self.send_header(key, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict) or "prompt" not in req:
                    self._reply(400, {"error": "missing field 'prompt'"})
                    return
                try:
                    fut = server.submit(GenerationRequest(
                        prompt=req["prompt"], negative_prompt=req.get("negative_prompt", ""),
                        seed=int(req.get("seed", 0)), lora_id=req.get("lora_id"),
                    ))
                except QueueFull as e:  # the bounded queue sheds load
                    self._reply(429, {"error": str(e)}, headers=[("Retry-After", "1")])
                    return
                except (KeyError, ValueError, TypeError) as e:  # unknown lora_id, bad seed
                    self._reply(400, {"error": str(e.args[0]) if e.args else str(e)})
                    return
                except RuntimeError as e:  # submit after shutdown
                    self._reply(503, {"error": str(e)})
                    return
                # a dead worker or an expired deadline must not hold the
                # handler (and the client) for ever
                timeout = server.request_timeout_s
                timeout = (timeout + 60.0) if timeout is not None else 600.0
                try:
                    res = fut.result(timeout=timeout)
                except (TimeoutError, FutureTimeout) as e:
                    self._reply(504, {"error": f"request timed out: {e}"})
                    return
                out = {"seed": res.seed, "lora_id": res.lora_id, "queue_s": round(res.queue_s, 4),
                       "batch_s": round(res.batch_s, 4)}
                if req.get("output", "png_base64") == "png_base64":
                    out["image"] = _png_b64(res.image)
                self._reply(200, out)
            except (KeyError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"malformed request: {e}"})
            except Exception as e:  # the handler thread reports; the server keeps serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet: server.stats() is the telemetry
            pass

    return Handler


def serve_http(server: SamplerServer, host: str = "127.0.0.1", port: int = 8000):
    """Serve the API in this thread until interrupted."""
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    httpd.serve_forever()


def start_http_background(server: SamplerServer, host: str = "127.0.0.1", port: int = 0):
    """The API on a daemon thread; returns (httpd, the bound port). Stop it
    with `httpd.shutdown(); httpd.server_close()`."""
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]
