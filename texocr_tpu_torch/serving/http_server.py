"""HTTP serving front end over the micro-batching engine.

A dependency-free server (stdlib ``http.server``) in front of
:class:`~texocr_tpu_torch.serving.batcher.ServingBatcher`, so concurrent HTTP
clients are micro-batched onto the card instead of served one image at a time.

Endpoints:
  - ``POST /ocr``: the request body is the raw image file (PNG, read without
    PIL; other formats through PIL where it is installed). Responds
    ``{"tokens": [...], "latex": "..."}``.
  - ``GET /healthz``: liveness and the engine's decode settings.

Decode settings (mode, max_len) are fixed per server instance, not per
request; start one server per decode configuration.

Run (a ``.json`` config needs no PyYAML):
  python -m texocr_tpu_torch.serving.http_server --config config.json \\
      --checkpoint model.pth --port 8000 --mode greedy --max_len 350 --device cuda
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from texocr_tpu_torch.serving.batcher import ServingBatcher
from texocr_tpu_torch.serving.image_io import decode_image

MAX_BODY_BYTES = 32 * 1024 * 1024  # generous for rendered-equation PNGs


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _send_json(self, code: int, payload: dict, close: bool = False) -> None:
        # close=True on every error path that did not read the request body:
        # under HTTP/1.1 keep-alive the unread bytes would otherwise be parsed
        # as the next request line.
        if close:
            self.close_connection = True
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if close:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # route through the server's flag
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.rstrip("/") in ("", "/healthz"):
            self._send_json(200, {"status": "ok", "warm": self.server.batcher.warm,
                                  **self.server.info})
        else:
            self._send_json(404, {"error": f"no such endpoint: {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path.rstrip("/") != "/ocr":
            self._send_json(404, {"error": f"no such endpoint: {self.path}"}, close=True)
            return
        if self.server.require_warm and not self.server.batcher.warm:
            self._send_json(503, {"error": "warming up, retry shortly"}, close=True)
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0:
            self._send_json(400, {"error": "empty request body"}, close=True)
            return
        if length > MAX_BODY_BYTES:
            self._send_json(413, {"error": "request body too large"}, close=True)
            return
        data = self.rfile.read(length)
        try:
            img = decode_image(data)
        except Exception as e:  # any decoder failure is the client's bad image
            self._send_json(400, {"error": f"unreadable image: {e}"})
            return
        try:
            tokens, latex = self.server.batcher.submit(img).result()
        except Exception as e:  # the server keeps answering; this request failed
            self._send_json(500, {"error": f"decode failed: {e}"})
            return
        self._send_json(200, {"tokens": [int(t) for t in tokens], "latex": latex})


def make_server(batcher: ServingBatcher, host: str = "127.0.0.1", port: int = 8000,
                verbose: bool = False, require_warm: bool = False) -> ThreadingHTTPServer:
    """Bind (not yet serving): call ``serve_forever()`` or ``serve_in_thread``.
    ``port=0`` picks a free port (``server.server_address``).
    ``require_warm=True`` makes /ocr return 503 until ``batcher.warm``: pair it
    with a background warmup."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.batcher = batcher
    server.verbose = verbose
    server.require_warm = require_warm
    server.info = {"mode": batcher.mode, "max_len": batcher.max_len,
                   "max_batch": batcher.max_batch}
    return server


def serve_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="HTTP OCR server (micro-batched decode on the GPU).")
    p.add_argument("--config", type=str, default="config/config.yml",
                   help="configuration file (.yml, or .json without PyYAML)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference state dict (.pth/.pt) or .npz")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--mode", type=str, default="greedy", choices=["greedy", "beam", "sample"])
    p.add_argument("--max_len", type=int, default=350)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--request_timeout_s", type=float, default=120.0,
                   help="fail requests queued longer than this (0 disables)")
    p.add_argument("--warmup", type=str, default="160x1008",
                   help="comma-separated HxW canvases to run once before accepting "
                        "requests (default the flagship canvas; 'none' to skip)")
    p.add_argument("--background_warmup", action="store_true",
                   help="listen immediately and 503 /ocr until the warmup finishes")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from texocr_tpu_torch.config import load_config
    from texocr_tpu_torch.serving.wrapper import TexOCR

    args = parse_args(argv)
    config = load_config(args.config)
    if args.checkpoint:
        config["model_path"] = args.checkpoint
    engine = TexOCR(config, device=args.device)
    batcher = ServingBatcher(engine, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                             max_len=args.max_len, mode=args.mode,
                             request_timeout_s=args.request_timeout_s or None)
    shapes = []
    if args.warmup and args.warmup.lower() != "none":
        for part in args.warmup.split(","):
            h, w = part.lower().split("x")
            shapes.append((int(h), int(w)))
    if shapes and not args.background_warmup:
        print(f"warming up {len(shapes)} canvas(es) ...", flush=True)
        batcher.warmup(shapes)
    # require_warm only when something will flip `warm`: with no warmup
    # shapes a 503 gate would never open.
    server = make_server(batcher, args.host, args.port, verbose=args.verbose,
                         require_warm=args.background_warmup and bool(shapes))
    if shapes and args.background_warmup:
        threading.Thread(target=batcher.warmup, args=(shapes,), daemon=True).start()
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  (mode={args.mode}, max_len={args.max_len}, "
          f"device={args.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        batcher.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
