"""HTTP serving of one-shot portrait synthesis (port of
``real3dportrait_tpu/inference/server.py``): a small HTML form and a
JSON/HTTP API over :meth:`Real3DPortraitPipeline.run`, standard library
only.

Run: ``python -m real3dportrait_tpu_torch.inference.server --port 7860
[--mock_weights] [--hparams ...] [--device cuda]``, then open
http://localhost:7860.

Endpoints:
  GET  /            HTML form
  GET  /health      {"status": "ok", "model_loaded": ...}
  POST /synthesize  multipart: src_img (png/jpg), drv_aud (16 kHz wav),
                    optional temperature / mouth_amp fields
                    -> an mp4 video (or the uint8 frames as .npy where no
                    video backend opens)

The pipeline keeps per-video caches and advances its sampling generator on
every call, so one lock holds each request's ``run`` and video writing;
the server still answers other requests (``/health``) meanwhile.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import threading
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_INDEX_HTML = """<!doctype html>
<title>real3dportrait_tpu_torch</title>
<h2>One-shot talking portrait (GPU)</h2>
<form action="/synthesize" method="post" enctype="multipart/form-data">
  <p>Source portrait (png/jpg): <input type="file" name="src_img" required></p>
  <p>Driving audio (16 kHz wav): <input type="file" name="drv_aud" required></p>
  <p>Temperature: <input type="number" step="0.05" name="temperature" value="0.2"></p>
  <p>Mouth amplitude: <input type="number" step="0.05" name="mouth_amp" value="0.4"></p>
  <p><input type="submit" value="Synthesize"></p>
</form>
"""


class _State:
    pipeline = None
    lock = threading.Lock()       # builds the pipeline once
    run_lock = threading.Lock()   # one request at a time in the pipeline
    build_kwargs: dict = {}


def get_pipeline():
    with _State.lock:
        if _State.pipeline is None:
            from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline

            _State.pipeline = Real3DPortraitPipeline(**_State.build_kwargs)
        return _State.pipeline


def _parse_multipart(handler) -> dict:
    """The fields of a ``multipart/form-data`` body: bytes for a file part,
    str for any other (the fields ``cgi.FieldStorage`` gives)."""
    length = int(handler.headers.get("Content-Length", 0) or 0)
    body = handler.rfile.read(length)
    head = f"Content-Type: {handler.headers.get('Content-Type', '')}\r\n\r\n".encode()
    msg = BytesParser(policy=HTTP).parsebytes(head + body)
    out = {}
    if not msg.is_multipart():
        return out
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None or name in out:
            continue
        data = part.get_payload(decode=True) or b""
        out[name] = data if part.get_filename() else data.decode(
            part.get_content_charset() or "utf-8", "replace")
    return out


def _video_body(out_path: str) -> tuple[bytes, str, str]:
    """(body, content type, file name) of what ``write_video`` wrote: the
    mp4, or its raw frames (``.raw`` with ``.meta.json``) as an .npy."""
    if os.path.isfile(out_path):
        with open(out_path, "rb") as f:
            return f.read(), "video/mp4", "out.mp4"
    with open(out_path + ".meta.json") as f:
        meta = json.load(f)
    frames = np.fromfile(out_path + ".raw", np.uint8).reshape(meta["frames"], *meta["shape"])
    buf = io.BytesIO()
    np.save(buf, frames)
    return buf.getvalue(), "application/octet-stream", "out.npy"


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str = "text/html"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            ready = _State.pipeline is not None
            self._send(200, json.dumps({"status": "ok", "model_loaded": ready}).encode(),
                       "application/json")
        else:
            self._send(200, _INDEX_HTML.encode())

    def do_POST(self):
        if self.path != "/synthesize":
            self._send(404, b"not found")
            return
        try:
            from real3dportrait_tpu_torch.inference.cli import load_image, load_wav
            from real3dportrait_tpu_torch.inference.pipeline import write_video

            fields = _parse_multipart(self)
            with tempfile.TemporaryDirectory() as td:
                img_path = os.path.join(td, "src.png")
                wav_path = os.path.join(td, "drv.wav")
                with open(img_path, "wb") as f:
                    f.write(fields["src_img"])
                with open(wav_path, "wb") as f:
                    f.write(fields["drv_aud"])
                src = load_image(img_path)
                wav = load_wav(wav_path)
                pipe = get_pipeline()
                out_path = os.path.join(td, "out.mp4")
                with _State.run_lock:
                    frames = pipe.run(
                        src, wav=wav,
                        temperature=float(fields.get("temperature", 0.2)),
                        mouth_amp=float(fields.get("mouth_amp", 0.4)),
                    )
                    write_video(frames, out_path)
                body, ctype, name = _video_body(out_path)
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Disposition", f"attachment; filename={name}")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except Exception as e:  # report errors as JSON, keep the server alive
            self._send(500, json.dumps({"error": repr(e)}).encode(), "application/json")


def serve(port: int = 7860, **build_kwargs):
    _State.build_kwargs = build_kwargs
    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    print(f"| serving on http://localhost:{port}")
    server.serve_forever()


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description="HTTP server of the port's run")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--mock_weights", action="store_true")
    p.add_argument("--a2m_ckpt", default="")
    p.add_argument("--s2v_ckpt", default="")
    p.add_argument("--hparams", default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from real3dportrait_tpu_torch import entry_device
    from real3dportrait_tpu_torch.utils.precision import set_fp32_policy

    set_fp32_policy()
    entry_device(args.device)  # no card: fail now, not at the first request
    kwargs = dict(mock_weights=args.mock_weights or not (args.a2m_ckpt and args.s2v_ckpt),
                  a2m_ckpt_dir=args.a2m_ckpt, secc2video_ckpt_dir=args.s2v_ckpt,
                  device=args.device)
    if args.hparams:
        from real3dportrait_tpu_torch.config import load_config, parse_overrides
        from real3dportrait_tpu_torch.inference.pipeline import DEFAULT_CONFIG

        kwargs["cfg"] = load_config(DEFAULT_CONFIG, parse_overrides(args.hparams))
    serve(args.port, **kwargs)


if __name__ == "__main__":
    main()
