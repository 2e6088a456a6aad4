"""The port's HTTP server and profiling helpers on the CPU: the form,
``/health`` and a 404; a JSON 500 for a form without a source image; a
``POST /synthesize`` at a tiny config whose body is the video of the same
``run`` called directly (twice, equal); the multipart parse against the JAX
server's ``cgi`` parse of one body; the server's refusal to start on a
missing card; ``Timer`` against the JAX package's, and ``trace_to``'s
Chrome trace."""

import http.client
import io
import json
import os
import sys
import threading
import wave

import numpy as np
import pytest
import torch
from http.server import ThreadingHTTPServer

from real3dportrait_tpu.inference import server as jserver
from real3dportrait_tpu.utils import profiling as jprofiling
from real3dportrait_tpu_torch import config as port_config
from real3dportrait_tpu_torch.inference import server
from real3dportrait_tpu_torch.inference.cli import load_image, load_wav
from real3dportrait_tpu_torch.inference.pipeline import Real3DPortraitPipeline, write_video
from real3dportrait_tpu_torch.utils import profiling
from tests.test_torch_audio import chirp_wav
from tests.test_torch_run import CONFIG, SMALL

torch.set_num_threads(1)


def multipart(fields: dict) -> tuple[bytes, str]:
    """(body, Content-Type) of a multipart/form-data form: a (filename,
    bytes) value is a file part, a str a plain field."""
    boundary = "----r3dp-test-boundary-7d1f"
    parts = []
    for name, value in fields.items():
        if isinstance(value, tuple):
            head = (f'Content-Disposition: form-data; name="{name}"; filename="{value[0]}"\r\n'
                    f"Content-Type: application/octet-stream\r\n\r\n").encode()
            data = value[1]
        else:
            head = f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode()
            data = value.encode()
        parts.append(f"--{boundary}\r\n".encode() + head + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def png_bytes(res: int, seed: int) -> bytes:
    from PIL import Image

    img = np.random.RandomState(seed).randint(0, 256, (res, res, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def wav_bytes(seconds: float, seed: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((chirp_wav(seconds, seed=seed) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def build_kwargs() -> dict:
    return dict(cfg=port_config.load_config(CONFIG, SMALL), seed=0, device="cpu")


@pytest.fixture
def port():
    """The port's handler on a free local port, with a fresh pipeline
    state (a tiny config on the CPU), restored afterwards."""
    saved = (server._State.pipeline, server._State.build_kwargs)
    server._State.pipeline, server._State.build_kwargs = None, build_kwargs()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        server._State.pipeline, server._State.build_kwargs = saved
    assert not thread.is_alive()


def request(port: int, method: str, path: str, fields: dict | None = None):
    """(status, headers, body) of one request to the local server, with a
    multipart form for ``fields``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        if fields is None:
            conn.request(method, path)
        else:
            body, ctype = multipart(fields)
            conn.request(method, path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_index_health_and_404(port):
    code, headers, body = request(port, "GET", "/")
    assert code == 200 and b"Synthesize" in body and headers["Content-Type"] == "text/html"
    code, _, body = request(port, "GET", "/health")
    assert code == 200 and json.loads(body) == {"status": "ok", "model_loaded": False}
    assert request(port, "POST", "/other", {"x": "1"})[::2] == (404, b"not found")


def test_form_without_src_img_is_a_json_500(port):
    code, headers, body = request(port, "POST", "/synthesize",
                                  {"drv_aud": ("a.wav", wav_bytes(0.1, 0))})
    assert code == 500 and headers["Content-Type"] == "application/json"
    assert "src_img" in json.loads(body)["error"]
    assert json.loads(request(port, "GET", "/health")[2])["status"] == "ok"  # still serving


@pytest.mark.parametrize("backend", ["video", "raw"])
def test_synthesize_is_the_direct_run(port, tmp_path, monkeypatch, backend):
    # a 64^2 png and 0.32 s of wav at temperature 0: the body is the video
    # that write_video makes of the same run called directly (8 frames),
    # and a second request gives the same body; with no video backend
    # (cv2 and imageio hidden) the body is the uint8 frames as an .npy
    if backend == "raw":
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setitem(sys.modules, "imageio", None)
    else:
        import cv2

        if not cv2.VideoWriter(str(tmp_path / "probe.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                               25, (64, 64)).isOpened():
            pytest.skip("no cv2 video encoder in this image")
    fields = {"src_img": ("src.png", png_bytes(64, 1)), "drv_aud": ("drv.wav", wav_bytes(0.32, 2)),
              "temperature": "0", "mouth_amp": "0.4"}
    code, headers, body = request(port, "POST", "/synthesize", fields)
    assert code == 200, body[:500]
    assert json.loads(request(port, "GET", "/health")[2])["model_loaded"] is True
    (tmp_path / "src.png").write_bytes(fields["src_img"][1])
    (tmp_path / "drv.wav").write_bytes(fields["drv_aud"][1])
    pipe = Real3DPortraitPipeline(**build_kwargs())
    frames = pipe.run(load_image(str(tmp_path / "src.png")),
                      wav=load_wav(str(tmp_path / "drv.wav")), temperature=0.0, mouth_amp=0.4)
    assert frames.shape == (8, 64, 64, 3)
    direct = tmp_path / "direct.mp4"
    write_video(frames, str(direct))
    if backend == "video":
        assert headers["Content-Type"] == "video/mp4" and body == direct.read_bytes()
    else:
        assert not direct.exists() and headers["Content-Type"] == "application/octet-stream"
        want = ((np.clip(frames.numpy(), -1, 1) + 1) * 127.5).astype(np.uint8)
        np.testing.assert_array_equal(np.load(io.BytesIO(body)), want)
    assert request(port, "POST", "/synthesize", fields)[2] == body


class _Request:
    """What a parser reads of a request handler: its headers and body."""

    def __init__(self, body: bytes, ctype: str):
        head = f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n\r\n".encode()
        self.headers = http.client.parse_headers(io.BytesIO(head))
        self.rfile = io.BytesIO(body)


def test_multipart_parse_matches_the_jax_servers():
    # a binary file part holding CRLFs, dashes and a fake boundary, an
    # empty file part, plain fields (one not ASCII): the same fields, bytes
    # for files and str for the rest, as the JAX server's cgi parse
    rng = np.random.RandomState(4)
    blob = rng.randint(0, 256, 4096).astype(np.uint8).tobytes()
    blob += b"\r\n--\r\n------r3dp-test-boundary\r\n\n\r" + bytes(range(256))
    fields = {"src_img": ("a.png", blob), "drv_aud": ("b.wav", b""), "temperature": "0.25",
              "mouth_amp": "0.4", "note": "café λ"}
    body, ctype = multipart(fields)
    got = server._parse_multipart(_Request(body, ctype))
    want = jserver._parse_multipart(_Request(body, ctype))
    assert got == want
    assert got["src_img"] == blob and got["temperature"] == "0.25"
    assert got["note"] == "café λ" and got["drv_aud"] == b""


def test_server_main_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the server would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--port", "0"])


def test_timer_matches_jax():
    # the same phases through both: equal counts, the same names, totals
    # that add each timed block's wall time; disabled blocks count nothing
    def phases(timer_cls):
        timer_cls.reset()
        for name, enable in (("fwd", True), ("bwd", True), ("fwd", True), ("skip", False)):
            with timer_cls(name, enable=enable):
                sum(range(1000))
        return dict(timer_cls.counts), timer_cls.report()

    try:
        got, want = phases(profiling.Timer), phases(jprofiling.Timer)
    finally:
        profiling.Timer.reset()
        jprofiling.Timer.reset()
    assert got[0] == want[0] == {"fwd": 2, "bwd": 1}
    assert sorted(got[1]) == sorted(want[1]) == ["bwd", "fwd"]
    assert all(v > 0 for v in got[1].values())
    assert profiling.Timer.report() == {}


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with profiling.trace_to(str(tmp_path / "trace")) as prof:
        with profiling.named_scope("port_span"):
            (torch.ones(64) * 2).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".json")
    events = json.loads((tmp_path / "trace" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "port_span" for e in events)
    assert any(e.key == "port_span" for e in prof.key_averages())
