"""The port's serving surface beyond greedy: TexOCR in beam and sample modes
against the JAX wrapper, the micro-batcher (the behaviours of
tests/test_batcher.py), the HTTP server (those of tests/test_http_server.py),
the PIL-free PNG reader against PIL's ``convert("L")``, and the serving CLI on
the CPU."""

import io
import json
import struct
import threading
import time
import types
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from tests.tiny import TINY_CONFIG
from texocr_tpu.serving import TexOCR as JaxTexOCR
from texocr_tpu_torch.checkpoint import state_dict_from_jax
from texocr_tpu_torch.serving import TexOCR
from texocr_tpu_torch.serving import cli as serving_cli
from texocr_tpu_torch.serving.batcher import ServingBatcher
from texocr_tpu_torch.serving.http_server import make_server, parse_args, serve_in_thread
from texocr_tpu_torch.serving.image_io import decode_image, decode_png
from texocr_tpu_torch.tokenizer import DEFAULT_VOCAB_PATH

torch.set_num_threads(1)
MAX_LEN = 30


def _config(**overrides):
    cfg = {k: v for k, v in TINY_CONFIG.items() if k not in ("vocab_size", "max_length")}
    cfg.update(tokenizer_path=DEFAULT_VOCAB_PATH, bos_token=998, eos_token=997,
               trg_pad_idx=999, dtype="float32", use_flash_attention=False)
    cfg.update(overrides)
    return cfg


def _ink(rng, h, w):
    img = np.full((h, w), 255, np.uint8)
    img[rng.integers(0, h, 60), rng.integers(0, w, 60)] = 0
    return img


@pytest.fixture(scope="module")
def engines():
    jax_engine = JaxTexOCR(_config())
    port = TexOCR(_config(), device="cpu", state_dict=state_dict_from_jax(jax_engine.params))
    return jax_engine, port


# -- wrapper modes --------------------------------------------------------------


@pytest.mark.parametrize("beam_size", [1, 3])
def test_beam_mode_equals_jax_ids_and_latex(engines, beam_size):
    jax_engine, port = engines
    img = Image.fromarray(_ink(np.random.default_rng(beam_size), 20, 50))
    want = jax_engine(img, max_len=MAX_LEN, mode="beam", beam_size=beam_size)
    assert port(img, max_len=MAX_LEN, mode="beam", beam_size=beam_size) == want


def test_sample_mode_runs_and_advances_its_generator(engines):
    """temp 1e-4 gives greedy's answer (over 8 steps: later steps of the random
    model hold near-ties closer than the noise at that temperature); the
    generator, seeded from the config (42), advances with every sampled call."""
    _, port = engines
    img = _ink(np.random.default_rng(7), 20, 50)
    assert port(img, max_len=8, mode="sample", temp=1e-4) == port(img, max_len=8)
    assert port.generator.initial_seed() == 42
    state = port.generator.get_state().clone()
    ids, latex = port(img, max_len=MAX_LEN, mode="sample")
    assert not torch.equal(state, port.generator.get_state())
    assert all(0 <= i < 1000 for i in ids) and isinstance(latex, str)


def test_int8_config_serves(engines):
    jax_engine, _ = engines
    cfg = _config(kv_quant="int8", self_kv_quant="int8")
    port = TexOCR(cfg, device="cpu", state_dict=state_dict_from_jax(jax_engine.params))
    img = Image.fromarray(_ink(np.random.default_rng(4), 20, 50))
    assert port(img, max_len=MAX_LEN) == JaxTexOCR(cfg, params=jax_engine.params)(
        img, max_len=MAX_LEN)


# -- micro-batcher (stub engine, no model) --------------------------------------


class _StubEngine:
    """TexOCR stand-in: identity preprocess, constant decode on a tensor."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s
        self.calls = 0

    def preprocess(self, img):
        arr = np.asarray(img, np.uint8)
        return arr.reshape((1,) + arr.shape + (1,))

    def generate_batch(self, canvases, max_len=350, temp=0.3, mode="greedy", **kw):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return torch.full((canvases.shape[0], 4), 997, dtype=torch.int64)

    def postprocess(self, row):
        return [int(t) for t in row], "x"


def _img(h=8, w=8):
    return np.full((h, w), 255, np.uint8)


def test_batcher_round_trip_and_warm_flag():
    eng = _StubEngine()
    b = ServingBatcher(eng, max_batch=2, max_wait_ms=1.0)
    assert b.warm is False
    tokens, latex = b.submit(_img()).result(timeout=10)
    assert latex == "x" and len(tokens) == 4
    assert b.warm is True and eng.calls == 1
    b.shutdown()


def test_batcher_warmup_sets_warm():
    eng = _StubEngine()
    b = ServingBatcher(eng, max_batch=2)
    b.warmup([(8, 8)])
    assert b.warm is True
    assert eng.calls == len(b.batch_sizes)  # one run per batch size
    b.shutdown()


def test_batcher_submit_after_shutdown_raises():
    b = ServingBatcher(_StubEngine(), max_batch=2)
    b.shutdown()
    with pytest.raises(RuntimeError):
        b.submit(_img())


def test_batcher_request_timeout_expires_stale_requests():
    b = ServingBatcher(_StubEngine(delay_s=0.5), max_batch=1, max_wait_ms=0.0,
                       request_timeout_s=0.05)
    first = b.submit(_img())
    time.sleep(0.1)  # the worker takes `first` alone (max_batch=1)
    second = b.submit(_img())
    assert first.result(timeout=10)[1] == "x"
    with pytest.raises(TimeoutError):
        second.result(timeout=10)
    b.shutdown()


def test_batcher_shutdown_fails_queued_futures():
    b = ServingBatcher(_StubEngine(delay_s=0.5), max_batch=1, max_wait_ms=0.0)
    b.submit(_img())
    time.sleep(0.1)
    late = b.submit(_img())
    shut = threading.Thread(target=b.shutdown)
    shut.start()
    # Either the worker drains it before exiting or shutdown fails it: it
    # must not block.
    try:
        late.result(timeout=10)
    except RuntimeError:
        pass
    shut.join(timeout=10)
    assert not shut.is_alive()


def test_batcher_groups_canvases_and_pads_batches():
    """Requests of two canvases within one wait window form one batch per
    canvas, each padded with zero canvases to the least batch size (1 or 4)
    that holds it."""
    seen = []

    class Recording(_StubEngine):
        def generate_batch(self, canvases, **kw):
            requests = int((canvases.reshape(len(canvases), -1).max(1) > 0).sum())
            seen.append((canvases.shape, requests))  # the padding canvases are zero
            return super().generate_batch(canvases, **kw)

    b = ServingBatcher(Recording(delay_s=0.2), max_batch=4, max_wait_ms=200.0)
    futs = [b.submit(_img(8, 8)), b.submit(_img(16, 8)), b.submit(_img(8, 8))]
    assert all(f.result(timeout=10)[1] == "x" for f in futs)
    b.shutdown()
    assert sorted(seen) == [((1, 16, 8, 1), 1), ((4, 8, 8, 1), 2)]


# -- HTTP server ----------------------------------------------------------------


@pytest.fixture(scope="module")
def server_url():
    engine = TexOCR(_config(img_size=(32, 128), max_length=64), device="cpu")
    batcher = ServingBatcher(engine, max_batch=4, max_len=6)
    server = make_server(batcher, port=0)  # an ephemeral port
    serve_in_thread(server)
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}"
    server.shutdown()
    batcher.shutdown()


def _png_bytes(h=30, w=100, mode="L"):
    buf = io.BytesIO()
    Image.fromarray(np.full((h, w), 255, np.uint8)).convert(mode).save(buf, format="PNG")
    return buf.getvalue()


def test_http_healthz(server_url):
    with urllib.request.urlopen(f"{server_url}/healthz", timeout=30) as r:
        payload = json.loads(r.read())
    assert payload["status"] == "ok"
    assert payload["mode"] == "greedy"
    assert payload["max_batch"] == 4


def test_http_ocr_post_round_trip(server_url):
    req = urllib.request.Request(f"{server_url}/ocr", data=_png_bytes(),
                                 headers={"Content-Type": "image/png"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        payload = json.loads(r.read())
    assert isinstance(payload["tokens"], list)
    assert all(isinstance(t, int) for t in payload["tokens"])
    assert isinstance(payload["latex"], str)


def test_http_concurrent_requests_batch(server_url):
    def post(i):
        req = urllib.request.Request(f"{server_url}/ocr",
                                     data=_png_bytes(mode="RGB" if i % 2 else "L"),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    with ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(post, range(4)))
    assert len(results) == 4
    assert all("latex" in p for p in results)


def test_http_bad_image_is_400(server_url):
    req = urllib.request.Request(f"{server_url}/ocr", data=b"this is not an image",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 400
    assert "error" in json.loads(exc.value.read())


def test_http_empty_body_is_400(server_url):
    req = urllib.request.Request(f"{server_url}/ocr", data=b"", method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 400


def test_http_unknown_route_is_404(server_url):
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"{server_url}/nope", timeout=30)
    assert exc.value.code == 404


def test_http_error_paths_close_keepalive_connection(server_url):
    import http.client
    from urllib.parse import urlparse

    u = urlparse(server_url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request("POST", "/nope", body=b"x" * 1024,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        assert resp.status == 404
        assert resp.getheader("Connection") == "close"
        resp.read()
    finally:
        conn.close()


def test_http_healthy_post_keeps_connection_alive(server_url):
    import http.client
    from urllib.parse import urlparse

    u = urlparse(server_url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        for _ in range(2):
            conn.request("POST", "/ocr", body=_png_bytes(), headers={"Content-Type": "image/png"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert "latex" in json.loads(resp.read())
    finally:
        conn.close()


def test_http_503_until_warm():
    stub = types.SimpleNamespace(warm=False, mode="greedy", max_len=6, max_batch=4)
    server = make_server(stub, port=0, require_warm=True)
    serve_in_thread(server)
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    try:
        req = urllib.request.Request(f"{url}/ocr", data=b"zz", method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 503
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.loads(r.read())["warm"] is False
    finally:
        server.shutdown()


def test_http_server_flags_default_to_cuda():
    args = parse_args([])
    assert args.device == "cuda" and args.mode == "greedy" and args.max_len == 350
    assert parse_args(["--device", "cpu", "--mode", "beam"]).mode == "beam"


# -- PNG reader -------------------------------------------------------------------


def _pil_png(arr, mode):
    img = Image.fromarray(arr)
    if mode == "P":
        img = img.convert("RGB").quantize(colors=37)
    elif mode != img.mode:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_decode_image_equals_pil_convert_l(mode):
    rng = np.random.default_rng(len(mode))
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 3}[mode]
    arr = rng.integers(0, 256, (23, 37, channels), dtype=np.uint8)
    arr[5:9] = 255  # flat rows, which PIL's encoder filters differently
    src = arr[..., 0] if channels == 1 else arr
    data = _pil_png(src if mode != "P" else arr, mode)
    with Image.open(io.BytesIO(data)) as img:
        assert img.mode == mode
        want = np.asarray(img.convert("L"))
    np.testing.assert_array_equal(decode_image(data), want)


def _png_with_filter(pixels: np.ndarray, colour: int, kind: int) -> bytes:
    """A PNG whose every row uses filter ``kind`` (encoded here, so each of
    the five filters is exercised whatever PIL's encoder picks)."""
    h, w, c = pixels.shape
    rows, prior = [], np.zeros(w * c, np.int32)
    for y in range(h):
        cur = pixels[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_decode_png_undoes_each_filter(kind):
    rng = np.random.default_rng(kind)
    pixels = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    data = _png_with_filter(pixels, colour=2, kind=kind)
    with Image.open(io.BytesIO(data)) as img:
        np.testing.assert_array_equal(np.asarray(img), pixels)
        want = np.asarray(img.convert("L"))
    np.testing.assert_array_equal(decode_png(data), want)


def test_decode_image_other_formats_and_errors():
    arr = np.random.default_rng(0).integers(0, 256, (12, 20), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="BMP")
    np.testing.assert_array_equal(decode_image(buf.getvalue()), arr)  # through PIL
    with pytest.raises(Exception):
        decode_image(b"this is not an image")
    with pytest.raises(ValueError, match="truncated|corrupt"):
        decode_png(_pil_png(arr, "L")[:60])


# -- serving CLI ------------------------------------------------------------------


def test_serving_cli_runs_on_the_cpu(tmp_path, capsys):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(_config(img_size=[32, 64], max_length=64)))
    img = tmp_path / "eq.png"
    Image.fromarray(_ink(np.random.default_rng(2), 20, 50)).save(img)
    serving_cli.main([str(img), "--config", str(cfg), "--max_len", "5", "--device", "cpu",
                      "--mode", "beam", "--beam_size", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("tokens: [")
    assert len(json.loads(out[0][len("tokens: "):])) <= 5
    assert serving_cli.parse_args(["x.png"]).device == "cuda"
