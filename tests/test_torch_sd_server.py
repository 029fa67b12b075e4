"""The port's SD1.5 server contract on the CPU, tiny preset.

The endpoints, status codes and headers of ``tpustack/serving/sd_server.py``,
on the port's standard-library server over real HTTP (``urllib``), plus the
micro-batcher and the stdlib PNG encoder.  64x64 images, 1-2 steps.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from tpustack_torch.models.sd15 import SD15Config, SD15Pipeline
from tpustack_torch.serving.sd_server import BadRequest, SDServer, parse_request
from tpustack_torch.utils.image import PNG_MAGIC, array_to_png

SMALL = {"steps": 1, "width": 64, "height": 64}


@pytest.fixture(scope="module")
def pipe():
    return SD15Pipeline(SD15Config.tiny(), device="cpu", seed=0)


@pytest.fixture
def server(pipe):
    srv = SDServer(pipe, batch_window_ms=5000, max_batch=2)
    port = srv.start(host="127.0.0.1", port=0)
    srv.url = f"http://127.0.0.1:{port}"
    yield srv
    srv.stop()


def _call(url, body=None, raw=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _decode(png):
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def test_array_to_png_roundtrips_through_pil():
    img = np.random.RandomState(0).randint(0, 256, size=(37, 53, 3)).astype(np.uint8)
    png = array_to_png(img)
    assert png.startswith(PNG_MAGIC)
    np.testing.assert_array_equal(_decode(png), img)
    with pytest.raises(ValueError):
        array_to_png(img.astype(np.float32))


def test_endpoints_and_generate(server, pipe):
    status, _, body = _call(server.url + "/healthz")
    assert status == 200 and json.loads(body)["ok"] is True
    assert _call(server.url + "/last")[0] == 404
    status, headers, html = _call(server.url + "/")
    assert status == 200 and b"No image generated yet" in html

    server.batch_window_s = 0.0  # a lone request need not wait for company
    status, headers, png = _call(server.url + "/generate", {"prompt": "a red fox", "seed": 3, **SMALL})
    assert status == 200 and png.startswith(PNG_MAGIC)
    assert headers["Content-Type"] == "image/png"
    assert headers["X-Gen-Time"].endswith("s") and float(headers["X-Gen-Time"][:-1]) >= 0
    got = _decode(png)
    want, _ = pipe.generate("a red fox", seed=3, **SMALL)  # same batch size: bit-identical
    np.testing.assert_array_equal(got, want[0])

    status, headers, last = _call(server.url + "/last")
    assert status == 200 and last == png
    assert b"data:image/png;base64," in _call(server.url + "/")[2]
    assert server.batch_log[-1][0] == 1


@pytest.mark.parametrize("body,status", [
    ({"prompt": "   "}, 400),
    ({"prompt": ""}, 400),
    ({"prompt": "x", "width": 72, "height": 64, "steps": 1}, 400),  # not a multiple of 64
    ({"prompt": "x", "steps": 0}, 400),
    ({"steps": 2}, 422),                          # prompt missing
    ({"prompt": "x", "steps": "many"}, 422),
    ({"prompt": "x", "seed": 1.5}, 422),
    ({"prompt": 7}, 422),
    ([1, 2], 422),
])
def test_bad_requests(server, body, status):
    server.batch_window_s = 0.0
    got, _, payload = _call(server.url + "/generate", body)
    assert got == status and "detail" in json.loads(payload)


class _FailingPipeline:
    """Passes the request checks, then fails inside the dispatch."""
    device = "cpu"

    def check_request(self, steps, width, height):
        pass

    def generate(self, *args, **kwargs):
        raise ValueError("flash_attention kernel takes bfloat16")


def test_pipeline_failure_is_500_not_400():
    """A fault of the server's own dispatch is no bad request."""
    srv = SDServer(_FailingPipeline(), batch_window_ms=0, max_batch=1)
    url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    try:
        status, _, payload = _call(url + "/generate", {"prompt": "x", **SMALL})
    finally:
        srv.stop()
    assert status == 500 and "bfloat16" in json.loads(payload)["detail"]


def test_malformed_json_is_422(server):
    assert _call(server.url + "/generate", raw=b"{not json")[0] == 422
    assert _call(server.url + "/nowhere")[0] == 404


def test_concurrent_same_signature_rides_one_batch(server):
    """Two concurrent requests with one (steps, guidance, size) are served by
    one pipeline dispatch; distinct seeds give distinct images."""
    n_before = len(server.batch_log)
    out = {}

    def send(seed):
        out[seed] = _call(server.url + "/generate", {"prompt": "a boat", "seed": seed, **SMALL})

    threads = [threading.Thread(target=send, args=(s,)) for s in (10, 11)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r[0] == 200 for r in out.values())
    assert [n for n, _ in list(server.batch_log)[n_before:]] == [2]
    assert not np.array_equal(_decode(out[10][2]), _decode(out[11][2]))


def test_parse_request_defaults():
    req = parse_request(b'{"prompt": "x", "steps": null, "extra": 1}')
    assert req == {"prompt": "x", "steps": 30, "guidance_scale": 7.5, "seed": None,
                   "width": 512, "height": 512, "negative_prompt": ""}
    with pytest.raises(BadRequest):
        parse_request(b'{"prompt": "x", "steps": true}')


def test_server_from_env(monkeypatch):
    monkeypatch.setenv("MODEL_DIR", "/nonexistent")
    with pytest.raises(NotImplementedError, match="not supported yet"):
        SDServer()
    monkeypatch.delenv("MODEL_DIR")
    monkeypatch.setenv("SD15_PRESET", "tiny")
    monkeypatch.setenv("SD15_DEVICE", "cpu")
    monkeypatch.setenv("SD15_MAX_BATCH", "4")
    srv = SDServer()
    assert srv.max_batch == 4 and str(srv.pipe.device) == "cpu"
