"""The port's Wan graph server on the CPU, driven by the reference client.

The client script's own functions (``build_graph``, ``preflight``,
``submit``, ``wait_for_result``, ``result_files``, ``download``) drive the
port's standard-library server over real HTTP at ``WanConfig.tiny()``
(float32, 32x32, 5 frames, 1 step).  What a prompt returns is held to the
port pipeline's own solo run of the same (prompt, negative, seed), and the
``/object_info`` schema to the JAX server's.  Frames agree within +-2 uint8
levels (a batch of 2 and a solo run sum in different orders on the CPU).
"""

import importlib.util
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from tpustack_torch.models.wan import WanConfig, WanPipeline
from tpustack_torch.serving import graph_server as gs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENT = os.path.join(REPO, "cluster-config", "apps", "llm", "scripts", "generate_wan_t2v.py")
LEVELS = 2


def _load_client():
    spec = importlib.util.spec_from_file_location("wan_client_port", CLIENT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


client = _load_client()


@pytest.fixture(scope="module")
def pipe():
    return WanPipeline(WanConfig.tiny(), device="cpu", seed=0)


@pytest.fixture(scope="module")
def server(pipe, tmp_path_factory):
    rt = gs.WanRuntime(models_dir=str(tmp_path_factory.mktemp("models")),
                       output_dir=str(tmp_path_factory.mktemp("out")), pipeline=pipe)
    srv = gs.GraphServer(rt)
    assert (srv.max_batch, srv.pixel_budget) == (4, gs.DEFAULT_PIXEL_BUDGET)
    srv.url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    yield srv
    srv.shutdown()


def _graph(**kw):
    args = dict(prompt="a red panda", negative="blurry", seed=3, width=32, height=32, frames=5,
                steps=1, cfg=6.0, sampler="uni_pc", scheduler="simple", denoise=1.0,
                save_images=True)
    args.update(kw)
    return client.build_graph(**args)


def _frames(server, entry, tmp_path):
    files = client.result_files(entry)
    return np.stack([np.asarray(Image.open(client.download(server.url, f, tmp_path)))
                     for f in files])


def _run(server, graph, tmp_path):
    pid = client.submit(server.url, graph, "test", retries=0)
    entry = client.wait_for_result(server.url, pid, timeout=300, poll=0.05, retries=0)
    return _frames(server, entry, tmp_path)


def _solo(pipe, prompt, negative, seed):
    vid, _ = pipe.generate(prompt, negative_prompt=negative, seed=seed, frames=5, steps=1,
                           width=32, height=32, sampler="uni_pc", guidance_scale=6.0)
    return vid[0]


def _close(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape and d.max() <= LEVELS, d.max()


def test_object_info_preflight_and_schema_equal_jax(server, monkeypatch):
    info = client.preflight(server.url, client.DEFAULT_UNET, client.DEFAULT_CLIP,
                            client.DEFAULT_VAE)
    from tpustack.serving.graph_server import GraphExecutor as JaxExecutor
    from tpustack.serving.graph_server import WanRuntime as JaxRuntime

    ref = JaxExecutor(JaxRuntime(models_dir=server.rt.models_dir,
                                 output_dir=server.rt.output_dir)).object_info()
    assert info == json.loads(json.dumps(ref))  # PIL here, no ffmpeg: the same node set
    assert "SaveWEBM" not in info and "SaveAnimatedWEBP" in info
    monkeypatch.setattr(gs, "_have_pil", lambda: False)  # the card machine's case
    assert "SaveAnimatedWEBP" not in server.executor.object_info()
    status, _ = _post(server, {"prompt": _graph(save_images=False, save_webp=True)})
    assert status == 400


def test_video_graph_saves_pngs_served_by_view(server, pipe, tmp_path):
    got = _run(server, _graph(), tmp_path)
    assert got.shape == (pipe.pixel_frame_count(5), 32, 32, 3) and got.dtype == np.uint8
    _close(got, _solo(pipe, "a red panda", "blurry", 3))
    assert got.std() > 1.0
    status, body = _get(server, "/queue")
    assert status == 200 and json.loads(body) == {"queue_running": [], "queue_pending": []}
    status, body = _get(server, "/healthz")
    assert status == 200 and json.loads(body)["worker_alive"] is True


def test_in_graph_batch_size_rows_equal_solo(server, pipe, tmp_path):
    got = _run(server, _graph(batch_size=2, seed=11), tmp_path)
    n = pipe.pixel_frame_count(5)
    assert got.shape[0] == 2 * n
    _close(got[:n], _solo(pipe, "a red panda", "blurry", 11))
    _close(got[n:], _solo(pipe, "a red panda", "blurry", 12))
    assert server.dispatch_log[-1]["batch"] == 2


def test_queued_prompts_fuse_into_one_dispatch(server, pipe, tmp_path):
    before = len(server.dispatch_log)
    with server.hold():
        pa = client.submit(server.url, _graph(prompt="a red panda", seed=5), "t", retries=0)
        pb = client.submit(server.url, _graph(prompt="a blue robot", seed=9), "t", retries=0)
    ea = client.wait_for_result(server.url, pa, timeout=300, poll=0.05, retries=0)
    eb = client.wait_for_result(server.url, pb, timeout=300, poll=0.05, retries=0)
    assert [r["batch"] for r in server.dispatch_log[before:]] == [2]
    assert server.batch_fallbacks == 0
    _close(_frames(server, ea, tmp_path), _solo(pipe, "a red panda", "blurry", 5))
    _close(_frames(server, eb, tmp_path), _solo(pipe, "a blue robot", "blurry", 9))


def test_batched_dispatch_failure_is_served_row_by_row(server, pipe, tmp_path, monkeypatch):
    real = pipe.generate_many_async

    def only_solo(items, **kw):
        if len(items) > 1:
            raise RuntimeError("planted batched failure")
        return real(items, **kw)

    monkeypatch.setattr(pipe, "generate_many_async", only_solo)
    fallbacks = server.batch_fallbacks
    got = _run(server, _graph(batch_size=2, seed=21, frames=1), tmp_path)
    assert server.batch_fallbacks == fallbacks + 1
    assert got.shape[0] == 2
    server._no_batch.clear()


def test_failing_graph_surfaces_in_history(server, tmp_path):
    graph = _graph()
    graph["unet"]["inputs"]["unet_name"] = "missing.safetensors"
    pid = client.submit(server.url, graph, "t", retries=0)
    with pytest.raises(RuntimeError, match="missing.safetensors"):
        client.wait_for_result(server.url, pid, timeout=60, poll=0.05, retries=0)
    status, body = _get(server, f"/history/{pid}")
    entry = json.loads(body)[pid]
    assert entry["status"]["status_str"] == "error" and entry["status"]["completed"]
    # the worker is still alive for the next graph (the 1-frame image mode)
    assert _run(server, _graph(frames=1), tmp_path).shape == (1, 32, 32, 3)


def test_submit_rejects_bad_bodies_and_view_stays_inside_output_dir(server):
    assert _post(server, {"prompt": {"1": {"class_type": "Nope"}}})[0] == 400
    assert _post(server, {"prompt": {}})[0] == 400
    assert _post(server, {"prompt": _graph(save_images=False, save_webm=True)})[0] == 400
    req = urllib.request.Request(server.url + "/prompt", data=b"{not json", method="POST")
    assert _status(req) == 400
    for name in ("../../../etc/passwd", "/etc/passwd", "missing.png"):
        assert _get(server, "/view?filename=" + urllib.request.quote(name))[0] == 404
    assert _get(server, "/history/unknown") == (200, b"{}")


def test_concurrent_submits_all_publish_with_distinct_files(server):
    """Sixteen prompts from eight client threads at once, with a short
    switch interval: every prompt publishes success, no output file name
    repeats, and the queue drains (the handlers and the worker share the
    history and queue under one lock)."""
    import sys
    import threading

    pids, errors = [], []

    def send(i):
        try:
            for j in range(2):
                pids.append(client.submit(server.url, _graph(frames=1, seed=100 + 2 * i + j),
                                          "t", retries=0))
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=send, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        entries = [client.wait_for_result(server.url, pid, timeout=300, poll=0.05, retries=0)
                   for pid in pids]
    finally:
        sys.setswitchinterval(old)
    names = [f["filename"] for e in entries for f in client.result_files(e)]
    assert len(pids) == 16 and len(names) == 16 == len(set(names))
    assert json.loads(_get(server, "/queue")[1]) == {"queue_running": [], "queue_pending": []}


@pytest.mark.parametrize("raw", [None, "", "none", "off", "int8", " INT8 ", "fp4"])
@pytest.mark.parametrize("preset", ["wan_1_3b", "tiny"])
def test_wan_text_quant_resolution_equals_jax(monkeypatch, raw, preset):
    """Unset means the int8 tower for every preset but tiny; none/off opts
    out; anything else raises at startup: the JAX server's rule."""
    from tpustack.serving.graph_server import _text_quant as jax_text_quant

    if raw is None:
        monkeypatch.delenv("WAN_TEXT_QUANT", raising=False)
    else:
        monkeypatch.setenv("WAN_TEXT_QUANT", raw)
    if raw == "fp4":
        with pytest.raises(ValueError, match="fp4"):
            gs._text_quant(preset)
        with pytest.raises(ValueError):
            jax_text_quant(preset)
        return
    assert gs._text_quant(preset) == jax_text_quant(preset)
    assert gs._text_quant(preset) == ("int8" if raw in ("int8", " INT8 ")
                                      or (not raw and preset != "tiny") else None)


def test_runtime_env_contract(tmp_path, monkeypatch):
    monkeypatch.setenv("WAN_TEXT_QUANT", "int8")
    assert gs._text_quant("tiny") == "int8"
    monkeypatch.setenv("WAN_TEXT_QUANT", "fp4")
    with pytest.raises(ValueError):
        gs._text_quant("wan_1_3b")
    monkeypatch.setenv("WAN_TEXT_QUANT", "none")
    assert gs._text_quant("wan_1_3b") is None
    rt = gs.WanRuntime(models_dir=str(tmp_path / "m"), output_dir=str(tmp_path / "o"))
    assert rt.unet_names() == [gs.CANONICAL_UNET]
    monkeypatch.setenv("WAN_ALLOW_RANDOM", "0")
    assert rt.unet_names() == []
    with pytest.raises(RuntimeError, match="WAN_ALLOW_RANDOM"):
        rt.pipeline()
    os.makedirs(tmp_path / "m" / "diffusion_models")
    (tmp_path / "m" / "diffusion_models" / "x.safetensors").write_bytes(b"")
    assert rt.unet_names() == ["x.safetensors"]
    with pytest.raises(NotImplementedError, match="safetensors"):
        rt.pipeline()


def _status(req):
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _post(server, body):
    req = urllib.request.Request(server.url + "/prompt", data=json.dumps(body).encode(),
                                 method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(server, path):
    try:
        with urllib.request.urlopen(server.url + path, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
