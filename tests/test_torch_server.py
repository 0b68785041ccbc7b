"""The port's HTTP server (``mlimgsynth_torch.server``) against the JAX
package's, over real sockets: the same JSON and multipart bodies go to a
server of each package, each over a tiny SD1 session (f32 on the CPU).

Merging is made deterministic: the requests are queued before the worker
thread starts (its merge window is 0), and a running batch is held at its
first step by an event, never by a sleep; every socket call has a timeout.
The decoded images are compared at PSNR > 40 dB; the infotexts, the
``/metrics`` counters, ``/health``, the ``/info`` keys, the cancellation
states and the preview frames exactly.
"""
import base64
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from helpers import patch_tiny_model_types, write_tiny_checkpoint
from mlimgsynth_tpu import server as jax_server
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import server as torch_server
from mlimgsynth_torch import testing as T
from torch_jax_memo import jax_spec_memo  # noqa: F401

TIMEOUT = 120
IMPLS = ("jax", "torch")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("srv") / "tiny.safetensors"
    write_tiny_checkpoint(ckpt)
    with pytest.MonkeyPatch.context() as mp:
        patch_tiny_model_types(mp)
        mp.setattr(torch_api, "_model_types",
                   lambda: {"sd1": T.TINY_MODEL_TYPE})
        mp.setenv("MLIS_PROGRESS_CHUNK", "1")
        out = {"jax": JaxSession(),
               "torch": torch_api.MLImgSynth(device="cpu")}
        out["jax"]._dtype = jnp.float32
        for s in out.values():
            for k, v in [("model", str(ckpt)), ("image-dim", 64),
                         ("steps", 2), ("seed", 1), ("cfg-scale", 6.0)]:
                s.option_set(k, v)
        yield out


class Served:
    """A server of one package on 127.0.0.1, its worker not started."""

    def __init__(self, impl, session):
        mod = jax_server if impl == "jax" else torch_server
        self.srv = mod.Server(session, merge_window_s=0.0,
                              start_worker=False)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         mod.make_handler(self.srv))
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.threads, self.results = [], {}

    def start_worker(self):
        self.srv.worker = threading.Thread(target=self.srv._worker,
                                           daemon=True)
        self.srv.worker.start()

    def queued(self, n):
        """Block until ``n`` requests wait in the queue."""
        with self.srv.cond:
            assert self.srv.cond.wait_for(
                lambda: len(self.srv.queue) >= n, timeout=TIMEOUT)

    def post_async(self, key, path, obj=None, **kw):
        t = threading.Thread(target=lambda: self.results.__setitem__(
            key, call(self.url + path, obj, **kw)), daemon=True)
        t.start()
        self.threads.append(t)

    def join(self):
        for t in self.threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        self.threads = []
        return self.results

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def call(url, obj=None, data=None, ctype="application/json"):
    """(status, headers, body) of a GET (no body) or POST."""
    if obj is not None:
        data = json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.fixture
def served(sessions):
    out = {impl: Served(impl, sessions[impl]) for impl in IMPLS}
    yield out
    for s in out.values():
        s.close()


def _png(b64_or_bytes):
    raw = (b64_or_bytes if isinstance(b64_or_bytes, bytes)
           else base64.b64decode(b64_or_bytes))
    img = Image.open(io.BytesIO(raw))
    return np.asarray(img), img.info.get("parameters")


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _counters(metrics: bytes) -> dict:
    """The /metrics lines but the latency histogram's buckets and sum
    (times)."""
    return {ln.rsplit(" ", 1)[0]: ln.rsplit(" ", 1)[1]
            for ln in metrics.decode().splitlines()
            if ln and not ln.startswith("#")
            and not ln.startswith(("mlis_batch_seconds_bucket",
                                   "mlis_batch_seconds_sum"))}


def _b64_png(arr) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


A1111 = [{"prompt": "a cat", "negative_prompt": "blurry", "seed": 11,
          "steps": 2, "sampler_name": "Euler"},
         {"prompt": "a (red:1.2) fox", "seed": 12, "steps": 2,
          "sampler_name": "Euler", "batch_size": 2},
         {"prompt": "a lighthouse", "seed": 13, "steps": 2,
          "sampler_name": "Euler"}]


def test_a1111_txt2img_merges(served):
    """Three queued A1111 txt2img requests merge into one device batch of
    four images; then /metrics, /health and /info."""
    out = {}
    for impl, sv in served.items():
        for i, body in enumerate(A1111):
            sv.post_async(i, "/sdapi/v1/txt2img", body)
            sv.queued(i + 1)
        sv.start_worker()
        res = sv.join()
        out[impl] = {"res": res,
                     "metrics": call(sv.url + "/metrics")[2],
                     "health": call(sv.url + "/health")[2],
                     "info": json.loads(call(sv.url + "/info")[2])}
    for i in range(len(A1111)):
        (cj, _, bj), (ct, _, bt) = (out[k]["res"][i] for k in IMPLS)
        assert cj == ct == 200
        dj, dt = json.loads(bj), json.loads(bt)
        assert len(dt["images"]) == len(dj["images"]) == \
            A1111[i].get("batch_size", 1)
        assert json.loads(dt["info"])["infotexts"] == \
            json.loads(dj["info"])["infotexts"]
        for a, b in zip(dj["images"], dt["images"]):
            (ia, pa), (ib, pb) = _png(a), _png(b)
            assert ia.shape == ib.shape == (64, 64, 3)
            assert _psnr(ia, ib) > 40.0 and pa == pb
    cj, ct = (_counters(out[k]["metrics"]) for k in IMPLS)
    assert ct == cj
    assert ct["mlis_merged_requests_total"] == "2"
    assert ct["mlis_images_total"] == "4"
    assert out["torch"]["health"] == out["jax"]["health"]
    ij, it = out["jax"]["info"], out["torch"]["info"]
    assert set(it) == set(ij) and set(it["backend"]) == set(ij["backend"])
    assert it["backend"]["name"] == ij["backend"]["name"] == "cpu"
    assert (it["requests"], it["merged"]) == (ij["requests"], ij["merged"])


def _img2img_bodies():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (64, 64, 3), np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[:, 32:] = 255                      # white repaints
    rgba = np.concatenate([rgb, np.full((64, 64, 1), 255, np.uint8)], 2)
    rgba[16:48, 16:48, 3] = 0               # transparent: edit
    a1111 = {"prompt": "a house", "seed": 21, "steps": 2,
             "init_images": ["data:image/png;base64," + _b64_png(rgb)],
             "mask": _b64_png(mask), "denoising_strength": 0.6,
             "mask_blur": 2}
    boundary = "mlisboundary"
    parts = []
    for name, val, fname in (("prompt", b"a garden", None),
                             ("seed", b"22", None), ("size", b"64x64", None),
                             ("image", base64.b64decode(_b64_png(rgba)),
                              "in.png")):
        disp = f'form-data; name="{name}"' + (
            f'; filename="{fname}"' if fname else "")
        parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                     f"\r\n".encode() + val + b"\r\n")
    multipart = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return a1111, (multipart, f"multipart/form-data; boundary={boundary}")


def test_img2img_and_openai_edit(served):
    """A1111 img2img with a mask (white repaints) and its blur; an OpenAI
    edit in multipart whose image's transparency marks the area to
    repaint."""
    a1111, (multipart, ctype) = _img2img_bodies()
    out = {}
    for impl, sv in served.items():
        sv.start_worker()
        out[impl] = [call(sv.url + "/sdapi/v1/img2img", a1111),
                     call(sv.url + "/v1/images/edits", data=multipart,
                          ctype=ctype)]
    (a_j, e_j), (a_t, e_t) = out["jax"], out["torch"]
    assert a_j[0] == a_t[0] == 200 and e_j[0] == e_t[0] == 200
    (ij, pj), (it, pt) = (_png(json.loads(b[2])["images"][0])
                          for b in (a_j, a_t))
    assert _psnr(ij, it) > 40.0 and pj == pt and "Mode: inpaint" in pt
    (ij, pj), (it, pt) = (_png(json.loads(b[2])["data"][0]["b64_json"])
                          for b in (e_j, e_t))
    assert _psnr(ij, it) > 40.0 and pj == pt and "Seed: 22" in pt


def test_openai_generations_and_generate(served):
    """/v1/images/generations (n 2, a size); /generate answering JSON
    and a PNG with its headers."""
    out = {}
    for impl, sv in served.items():
        sv.start_worker()
        out[impl] = [
            call(sv.url + "/v1/images/generations",
                 {"prompt": "a boat", "n": 2, "size": "64x64", "seed": 31}),
            call(sv.url + "/generate", {"prompt": "a tree", "seed": 32,
                                        "format": "json",
                                        "request_id": "r32"}),
            call(sv.url + "/generate", {"prompt": "a tree", "seed": 33})]
    for k in range(3):
        rj, rt = out["jax"][k], out["torch"][k]
        assert rj[0] == rt[0] == 200
    imgs = {impl: [_png(d["b64_json"]) for d in
                   json.loads(out[impl][0][2])["data"]]
            + [_png(json.loads(out[impl][1][2])["images"][0]),
               _png(out[impl][2][2])] for impl in IMPLS}
    assert len(imgs["torch"]) == 4
    for (ia, pa), (ib, pb) in zip(imgs["jax"], imgs["torch"]):
        assert _psnr(ia, ib) > 40.0 and pa == pb
    assert json.loads(out["torch"][1][2])["request_id"] == "r32"
    assert out["torch"][2][1]["Content-Type"] == "image/png"
    assert "X-Request-Id" in out["torch"][2][1]


def test_cancel_and_preview(served, sessions):
    """A queued request cancelled (499, "dequeued"); an unknown id ("not
    found"); a running preview request held at its first step: /preview
    gives that step's frame, /cancel says "cancelling" and the batch
    aborts (499); the counters after it."""
    out = {}
    for impl, sv in served.items():
        s = sessions[impl]
        started, go = threading.Event(), threading.Event()
        orig = s.generate_batch

        def held(requests, step_callback=None, **kw):
            def cb(i, n):
                if i == 1:
                    started.set()
                    assert go.wait(TIMEOUT)
                return step_callback(i, n)
            return orig(requests, step_callback=cb, **kw)

        s.generate_batch = held
        try:
            sv.post_async("queued", "/generate",
                          {"prompt": "a cat", "request_id": "qa"})
            sv.queued(1)
            states = [json.loads(call(sv.url + "/cancel", {
                "request_id": rid})[2])["status"] for rid in ("qa", "nope")]
            sv.post_async("running", "/generate", {
                "prompt": "a dog", "seed": 41, "request_id": "rb",
                "preview": True, "preview_every": 1, "format": "json"})
            sv.queued(1)
            sv.start_worker()
            assert started.wait(TIMEOUT)
            code, _, body = call(sv.url + "/preview?request_id=rb")
            preview = json.loads(body)
            states.append(json.loads(call(sv.url + "/cancel", {
                "request_id": "rb"})[2])["status"])
            go.set()
            res = sv.join()
        finally:
            go.set()
            del s.generate_batch
        out[impl] = (states, code, preview, res,
                     _counters(call(sv.url + "/metrics")[2]),
                     call(sv.url + "/preview?request_id=rb")[0])
    (sj, cj, pj, rj, mj, gj), (st, ct, pt, rt, mt, gt) = (out[k]
                                                          for k in IMPLS)
    assert st == sj == ["dequeued", "not found", "cancelling"]
    assert ct == cj == 200 and gt == gj == 404
    assert {k: pt[k] for k in ("state", "step", "n_step")} == \
        {k: pj[k] for k in ("state", "step", "n_step")} == \
        {"state": "running", "step": 1, "n_step": 2}
    frames = [_png(p["images"][0])[0] for p in (pj, pt)]
    assert frames[0].shape == (8, 8, 3)
    np.testing.assert_array_equal(frames[1], frames[0])
    for key in ("queued", "running"):
        assert rt[key][0] == rj[key][0] == 499
        assert json.loads(rt[key][2])["error"] == "cancelled"
    assert mt == mj and mt["mlis_errors_total"] == "0"


@pytest.mark.parametrize("path", [
    "/health", "/sdapi/v1/samplers", "/sdapi/v1/schedulers",
    "/sdapi/v1/options", "/sdapi/v1/upscalers", "/sdapi/v1/sd-models",
    "/sdapi/v1/prompt-styles", "/sdapi/v1/progress", "/preview?request_id=x",
    "/no/such/route"])
def test_get_routes_match(served, path):
    got = {impl: call(sv.url + path) for impl, sv in served.items()}
    assert got["torch"][0] == got["jax"][0]
    assert json.loads(got["torch"][2]) == json.loads(got["jax"][2])


def test_bad_requests_match(served):
    """A body without a prompt, a malformed JSON body, an unknown A1111
    sampler and a non-b64 OpenAI response format: 400 from both."""
    for impl, sv in served.items():
        assert call(sv.url + "/generate", {"seed": 1})[0] == 400
        assert call(sv.url + "/generate", data=b"{")[0] == 400
        assert call(sv.url + "/sdapi/v1/txt2img", {
            "prompt": "a", "sampler_name": "nope"})[0] == 400
        assert call(sv.url + "/v1/images/generations", {
            "prompt": "a", "response_format": "url"})[0] == 400
