"""The rank side of tests/test_torch_parallel*.py: functions that run in
processes started by ``mlimgsynth_torch.parallel.comm.spawn`` (gloo on the
CPU, one thread a rank).  This module imports no jax and nothing of the
JAX package, and every rank checks that neither is loaded; the JAX
references are computed in the parent."""
import base64
import dataclasses
import json
import os
import sys
import tempfile
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

from mlimgsynth_torch import api, cli, server, testing
from mlimgsynth_torch.errors import MlisError
from mlimgsynth_torch.models import blocks as B
from mlimgsynth_torch.models import mmdit as mmdit_mod
from mlimgsynth_torch.models import t5 as t5_mod
from mlimgsynth_torch.ops import quant
from mlimgsynth_torch.parallel import mesh as pmesh
from mlimgsynth_torch.parallel import pipeline as pipe
from mlimgsynth_torch.parallel import ring_attention as ring
from mlimgsynth_torch.parallel import tensor_parallel as tpar
from mlimgsynth_torch.utils import image as image_mod
from mlimgsynth_torch.weights import load_module, quantize_linear_weights

# the tiny geometries the sessions run: the JAX package's tiny files, an
# MMDiT of four blocks (pp up to 4), the SD3 pattern at widths that
# quantize, a Flux of 2 double and 3 single blocks (uneven stages)
SD3_D4 = dataclasses.replace(testing.TINY_MMDIT, depth=4)
SD3_Q = dataclasses.replace(testing.TINY_Q_MMDIT, d_pooled=64)
FLUX_PP = dataclasses.replace(testing.TINY_FLUX_DEV, depth_double=2,
                              depth_single=3)
TYPES = {
    "sd1": {"sd1": testing.TINY_MODEL_TYPE},
    "sd1_q": {"sd1": testing.TINY_Q_MODEL_TYPE},
    "sd3": {"sd3": api.ModelTypeDef("sd3", testing.TINY_CLIP, SD3_D4,
                                    testing.TINY_VAE_SD3, 64, 2,
                                    testing.TINY_CLIP2)},
    "sd3_q": {"sd3": api.ModelTypeDef("sd3", testing.TINY_CLIP, SD3_Q,
                                      testing.TINY_VAE_SD3, 64, 2,
                                      testing.TINY_CLIP2)},
    "flux": {"flux_dev": api.ModelTypeDef("flux_dev", testing.TINY_CLIP,
                                          FLUX_PP, testing.TINY_VAE_FLUX,
                                          64, 1)},
    # the refusals' models: MMDiT-X, and a depth that pp = 2 does not
    # divide
    "sd35": {"sd35_medium": testing.TINY_MODEL_TYPE_SD35},
    "sd3_d3": {"sd3": dataclasses.replace(
        testing.TINY_MODEL_TYPE_SD3,
        unet_p=dataclasses.replace(testing.TINY_MMDIT, depth=3))},
}


def assert_no_jax() -> None:
    bad = [m for m in ("jax", "mlimgsynth_tpu") if m in sys.modules]
    assert not bad, f"a rank imported {bad}"


# -- functions --------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ring(q, k, v, sp):
    mesh = pmesh.Mesh(sp=sp)
    return ring.sp_attention(_t(q), _t(k), _t(v), mesh).numpy()


def _tp_module(m, prefix, params, tp, mesh_kw):
    mesh = pmesh.Mesh(tp=tp, **mesh_kw)
    full = {prefix + k: _t(v) for k, v in params.items()}
    sh = tpar.shard(m, prefix, full, tp, mesh.index(pmesh.TP_AXIS),
                    mesh.group(pmesh.TP_AXIS))
    return load_module(m, prefix, sh).eval()


def _tp_block(params, d, d_ctx, n_head, x, c, tp, mesh_kw=None):
    with torch.device("meta"):
        m = B.BasicTransformer(d, d_ctx, n_head)
    m = _tp_module(m, "blk.", params, tp, mesh_kw or {})
    heads = [mod.n_head for mod in (m.attn1, m.attn2)]
    with torch.no_grad():
        return m(_t(x), _t(c)).numpy(), heads


def _tp_t5(params, P, tokens, tp):
    with torch.device("meta"):
        m = t5_mod.T5Encoder(t5_mod.T5Params(**P))
    m = _tp_module(m, "t5.", params, tp, {})
    with torch.no_grad():
        return m(_t(tokens).long()).numpy()


def _pipeline(depth, pp, n, seed):
    """A tiny MMDiT stack of ``depth`` joint blocks (the last one's context
    side pre-only) run sequentially and through the pipeline at each
    microbatch count."""
    P = dataclasses.replace(testing.TINY_MMDIT, depth=depth)
    torch.manual_seed(seed)
    blocks = torch.nn.ModuleList(
        mmdit_mod.JointBlock(P, i == depth - 1) for i in range(depth))
    for p in blocks.parameters():
        p.data.normal_(0.0, 0.1)
    g = torch.Generator().manual_seed(seed + 1)
    cx = torch.randn(n, 5, P.width, generator=g)
    xe = torch.randn(n, 16, P.width, generator=g)
    c = torch.randn(n, P.width, generator=g)
    with torch.no_grad():
        a, b = cx, xe
        for blk in blocks:
            a, b = blk(a, b, c)
        ref = b.numpy()
        mesh = pmesh.Mesh(pp=pp)
        stage = pipe.Stage(mesh.index(pmesh.PP_AXIS), pp,
                           mesh.ranks(pmesh.PP_AXIS),
                           mesh.group(pmesh.PP_AXIS))
        pipe.keep_stage(blocks, *pipe.stage_range(depth, pp, stage.index))
        mine = pipe.present(blocks)

        def stage_fn(acts):
            cx_, xe_, c_ = acts
            for blk in mine:
                cx_, xe_ = blk(cx_, xe_, c_)
            return cx_, xe_, c_

        outs = {m: pipe.pipeline_apply(stage, stage_fn, (cx, xe, c),
                                       collect=1, m=m).numpy()
                for m in (1, 2, n)}
    return ref, outs, len(mine)


# -- the server and the CLI on ranks -----------------------------------------

HTTP_TIMEOUT = 120
# the merged pair, then the request that is cancelled at its first step
SERVE_PAIR = [{"prompt": "a (cat:1.2) on a hill", "seed": 41},
              {"prompt": "a red bicycle", "nprompt": "blurry", "seed": 42}]
SERVE_CANCEL = {"prompt": "a dog", "seed": 43, "request_id": "rc"}


def _http(url, obj=None):
    req = urllib.request.Request(
        url, data=None if obj is None else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serve_session(ckpt, mesh):
    s = api.MLImgSynth(device="cpu")
    for k, v in [("model", ckpt), ("image-dim", 64), ("steps", 3),
                 ("seed", 1), ("cfg-scale", 6.0)] + list(mesh.items()):
        s.option_set(k, v)
    s.setup()
    return s


def _served(srv, hold=None):
    """Rank 0's side: the pair queued before the worker starts (merged),
    then, with ``hold`` (two events), the request cancelled while its
    batch is held at its first step; the pair's u8 images, the cancelled
    request's status and error, the merge count."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    res = {}

    def post(key, body):
        res[key] = _http(url + "/generate", {**body, "format": "json"})

    threads = [threading.Thread(target=post, args=(i, b), daemon=True)
               for i, b in enumerate(SERVE_PAIR)]
    try:
        for t in threads:
            t.start()
        with srv.cond:
            assert srv.cond.wait_for(lambda: len(srv.queue) == 2,
                                     timeout=HTTP_TIMEOUT)
        srv.worker = threading.Thread(target=srv._worker, daemon=True)
        srv.worker.start()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        out = {"images": [image_mod.image_load_bytes(base64.b64decode(
            json.loads(res[i][1])["images"][0])) for i in range(2)],
            "merged": srv.n_merged}
        if hold is not None:
            started, go = hold
            t = threading.Thread(target=post, args=("c", SERVE_CANCEL),
                                 daemon=True)
            t.start()
            assert started.wait(HTTP_TIMEOUT)
            out["cancel"] = json.loads(_http(url + "/cancel", {
                "request_id": "rc"})[1])["status"]
            go.set()
            t.join(HTTP_TIMEOUT)
            out["cancelled"] = (res["c"][0],
                                json.loads(res["c"][1])["error"])
        srv.stop()
        srv.worker.join(HTTP_TIMEOUT)
        assert not srv.worker.is_alive()
    finally:
        httpd.shutdown()
        httpd.server_close()
    return out


def _serve(ckpt, mesh):
    """The port's server on these ranks (``Server.follow`` on all but rank
    0), then, on rank 0, the same requests to a one-rank server.  Each
    rank records its step callbacks: (requests in the batch, step, the
    answer)."""
    api._model_types = lambda: dict(TYPES["sd1"])
    os.environ["MLIS_PROGRESS_CHUNK"] = "1"
    s = _serve_session(ckpt, mesh)
    srv = server.Server(s, merge_window_s=0.0, start_worker=False)
    assert srv.ranked()
    rank = dist.get_rank()
    steps = []
    started, go = threading.Event(), threading.Event()
    orig = s.generate_batch

    def recorded(requests, step_callback=None, **kw):
        def cb(i, n):
            if rank == 0 and i == 1 and requests[0]["seed"] == 43:
                started.set()
                assert go.wait(HTTP_TIMEOUT)
            ans = step_callback(i, n)
            steps.append((len(requests), i, ans))
            return ans
        return orig(requests, step_callback=cb, **kw)

    s.generate_batch = recorded
    if rank != 0:
        srv.follow()
        return {"steps": steps}
    out = _served(srv, (started, go))
    one = server.Server(_serve_session(ckpt, {}), merge_window_s=0.0,
                        start_worker=False)
    assert not one.ranked()
    out["one_rank"] = _served(one)["images"]
    out["steps"] = steps
    return out


def _cli(ckpt, png, mesh):
    """``vae-test`` and ``clip-encode`` through ``cli.main`` on these ranks,
    each rank in a directory of its own: the exit codes and the files each
    rank wrote."""
    api._model_types = lambda: dict(TYPES["sd1"])
    flags = [x for k, v in mesh.items() for x in (f"--{k}", str(v))]
    d = tempfile.mkdtemp(prefix=f"mlis_cli_rank{dist.get_rank()}_")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        rc = [cli.main(["vae-test", "-b", "cpu", "-m", ckpt, "-i", png,
                        "-o", "round.png", "-S", "5"] + flags),
              cli.main(["clip-encode", "-b", "cpu", "-m", ckpt, "-p",
                        "a (cat:1.2)"] + flags)]
        files = sorted(os.listdir(d))
        img = (image_mod.png_read("round.png")[0] if "round.png" in files
               else None)
        emb = (image_mod.tensor_load("clip-embed.tensor")
               if "clip-embed.tensor" in files else None)
    finally:
        os.chdir(cwd)
    return {"rc": rc, "files": files, "image": img, "embed": emb}


# (bits, per-column hint, {name: (K, N)}): a column-parallel q_proj and
# row-parallel out_proj / ff.net.2 under the tp rules' names; at M = 2048
# the per-column (512, 256) takes the W8A8 route whole, its rank's
# (512, 128) would not; a per-column row-parallel weight stays whole, and
# so does one whose K (640) splits into no whole 128-blocks
Q_LINEARS = {
    "percol": (8, 2048, {"attn1.q_proj": (512, 256),
                         "attn1.out_proj": (2048, 256)}),
    "q8": (8, None, {"attn1.out_proj": (2048, 256),
                     "ff.net.2": (640, 128)}),
    "q4": (4, None, {"attn1.out_proj": (2048, 256),
                     "ff.net.2": (640, 128)})}


def _q_linears(kind, m=2048, seed=0):
    """Quantized linears cut to this rank's tp share
    (``tensor_parallel.shard`` after ``quantize_linear_weights``), each fed
    its share of one input: {name: (the whole module's output, the share's,
    the share's class, the W8A8 slabs it used)}."""
    bits, hint, shapes = Q_LINEARS[kind]
    g = torch.Generator().manual_seed(seed)

    def build():
        with torch.device("meta"):
            root = torch.nn.Module()
            for name, (k, n) in shapes.items():
                owner = root
                for part in name.split(".")[:-1]:
                    if not hasattr(owner, part):
                        owner.add_module(part, torch.nn.Module())
                    owner = getattr(owner, part)
                owner.add_module(name.split(".")[-1], torch.nn.Linear(k, n))
        return root

    params = {}
    for name, (k, n) in shapes.items():
        params[f"blk.{name}.weight"] = torch.randn(n, k, generator=g) * 0.1
        params[f"blk.{name}.bias"] = torch.randn(n, generator=g) * 0.1
    xs = {name: torch.randn(m, k, generator=g) for name, (k, n)
          in shapes.items()}
    whole, share = build(), build()
    pw = dict(params)
    quantize_linear_weights(whole, "blk.", pw, bits, hint)
    whole = load_module(whole, "blk.", pw).eval()
    ps = dict(params)
    quantize_linear_weights(share, "blk.", ps, bits, hint)
    mesh = pmesh.Mesh(tp=2)
    r = mesh.index(pmesh.TP_AXIS)
    ps = tpar.shard(share, "blk.", ps, 2, r, mesh.group(pmesh.TP_AXIS))
    share = load_module(share, "blk.", ps).eval()
    slabs = []
    plain = quant.q8_ws_int8_plain

    def spy(x, w, s_col, slab=None):
        slabs.append((tuple(w.shape), slab or quant._ws_slab(w.shape[1])))
        return plain(x, w, s_col, slab)

    quant.q8_ws_int8_plain = spy
    out = {}
    try:
        with torch.no_grad():
            for name, (k, n) in shapes.items():
                mod = share.get_submodule(name)
                col = name.endswith("q_proj")
                x = xs[name] if col else xs[name].chunk(2, dim=1)[r]
                y_whole = whole.get_submodule(name)(xs[name]).numpy()
                del slabs[:]
                out[name] = (y_whole, mod(x).numpy(), type(mod).__name__,
                             list(slabs))
    finally:
        quant.q8_ws_int8_plain = plain
    return out


FUNCS = {"ring": _ring, "tp_block": _tp_block, "tp_t5": _tp_t5,
         "pipeline": _pipeline, "serve": _serve, "cli": _cli,
         "q_linears": _q_linears}


# -- sessions ---------------------------------------------------------------

def _q_shares(s) -> dict:
    """The denoiser's stored quantized tensors (``_q8``, ``_q4`` and their
    scales) on this rank."""
    prefix = s._denoiser()
    return {prefix + k: v.numpy().copy()
            for k, v in s._models[prefix].state_dict().items()
            if k.endswith(("_q8", "_q4", "_scale"))}


def run_session(types, opts, env=None):
    """One request through a session of the tiny ``types`` with ``opts``:
    (every step's latent, the image, the denoiser's stored quantized
    tensors), or ("error", the ``MlisError`` code, its text)."""
    api._model_types = lambda: dict(TYPES[types])
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        s = api.MLImgSynth(device="cpu")
        traj = []
        try:
            for k, v in opts:
                s.option_set(k, v)
            s.step_observer = lambda i, lat: traj.append(lat.copy())
            img = s.generate()
        except MlisError as e:
            return "error", e.code, str(e)
        return traj, img, _q_shares(s)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run(rank, world, fcases, scases):
    """The function cases (name, kind, kwargs) of ``FUNCS``, then each
    session case (name, types, opts, env), on this rank."""
    assert_no_jax()
    out = {name: FUNCS[kind](**kw) for name, kind, kw in fcases}
    out.update({name: run_session(types, opts, env)
                for name, types, opts, env in scases})
    assert_no_jax()
    return out
