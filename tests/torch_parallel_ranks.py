"""The rank side of tests/test_torch_parallel*.py: functions that run in
processes started by ``mlimgsynth_torch.parallel.comm.spawn`` (gloo on the
CPU, one thread a rank).  This module imports no jax and nothing of the
JAX package, and every rank checks that neither is loaded; the JAX
references are computed in the parent."""
import dataclasses
import os
import sys

import numpy as np
import torch

from mlimgsynth_torch import api, testing
from mlimgsynth_torch.errors import MlisError
from mlimgsynth_torch.models import blocks as B
from mlimgsynth_torch.models import mmdit as mmdit_mod
from mlimgsynth_torch.models import t5 as t5_mod
from mlimgsynth_torch.parallel import mesh as pmesh
from mlimgsynth_torch.parallel import pipeline as pipe
from mlimgsynth_torch.parallel import ring_attention as ring
from mlimgsynth_torch.parallel import tensor_parallel as tpar
from mlimgsynth_torch.weights import load_module

# the tiny geometries the sessions run: the JAX package's tiny files, an
# MMDiT of four blocks (pp up to 4), the SD3 pattern at widths that
# quantize, a Flux of 2 double and 3 single blocks (uneven stages)
SD3_D4 = dataclasses.replace(testing.TINY_MMDIT, depth=4)
SD3_Q = dataclasses.replace(testing.TINY_Q_MMDIT, d_pooled=64)
FLUX_PP = dataclasses.replace(testing.TINY_FLUX_DEV, depth_double=2,
                              depth_single=3)
TYPES = {
    "sd1": {"sd1": testing.TINY_MODEL_TYPE},
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


FUNCS = {"ring": _ring, "tp_block": _tp_block, "tp_t5": _tp_t5,
         "pipeline": _pipeline}


# -- sessions ---------------------------------------------------------------

def run_session(types, opts, env=None):
    """One request through a session of the tiny ``types`` with ``opts``:
    (every step's latent, the image), or ("error", the ``MlisError`` code,
    its text)."""
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
        return traj, img
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
