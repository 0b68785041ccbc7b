"""DeepCache in the port against the JAX package: each model's cache split
(the UNet's feature entering the level-0 decoder; the MMDiT's deep-tail
residual on the image stream; Flux's on the joint text ++ image stream),
the loop's refresh rule (steps i with i % k == 0 or i < max(1, n // 10)
run the whole model and keep its deep output, the others only the shallow
part), and the ``deepcache`` sessions on the tiny SD1 UNet, MMDiT and Flux.

Modules f32 on the CPU at atol/rtol 1e-4: the full forward's output and
cache against the JAX package's, and the shallow forward fed that cache
against the full output.  Sessions: every step's latent at 1e-4 (the JAX
session read through its stepwise path, ``jax_steps``: its loop refuses a
step observer under DeepCache) and the image at PSNR > 40 dB.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import patch_tiny_model_types
from mlimgsynth_tpu import api as japi
from mlimgsynth_tpu import testing as JT
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import flux as jflux
from mlimgsynth_tpu.models import mmdit as jmmdit
from mlimgsynth_tpu.models import unet as junet
from mlimgsynth_torch import api as tapi
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.models import flux as tflux
from mlimgsynth_torch.models import mmdit as tmmdit
from mlimgsynth_torch.models import unet as tunet

from test_torch_flux import _deeper, _flux_case
from test_torch_guidance import (OPTS, _nchw, _port,  # noqa
                                 _unet_case, assert_sessions_match,
                                 run_session, tiny, tiny_path)
from test_torch_mmdit import _mmdit_case
from torch_jax_memo import jax_spec_memo  # noqa: F401

ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run_pair(fn, params, *args):
    """``fn(ctx, *args)`` jitted over an f32 ``Ctx``: (output, cache)."""
    return jax.jit(lambda p, *a: fn(JB.Ctx(p, dtype=jnp.float32), *a))(
        params, *args)


def _split_checks(full, out, cache, want_out, want_cache, shallow):
    """The full forward's output and cache against the JAX package's, the
    plain forward equal to the full one, and the shallow forward fed the
    cache equal to it (full = shallow + cache)."""
    np.testing.assert_array_equal(out, full)
    np.testing.assert_allclose(out, want_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cache, want_cache, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(shallow, full, atol=ATOL, rtol=RTOL)
    assert float(np.abs(cache).mean()) > 1e-3


def test_unet_cache_split_matches_jax():
    params, x, cond = _unet_case(seed=9, hw=16)
    sigma, t = np.float32(3.0), np.float32(640.5)
    want, want_cache = [np.asarray(a) for a in _jax_run_pair(
        lambda c, x, k: junet.denoise(c, x, sigma, t, k, None, JT.TINY_UNET,
                                      want_cache=True), params, x, cond)]
    model = _port(tunet.UNet(T.TINY_UNET), "unet.", params)
    c = torch.from_numpy(cond)
    with torch.no_grad():
        full = tunet.denoise(model, _nchw(x), sigma, t, c).numpy()
        out, cache = tunet.denoise(model, _nchw(x), sigma, t, c,
                                   want_cache=True)
        shallow = tunet.denoise(model, _nchw(x), sigma, t, c,
                                use_cache=cache).numpy()
    _split_checks(full, out.numpy(), cache.numpy(),
                  want.transpose(0, 3, 1, 2),
                  want_cache.transpose(0, 3, 1, 2), shallow)
    np.testing.assert_array_equal(shallow, full)   # a concatenation


def test_mmdit_cache_split_matches_jax():
    JP, P = JT.TINY_MMDIT, T.TINY_MMDIT
    params, x, t, cond, pooled = _mmdit_case(JP)
    want, want_cache = _jax_run_pair(
        lambda c, x, t, k, y: jmmdit.mmdit_apply(c, x, t, k, y, JP,
                                                 want_cache=True),
        params, x.transpose(0, 2, 3, 1), t, cond, pooled)
    model = _port(tmmdit.MMDiT(P), "mmdit.", params)
    args = tuple(map(torch.from_numpy, (x, t, cond, pooled)))
    with torch.no_grad():
        full = model(*args).numpy()
        out, cache = model(*args, want_cache=True)
        shallow = model(*args, use_cache=cache).numpy()
    _split_checks(full, out.numpy(), cache.numpy(),
                  np.asarray(want).transpose(0, 3, 1, 2),
                  np.asarray(want_cache), shallow)
    assert tmmdit.dc_split(P.depth) == jmmdit._dc_split(P.depth)


@pytest.mark.parametrize("kind", ["schnell", "dev"])
def test_flux_cache_split_matches_jax(kind):
    JP = _deeper(JT.TINY_FLUX_DEV if kind == "dev" else JT.TINY_FLUX_SCHNELL)
    P = _deeper(T.TINY_FLUX_DEV if kind == "dev" else T.TINY_FLUX_SCHNELL)
    params, x, t, cond, pooled = _flux_case(JP)
    g = np.array([3.5, 1.0], np.float32)
    want, want_cache = _jax_run_pair(
        lambda c, x, t, k, y, g: jflux.flux_apply(
            c, x, t, k, y, JP, guidance=g if JP.guidance_embed else None,
            want_cache=True),
        params, x.transpose(0, 2, 3, 1), t, cond, pooled, g)
    model = _port(tflux.Flux(P), "flux.", params)
    args = tuple(map(torch.from_numpy, (x, t, cond, pooled)))
    gk = dict(guidance=torch.from_numpy(g) if kind == "dev" else None)
    with torch.no_grad():
        full = model(*args, **gk).numpy()
        out, cache = model(*args, **gk, want_cache=True)
        shallow = model(*args, **gk, use_cache=cache).numpy()
    _split_checks(full, out.numpy(), cache.numpy(),
                  np.asarray(want).transpose(0, 3, 1, 2),
                  np.asarray(want_cache), shallow)
    deep = dataclasses.replace(P, depth_double=19)
    assert tflux.dc_split(deep.depth_double) == jflux._dc_split(19) == 2


def test_deepcache_with_skip_layers_raises():
    params, x, t, cond, pooled = _mmdit_case(JT.TINY_MMDIT)
    model = _port(tmmdit.MMDiT(T.TINY_MMDIT), "mmdit.", params)
    with pytest.raises(ValueError, match="skip_layers"):
        model(*map(torch.from_numpy, (x, t, cond, pooled)), skip_layers=(1,),
              want_cache=True)


@pytest.mark.parametrize("method,k", [("euler", 2), ("dpmpp2m", 3)])
def test_deepcache_session_matches_jax(tiny, monkeypatch, method, k):
    """``deepcache`` on the tiny SD1 UNet at 4 steps (refresh on steps 0
    and 2 at k 2, 0 and 3 at k 3); the infotext says DeepCache: k.  The
    dpmpp2m case keeps the latent (the decode is the euler case's)."""
    opts = [("model", tiny)] + OPTS + [("method", method), ("deepcache", k)]
    if method != "euler":
        opts.append(("no-decode", 1))
    js, ts = assert_sessions_match(opts, monkeypatch)
    plain, _ = run_session(tapi.MLImgSynth(device="cpu"),
                           [("model", tiny)] + OPTS + [("method", method)])
    assert np.abs(ts.tensors["latent"] - plain[-1]).max() > 1e-3
    assert f", DeepCache: {k}" in ts.infotext
    assert f", DeepCache: {k}" in js.infotext


def test_deepcache_one_is_the_plain_loop(tiny):
    """k 1 refreshes every step: bit for bit the loop without DeepCache."""
    base = [("model", tiny)] + OPTS
    plain, _ = run_session(tapi.MLImgSynth(device="cpu"), base)
    one, _ = run_session(tapi.MLImgSynth(device="cpu"),
                         base + [("deepcache", 1)])
    for a, b in zip(plain, one):
        np.testing.assert_array_equal(a, b)


T_TYPES = {"sd3": T.TINY_MODEL_TYPE_SD3,
           "flux_dev": T.TINY_MODEL_TYPE_FLUX_DEV}
J_TYPES = {"sd3": JT.TINY_MODEL_TYPE_SD3,
           "flux_dev": japi.ModelTypeDef("flux_dev", JT.TINY_CLIP, None,
                                         JT.TINY_FLUX_DEV, JT.TINY_VAE_FLUX,
                                         64, 1)}


@pytest.fixture(scope="module")
def dit_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dc")
    path = str(d / "sd3.safetensors")
    JT.write_checkpoint_sd3(path)
    f = JT.write_tiny_flux_files(tmp_path_factory.mktemp("flux"),
                                 P=JT.TINY_FLUX_DEV)
    return {"sd3": [("model", path)],
            "flux_dev": [("model", f["model"]), ("clip", f["clip"]),
                         ("vae", f["vae"])]}


@pytest.mark.parametrize("model", ["sd3", "flux_dev"])
def test_deepcache_dit_session_matches_jax(dit_files, monkeypatch, model):
    """``deepcache 2`` on the tiny MMDiT (CFG batch) and Flux-dev (embedded
    guidance): every step's latent and the image."""
    patch_tiny_model_types(monkeypatch, J_TYPES)
    monkeypatch.setattr(tapi, "_model_types", lambda: dict(T_TYPES))
    opts = dit_files[model] + [
        ("image-dim", 64), ("steps", 4), ("seed", 13), ("cfg-scale", 4.0),
        ("prompt", "a cached (cat:1.1)"), ("nprompt", "blurry"),
        ("deepcache", 2)]
    js, ts = assert_sessions_match(opts, monkeypatch)
    plain, _ = run_session(tapi.MLImgSynth(device="cpu"), opts[:-1])
    assert np.abs(ts.tensors["latent"] - plain[-1]).max() > 1e-4
