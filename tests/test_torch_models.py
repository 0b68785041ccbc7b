"""The port's models against the JAX package's at the tiny geometries:
CLIP text tower, UNet ``denoise`` and VAE decode.

Parameters are seeded f32 numpy in the JAX layout (fan-in scaled, so
activations stay O(1) through the stack), handed to the JAX models through
a ``Ctx`` and to the port through ``params_from_jax``.  The latent is
24x24, so the UNet's level-0 self-attention (S=576) and the VAE mid-block
(S=576) pass the flash size gate: on the CPU the port runs the kernels'
plain twin there, and the test counts those routes.  Tolerance atol/rtol
1e-4 in f32: summation order between XLA:CPU and torch, accumulated over
the depth of each model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import clip as jclip
from mlimgsynth_tpu.models import unet as junet
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_tpu.testing import TINY_CLIP as J_TINY_CLIP
from mlimgsynth_tpu.testing import TINY_UNET as J_TINY_UNET
from mlimgsynth_tpu.testing import TINY_VAE as J_TINY_VAE
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.models import clip as tclip
from mlimgsynth_torch.models import unet as tunet
from mlimgsynth_torch.models import vae as tvae
from mlimgsynth_torch.ops import flash_attention as tfa
from mlimgsynth_torch.weights import load_module, params_from_jax
from torch_jax_memo import jax_spec_memo  # noqa: F401

ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool would only contend with theirs (and the tensors here are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(spec, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, ps in spec.items():
        if ps.kind == JB.LINEAR_W:
            std = ps.shape[0] ** -0.5
        elif ps.kind == JB.CONV_W:
            std = float(np.prod(ps.shape[:3])) ** -0.5
        elif ps.kind == JB.VEC:
            std = 0.1
        else:
            std = 0.02
        a = rng.standard_normal(ps.shape).astype(np.float32) * np.float32(std)
        if ps.kind == JB.VEC and name.endswith(".weight"):
            a += 1.0                           # norm scales around 1
        out[name] = a
    return out


def _jax_run(fn, params, *args):
    """``fn(ctx, *args)`` jitted over an f32 ``Ctx`` of ``params``."""
    return np.asarray(jax.jit(
        lambda p, *a: fn(JB.Ctx(p, dtype=jnp.float32), *a))(params, *args))


def _port(module, prefix, params):
    mine = {k: v for k, v in params_from_jax(params).items()
            if k.startswith(prefix)}
    return load_module(module, prefix, mine).eval()


@pytest.fixture
def flash_routes(monkeypatch):
    """Counts the attention calls that pass the flash gate."""
    calls = []
    orig = tfa.flash_attention

    def spy(q, k, v, scale=None):
        calls.append(tuple(q.shape))
        return orig(q, k, v, scale)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("clip_skip", [1, 2])
def test_clip_matches_jax(clip_skip):
    # the port keeps its own ClipParams class: compare the fields
    assert vars(T.TINY_CLIP) == vars(J_TINY_CLIP)
    toks = jnp.zeros((1, 77), jnp.int32)
    spec = JB.trace_spec(
        lambda c, t: jclip.clip_text_apply(c, t, J_TINY_CLIP), toks)
    params = _params(spec, seed=1)
    tokens = np.random.default_rng(2).integers(0, 49408, (2, 77))
    want = _jax_run(lambda c, t: jclip.clip_text_apply(
        c, t, J_TINY_CLIP, clip_skip=clip_skip)[0], params,
        jnp.asarray(tokens, jnp.int32))
    model = _port(tclip.ClipText(T.TINY_CLIP), "clip.text.", params)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), clip_skip)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                               rtol=RTOL)


def test_unet_denoise_matches_jax(flash_routes):
    P = T.TINY_UNET
    spec = JB.trace_spec(
        lambda c, x, t, k: junet.unet_apply(c, x, t, k, None, J_TINY_UNET),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)))
    params = _params(spec, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, 24, 4)).astype(np.float32) * 3.0
    cond = rng.standard_normal((2, 77, P.n_ctx)).astype(np.float32)
    sigma, t = np.float32(3.0), np.float32(640.5)
    want = _jax_run(lambda c, x, k: junet.denoise(
        c, x, sigma, t, k, None, J_TINY_UNET), params, x, cond)
    want = want.transpose(0, 3, 1, 2)
    model = _port(tunet.UNet(P), "unet.", params)
    with torch.no_grad():
        got = tunet.denoise(model, torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 3, 1, 2))), sigma, t,
            torch.from_numpy(cond))
    assert float(np.abs(want).mean()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # level 0 (24x24): 2 input + 3 output transformer blocks
    assert flash_routes == [(2, 4, 576, 8)] * 5


def test_vae_decode_matches_jax(flash_routes):
    P = T.TINY_VAE
    spec = JB.trace_spec(
        lambda c, z: jvae.vae_decode_apply(c, z, J_TINY_VAE),
        jnp.zeros((1, 8, 8, 4)))
    params = _params(spec, seed=5)
    z = np.random.default_rng(6).standard_normal((1, 24, 24, 4)).astype(
        np.float32)
    want = _jax_run(lambda c, z: jvae.vae_decode_apply(c, z, J_TINY_VAE),
                    params, z).transpose(0, 3, 1, 2)
    model = _port(tvae.VaeDecoder(P), "vae.", params)
    with torch.no_grad():
        got = model(torch.from_numpy(np.ascontiguousarray(
            z.transpose(0, 3, 1, 2))))
    assert got.shape == (1, 3, 192, 192)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the mid-block's single head, d = 2 * 32 channels
    assert flash_routes == [(1, 1, 576, 64)]
