"""The port's Flux modules against the JAX package's: ``flux_apply`` for
schnell and dev, its RoPE tables and schedule shift, the guidance column of
``denoise``, the Flux VAE decode and CLIP-L's unprojected pooled row.

Parameters are seeded f32 numpy in the JAX layout (fan-in scaled, RMSNorm
scales about 1), handed to the JAX models through a ``Ctx`` and to the port
through ``params_from_jax``.  Tolerance atol/rtol 1e-4 in f32, as the
earlier slices' module tests.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu import testing as JT
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import clip as jclip
from mlimgsynth_tpu.models import flux as jflux
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.models import clip as tclip
from mlimgsynth_torch.models import flux as tflux
from mlimgsynth_torch.models import vae as tvae
from mlimgsynth_torch.weights import load_module, params_from_jax
from torch_jax_memo import jax_spec_memo  # noqa: F401

ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores (and the tensors are
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
        if ps.kind == JB.VEC and name.endswith((".weight", ".scale")):
            a += 1.0
        out[name] = a
    return out


def _jax_run(fn, params, *args):
    return jax.jit(lambda p, *a: fn(JB.Ctx(p, dtype=jnp.float32), *a))(
        params, *args)


def _port(module, prefix, params):
    mine = {k: v for k, v in params_from_jax(params).items()
            if k.startswith(prefix)}
    return load_module(module, prefix, mine).eval()


# two blocks of each kind, as tests/test_flux.py's tiny
def _deeper(P):
    return dataclasses.replace(P, depth_double=2, depth_single=2)


def _flux_case(JP, hw=8, n=2, s_txt=5, seed=0):
    spec = JB.trace_spec(
        lambda ctx, x, t, c, y: jflux.flux_apply(
            ctx, x, t, c, y, JP,
            guidance=jnp.zeros((1,)) if JP.guidance_embed else None),
        jnp.zeros((1, 8, 8, JP.n_ch_in // 4)), jnp.zeros((1,)),
        jnp.zeros((1, s_txt, JP.d_ctx_in)), jnp.zeros((1, JP.d_pooled)))
    params = _params(spec, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, JP.n_ch_in // 4, hw, hw)).astype(np.float32)
    t = np.array([1000.0, 250.0][:n], np.float32)
    cond = rng.standard_normal((n, s_txt, JP.d_ctx_in)).astype(np.float32)
    pooled = rng.standard_normal((n, JP.d_pooled)).astype(np.float32)
    return params, x, t, cond, pooled


def test_tiny_geometry_matches_jax():
    """The port's tiny Flux sets and Flux VAE carry the JAX package's
    values."""
    for mine, theirs in ((T.TINY_FLUX_SCHNELL, JT.TINY_FLUX_SCHNELL),
                         (T.TINY_FLUX_DEV, JT.TINY_FLUX_DEV),
                         (tflux.FLUX_DEV, jflux.FLUX_DEV),
                         (tflux.FLUX_SCHNELL, jflux.FLUX_SCHNELL)):
        assert vars(mine) == {k: getattr(theirs, k) for k in vars(mine)}
    assert vars(T.TINY_VAE_FLUX) == vars(JT.TINY_VAE_FLUX)
    assert vars(tvae.VAE_FLUX) == vars(jvae.VAE_FLUX)


@pytest.mark.parametrize("kind", ["schnell", "dev"])
def test_flux_apply_matches_jax(kind):
    JP = _deeper(JT.TINY_FLUX_DEV if kind == "dev" else JT.TINY_FLUX_SCHNELL)
    P = _deeper(T.TINY_FLUX_DEV if kind == "dev" else T.TINY_FLUX_SCHNELL)
    params, x, t, cond, pooled = _flux_case(JP)
    assert ("flux.guidance_in.in_layer.weight" in params) == (kind == "dev")
    g = np.array([3.5, 1.0], np.float32)
    want = np.asarray(_jax_run(
        lambda c, x, t, k, y, g: jflux.flux_apply(
            c, x, t, k, y, JP, guidance=g if JP.guidance_embed else None),
        params, x.transpose(0, 2, 3, 1), t, cond, pooled, g)).transpose(
            0, 3, 1, 2)
    model = _port(tflux.Flux(P), "flux.", params)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t, cond, pooled)),
                    guidance=torch.from_numpy(g) if kind == "dev"
                    else None).numpy()
    assert got.shape == x.shape
    assert float(np.abs(want).mean()) > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hp,wp,s_txt", [(4, 4, 5), (64, 64, 512),
                                         (48, 80, 0)])
def test_rope_tables_match_jax(hp, wp, s_txt):
    for P, JP in ((tflux.FLUX_DEV, jflux.FLUX_DEV),
                  (T.TINY_FLUX_SCHNELL, JT.TINY_FLUX_SCHNELL)):
        cos, sin = tflux.rope_tables(P, hp, wp, s_txt)
        jcos, jsin = jflux.rope_tables(JP, hp, wp, s_txt)
        assert cos.dtype == np.float32
        assert cos.shape == (s_txt + hp * wp, P.d_head // 2)
        np.testing.assert_array_equal(cos, jcos)
        np.testing.assert_array_equal(sin, jsin)


def test_rope_apply_matches_jax():
    cos, sin = tflux.rope_tables(T.TINY_FLUX_SCHNELL, 3, 4, 2)
    x = np.random.default_rng(2).standard_normal(
        (2, 2, 14, 16)).astype(np.float32)
    want = np.asarray(jflux._rope_apply(jnp.asarray(x), jnp.asarray(cos),
                                        jnp.asarray(sin)))
    got = tflux.rope_apply(torch.from_numpy(x), torch.from_numpy(cos),
                           torch.from_numpy(sin)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("h,w", [(128, 128), (32, 32), (96, 160), (16, 8)])
def test_dynamic_flow_shift_matches_jax(h, w):
    for P, JP in ((tflux.FLUX_DEV, jflux.FLUX_DEV),
                  (tflux.FLUX_SCHNELL, jflux.FLUX_SCHNELL)):
        assert tflux.dynamic_flow_shift(P, h, w) == \
            jflux.dynamic_flow_shift(JP, h, w)
    if (h, w) == (128, 128):    # 1024^2: e^1.15 on dev, 1 on schnell
        assert tflux.dynamic_flow_shift(tflux.FLUX_DEV, h, w) == \
            pytest.approx(math.exp(1.15), rel=1e-12)
        assert tflux.dynamic_flow_shift(tflux.FLUX_SCHNELL, h, w) == 1.0


def test_denoise_guidance_column():
    """dev's ``denoise`` takes the guidance value from the label's column
    ``d_pooled``: the model's output at that guidance, as in the JAX
    package."""
    JP, P = JT.TINY_FLUX_DEV, T.TINY_FLUX_DEV
    params, x, _, cond, pooled = _flux_case(JP, n=1, seed=4)
    lab = np.concatenate([pooled, np.full((1, 1), 4.0, np.float32)], -1)
    sigma = np.float32(0.6)
    t = sigma * np.float32(1000.0)
    want = np.asarray(_jax_run(
        lambda c, x, k, y: jflux.denoise(c, x, sigma, t, k, y, JP),
        params, x.transpose(0, 2, 3, 1), cond, lab)).transpose(0, 3, 1, 2)
    model = _port(tflux.Flux(P), "flux.", params)
    with torch.no_grad():
        got = tflux.denoise(model, torch.from_numpy(x), sigma, t,
                            torch.from_numpy(cond), torch.from_numpy(lab))
        raw = model(torch.from_numpy(x), torch.full((1,), float(t)),
                    torch.from_numpy(cond), torch.from_numpy(pooled),
                    torch.full((1,), 4.0))
        other = tflux.denoise(model, torch.from_numpy(x), sigma, t,
                              torch.from_numpy(cond),
                              torch.from_numpy(lab) * torch.tensor(
                                  [1.0] * P.d_pooled + [0.25]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.numpy(), raw.numpy())
    assert (got - other).abs().max() > 1e-4


def test_rope_positions_matter():
    """Shifting the image content changes the output other than by the
    same shift: the model sees positions only through RoPE (mirrors
    tests/test_flux.py:79)."""
    params, x, t, cond, pooled = _flux_case(JT.TINY_FLUX_SCHNELL, n=1,
                                            seed=2)
    model = _port(tflux.Flux(T.TINY_FLUX_SCHNELL), "flux.", params)
    args = [torch.from_numpy(a) for a in (t, cond, pooled)]
    with torch.no_grad():
        a = model(torch.from_numpy(x), *args).numpy()
        b = model(torch.from_numpy(np.roll(x, 2, axis=3)), *args).numpy()
    assert np.abs(a - np.roll(b, -2, axis=3)).max() > 1e-4


def test_flux_vae_decode_matches_jax():
    """The Flux VAE: the SD3 autoencoder at scale 0.3611, shift 0.1159."""
    P = T.TINY_VAE_FLUX
    spec = JB.trace_spec(
        lambda c, z: jvae.vae_decode_apply(c, z, JT.TINY_VAE_FLUX),
        jnp.zeros((1, 8, 8, P.ch_z)))
    params = _params(spec, seed=8)
    z = np.random.default_rng(9).standard_normal(
        (1, 16, 16, P.ch_z)).astype(np.float32)
    want = np.asarray(_jax_run(
        lambda c, z: jvae.vae_decode_apply(c, z, JT.TINY_VAE_FLUX), params,
        z)).transpose(0, 3, 1, 2)
    model = _port(tvae.VaeDecoder(P), "vae.", params)
    with torch.no_grad():
        got = model(torch.from_numpy(z.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_clip_unprojected_pooled_row_matches_jax():
    """A tower without ``text_proj`` gives the pooled row as it is (HF
    ``pooler_output``, Flux's label), as ``feat_proj=False`` does."""
    P = T.TINY_CLIP
    spec = JB.trace_spec(lambda c, t: jclip.clip_text_apply(
        c, t, JT.TINY_CLIP, feat_tok_idx=jnp.zeros((1,), jnp.int32),
        feat_proj=False), jnp.zeros((1, 77), jnp.int32))
    assert "clip.text.text_proj" not in spec
    params = _params(spec, seed=6)
    tokens = np.random.default_rng(7).integers(0, 49408, (3, 77))
    fidx = np.array([5, 76, 11], np.int32)
    _, feat_j = _jax_run(lambda c, t, f: jclip.clip_text_apply(
        c, t, JT.TINY_CLIP, feat_tok_idx=f, feat_proj=False), params,
        jnp.asarray(tokens, jnp.int32), jnp.asarray(fidx))
    model = _port(tclip.ClipText(P), "clip.text.", params)
    assert not hasattr(model, "text_proj")
    with torch.no_grad():
        _, feat = model.encode(torch.from_numpy(tokens), 1, True,
                               torch.from_numpy(fidx).long())
    assert feat.dtype == torch.float32 and feat.shape == (3, P.d_embed)
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_j), atol=ATOL,
                               rtol=RTOL)
