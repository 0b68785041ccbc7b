"""The port's tiled VAE codec (``vae_tile``) against the JAX package's:
``_tile_geometry`` over a sweep of canvases, and ``_tiled_decode`` and
``_tiled_encode`` on TINY_VAE's f32 weights, over a grid of 5 x 7 tiles
whose last row and column overlap the ones before, and on a latent or
image that one tile covers (the untiled branch).

Both packages run in f32 on the CPU on the same random weights and inputs.
Tolerance: atol/rtol 1e-4, as the port's other VAE legs
(tests/test_torch_img2img.py); the two differ by summation order alone, and
a tile in the wrong place or a margin written moves pixels by the image's
own scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu import api as jax_api
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.models import vae as tvae
from torch_jax_memo import jax_spec_memo  # noqa: F401

P = T.TINY_VAE

# (full0, full1, n0, n1, k): width and height of the canvas, of a tile, and
# the margin
GEOMETRY = {"square": (32, 32, 24, 24, 8),
            "non-square": (56, 40, 24, 24, 8),
            "side-equals-tile": (24, 40, 24, 24, 8),
            "last-tile-overlaps": (50, 37, 24, 24, 8),
            "encode-margin": (448, 320, 192, 192, 64),
            "one-tile": (24, 24, 24, 24, 8)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(GEOMETRY))
def test_tile_geometry_matches_jax(case):
    """Origins and inner boxes equal the JAX package's, and the inner boxes
    cover the canvas: each pixel is written by some tile."""
    full0, full1, n0, n1, k = GEOMETRY[case]
    origins, boxes = torch_api._tile_geometry(full0, full1, n0, n1, k)
    want_o, want_b = jax_api._tile_geometry(full0, full1, n0, n1, k)
    np.testing.assert_array_equal(origins, want_o)
    np.testing.assert_array_equal(boxes, want_b)
    assert origins.dtype == boxes.dtype == np.int32
    written = np.zeros((full1, full0), bool)
    for (y, x), (y0, y1, x0, x1) in zip(origins, boxes):
        assert 0 <= y <= full1 - n1 and 0 <= x <= full0 - n0
        written[y + y0:y + y1, x + x0:x + x1] = True
    assert written.all()


def _params(fn, x_shape, seed):
    spec = JB.trace_spec(fn, jnp.zeros(x_shape))
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(ps.shape).astype(np.float32)
                * np.float32(0.1 if ps.kind == JB.VEC else
                             float(np.prod(ps.shape[:-1])) ** -0.5))
            for k, ps in spec.items()}


@pytest.fixture(scope="module")
def decoder():
    params = _params(lambda c, x: jvae.vae_decode_apply(c, x, P),
                     (1, 8, 8, 4), 11)
    with torch.device("meta"):
        model = tvae.VaeDecoder(P)
    return params, tweights.load_module(
        model, "vae.", tweights.params_from_jax(params)).eval()


@pytest.fixture(scope="module")
def encoder():
    params = _params(lambda c, x: jvae.vae_encode_apply(c, x, P),
                     (1, 64, 64, 3), 12)
    with torch.device("meta"):
        model = tvae.VaeEncoder(P)
    return params, tweights.load_module(
        model, "vae.", tweights.params_from_jax(params)).eval()


# (latent h, w, tile_px): 64-px tiles on a 40 x 56 latent are 24 x 24
# latent tiles on a step of 8, 5 x 7 of them, the last column clamped onto
# the one before it; the 8 x 8 latent fits in one tile
DECODE_CASES = {"tiled": (40, 56, 64), "one-tile": (8, 8, 64)}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_tiled_decode_matches_jax(decoder, case):
    params, model = decoder
    lh, lw, tile = DECODE_CASES[case]
    lat = np.random.default_rng(13).standard_normal(
        (1, P.ch_z, lh, lw)).astype(np.float32)
    want = jax_api._tiled_decode(params, lat, P, tile, jnp.float32)
    with torch.no_grad():
        got = torch_api._tiled_decode(model, torch.from_numpy(lat), tile)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (1, 3, lh * 8, lw * 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    if case == "tiled":   # a tile really is not the whole decode
        with torch.no_grad():
            whole = model(torch.from_numpy(lat)).numpy()
        assert np.abs(whole - want).max() > 1e-2


# (image h, w, tile_px): 64-px tiles plus a 64-px margin are 192 x 192
# image tiles on a step of 64, 5 x 7 of them on 320 x 448
ENCODE_CASES = {"tiled": (320, 448, 64), "one-tile": (64, 64, 64)}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_tiled_encode_matches_jax(encoder, case):
    params, model = encoder
    ih, iw, tile = ENCODE_CASES[case]
    img = np.random.default_rng(14).uniform(
        -1, 1, (1, 3, ih, iw)).astype(np.float32)
    want = jax_api._tiled_encode(params, img, P, tile, jnp.float32)
    with torch.no_grad():
        got = torch_api._tiled_encode(model, torch.from_numpy(img), tile)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (1, 2 * P.ch_z, ih // 8, iw // 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
