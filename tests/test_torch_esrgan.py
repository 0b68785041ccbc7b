"""ESRGAN upscaling: the port's ``models/esrgan.py`` and the session's
``upscale`` against the JAX package.

Random upscalers written by the port's writer (``testing.write_random_
esrgan``: RRDBNet at pixel-unshuffle 1, 2 and 4, SRVGGNetCompact at x4 and
x2; ``.safetensors`` in basicsr names, ``.pth`` in the old ESRGAN names)
read by both packages' loaders and run on the same seeded images, f32,
relative L2 1e-4; the session's ``upscale`` untiled and tiled (the JAX
scan of tiles against the port's loop), with the edge padding an odd size
needs and a Lanczos ``resize`` to a non-integer factor; a tiled SRVGG pass
(receptive field inside the tile margin) against the untiled one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.models import esrgan as jesr
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.models import esrgan as tesr
from torch_jax_memo import jax_spec_memo  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _img(n, h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3, h, w)).astype(
        np.float32)


def _both(path, img):
    """(JAX output, port output) of the file at ``path`` on ``img`` NCHW."""
    params, P = jesr.load_esrgan(str(path), dtype=jnp.float32)
    want = np.asarray(jesr.esrgan_run(params, jnp.asarray(
        img.transpose(0, 2, 3, 1)), P, dtype=jnp.float32)).transpose(
        0, 3, 1, 2)
    m, TP = tesr.load_esrgan(str(path), "cpu", torch.float32)
    assert TP == tesr.EsrganParams(**vars(P)) if isinstance(
        P, jesr.EsrganParams) else TP == tesr.SrvggParams(**vars(P))
    with torch.no_grad():
        got = m(torch.from_numpy(img)).numpy()
    return want, got


@pytest.mark.parametrize("unshuffle", [1, 2, 4])
def test_rrdbnet_matches_jax(tmp_path, unshuffle):
    """RRDBNet (2 blocks, 8 wide) at each pixel-unshuffle factor: the
    output is [N, 3, s H, s W], s = 4 / unshuffle, clamped to [0, 1]."""
    P = tesr.EsrganParams(n_feat=8, n_block=2, growth=4, unshuffle=unshuffle)
    path = tmp_path / "rrdb.safetensors"
    T.write_random_esrgan(path, P, seed=unshuffle)
    want, got = _both(path, _img(2, 16, 24))
    assert got.shape == (2, 3, 16 * P.scale, 24 * P.scale)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("scale", [4, 2])
def test_srvgg_matches_jax(tmp_path, scale):
    """SRVGGNetCompact (3 conv + PReLU pairs, 8 wide) at x4 and x2, from a
    ``.pth`` (the Real-ESRGAN ``params_ema`` dict)."""
    P = tesr.SrvggParams(n_feat=8, n_conv=3, scale=scale)
    path = tmp_path / "srvgg.pth"
    T.write_random_esrgan(path, P, seed=scale)
    want, got = _both(path, _img(1, 20, 12, seed=1))
    assert got.shape == (1, 3, 20 * scale, 12 * scale)
    assert _rel(got, want) < 1e-4


def test_old_names_pth_load_as_basicsr(tmp_path):
    """A ``.pth`` in the old ESRGAN names (``model.N``, the trunk under
    ``model.1.sub.``) gives what the same weights in basicsr names give,
    in both packages."""
    P = tesr.EsrganParams(n_feat=8, n_block=2, growth=4, unshuffle=2)
    T.write_random_esrgan(tmp_path / "a.safetensors", P, seed=9)
    T.write_random_esrgan(tmp_path / "b.pth", P, seed=9, old_names=True)
    img = _img(1, 12, 12, seed=2)
    wa, ga = _both(tmp_path / "a.safetensors", img)
    wb, gb = _both(tmp_path / "b.pth", img)
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(wa, wb)
    assert _rel(gb, wa) < 1e-4


@pytest.mark.parametrize("case", ["untiled", "tiled", "resize"])
def test_session_upscale_matches_jax(tmp_path, case):
    """``upscale`` through both sessions on a 2x model and a 46 x 38 image
    (padded by the edge to even sizes, trimmed after): the whole image;
    tiles of 16 pixels and a margin of 16 (``_tile_geometry``'s order, the
    clamped last tile overwriting); and a Lanczos resize to 1.5x."""
    P = tesr.EsrganParams(n_feat=8, n_block=1, growth=4, unshuffle=2)
    path = str(tmp_path / "x2.safetensors")
    T.write_random_esrgan(path, P, seed=4)
    img = _img(1, 46, 38, seed=3)
    kw = {"tile": 16} if case == "tiled" else (
        {"resize": 1.5} if case == "resize" else {})
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    js._dtype = jnp.float32
    for s in (js, ts):
        s.option_set("upscaler", path)
    want, got = js.upscale(img, **kw), ts.upscale(img, **kw)
    shape = (1, 3, 69, 57) if case == "resize" else (1, 3, 92, 76)
    assert got.shape == want.shape == shape
    assert _rel(got, want) < 1e-4


def test_tiled_srvgg_matches_untiled(tmp_path):
    """An SRVGG of 4 convs sees 6 pixels around an output pixel, inside
    the tile margin of 16: its tiled pass (tiles of 24) is the untiled one,
    f32 relative 1e-4; without an ``upscaler`` the session refuses."""
    path = str(tmp_path / "sr.safetensors")
    T.write_random_esrgan(path, tesr.SrvggParams(n_feat=8, n_conv=3), seed=6)
    ts = torch_api.MLImgSynth(device="cpu")
    with pytest.raises(torch_api.MlisError) as e:
        ts.upscale(_img(1, 8, 8))
    assert e.value.code == torch_api.MlisError.E_OPT_VALUE
    ts.option_set("upscaler", path)
    img = _img(1, 80, 72, seed=5)
    whole, tiled = ts.upscale(img), ts.upscale(img, tile=24)
    assert tiled.shape == (1, 3, 320, 288)
    assert _rel(tiled, whole) < 1e-4
