"""The port's guidance options against the JAX package: ``cfg_rescale``
(the std-rescaled CFG mix), FreeU (the skip filter and the backbone
scaling at each decoder block), perturbed-attention guidance (the identity
self-attention of the mid transformer, one more cond-only evaluation on
the steps of its window) and seamless ``tiling`` (every padded conv pads
circularly: the UNet and the VAE are wrap-equivariant), with their option
values, errors and infotext, and the CLI's flags.

Modules at the tiny geometries, f32 on the CPU, atol/rtol 1e-4; sessions
on the tiny SD1 checkpoint: every step's latent at 1e-4 and the final
image at PSNR > 40 dB.  The JAX session decodes with ``tiling`` only on
its fused path (without a step observer), so the tiling session is read
through a progress callback: ``jax_steps`` records the latent of each
step its stepwise path computes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safetensors.numpy import save_file

from helpers import (patch_tiny_model_types, spec_to_checkpoint_arrays,
                     tiny_specs)
from mlimgsynth_tpu import api as japi
from mlimgsynth_tpu import testing as JT
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import unet as junet
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_tpu.sampling import sampler as jsam
from mlimgsynth_torch import api as tapi
from mlimgsynth_torch import cli
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.models import blocks as tblocks
from mlimgsynth_torch.models import unet as tunet
from mlimgsynth_torch.models import vae as tvae
from mlimgsynth_torch.sampling import sampler as tsam
from mlimgsynth_torch.utils import image as image_mod
from mlimgsynth_torch.weights import load_module, params_from_jax

from test_torch_models import _params
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


def _jax_run(fn, params, *args):
    return np.asarray(jax.jit(
        lambda p, *a: fn(JB.Ctx(p, dtype=jnp.float32), *a))(params, *args))


def _port(module, prefix, params):
    mine = {k: v for k, v in params_from_jax(params).items()
            if k.startswith(prefix)}
    return load_module(module, prefix, mine).eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# -- modules -----------------------------------------------------------------

@pytest.mark.parametrize("n,rescale", [(1, 0.7), (2, 0.7), (2, 1.0)])
def test_cfg_rescale_mix_matches_jax(n, rescale):
    d = np.random.default_rng(n).standard_normal((2 * n, 4, 6, 5)).astype(
        np.float32) * np.float32(1.5)
    d[n:] *= np.float32(0.3)
    want = np.asarray(jsam._cfg_mix(jnp.asarray(d), n, jnp.float32(6.5),
                                    rescale))
    got = tsam._cfg_mix(torch.from_numpy(d), n, 6.5, rescale).numpy()
    plain = tsam._cfg_mix(torch.from_numpy(d), n, 6.5).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(got - plain).max() > 0.1


@pytest.mark.parametrize("h,w,scale", [(8, 8, 0.9), (6, 10, 0.2),
                                       (1, 4, 0.5)])
def test_freeu_filter_matches_jax(h, w, scale):
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 6)).astype(
        np.float32)
    want = np.asarray(junet._freeu_filter(jnp.asarray(x), scale))
    got = tunet._freeu_filter(_nchw(x), scale).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("mult", [4, 2, 1])
def test_freeu_apply_matches_jax(mult):
    """The channel dispatch: (b1, s1) at 4 n_ch, (b2, s2) at 2 n_ch, the
    feature and the skip untouched elsewhere."""
    P = T.TINY_UNET
    fu = (1.5, 1.6, 0.9, 0.2)
    rng = np.random.default_rng(mult)
    x = rng.standard_normal((2, 4, 4, P.n_ch * mult)).astype(np.float32)
    h = rng.standard_normal((2, 4, 4, P.n_ch)).astype(np.float32)
    jx, jh = junet._freeu_apply(jnp.asarray(x), jnp.asarray(h),
                                JT.TINY_UNET, fu)
    tx, th = tunet._freeu_apply(_nchw(x), _nchw(h), P, fu)
    np.testing.assert_allclose(tx.numpy(),
                               np.asarray(jx).transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(th.numpy(),
                               np.asarray(jh).transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=RTOL)
    assert np.array_equal(tx.numpy(), _nchw(x).numpy()) == (mult == 1)


@pytest.mark.parametrize("identity", [True, False])
def test_identity_attention_block_matches_jax(identity):
    """A basic transformer with the perturbed (identity) self-attention
    map: the output of ``out_proj(v_proj(x))`` for attn1."""
    d, d_ctx, heads = 32, 24, 4
    spec = JB.trace_spec(
        lambda c, x, k: JB.basic_transformer(c, "bt", x, k, d, d, heads),
        jnp.zeros((1, 9, d)), jnp.zeros((1, 5, d_ctx)))
    params = _params(spec, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    c = rng.standard_normal((2, 5, d_ctx)).astype(np.float32)
    want = _jax_run(lambda p, x, k: JB.basic_transformer(
        p, "bt", x, k, d, d, heads, self_identity=identity), params, x, c)
    model = _port(tblocks.BasicTransformer(d, d_ctx, heads), "bt.", params)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(c),
                    self_identity=identity).numpy()
        other = model(torch.from_numpy(x), torch.from_numpy(c),
                      self_identity=not identity).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(got - other).max() > 1e-3


def _unet_case(seed=3, hw=16):
    spec = JB.trace_spec(
        lambda c, x, t, k: junet.unet_apply(c, x, t, k, None, JT.TINY_UNET),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)))
    params = _params(spec, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32) * 3.0
    cond = rng.standard_normal((2, 77, 32)).astype(np.float32)
    return params, x, cond


@pytest.mark.parametrize("kw", [{"freeu": (1.5, 1.6, 0.9, 0.2)},
                                {"pag": True}], ids=["freeu", "pag"])
def test_unet_freeu_and_pag_match_jax(kw):
    """The whole tiny UNet's ``denoise`` with FreeU at every decoder block,
    or with the mid transformer's identity self-attention."""
    params, x, cond = _unet_case()
    sigma, t = np.float32(3.0), np.float32(640.5)
    want = _jax_run(lambda c, x, k: junet.denoise(
        c, x, sigma, t, k, None, JT.TINY_UNET, **kw), params, x, cond)
    model = _port(tunet.UNet(T.TINY_UNET), "unet.", params)
    with torch.no_grad():
        got = tunet.denoise(model, _nchw(x), sigma, t,
                            torch.from_numpy(cond), **kw).numpy()
        plain = tunet.denoise(model, _nchw(x), sigma, t,
                              torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=ATOL,
                               rtol=RTOL)
    assert np.abs(got - plain).max() > 1e-3


def test_conv_wrap_equivariance():
    """A padded conv under tiling commutes with a roll; switched back off
    it pads with zeros again (tests/test_tiling.py:24-34)."""
    torch.manual_seed(0)
    conv = tblocks.conv2d(4, 8)
    x = torch.randn(1, 4, 8, 8)
    tblocks.set_tiling(conv, True)
    y, y_roll = conv(x), conv(torch.roll(x, (3, 2), (2, 3)))
    np.testing.assert_allclose(torch.roll(y, (3, 2), (2, 3)).detach(),
                               y_roll.detach(), atol=1e-5)
    tblocks.set_tiling(conv, False)
    z = conv(torch.roll(x, (3, 2), (2, 3)))
    assert not torch.allclose(torch.roll(conv(x), (3, 2), (2, 3)), z,
                              atol=1e-3)


def test_unet_tiling_matches_jax_and_wraps():
    """The tiny UNet under tiling: the JAX package's output at 1e-4, and a
    roll of the input rolls the output (tests/test_tiling.py:37-56); the
    module switched back gives the untiled output again."""
    params, x, cond = _unet_case(seed=5, hw=8)
    t = np.float32(5.0)
    want = np.asarray(jax.jit(lambda p, x, k: junet.unet_apply(
        JB.Ctx(p, dtype=jnp.float32, tiling=True), x, jnp.full((2,), t), k,
        None, JT.TINY_UNET))(params, x, cond))
    model = _port(tunet.UNet(T.TINY_UNET), "unet.", params)
    tt, c = torch.full((2,), float(t)), torch.from_numpy(cond)
    with torch.no_grad():
        plain = model(_nchw(x), tt, c)
        tblocks.set_tiling(model, True)
        got = model(_nchw(x), tt, c)
        rolled = model(torch.roll(_nchw(x), (2, 4), (2, 3)), tt, c)
        tblocks.set_tiling(model, False)
        again = model(_nchw(x), tt, c)
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(torch.roll(got, (2, 4), (2, 3)).numpy(),
                               rolled.numpy(), atol=2e-4)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-3
    np.testing.assert_array_equal(again.numpy(), plain.numpy())


@pytest.mark.parametrize("which", ["decoder", "encoder"])
def test_vae_tiling_matches_jax_and_wraps(which):
    """The VAE decoder (a latent rolled by k decodes to the image rolled by
    8k; tests/test_tiling.py:59-78) and encoder (the image rolled by 8k
    encodes to the moments rolled by k, the downsampling pad wrapping too)
    under tiling, against the JAX package's at 1e-4."""
    P, JP = T.TINY_VAE, JT.TINY_VAE
    f = P.f_down
    if which == "decoder":
        fn, shape, mod = jvae.vae_decode_apply, (1, 8, 8, P.ch_z), \
            tvae.VaeDecoder(P)
        roll, back = (3, 1), (3 * f, 1 * f)
    else:
        fn, shape, mod = jvae.vae_encode_apply, (1, 8 * f, 8 * f, 3), \
            tvae.VaeEncoder(P)
        roll, back = (3 * f, 1 * f), (3, 1)
    spec = JB.trace_spec(lambda c, z: fn(c, z, JP), jnp.zeros(shape))
    params = _params(spec, seed=7)
    z = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: fn(
        JB.Ctx(p, dtype=jnp.float32, tiling=True), z, JP))(params, z))
    model = _port(mod, "vae.", params)
    tblocks.set_tiling(model, True)
    with torch.no_grad():
        got = model(_nchw(z))
        rolled = model(torch.roll(_nchw(z), roll, (2, 3)))
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(torch.roll(got, back, (2, 3)).numpy(),
                               rolled.numpy(), atol=2e-4)


# -- sessions ----------------------------------------------------------------

OPTS = [("model-type", "sd1"), ("image-dim", 64), ("steps", 4),
        ("seed", 21), ("cfg-scale", 6.0), ("prompt", "a (cat:1.2) on a hill"),
        ("nprompt", "blurry")]


def write_tiny_sd1(path) -> None:
    """The tiny SD1 checkpoint with weights of std 0.12 (the helpers'
    0.05 leaves the UNet's output nearly independent of its input, so
    that guidance hardly moves it)."""
    save_file(spec_to_checkpoint_arrays(tiny_specs(), seed=0, scale=0.12),
              str(path))


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.safetensors")
    write_tiny_sd1(path)
    return path


@pytest.fixture
def tiny(tiny_path, monkeypatch):
    """The tiny SD1 checkpoint, both packages' model tables patched."""
    path = tiny_path
    patch_tiny_model_types(monkeypatch)
    monkeypatch.setattr(tapi, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    return path


def psnr_u8(a, b) -> float:
    a, b = np.round(a * 255.0), np.round(b * 255.0)
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def jax_steps(s, monkeypatch):
    """Record the latent (NCHW f32) of every step of the JAX session ``s``
    through its stepwise path (a progress callback): the per-step and
    per-chunk programs are wrapped to keep their carry's latent."""
    traj = []

    def keep(fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            carry = out[0] if isinstance(out[0], tuple) else out
            traj.append(np.asarray(carry[0], np.float32).transpose(
                0, 3, 1, 2))
            return out
        return run

    monkeypatch.setattr(jsam, "_step_jit", keep(jsam._step_jit))
    monkeypatch.setattr(jsam, "_chunk_jit", keep(jsam._chunk_jit))
    monkeypatch.delenv("MLIS_PROGRESS_CHUNK", raising=False)
    s.option_set("callback", lambda *a: False)
    return traj


def run_session(s, opts, monkeypatch=None):
    """Set ``opts`` on ``s`` and generate: (per-step latents, image).  The
    JAX session runs in f32; with ``monkeypatch`` it is read through its
    stepwise path (``jax_steps``), else by its step observer."""
    for k, v in opts:
        s.option_set(k, v)
    if isinstance(s, japi.MLImgSynth):
        s._dtype = jnp.float32
        if monkeypatch is not None:
            traj = jax_steps(s, monkeypatch)
            return traj, np.asarray(s.generate(), np.float32)
    traj = []
    s.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    return traj, np.asarray(s.generate(), np.float32)


def assert_sessions_match(opts, monkeypatch=None, n_step=4):
    """Both sessions on ``opts``: every step's latent at 1e-4, the image
    at PSNR > 40 dB, the same NFE; returns the two sessions."""
    js, ts = japi.MLImgSynth(), tapi.MLImgSynth(device="cpu")
    traj_j, img_j = run_session(js, opts, monkeypatch)
    traj_t, img_t = run_session(ts, opts)
    assert len(traj_j) == len(traj_t) == n_step
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {i} latent mismatch")
    if img_j.ndim == 4 and img_j.shape[1] == 3:
        assert psnr_u8(img_j, img_t) > 40.0
    assert ts._nfe == js._nfe
    return js, ts


def _tail(text: str) -> str:
    """The infotext after the seed (the version string differs)."""
    return text.split("\n")[-1].rsplit(", Version:", 1)[0]


# (options, the infotext part both packages give for them)
SESSION_CASES = {
    "cfg_rescale": ([("cfg-rescale", 0.7)], ", CFG Rescale: 0.7"),
    "freeu_auto": ([("freeu", "1")], ", FreeU: 1.5,1.6,0.9,0.2"),
    "freeu_values": ([("freeu", "1.2,1.3,0.8,0.5")],
                     ", FreeU: 1.2,1.3,0.8,0.5"),
    "pag": ([("pag-scale", 3.0), ("pag-end", 0.5)],
            ", PAG scale: 3, PAG start: 0, PAG end: 0.5"),
}


@pytest.mark.parametrize("case", list(SESSION_CASES))
def test_guidance_session_matches_jax(tiny, case):
    extra, text = SESSION_CASES[case]
    opts = [("model", tiny)] + OPTS + extra
    js, ts = assert_sessions_match(opts)
    plain, _ = run_session(tapi.MLImgSynth(device="cpu"),
                           [("model", tiny)] + OPTS)
    assert np.abs(ts.tensors["latent"] - plain[-1]).max() > 1e-4
    assert text in ts.infotext
    assert _tail(ts.infotext) == _tail(js.infotext)


def test_pag_window_gating(tiny):
    """Outside its window PAG changes nothing: with the window at steps
    2-3 of 4 the first two latents are those without PAG, bit for bit."""
    base = [("model", tiny)] + OPTS
    plain, _ = run_session(tapi.MLImgSynth(device="cpu"), base)
    late, _ = run_session(tapi.MLImgSynth(device="cpu"), base + [
        ("pag-scale", 3.0), ("pag-start", 0.5)])
    for i in range(2):
        np.testing.assert_array_equal(late[i], plain[i])
    assert np.abs(late[2] - plain[2]).max() > 1e-4


def test_tiling_session_matches_jax(tiny, monkeypatch):
    """``tiling 1``: the loop and the decode wrap; the JAX session read on
    its fused-decode path; the session's modules are back to zero padding
    for a request without it."""
    opts = [("model", tiny)] + OPTS + [("tiling", 1)]
    js, ts = assert_sessions_match(opts, monkeypatch)
    tiled = ts.tensors["latent"]
    plain, img = run_session(ts, [("tiling", 0)] + OPTS)
    assert np.abs(tiled - plain[-1]).max() > 1e-3
    fresh, img2 = run_session(tapi.MLImgSynth(device="cpu"),
                              [("model", tiny)] + OPTS)
    np.testing.assert_array_equal(plain[-1], fresh[-1])
    np.testing.assert_array_equal(img, img2)


# -- errors ------------------------------------------------------------------

# (case, model, options): MlisError E_OPT_VALUE in both packages, at
# option_set or at generate
ERRORS = {
    "cfg_rescale_range": ("sd1", [("cfg-rescale", 1.5)]),
    "pag_negative": ("sd1", [("pag-scale", -1.0)]),
    "pag_start_range": ("sd1", [("pag-start", 1.5)]),
    "pag_empty_window": ("sd1", [("pag-scale", 2.0), ("pag-start", 0.5),
                                 ("pag-end", 0.5)]),
    "pag_deepcache": ("sd1", [("pag-scale", 2.0), ("deepcache", 2)]),
    "pag_flow": ("sd3", [("pag-scale", 2.0)]),
    "freeu_syntax": ("sd1", [("freeu", "1.2,1.3")]),
    "freeu_flow": ("sd3", [("freeu", "1")]),
    "tiling_value": ("sd1", [("tiling", "yes")]),
    "deepcache_heun": ("sd1", [("deepcache", 2), ("method", "heun")]),
    "deepcache_editing": ("sd1", [("deepcache", 2),
                                  ("prompt", "a [cat:dog:2]")]),
    "deepcache_slg": ("sd3", [("deepcache", 2), ("slg-scale", 2.0),
                              ("slg-layers", "1")]),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_guidance_errors_match_jax(tiny, tmp_path, monkeypatch, case):
    model, extra = ERRORS[case]
    if model == "sd3":
        path = str(tmp_path / "sd3.safetensors")
        JT.write_checkpoint_sd3(path)
        patch_tiny_model_types(monkeypatch,
                               {"sd3": JT.TINY_MODEL_TYPE_SD3})
        monkeypatch.setattr(tapi, "_model_types",
                            lambda: {"sd3": T.TINY_MODEL_TYPE_SD3})
        opts = [("model", path), ("image-dim", 64), ("steps", 4)]
    else:
        opts = [("model", tiny)] + OPTS
    for s in (japi.MLImgSynth(), tapi.MLImgSynth(device="cpu")):
        err = (japi.MlisError if isinstance(s, japi.MLImgSynth)
               else tapi.MlisError)
        with pytest.raises(err) as e:
            for k, v in opts + extra:
                s.option_set_str(k, str(v))
            if isinstance(s, japi.MLImgSynth):
                s._dtype = jnp.float32
            s.generate()
        assert e.value.code == err.E_OPT_VALUE, (type(s), e.value)


def test_lcm_on_a_flow_model_raises(tmp_path, monkeypatch):
    """lcm on the MMDiT: ``MlisError`` in the port, where the JAX session's
    ``make_plan`` raises a bare ``ValueError``."""
    path = str(tmp_path / "sd3.safetensors")
    JT.write_checkpoint_sd3(path)
    patch_tiny_model_types(monkeypatch, {"sd3": JT.TINY_MODEL_TYPE_SD3})
    monkeypatch.setattr(tapi, "_model_types",
                        lambda: {"sd3": T.TINY_MODEL_TYPE_SD3})
    opts = [("model", path), ("image-dim", 64), ("steps", 4),
            ("method", "lcm")]
    js, ts = japi.MLImgSynth(), tapi.MLImgSynth(device="cpu")
    for k, v in opts:
        js.option_set(k, v)
        ts.option_set(k, v)
    js._dtype = jnp.float32
    with pytest.raises(ValueError, match="rectified-flow"):
        js.generate()
    with pytest.raises(tapi.MlisError, match="rectified-flow") as e:
        ts.generate()
    assert e.value.code == tapi.MlisError.E_OPT_VALUE


# -- the CLI -----------------------------------------------------------------

CLI_ARGS = ["-d", "64", "-s", "4", "-S", "21", "--cfg-scale", "6", "-p",
            "a (cat:1.2) on a hill", "-n", "blurry"]


@pytest.mark.parametrize("flags,opts", [
    (["--cfg-rescale", "0.7", "--freeu", "1", "--pag-scale", "2",
      "--pag-end", "0.5", "--tiling", "1", "--subseed", "5",
      "--subseed-strength", "0.3", "--method", "lcm"],
     [("cfg-rescale", 0.7), ("freeu", "1"), ("pag-scale", 2.0),
      ("pag-end", 0.5), ("tiling", 1), ("subseed", 5),
      ("subseed-strength", 0.3), ("method", "lcm")]),
    (["--deepcache", "2", "--method", "dpm++2m"],
     [("deepcache", 2), ("method", "dpmpp2m")]),
], ids=["guidance", "deepcache"])
def test_options_through_the_cli(tiny, tmp_path, flags, opts):
    """The CLI forwards every new flag: its latent is the session's with
    the same options, and the PNG carries the session's infotext."""
    out, png = str(tmp_path / "lat.npy"), str(tmp_path / "o.png")
    assert cli.main(["generate", "-b", "cpu", "-m", tiny] + CLI_ARGS + flags
                    + ["--olatent", out, "-o", png, "-q"]) == 0
    ts = tapi.MLImgSynth(device="cpu")
    traj, _ = run_session(ts, [("model", tiny)] + OPTS + opts)
    np.testing.assert_array_equal(image_mod.tensor_load(out), traj[-1])
    text = image_mod.png_read(png)[1]["parameters"]
    assert _tail(text) == _tail(ts.infotext)
    for flag in flags[::2]:
        assert flag in cli.HELP, flag
