"""The hires fix: the port's two-stage request against the JAX session's
on a tiny SD1 checkpoint.

Base 128 x 128, factor 1.5: the final size 192 x 192 (a multiple of 64),
the latent 16 -> 24 (a per-axis factor of 1.5, not an integer).  The
latent branch (bilinear, as ``jax.image.resize``) and the image branch (a
random 2x RRDBNet on the decoded first pass, a Lanczos resize to the final
size, the re-encode): every step of both passes atol/rtol 1e-4, the final
u8 image PSNR > 40 dB, the infotext; then the options the first pass
clears restored for the second and the base size and steps after it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import patch_tiny_model_types, write_tiny_checkpoint
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.models import esrgan as tesr

OPTS = [("model-type", "sd1"), ("image-dim", 128), ("steps", 4),
        ("seed", 11), ("cfg-scale", 7.0), ("method", "euler"),
        ("weight-type", "f32"), ("hires-fix", 1.5), ("hires-steps", 3),
        ("hires-denoise", 0.7), ("prompt", "a lighthouse at dawn"),
        ("nprompt", "blurry")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr_u8(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.fixture
def files(tmp_path, monkeypatch):
    write_tiny_checkpoint(tmp_path / "tiny.safetensors")
    T.write_random_esrgan(tmp_path / "x2.pth", tesr.EsrganParams(
        n_feat=8, n_block=1, growth=4, unshuffle=2), seed=2)
    patch_tiny_model_types(monkeypatch)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    return str(tmp_path / "tiny.safetensors"), str(tmp_path / "x2.pth")


def _run(session, ckpt, extra):
    traj = []
    session.option_set("model", ckpt)
    for k, *v in OPTS + extra:
        session.option_set(k, *v)
    if isinstance(session, JaxSession):
        session._dtype = jnp.float32
    session.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    return traj, np.asarray(session.generate(), np.float32)


@pytest.mark.parametrize("branch", ["latent", "image"])
def test_hires_matches_jax(files, branch):
    """4 steps at 128 x 128, then 2 of 3 steps (strength 0.7) at 192 x
    192: the latents of every step, the final image, the infotext."""
    ckpt, up = files
    extra = ([("hires-upscaler", "RealESRGAN_x2"), ("upscaler", up)]
             if branch == "image" else [])
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    traj_j, img_j = _run(js, ckpt, extra)
    traj_t, img_t = _run(ts, ckpt, extra)
    assert [a.shape[2:] for a in traj_t] == [(16, 16)] * 4 + [(24, 24)] * 2
    assert len(traj_j) == len(traj_t)
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert img_t.shape == img_j.shape == (1, 3, 192, 192)
    assert _psnr_u8(np.round(img_j * 255), np.round(img_t * 255)) > 40.0
    assert ts.infotext == js.infotext
    assert ("Size: 192x192" in ts.infotext
            and "Hires upscale: 1.5, Hires steps: 3, Denoising strength: "
                "0.7" in ts.infotext)
    assert ("Hires upscaler: RealESRGAN_x2" in ts.infotext) == (
        branch == "image")
    # the base size and steps come back; the one-shot options are spent
    c = ts.c
    assert (c["width"], c["height"], c["steps"]) == (128, 128, 4)
    assert c["prompt_raw"] == "" and c["tuflags"] == 0
    assert not ts._in_hires


def test_hires_keeps_no_decode(files):
    """With ``no_decode`` the second pass's latent is the result, its
    first pass decoded nothing (the latent branch) either."""
    ckpt, _ = files
    ts = torch_api.MLImgSynth(device="cpu")
    traj, lat = _run(ts, ckpt, [("no-decode", "1")])
    assert lat.shape == (1, 4, 24, 24)
    np.testing.assert_array_equal(lat, traj[-1])
    assert ts.c["no_decode"] is True
