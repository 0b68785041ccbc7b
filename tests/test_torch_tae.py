"""The port's TAE against the JAX package's: ``TaeDecoder`` and
``TaeEncoder`` against ``tae_decode_apply`` and ``tae_encode_apply`` on the
JAX package's ``write_tiny_tae`` files (4- and 16-channel latents), and a
tiny SD1 session with the ``tae`` option against the JAX session with it
(the latents, the image and the infotext with its ``VAE: tae`` marker),
also with a relative TAE path found through ``aux_dir``, and for img2img.

f32 on the CPU.  Tolerances: the decoder's output atol/rtol 1e-4 (summation
order between XLA:CPU's and torch's convolutions over 13 layers); the
session's latents atol/rtol 1e-4 and image PSNR > 40 dB, as the other
session legs (tests/test_torch_e2e.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import (TINY_MODEL_TYPE, patch_tiny_model_types,
                     write_tiny_checkpoint, write_tiny_tae)
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.io.tensorstore import TensorStore as JaxTensorStore
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import tae as jtae
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.models import tae as ttae
from torch_jax_memo import jax_spec_memo  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores (and the tensors are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(path):
    """A taesd file's tensors in the JAX layout (conv HWIO) under
    ``tae.``, as the JAX session hands them to ``tae_decode_apply``."""
    store = JaxTensorStore.open(path)
    out = {}
    for k in store.names():
        a = np.array(store.read(k), np.float32)
        out["tae." + k] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    store.close()
    return out


@pytest.mark.parametrize("ch_z", [4, 16])
def test_tae_decoder_matches_jax(tmp_path, ch_z):
    path = str(tmp_path / "tae.safetensors")
    P = write_tiny_tae(path, seed=ch_z, ch_z=ch_z)
    m = tweights.load_tae(path, "cpu", torch.float32)
    assert dataclasses.asdict(m.P) == dataclasses.asdict(P)
    lat = np.random.default_rng(1).standard_normal(
        (2, ch_z, 8, 6)).astype(np.float32) * np.float32(4.0)
    want = np.asarray(jax.jit(lambda p, x: jtae.tae_decode_apply(
        JB.Ctx(p, dtype=jnp.float32), x, P))(
        _jax_params(path), lat.transpose(0, 2, 3, 1))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = m(torch.from_numpy(lat)).numpy()
    assert got.shape == (2, 3, 64, 48)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ch_z", [4, 16])
def test_tae_encoder_matches_jax(tmp_path, ch_z):
    """The encoder takes the image in [0, 1] (not [-1, 1]) to the sampler's
    latent."""
    path = str(tmp_path / "tae.safetensors")
    P = write_tiny_tae(path, seed=ch_z + 1, ch_z=ch_z)
    m = tweights.load_tae(path, "cpu", torch.float32, encoder=True)
    assert isinstance(m, ttae.TaeEncoder) and m.P == ttae.TaeParams(
        **dataclasses.asdict(P))
    img = np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 48)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: jtae.tae_encode_apply(
        JB.Ctx(p, dtype=jnp.float32), x, P))(
        _jax_params(path), img.transpose(0, 2, 3, 1))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = m(torch.from_numpy(img)).numpy()
    assert got.shape == (2, ch_z, 8, 6)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_tae_params_from_a_full_width_file(tmp_path):
    """``write_random_tae``'s full-width taesd decoder (ch_inner 64, three
    blocks a level) reads back as ``TAE_SD1``."""
    path = str(tmp_path / "taesd.safetensors")
    T.write_random_tae(path)
    m = tweights.load_tae(path, "cpu", torch.float32)
    assert m.P == ttae.TAE_SD1
    assert len(m.decoder["layers"]) == 19 - 4   # the ReLU, 3 upsamples
    enc = tweights.load_tae(path, "cpu", torch.float32, encoder=True)
    assert len(enc.encoder["layers"]) == 15


def _run(s, ckpt, tae, extra=()):
    traj = []
    for k, v in [("model", ckpt), ("model-type", "sd1"),
                 ("weight-type", "f32"), ("image-dim", 64), ("steps", 4),
                 ("seed", 9), ("cfg-scale", 5.0), ("prompt", "a test"),
                 ("tae", tae), *extra]:
        s.option_set(k, v)
    s.step_observer = lambda i, lat: traj.append(np.asarray(lat).copy())
    return traj, np.asarray(s.generate(), np.float32), s.infotext


@pytest.mark.parametrize("where", ["path", "aux_dir", "img2img"])
def test_tae_session_matches_jax(tmp_path, monkeypatch, where):
    ckpt = str(tmp_path / "sd1.safetensors")
    write_tiny_checkpoint(ckpt)
    aux = tmp_path / "aux"
    aux.mkdir()
    P = write_tiny_tae(str(aux / "taesd.safetensors"))
    monkeypatch.setattr(jtae, "TAE_SD1", P)   # the JAX session's geometry
    patch_tiny_model_types(monkeypatch)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    if where == "aux_dir":     # a relative path, not in the working dir
        monkeypatch.chdir(tmp_path)
        tae = "taesd.safetensors"
    else:
        tae = str(aux / "taesd.safetensors")
    # img2img: the TAE encoder (image in [0, 1], no noise drawn) gives the
    # initial latent; 2 of the 4 steps run
    extra = ([("image", np.random.default_rng(3).integers(
        0, 256, (64, 64, 3)).astype(np.uint8)), ("f-t-ini", 0.5)]
             if where == "img2img" else [])
    res = []
    for s in (JaxSession(), torch_api.MLImgSynth(device="cpu")):
        if where == "aux_dir":
            s.option_set("aux-dir", str(aux))
        res.append(_run(s, ckpt, tae, extra))
    (traj_j, img_j, info_j), (traj_t, img_t, info_t) = res
    assert len(traj_t) == len(traj_j) == (2 if extra else 4)
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}")
    assert img_t.shape == (1, 3, 64, 64) and np.isfinite(img_t).all()
    mse = np.mean((np.round(img_j * 255) - np.round(img_t * 255)) ** 2)
    psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    assert psnr > 40.0, f"TAE image PSNR {psnr:.1f} dB <= 40"
    assert "VAE: tae" in info_t and info_t == info_j


def test_tae_latent_width_must_match(tmp_path, monkeypatch):
    """A 16-channel TAE (taesd3) on a 4-channel model raises, as the JAX
    session does."""
    ckpt = str(tmp_path / "sd1.safetensors")
    write_tiny_checkpoint(ckpt)
    write_tiny_tae(str(tmp_path / "taesd3.safetensors"), ch_z=16)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    s = torch_api.MLImgSynth(device="cpu")
    s.option_set("model", ckpt)
    s.option_set("tae", str(tmp_path / "taesd3.safetensors"))
    with pytest.raises(torch_api.MlisError) as e:
        s.setup()
    assert e.value.code == torch_api.MlisError.E_IMAGE
    assert TINY_MODEL_TYPE.vae_p.ch_z == 4
