"""The SDXL refiner: the ``sdxl_refiner`` model type and the base ->
refiner ensemble, the port against the JAX package on tiny checkpoints.

The refiner alone (its bigG tower under ``conditioner.embedders.0.model.``;
the label = the pooled projected feature and the embeddings of [h, w, 0, 0,
score], the negative prompt's row at the negative score): per-step latents
atol/rtol 1e-4, the final u8 image PSNR > 40 dB, the label rows against the
JAX session's (1e-5: torch's and XLA's f32 cos and sin) and their score
embeddings bit for bit the port's ``timestep_embedding``.  The ensemble (a
tiny SDXL base stopping at the switch with its noise kept, the refiner
going on without new noise, one Philox stream) against the JAX session's,
every step of both stages, and its three one-model branches.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import (TINY_MODEL_TYPE_REFINER, TINY_MODEL_TYPE_XL,
                     patch_tiny_model_types, write_checkpoint_refiner,
                     write_checkpoint_sdxl)
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.models import blocks as tblocks
from mlimgsynth_torch.models import unet as tunet


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr_u8(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def test_refiner_model_type():
    """The full-size type: n_ctx 1280 identifies it; the bigG tower alone
    under ``clip.``, with its projection; the label 1280 + 5 x 256."""
    types = torch_api._model_types()
    assert {d.unet_p.n_ctx: k for k, d in types.items()}[1280] == \
        "sdxl_refiner"
    mt = types["sdxl_refiner"]
    models = torch_api.build_models(mt)
    assert set(models) == {"clip.text.", "unet.", "vae."}
    assert models["clip.text."].text_proj.shape == (1280, 1280)
    assert mt.unet_p.ch_adm_in == 1280 + 5 * 256


@pytest.fixture
def files(tmp_path, monkeypatch):
    write_checkpoint_refiner(tmp_path / "refiner.safetensors")
    write_checkpoint_sdxl(tmp_path / "base.safetensors")
    patch_tiny_model_types(monkeypatch, {
        "sdxl": TINY_MODEL_TYPE_XL, "sdxl_refiner": TINY_MODEL_TYPE_REFINER})
    monkeypatch.setattr(torch_api, "_model_types", lambda: {
        "sdxl": T.TINY_MODEL_TYPE_XL,
        "sdxl_refiner": T.TINY_MODEL_TYPE_REFINER})
    return str(tmp_path / "base.safetensors"), str(tmp_path /
                                                   "refiner.safetensors")


def _setup(session, ckpt, mt, extra):
    session.option_set("model", ckpt)
    for k, *v in [("model-type", mt), ("image-dim", 64), ("steps", 5),
                  ("seed", 21), ("cfg-scale", 6.0), ("weight-type", "f32"),
                  ("prompt", "a red fox in the snow")] + extra:
        session.option_set(k, *v)
    if isinstance(session, JaxSession):
        session._dtype = jnp.float32


def _observe(session, traj):
    session.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())


def _assert_same(traj_j, traj_t, img_j, img_t, n_step):
    assert len(traj_j) == len(traj_t) == n_step
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert img_t.shape == img_j.shape
    assert _psnr_u8(np.round(img_j * 255), np.round(img_t * 255)) > 40.0


@pytest.mark.parametrize("nprompt", ["blurry, low quality", ""])
def test_refiner_alone_matches_jax(files, nprompt):
    """The refiner as a model of its own: the steps, the image, the cond
    rows (zero for an empty negative prompt) and the label rows."""
    _, rf = files
    res = {}
    for name, s in (("j", JaxSession()),
                    ("t", torch_api.MLImgSynth(device="cpu"))):
        traj = []
        _setup(s, rf, "sdxl_refiner", [("nprompt", nprompt)])
        _observe(s, traj)
        res[name] = (s, traj, np.asarray(s.generate(), np.float32))
    (js, traj_j, img_j), (ts, traj_t, img_t) = res["j"], res["t"]
    _assert_same(traj_j, traj_t, img_j, img_t, 5)
    assert ts.infotext == js.infotext
    for k in ("cond", "ncond", "label", "nlabel"):
        np.testing.assert_allclose(ts.tensors[k], np.asarray(js.tensors[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    assert ts.tensors["label"].shape == (1, 32 + 5 * 256)
    assert ts.tensors["ncond"].any() == bool(nprompt)
    for k, score in (("label", tunet.AESTHETIC_SCORE),
                     ("nlabel", tunet.AESTHETIC_NSCORE)):
        se = tblocks.timestep_embedding(torch.tensor(
            [64.0, 64.0, 0.0, 0.0, score]), 256).reshape(1, -1).numpy()
        np.testing.assert_array_equal(ts.tensors[k][:, 32:], se)


def _ensemble(s, base, rf, extra):
    """The ensemble request on ``s``: (base steps, refiner steps, image)."""
    tb, tr = [], []
    _setup(s, base, "sdxl", [("nprompt", "blurry"), ("refiner", rf)]
           + extra)
    _observe(s, tb)
    _observe(s._refiner_get(), tr)
    return tb, tr, np.asarray(s.generate(), np.float32)


def test_refiner_ensemble_matches_jax(files):
    """5 steps, switch 0.6: the base runs 3 steps to sigma(0.4) and keeps
    that noise, the refiner runs the other 2 from it without new noise."""
    base, rf = files
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    tb_j, tr_j, img_j = _ensemble(js, base, rf, [("refiner-switch", 0.6)])
    tb_t, tr_t, img_t = _ensemble(ts, base, rf, [("refiner-switch", 0.6)])
    assert (len(tb_t), len(tr_t)) == (2, 2)
    _assert_same(tb_j + tr_j, tb_t + tr_t, img_j, img_t, 4)
    assert ts.infotext == js.infotext
    assert "Refiner: refiner.safetensors, Refiner switch: 0.6" in ts.infotext
    # the handoff latent still holds noise: the refiner moves it
    assert np.abs(tr_t[0] - tb_t[-1]).max() > 1e-3
    assert not ts._keep_tail and ts._refiner._noise_add


@pytest.mark.parametrize("case", ["ends-before", "starts-below",
                                  "too-few-steps"])
def test_refiner_degenerate_branches_match_jax(files, case):
    """One model alone: the base where the request ends before the switch
    (``f_t_end`` 0.5 > 0.2); the refiner where an img2img request starts
    below it (``f_t_ini`` 0.15) or the base would run fewer than 2 steps
    (2 steps, switch 0.5)."""
    base, rf = files
    img = np.random.default_rng(4).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    extra = {"ends-before": [("f-t-end", 0.5)],
             "starts-below": [("image", img), ("f-t-ini", 0.15)],
             "too-few-steps": [("steps", 2), ("refiner-switch", 0.5)]}[case]
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    tb_j, tr_j, img_j = _ensemble(js, base, rf, extra)
    tb_t, tr_t, img_t = _ensemble(ts, base, rf, extra)
    assert (len(tb_t) > 0, len(tr_t) > 0) == (
        (True, False) if case == "ends-before" else (False, True))
    _assert_same(tb_j + tr_j, tb_t + tr_t, img_j, img_t,
                 len(tb_t) + len(tr_t))
    assert ts.infotext == js.infotext
    assert ts.c["prompt_raw"] == "" and ts.c["tuflags"] == 0
