"""ControlNet: the port's module and session against the JAX package.

``models/controlnet.py`` against ``controlnet.py`` on random parameters
(the hint features and every residual, f32, relative L2 1e-4) for the tiny
SD1 UNet and the tiny SDXL one (its label path); whole tiny sessions with a
ControlNet file in the ``control_model.*`` layout (the JAX package's writer
for SD1, the port's for SDXL) against the JAX session: per-step latents
atol/rtol 1e-4, the final u8 image PSNR > 40 dB, the infotext; and the
session's refusals (no hint, a hint of another size, DeepCache).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import (TINY_MODEL_TYPE, TINY_MODEL_TYPE_XL,
                     patch_tiny_model_types, write_checkpoint_sdxl,
                     write_tiny_checkpoint)
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import controlnet as jcnet
from mlimgsynth_tpu.testing import TINY_UNET, TINY_UNET_XL
from mlimgsynth_tpu.testing import write_tiny_controlnet
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.models import controlnet as tcnet
from torch_jax_memo import jax_spec_memo  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("which", ["sd1", "sdxl"])
def test_controlnet_residuals_match_jax(which):
    """Hint features [N, n_ch, H/8, W/8] and the n_skips + 1 residuals of
    ``ControlNet`` against ``hint_apply`` / ``controlnet_apply`` on the
    same random parameters (the SDXL one with its label embedding), the
    hint at batch 1 broadcast over two rows."""
    JP, TP = ((TINY_UNET, T.TINY_UNET) if which == "sd1"
              else (TINY_UNET_XL, T.TINY_UNET_XL))
    lab = jnp.zeros((1, JP.ch_adm_in)) if JP.ch_adm_in else None

    def f(ctx, x, t, c, hint):
        feat = jcnet.hint_apply(ctx, hint, JP)
        return jcnet.controlnet_apply(ctx, x, t, c, lab, feat, JP)

    spec = JB.trace_spec(f, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                         jnp.zeros((1, 77, JP.n_ctx)),
                         jnp.zeros((1, 64, 64, 3)))
    assert ("cnet.label_embed.0.weight" in spec) == (which == "sdxl")
    rng = np.random.default_rng(11)
    params = {k: (rng.standard_normal(ps.shape).astype(np.float32)
                  * np.float32(0.1 if ps.kind == JB.VEC else
                               float(np.prod(ps.shape[:-1])) ** -0.5))
              for k, ps in spec.items()}
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([700.0, 700.0], np.float32)
    cond = rng.standard_normal((2, 77, JP.n_ctx)).astype(np.float32)
    hint = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    label = (rng.standard_normal((2, JP.ch_adm_in)).astype(np.float32)
             if JP.ch_adm_in else None)

    @jax.jit
    def run(p, x, t, c, hint, label):
        ctx = JB.Ctx(p, dtype=jnp.float32)
        feat = jcnet.hint_apply(ctx, hint, JP)
        return feat, jcnet.controlnet_apply(ctx, x, t, c, label, feat, JP)

    feat_j, res_j = run(params, x, t, cond, hint, label)
    with torch.device("meta"):
        m = tcnet.ControlNet(TP)
    m = tweights.load_module(m, "cnet.",
                             tweights.params_from_jax(params)).eval()
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        feat_t = m.hint_features(nchw(hint))
        res_t = m(nchw(x), torch.from_numpy(t), torch.from_numpy(cond),
                  None if label is None else torch.from_numpy(label),
                  feat_t)
    assert _rel(feat_t.numpy().transpose(0, 2, 3, 1),
                np.asarray(feat_j)) < 1e-4
    assert len(res_t) == len(res_j) == 3 * len(TP.ch_mult) + 1
    for i, (a, b) in enumerate(zip(res_t, res_j)):
        assert _rel(a.numpy().transpose(0, 2, 3, 1), np.asarray(b)) < 1e-4, i


def _psnr_u8(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _hint(h=64, w=64, seed=3):
    """A seeded edge-map-like hint: white lines on black."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    img[rng.integers(0, h, 6)] = 255
    img[:, rng.integers(0, w, 6)] = 255
    return img


def _run(session, ckpt, mt, extra):
    traj = []
    session.option_set("model", ckpt)
    for k, *v in [("model-type", mt), ("image-dim", 64), ("steps", 4),
                  ("seed", 7), ("cfg-scale", 6.0), ("weight-type", "f32"),
                  ("prompt", "a house"), ("nprompt", "blurry")] + extra:
        session.option_set(k, *v)
    if isinstance(session, JaxSession):
        session._dtype = jnp.float32
    session.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    return traj, np.asarray(session.generate(), np.float32)


@pytest.fixture
def ckpts(tmp_path, monkeypatch):
    """(model file, ControlNet file) by family."""
    out = {}
    write_tiny_checkpoint(tmp_path / "sd1.safetensors")
    write_tiny_controlnet(tmp_path / "cn-sd1.safetensors")
    out["sd1"] = (str(tmp_path / "sd1.safetensors"),
                  str(tmp_path / "cn-sd1.safetensors"))
    write_checkpoint_sdxl(tmp_path / "xl.safetensors")
    T.write_random_controlnet(tmp_path / "cn-xl.safetensors",
                              T.TINY_MODEL_TYPE_XL, seed=5,
                              dtype=np.float32, zero_scale=0.5)
    out["sdxl"] = (str(tmp_path / "xl.safetensors"),
                   str(tmp_path / "cn-xl.safetensors"))
    patch_tiny_model_types(monkeypatch, {"sd1": TINY_MODEL_TYPE,
                                         "sdxl": TINY_MODEL_TYPE_XL})
    monkeypatch.setattr(torch_api, "_model_types", lambda: {
        "sd1": T.TINY_MODEL_TYPE, "sdxl": T.TINY_MODEL_TYPE_XL})
    return out


@pytest.mark.parametrize("mt", ["sd1", "sdxl"])
def test_controlnet_session_matches_jax(ckpts, mt):
    """A request with ``control_net``, ``control_image`` and
    ``control_strength`` 0.8: every step's latent, the image and the
    infotext as the JAX session's; the ControlNet changes the result."""
    ckpt, cn = ckpts[mt]
    extra = [("control-net", cn), ("control-image", _hint()),
             ("control-strength", 0.8)]
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    traj_j, img_j = _run(js, ckpt, mt, extra)
    traj_t, img_t = _run(ts, ckpt, mt, extra)
    assert len(traj_j) == len(traj_t) == 4
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert _psnr_u8(np.round(img_j * 255), np.round(img_t * 255)) > 40.0
    assert ts.infotext == js.infotext
    assert "ControlNet: cn-" in ts.infotext
    assert "ControlNet strength: 0.8" in ts.infotext
    plain = _run(torch_api.MLImgSynth(device="cpu"), ckpt, mt, [])[0]
    assert np.abs(plain[-1] - traj_t[-1]).max() > 1e-3


def test_controlnet_refusals(ckpts):
    """No hint and a hint of another size give ``E_IMAGE``; DeepCache with
    a ControlNet gives ``E_OPT_VALUE`` (``unet.py:168``)."""
    ckpt, cn = ckpts["sd1"]
    E = torch_api.MlisError
    for extra, code in (([("control-net", cn)], E.E_IMAGE),
                        ([("control-net", cn),
                          ("control-image", _hint(32, 64))], E.E_IMAGE),
                        ([("control-net", cn), ("control-image", _hint()),
                          ("deepcache", 2)], E.E_OPT_VALUE)):
        with pytest.raises(E) as e:
            _run(torch_api.MLImgSynth(device="cpu"), ckpt, "sd1", extra)
        assert e.value.code == code, extra
