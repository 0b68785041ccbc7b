"""The inpainting extras and inpaint-variant UNets: the port against the
JAX package on tiny SD1 checkpoints.

Whole sessions against the JAX session from the same checkpoint, image,
mask and seed: the mask blurred before its downsize (``mask_blur``),
inpainting at full resolution around an off-centre mask
(``inpaint_full_res``: the crop, the Lanczos resizes both ways, the paste;
an empty mask falls back to img2img), and a 9-channel inpaint-variant UNet
(the width from the checkpoint; the repaint mask and the deterministic
encode of the grey-filled image as extra input channels) from an RGBA image
and from no image.  Tolerances as the img2img legs
(tests/test_torch_img2img.py): per-step latents atol/rtol 1e-4, the final
u8 image PSNR > 40 dB.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import patch_tiny_model_types, write_tiny_checkpoint
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.testing import write_tiny_inpaint_checkpoint
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T

OPTS = [("model-type", "sd1"), ("image-dim", 64), ("steps", 5),
        ("seed", 42), ("cfg-scale", 7.0), ("method", "euler"),
        ("prompt", "a (cat:1.3) on a sofa"), ("nprompt", "blurry")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr_u8(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _rgba(h=64, w=64, hole=(24, 48, 36, 60), seed=0):
    """A seeded RGBA image: colour ramps plus noise, opaque (kept) but for
    the transparent rectangle ``hole`` (y0, y1, x0, x1), repainted."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 3, y * 3, (x + y) * 2], axis=-1) % 256
    rgb = (rgb + rng.integers(0, 40, rgb.shape)) % 256
    alpha = np.full((h, w, 1), 255)
    y0, y1, x0, x1 = hole
    alpha[y0:y1, x0:x1] = 0
    return np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)


def _run(session, ckpt, extra):
    traj = []
    session.option_set("model", ckpt)
    for k, *v in OPTS + [("weight-type", "f32")] + extra:
        session.option_set(k, *v)
    if isinstance(session, JaxSession):
        session._dtype = jnp.float32
    session.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    return traj, np.asarray(session.generate(), np.float32)


def _assert_same(jres, tres, n_step):
    (traj_j, img_j), (traj_t, img_t) = jres, tres
    assert len(traj_j) == len(traj_t) == n_step
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert img_t.shape == img_j.shape
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


@pytest.fixture
def tiny_ckpt(tmp_path, monkeypatch):
    path = tmp_path / "tiny.safetensors"
    write_tiny_checkpoint(path)
    patch_tiny_model_types(monkeypatch)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    return str(path)


def test_mask_blur_matches_jax(tiny_ckpt):
    """``mask_blur`` 3: the blurred mask's block-mean latent mask is the
    JAX session's, and so are the steps and the image."""
    extra = [("image", _rgba()), ("f-t-ini", 0.8), ("mask-blur", 3.0)]
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    jres, tres = _run(js, tiny_ckpt, extra), _run(ts, tiny_ckpt, extra)
    _assert_same(jres, tres, 4)
    np.testing.assert_allclose(ts.tensors["lmask"], js.tensors["lmask"],
                               atol=1e-6)
    lm = ts.tensors["lmask"]
    assert 0.0 < lm.min() < 1.0 and ((lm > 0) & (lm < 1)).sum() > 10
    assert ts.infotext == js.infotext


@pytest.mark.parametrize("case", ["off-centre", "empty"])
def test_inpaint_full_res_matches_jax(tiny_ckpt, case):
    """``inpaint_full_res`` on a 128 x 96 image with an off-centre hole:
    its padded box, widened to the session's square, cut out and resized
    to 64 x 64, inpainted, resized back and pasted under the (blurred)
    mask; the image outside the box is the input's.  An all-opaque image
    (an empty repaint mask) runs img2img at the session's size."""
    hole = (8, 28, 80, 112) if case == "off-centre" else (0, 0, 0, 0)
    rgba = _rgba(96, 128, hole, seed=1)
    extra = [("image", rgba), ("f-t-ini", 0.8), ("mask-blur", 1.5),
             ("inpaint-full-res", 1), ("inpaint-full-res-padding", 6)]
    if case == "empty":
        extra[0] = ("image", _rgba(64, 64, hole, seed=1))
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    jres, tres = _run(js, tiny_ckpt, extra), _run(ts, tiny_ckpt, extra)
    _assert_same(jres, tres, 4)
    assert ts.infotext == js.infotext
    assert ts.c["mask_blur"] == 1.5 and not ts._in_fullres
    if case == "off-centre":
        assert tres[1].shape == (1, 3, 96, 128)
        assert "Inpaint area: only masked, Masked padding: 6" in ts.infotext
        # rows below the box keep the input image (quantized to u8)
        np.testing.assert_allclose(tres[1][0, :, 60:], rgba[60:, :, :3]
                                   .transpose(2, 0, 1) / 255.0, atol=1e-6)
    else:
        assert "Inpaint area" not in ts.infotext


@pytest.fixture
def inpaint_ckpt(tmp_path, monkeypatch):
    path = tmp_path / "tiny-inpainting.safetensors"
    write_tiny_inpaint_checkpoint(path)
    patch_tiny_model_types(monkeypatch)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    return str(path)


@pytest.mark.parametrize("case", ["rgba", "txt2img"])
def test_inpaint_variant_matches_jax(inpaint_ckpt, case):
    """A 9-channel UNet: the session widens the model type from the
    checkpoint's ``in.conv`` and conditions every evaluation on the repaint
    mask and the masked image's latent mean (no per-step mask blend:
    the kept region moves too); without an image, on a zero latent."""
    extra = ([("image", _rgba(seed=2)), ("f-t-ini", 0.8)]
             if case == "rgba" else [])
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    enc = []
    encode = ts.image_encode
    ts.image_encode = lambda img, sample=True: enc.append(
        (sample, encode(img, sample))) or enc[-1][1]
    jres, tres = _run(js, inpaint_ckpt, extra), _run(ts, inpaint_ckpt, extra)
    assert ts._mt.unet_p.n_ch_in == 9
    _assert_same(jres, tres, 4 if case == "rgba" else 5)
    assert [s for s, _ in enc] == ([True, False] if case == "rgba" else [])
    if case == "rgba":
        assert "Mode: inpaint" in ts.infotext
        # the learned conditioning replaces the blend: kept rows move
        assert not np.array_equal(ts.tensors["latent"][:, :, :2],
                                  enc[0][1][:, :, :2])


def test_inpaint_variant_refuses_deepcache(inpaint_ckpt):
    """DeepCache with an inpaint-variant UNet raises ``E_OPT_VALUE``, as
    the JAX session's check does."""
    ts = torch_api.MLImgSynth(device="cpu")
    with pytest.raises(torch_api.MlisError) as e:
        _run(ts, inpaint_ckpt, [("deepcache", 2)])
    assert e.value.code == torch_api.MlisError.E_OPT_VALUE
