"""The merged-batch path (``MLImgSynth.generate_batch``): the port against
the JAX session's ``generate_batch`` on tiny checkpoints, the same requests
in both, f32 on the CPU.

Each case holds the batch's latents (``_latent_only``) to atol/rtol 1e-4,
its u8 images to PSNR > 40 dB and its infotexts equal: seeded and seedless
requests with prompt editing in one of them, a shared ``<lora:...>`` tag,
img2img with a latent mask, the hires fix and the SDXL refiner ensemble.
Then each row of a batch against the port's own batch-1 ``generate`` of
the same request, the previews (a frame a chunk, the decoded image last),
``Aborted`` from a step callback, and the batch's refusals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import (TINY_MODEL_TYPE_REFINER, TINY_MODEL_TYPE_XL,
                     patch_tiny_model_types, write_checkpoint_refiner,
                     write_checkpoint_sdxl, write_tiny_checkpoint)
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T

REQUESTS = [{"prompt": "a cat on a sofa", "nprompt": "blurry", "seed": 5},
            {"prompt": "a [dog:bird:1] in the snow"},
            {"prompt": "a (red:1.2) fox", "nprompt": "", "seed": 9}]
OPTS = [("image-dim", 64), ("steps", 3), ("seed", 3), ("cfg-scale", 7.0),
        ("method", "euler"), ("weight-type", "f32")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr_u8(a, b) -> float:
    a = np.round(np.asarray(a, np.float64) * 255.0)
    b = np.round(np.asarray(b, np.float64) * 255.0)
    mse = np.mean((a - b) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.fixture
def sd1(tmp_path, monkeypatch):
    write_tiny_checkpoint(tmp_path / "tiny.safetensors")
    T.write_random_lora(tmp_path / "style.safetensors", T.TINY_MODEL_TYPE,
                        T.lora_attention_targets(T.TINY_MODEL_TYPE), rank=4,
                        seed=2, alpha=8.0, dtype=np.float32)
    patch_tiny_model_types(monkeypatch)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    return str(tmp_path / "tiny.safetensors"), str(tmp_path)


def _session(cls, ckpt, extra=()):
    s = cls() if cls is JaxSession else cls(device="cpu")
    s.option_set("model", ckpt)
    for k, *v in OPTS + list(extra):
        s.option_set(k, *v)
    if cls is JaxSession:
        s._dtype = jnp.float32
    return s


def _both(ckpt, requests, extra=(), **kw):
    """(latents, images, infotexts) of ``requests`` through each session:
    a latent-only batch, then the same batch decoded."""
    out = []
    for cls in (JaxSession, torch_api.MLImgSynth):
        s = _session(cls, ckpt, extra)
        lat, _ = s.generate_batch(requests, _latent_only=True, **kw)
        img, info = s.generate_batch(requests, **kw)
        out.append((np.asarray(lat), np.asarray(img), info))
    return out


def _assert_match(j, t, shape):
    (lat_j, img_j, info_j), (lat_t, img_t, info_t) = j, t
    assert img_t.shape == shape and lat_t.shape == lat_j.shape
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-4, rtol=1e-4)
    for i in range(shape[0]):
        assert _psnr_u8(img_t[i], img_j[i]) > 40.0
    assert info_t == info_j


@pytest.mark.parametrize("case", ["seeds_editing", "lora_tag"])
def test_batch_matches_jax(sd1, case):
    """Seeded and seedless requests (seed + index), one with prompt
    editing over the shared bank; or every request with the same LoRA
    tag."""
    ckpt, lora_dir = sd1
    reqs, extra = REQUESTS, []
    if case == "lora_tag":
        reqs = [{**r, "prompt": r["prompt"] + " <lora:style:0.8>"}
                for r in REQUESTS[::2]]
        extra = [("lora-dir", lora_dir)]
    j, t = _both(ckpt, reqs, extra)
    _assert_match(j, t, (len(reqs), 3, 64, 64))
    if case == "seeds_editing":     # the seedless request: seed 3 + 1
        assert "\nSeed: 4," in t[2][1]


def test_img2img_inpaint_batch_matches_jax(sd1):
    """init_latents and a latent mask (1 keeps the left half) at f_t_ini
    0.6: two requests, one mask each."""
    ckpt, _ = sd1
    rng = np.random.default_rng(4)
    lat0 = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    lmask = np.zeros((2, 1, 8, 8), np.float32)
    lmask[:, :, :, :4] = 1.0
    j, t = _both(ckpt, REQUESTS[::2], [("f-t-ini", 0.6)],
                 init_latents=lat0, init_lmask=lmask)
    _assert_match(j, t, (2, 3, 64, 64))
    assert "Mode: inpaint, f_t_ini: 0.6" in t[2][0]
    np.testing.assert_array_equal(t[0][:, :, :, :4], lat0[:, :, :, :4])


def test_hires_batch_matches_jax(sd1):
    """The hires fix on a batch: 64 -> 128 by the latent, 2 steps at
    strength 0.7."""
    ckpt, _ = sd1
    extra = [("hires-fix", 1.5), ("hires-steps", 3), ("hires-denoise", 0.7)]
    out = []
    for cls in (JaxSession, torch_api.MLImgSynth):
        s = _session(cls, ckpt, extra)
        img, info = s.generate_batch(REQUESTS[:2])
        out.append((np.asarray(img), info))
        assert s.c["width"] == 64 and s.c["steps"] == 3
    (img_j, info_j), (img_t, info_t) = out
    assert img_t.shape == (2, 3, 128, 128)
    for i in range(2):
        assert _psnr_u8(img_t[i], img_j[i]) > 40.0
    assert info_t == info_j and "Hires upscale: 1.5" in info_t[0]


def test_refiner_batch_matches_jax(tmp_path, monkeypatch):
    """A tiny SDXL base stopping at switch 0.6 and the tiny refiner
    going on from its latents without new noise, on a batch of two."""
    write_checkpoint_sdxl(tmp_path / "base.safetensors")
    write_checkpoint_refiner(tmp_path / "refiner.safetensors")
    patch_tiny_model_types(monkeypatch, {
        "sdxl": TINY_MODEL_TYPE_XL, "sdxl_refiner": TINY_MODEL_TYPE_REFINER})
    monkeypatch.setattr(torch_api, "_model_types", lambda: {
        "sdxl": T.TINY_MODEL_TYPE_XL,
        "sdxl_refiner": T.TINY_MODEL_TYPE_REFINER})
    extra = [("model-type", "sdxl"), ("steps", 5),
             ("refiner", str(tmp_path / "refiner.safetensors")),
             ("refiner-switch", 0.6)]
    out = []
    for cls in (JaxSession, torch_api.MLImgSynth):
        s = _session(cls, str(tmp_path / "base.safetensors"), extra)
        img, info = s.generate_batch(REQUESTS[::2])
        out.append((np.asarray(img), info))
    (img_j, info_j), (img_t, info_t) = out
    assert img_t.shape == (2, 3, 64, 64)
    for i in range(2):
        assert _psnr_u8(img_t[i], img_j[i]) > 40.0
    assert info_t == info_j and "Refiner switch: 0.6" in info_t[0]


def test_rows_match_batch1_generate(sd1):
    """Each row of a merged batch is the request served alone through
    ``generate`` (its seed, prompts and the session's options)."""
    ckpt, _ = sd1
    s = _session(torch_api.MLImgSynth, ckpt)
    lat, _ = s.generate_batch(REQUESTS, _latent_only=True)
    imgs, infos = s.generate_batch(REQUESTS)
    for i, r in enumerate(REQUESTS):
        s.option_set("seed", r.get("seed", 3 + i))
        s.option_set("prompt", r["prompt"])
        s.option_set("nprompt", r.get("nprompt", ""))
        img = s.generate()
        np.testing.assert_allclose(s.tensors["latent"][0], lat[i],
                                   atol=1e-5, rtol=1e-5)
        assert _psnr_u8(img[0], imgs[i]) > 40.0
        assert s.infotext == infos[i]


def test_previews_and_abort(sd1, monkeypatch):
    """With ``preview_chunk`` 2 over 3 steps: a latent-resolution frame
    after step 2, then the decoded images; a step callback asked after
    each chunk; a true answer before the last step raises ``Aborted`` and
    one on the last step does not."""
    ckpt, _ = sd1
    monkeypatch.setenv("MLIS_PROGRESS_CHUNK", "1")
    s = _session(torch_api.MLImgSynth, ckpt)
    frames, asked = [], []
    imgs, _ = s.generate_batch(
        REQUESTS[:2], step_callback=lambda i, n: asked.append(i) or i == n,
        preview_callback=lambda i, n, f: frames.append((i, n, f.copy())),
        preview_chunk=2)
    assert [(i, n, f.shape) for i, n, f in frames] == [
        (2, 3, (2, 8, 8, 3)), (3, 3, (2, 64, 64, 3))]
    assert asked == [2, 3]
    np.testing.assert_array_equal(
        frames[1][2], np.round(imgs * 255).astype(np.uint8).transpose(
            0, 2, 3, 1))
    with pytest.raises(torch_api.Aborted):
        s.generate_batch(REQUESTS[:2], step_callback=lambda i, n: True)
    asked.clear()
    s.generate_batch(REQUESTS[:1], step_callback=lambda i, n: asked.append(i))
    assert asked == [1, 2, 3]


@pytest.mark.parametrize("case", ["mixed_tags", "negative_tag",
                                  "mask_without_image", "latent_rows"])
def test_batch_refusals(sd1, case):
    ckpt, lora_dir = sd1
    s = _session(torch_api.MLImgSynth, ckpt, [("lora-dir", lora_dir)])
    kw, reqs = {}, REQUESTS[:2]
    if case == "mixed_tags":
        reqs = [{"prompt": "a <lora:style:0.5>"}, {"prompt": "a"}]
    elif case == "negative_tag":
        reqs = [{"prompt": "a", "nprompt": "<lora:style:0.5>"}]
    elif case == "mask_without_image":
        kw = {"init_lmask": np.ones((2, 1, 8, 8), np.float32)}
    else:
        kw = {"init_latents": np.zeros((1, 4, 8, 8), np.float32)}
    with pytest.raises(torch_api.MlisError):
        s.generate_batch(reqs, **kw)
