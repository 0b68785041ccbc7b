"""The memory options against the JAX package: ``vae_tile`` (the VAE
decodes and encodes in overlapping tiles) and ``unet_split`` (stage-wise
weight residency) through whole tiny SD1 and SDXL sessions, an img2img
request under ``vae_tile`` (the tiled encode), and a tiny SDXL session
under ``weight-type q4_0`` with both options; then the port alone:
``unet_split`` on against off over two requests and a LoRA change, its
residency record, and the CLI's ``--vae-tile`` / ``--unet-split``.

Both packages run in f32 on the CPU from the same checkpoint file, image,
prompts and seed, at 256 x 192 (a 32 x 24 latent), where 64-px tiles give
four decode tiles (24 x 24 latent, the last clamped onto the others) and
four encode tiles (192 x 192 px).  Tolerances as the txt2img legs
(tests/test_torch_e2e.py, its q4_0 leg included): per-step latents
atol/rtol 1e-4; under ``vae_tile`` the image is the decoder's float
output in both sessions (``image_decode``), held at atol 1e-4, else the u8
image at PSNR > 40 dB.
"""
import numpy as np
import pytest
import torch

from helpers import patch_tiny_model_types, write_tiny_checkpoint
from mlimgsynth_tpu import testing as jtesting
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import cli as tcli
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.utils import image as timage
from test_torch_sdxl import J_TINY_Q_XL, _write_q_xl
from torch_jax_memo import jax_spec_memo  # noqa: F401

PROMPT = "a (cat:1.3) riding a [bicycle]"
NPROMPT = "blurry, low quality"
OPTS = [("image-dim", 256, 192), ("steps", 5), ("seed", 42),
        ("cfg-scale", 7.0), ("method", "euler"), ("scheduler", "uniform"),
        ("prompt", PROMPT), ("nprompt", NPROMPT)]
MEMORY = {"vae_tile": [("vae-tile", 64)], "unet_split": [("unet-split", 1)],
          "both": [("vae-tile", 64), ("unet-split", 1)]}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores (and the tensors are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr_u8(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """model -> (checkpoint, JAX model types, port model types)."""
    d = tmp_path_factory.mktemp("lowmem")
    sd1, xl, xl_q = (str(d / n) for n in ("sd1.safetensors",
                                          "xl.safetensors",
                                          "xl-q.safetensors"))
    write_tiny_checkpoint(sd1)
    jtesting.write_checkpoint_sdxl(xl, seed=5)
    _write_q_xl(xl_q)
    return {"sd1": (sd1, {"sd1": jtesting.TINY_MODEL_TYPE},
                    {"sd1": T.TINY_MODEL_TYPE}),
            "sdxl": (xl, {"sdxl": jtesting.TINY_MODEL_TYPE_XL},
                     {"sdxl": T.TINY_MODEL_TYPE_XL}),
            "sdxl_q": (xl_q, {"sdxl": J_TINY_Q_XL},
                       {"sdxl": T.TINY_Q_MODEL_TYPE_XL})}


def _run(session, ckpt, extra, weight_type="f32"):
    """One request: (per-step latents, image, the encoded latent)."""
    traj, enc = [], []
    session.option_set("model", ckpt)
    for k, *v in OPTS + [("weight-type", weight_type)] + extra:
        session.option_set(k, *v)
    if isinstance(session, JaxSession):
        session._dtype = np.float32    # a quantized type sets bf16
    encode = session.image_encode
    session.image_encode = lambda img, *a: enc.append(encode(img, *a)) \
        or enc[-1]
    session.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    img = np.asarray(session.generate(), np.float32)
    return traj, img, (np.asarray(enc[0]) if enc else None)


def _both(ckpts, model, extra, monkeypatch, weight_type="f32"):
    ckpt, j_types, t_types = ckpts[model]
    patch_tiny_model_types(monkeypatch, j_types)
    monkeypatch.setattr(torch_api, "_model_types", lambda: dict(t_types))
    ts = torch_api.MLImgSynth(device="cpu")
    return (_run(JaxSession(), ckpt, extra, weight_type),
            _run(ts, ckpt, extra, weight_type), ts)


def _assert_same(jres, tres, n_step, float_image):
    (traj_j, img_j, enc_j), (traj_t, img_t, enc_t) = jres, tres
    if enc_j is not None:
        np.testing.assert_allclose(enc_t, enc_j, atol=1e-4, rtol=1e-4)
    assert len(traj_j) == len(traj_t) == n_step
    assert traj_t[0].shape == (1, 4, 24, 32)
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert img_t.shape == img_j.shape == (1, 3, 192, 256)
    # under vae_tile both sessions give the float (x + 1) / 2, unclamped
    is_u8 = np.array_equal(np.round(img_t * 255) / 255, img_t)
    assert is_u8 != float_image
    if float_image:
        np.testing.assert_allclose(img_t, img_j, atol=1e-4, rtol=1e-4)
    else:
        psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
        assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


@pytest.mark.parametrize("model", ["sd1", "sdxl"])
@pytest.mark.parametrize("memory", ["vae_tile", "unet_split"])
def test_memory_option_matches_jax(ckpts, monkeypatch, model, memory):
    jres, tres, ts = _both(ckpts, model, MEMORY[memory], monkeypatch)
    _assert_same(jres, tres, 5, memory == "vae_tile")
    # under unet_split the denoiser and the text encoders are off the
    # device after the request; the VAE stays
    staged = {"unet.", "clip.text."} | ({"clip2.text."} if model == "sdxl"
                                        else set())
    assert ts.resident == ({"vae."} if memory == "unet_split"
                           else staged | {"vae."})


@pytest.mark.parametrize("model", ["sd1", "sdxl"])
def test_img2img_lowmem_matches_jax(ckpts, monkeypatch, model):
    """img2img at ``f_t_ini`` 0.6 with both options: the moments of the
    tiled encode, then the same ``latent_sample`` on the same Philox
    streams; 3 of 5 steps.  The VAE encoder and decoder stay on the
    device."""
    img = np.random.default_rng(4).integers(0, 256, (192, 256, 3)).astype(
        np.uint8)
    jres, tres, ts = _both(ckpts, model, MEMORY["both"] + [
        ("image", img), ("f-t-ini", 0.6)], monkeypatch)
    assert tres[2].shape == (1, 4, 24, 32)
    _assert_same(jres, tres, 3, True)
    assert ts.resident == {"vae."} and "vae." in ts._encoders


def test_sdxl_q4_0_lowmem_matches_jax(ckpts, monkeypatch):
    """The quantizing tiny SDXL under ``weight-type q4_0`` with both
    options (the low-memory configuration): both packages store the same
    linears in packed int4 and run the dequantized products in f32."""
    jres, tres, ts = _both(ckpts, "sdxl_q", MEMORY["both"], monkeypatch,
                           "q4_0")
    assert ts.qbits == 4
    port_names = {prefix + k for prefix, m in ts._models.items()
                  for k in m.state_dict() if k.endswith("_q4")}
    assert "unet.label_embed.0.weight_q4" in port_names
    assert any(n.startswith("clip2.") for n in port_names)
    _assert_same(jres, tres, 5, True)


@pytest.mark.parametrize("model", ["sdxl", "sd3"])
def test_unet_split_is_bit_exact_and_stages(tmp_path, monkeypatch, model):
    """``unet_split`` on against off, and turned on after a first request
    without it: two requests, the second after a LoRA is added, give equal
    latents and images bit for bit.  With the option on, the residency
    record shows the text encoders off the device during the loop and the
    denoiser (SDXL's UNet, SD3's MMDiT) off it after; each staged module
    then holds its host copy (after the LoRA change, the reloaded one) and
    the VAE stays."""
    mt = {"sdxl": T.TINY_MODEL_TYPE_XL, "sd3": T.TINY_MODEL_TYPE_SD3}[model]
    denoiser = "unet." if model == "sdxl" else "mmdit."
    monkeypatch.setattr(torch_api, "_model_types", lambda: {model: mt})
    ckpt, lora = str(tmp_path / "m.safetensors"), str(tmp_path / "l.st")
    T.write_random_checkpoint(ckpt, mt, seed=9, dtype=np.float32)
    T.write_random_lora(lora, mt, T.lora_attention_targets(
        mt, ("clip.text.", "clip2.text.")), rank=4, seed=3,
        dtype=np.float32)
    results = {}
    for mode in ("off", "on", "late"):
        s = torch_api.MLImgSynth(device="cpu")
        loop, after = [], []
        s.step_observer = lambda i, lat: loop.append(set(s.resident))
        s.option_set("callback", lambda sess, p: after.append(
            set(sess.resident)) if p["stage"] == torch_api.
            STAGE_IMAGE_DECODE else None)
        out = []
        for req in range(2):
            split = mode == "on" or (mode == "late" and req == 1)
            for k, v in [("model", ckpt), ("image-dim", 64), ("steps", 3),
                         ("seed", 42 + req), ("prompt", PROMPT),
                         ("nprompt", NPROMPT), ("unet-split", int(split))]:
                s.option_set(k, v)
            if req == 1:
                s.option_set("lora", lora, 0.8)
            s.setup()
            if split and mode == "on":   # setup moved nothing staged
                assert s.resident == {"vae."}
            loop.clear()
            after.clear()
            s.generate()
            out.append((s.tensors["latent"], s.tensors["image"]))
            staged = {denoiser, "clip.text.", "clip2.text."}
            if split:
                assert loop and all(r == {denoiser, "vae."} for r in loop)
                assert after == [{"vae."}] and s.resident == {"vae."}
                for prefix in staged:
                    host = s._host[prefix]
                    for k, t in s._models[prefix].state_dict().items():
                        assert t.data_ptr() == host[prefix + k].data_ptr()
                # a module loaded before the option was set and kept by
                # the LoRA change was on the device already
                name = denoiser[:-1]
                moves = {f"move_out_{name}_s", "move_in_clip2_s"}
                if mode == "on":
                    moves.add(f"move_in_{name}_s")
                assert moves <= set(s.times)
            else:
                assert all(r == staged | {"vae."} for r in loop)
                assert not s._host
        assert {"clip.text.", "clip2.text."} <= s._lora_prefixes <= staged
        if mode == "on":   # turned off again: every module back on
            s.option_set("unet-split", 0)
            s.setup()
            assert s.resident == staged | {"vae."} and not s._host
        results[mode] = out
    for mode in ("on", "late"):
        for a, b in zip(results["off"], results[mode]):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(results["off"][0][0], results["off"][1][0])


def test_cli_memory_flags_match_session(tmp_path, monkeypatch):
    """``--vae-tile 256 --unet-split 1`` through the CLI against a session
    with the same options: the PNG is the session's float image as the
    writer truncates it, the latent equal bit for bit.  At 448 x 384 the
    256-px tiles are 48 x 48 latent pixels, two of them."""
    mt = T.TINY_MODEL_TYPE
    monkeypatch.setattr(torch_api, "_model_types", lambda: {"sd1": mt})
    ckpt = str(tmp_path / "sd1.safetensors")
    T.write_random_checkpoint(ckpt, mt, seed=4, dtype=np.float32)
    png, lat = str(tmp_path / "out.png"), str(tmp_path / "out.tensor")
    args = ["-d", "448,384", "-s", "3", "-S", "7", "-p", PROMPT]
    assert tcli.main(["generate", "-b", "cpu", "-m", ckpt, *args,
                      "--vae-tile", "256", "--unet-split", "1", "-q",
                      "-o", png, "--olatent", lat]) == 0
    s = torch_api.MLImgSynth(device="cpu")
    for k, v in [("model", ckpt), ("image-dim", "448,384"), ("steps", 3),
                 ("seed", 7), ("prompt", PROMPT), ("vae-tile", 256),
                 ("unet-split", 1)]:
        s.option_set_str(k, str(v))
    img = s.generate()
    assert s.c["vae_tile"] == 256 and s.c["unet_split"]
    assert img.shape == (1, 3, 384, 448)
    pix, text = timage.png_read(png)
    np.testing.assert_array_equal(pix, timage.tensor_to_image_arr(img, 0))
    assert text["parameters"] == s.infotext
    np.testing.assert_array_equal(timage.tensor_load(lat),
                                  s.tensors["latent"])
    # the float image of the tiled decode, not the u8 one
    assert not np.array_equal(np.round(img * 255) / 255, img)
