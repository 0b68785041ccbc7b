"""Port ``generate()`` against the JAX package's ``generate()`` on one tiny
checkpoint: per-step latents and the final image, with float weights and
with the quantized weight types q8_0 and q4_0.

Both sessions run in f32 on the CPU from the same checkpoint file, prompts
and seed.  Tolerances: per-step latents atol/rtol 1e-4 (summation order
differs between XLA:CPU and torch, and the JAX package folds the nearest
upsample into a 4x4 conv); the final u8 image PSNR > 40 dB.  Stat hashes are
not compared: their 8-character buckets straddle on differences far below
these tolerances.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from helpers import (TINY_VAE, patch_tiny_model_types,
                     spec_to_checkpoint_arrays, write_tiny_checkpoint)
from mlimgsynth_tpu import api as jax_api
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import clip as jclip
from mlimgsynth_tpu.models import unet as junet
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch.testing import (TINY_MODEL_TYPE, TINY_Q_CLIP,
                                      TINY_Q_MODEL_TYPE, TINY_Q_UNET)

PROMPT = "a (cat:1.3) riding a [bicycle]"
NPROMPT = "blurry, low quality"
OPTS = [("model-type", "sd1"), ("image-dim", 64), ("steps", 5),
        ("seed", 42), ("cfg-scale", 7.0), ("prompt", PROMPT),
        ("nprompt", NPROMPT)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores; torch's own
    thread pool would only contend with theirs (and the tensors here are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr_u8(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.fixture
def tiny_ckpt(tmp_path, monkeypatch):
    path = tmp_path / "tiny.safetensors"
    write_tiny_checkpoint(path)
    patch_tiny_model_types(monkeypatch)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": TINY_MODEL_TYPE})
    return str(path)


def _run(session, ckpt, method, sched, batch, weight_type="f32"):
    traj = []
    session.option_set("model", ckpt)
    for k, v in OPTS + [("method", method), ("scheduler", sched),
                        ("batch-size", batch), ("weight-type", weight_type)]:
        session.option_set(k, v)
    if isinstance(session, JaxSession):
        session._dtype = jnp.float32   # a quantized type sets bf16
    session.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    img = session.generate()
    return traj, np.asarray(img, np.float32)


@pytest.mark.parametrize("method,sched,batch", [("euler", "uniform", 1),
                                                ("dpmpp2m", "karras", 1),
                                                ("euler", "karras", 2)])
def test_generate_matches_jax(tiny_ckpt, method, sched, batch):
    traj_j, img_j = _run(JaxSession(), tiny_ckpt, method, sched, batch)
    traj_t, img_t = _run(torch_api.MLImgSynth(device="cpu"), tiny_ckpt,
                         method, sched, batch)
    assert len(traj_j) == len(traj_t) == 5
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert img_t.shape == img_j.shape == (batch, 3, 64, 64)
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


# The quantizing geometry (input widths 128 and 256) in the JAX package's
# parameter classes
J_TINY_Q = jax_api.ModelTypeDef(
    "sd1", jclip.ClipParams(**vars(TINY_Q_CLIP)), None,
    junet.UnetParams(**vars(TINY_Q_UNET)), TINY_VAE, 64, 1)


@pytest.fixture
def tiny_q_ckpt(tmp_path, monkeypatch):
    """A checkpoint of the quantizing geometry, written from the JAX
    package's parameter specs (its session also loads the VAE encoder)."""
    P = J_TINY_Q
    spec = JB.trace_spec(
        lambda ctx, toks: jclip.clip_text_apply(ctx, toks, P.clip_p),
        jnp.zeros((1, 77), jnp.int32))
    spec.update(JB.trace_spec(
        lambda ctx, x, t, c: junet.unet_apply(ctx, x, t, c, None, P.unet_p),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 128))))
    spec.update(JB.trace_spec(
        lambda ctx, x: jvae.vae_encode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(JB.trace_spec(
        lambda ctx, x: jvae.vae_decode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 8, 8, 4))))
    path = tmp_path / "tiny-q.safetensors"
    save_file(spec_to_checkpoint_arrays(spec, seed=7), str(path))
    patch_tiny_model_types(monkeypatch, {"sd1": J_TINY_Q})
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": TINY_Q_MODEL_TYPE})
    return str(path)


def _quantized_names(js, ts):
    """(JAX, port) sets of the weights stored quantized, port names."""
    jax_names = {k for sub in js._params.values() for k in sub
                 if k.endswith(("_q8", "_q4"))}
    port_names = {prefix + k for prefix, m in ts._models.items()
                  for k in m.state_dict() if k.endswith(("_q8", "_q4"))}
    return jax_names, port_names


@pytest.mark.parametrize("weight_type", ["q8_0", "q4_0"])
def test_quantized_generate_matches_jax(tiny_q_ckpt, weight_type):
    """Same tolerances as the float legs: both sessions quantize the same
    f32 weights bit for bit and run the dequantized products in f32."""
    js = JaxSession()
    traj_j, img_j = _run(js, tiny_q_ckpt, "euler", "uniform", 1,
                         weight_type)
    ts = torch_api.MLImgSynth(device="cpu")
    traj_t, img_t = _run(ts, tiny_q_ckpt, "euler", "uniform", 1,
                         weight_type)
    assert ts.qbits == (4 if weight_type == "q4_0" else 8)
    jax_names, port_names = _quantized_names(js, ts)
    assert port_names == jax_names and len(port_names) > 50
    assert len(traj_j) == len(traj_t) == 5
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


# prompts of two 77-token windows: 98 tokens, and a BREAK; each against a
# one-window negative prompt, whose uncond row the sessions pad to the cond
# row's window count
LONG_PROMPT = ", ".join(["a detailed photograph of a red fox in the snow"]
                        * 9)
MULTI_WINDOW = {"long": LONG_PROMPT,
                "break": "a (cat:1.3) on a hill BREAK a [bicycle] at dusk"}


@pytest.mark.parametrize("which", list(MULTI_WINDOW))
def test_multi_window_prompt_matches_jax(tiny_ckpt, which, monkeypatch):
    """A prompt of two windows against the JAX session's window rule
    (``_window_count``, ``_clip_encode_rows``): per-step latents 1e-4, image
    PSNR > 40 dB, and the conditioning of 2 x 77 rows."""
    monkeypatch.setattr(sys.modules[__name__], "OPTS",
                        OPTS[:-2] + [("prompt", MULTI_WINDOW[which]),
                                     ("nprompt", NPROMPT)])
    traj_j, img_j = _run(JaxSession(), tiny_ckpt, "euler", "uniform", 1)
    ts = torch_api.MLImgSynth(device="cpu")
    traj_t, img_t = _run(ts, tiny_ckpt, "euler", "uniform", 1)
    assert ts.tensors["cond"].shape == ts.tensors["ncond"].shape \
        == (1, 154, 32)
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


def test_session_keeps_weights_across_requests(tiny_ckpt):
    s = torch_api.MLImgSynth(device="cpu")
    s.option_set("model", tiny_ckpt)
    imgs = []
    for seed, prompt in ((42, "a cat"), (43, "a (dog:1.2) BREAK on a hill")):
        for k, v in OPTS:
            s.option_set(k, v)
        s.option_set("seed", seed)
        s.option_set("prompt", prompt)
        unet = s._models.get("unet.")
        imgs.append(s.generate())
        assert unet is None or s._models["unet."] is unet
    assert not np.array_equal(imgs[0], imgs[1])


@pytest.mark.parametrize("name,value", [
    ("tp", 2), ("weight-type", "q2_k"), ("dp", 2), ("sp", 2), ("pp", 2),
    ("weight-type", "q3_k"), ("weight-type", "iq4_nl"),
])
def test_unsupported_option_raises(name, value):
    """A weight type the port lacks raises at ``option_set``; a mesh
    option (tp, dp, sp, pp) raises at ``setup`` without a process group
    of that many ranks, naming the torchrun line (the JAX package's
    tests/test_parallel.py:180-185 without the devices)."""
    s = torch_api.MLImgSynth(device="cpu")
    with pytest.raises(torch_api.MlisError) as e:
        s.option_set(name, value)
        s.setup()
    if name in ("tp", "dp", "sp", "pp"):
        assert e.value.code == torch_api.MlisError.E_OPT_VALUE
        assert f"torchrun --nproc-per-node {value}" in str(e.value)


_NO_JAX = """
import sys
import numpy as np
from mlimgsynth_torch import api, testing
api._model_types = lambda: {"sd1": testing.TINY_MODEL_TYPE}
path = sys.argv[1]
testing.write_random_checkpoint(path, testing.TINY_MODEL_TYPE, seed=3,
                                dtype=np.float32)
s = api.MLImgSynth(device="cpu")
for k, v in [("model", path), ("model-type", "sd1"), ("image-dim", 64),
             ("steps", 2), ("seed", 1), ("prompt", "a cat")]:
    s.option_set(k, v)
img = s.generate()
assert img.shape == (1, 3, 64, 64) and np.isfinite(img).all()
from mlimgsynth_torch import cli
from mlimgsynth_torch.utils import image
assert cli.main(["generate", "-b", "cpu", "-m", path, "-d", "64", "-s", "2",
                 "-S", "1", "-p", "a cat", "-o", "cli.png", "-q"]) == 0
assert image.png_read("cli.png")[0].shape == (64, 64, 3)
rgba = np.random.default_rng(0).integers(0, 256, (64, 64, 4)).astype(
    np.uint8)
image.image_save("in.png", rgba)
testing.write_random_lora("style.safetensors", testing.TINY_MODEL_TYPE,
                          testing.lora_attention_targets(
                              testing.TINY_MODEL_TYPE))
assert cli.main(["generate", "-b", "cpu", "-m", path, "-d", "64", "-s", "2",
                 "-S", "1", "-p", "a cat <lora:style:0.5>", "-i", "in.png",
                 "--f-t-ini", "0.7", "-o", "i2i.png", "-q"]) == 0
assert "Mode: inpaint" in image.png_read("i2i.png")[1]["parameters"]
# the prompt layer: an embedding, prompt editing, SD3 with T5 context
rows = s._models["clip.text."].embed.token.weight.detach().numpy()
testing.write_embedding("likecat.safetensors",
                        {"emb_params": rows[s.text_tokenize("cat")]})
for k, v in [("embed-dir", "."), ("seed", 1), ("steps", 2),
             ("prompt", "a <emb:likecat> [photo:picture:1]")]:
    s.option_set(k, v)
assert np.isfinite(s.generate()).all() and s.tensors["cond"].shape[0] == 3
# the sampler and guidance options
for k, v in [("cfg-rescale", 0.7), ("subseed", 5), ("subseed-strength", 0.3),
             ("freeu", "1"), ("pag-scale", 2.0), ("tiling", 1),
             ("method", "lcm"), ("steps", 2), ("prompt", "a cat")]:
    s.option_set(k, v)
assert np.isfinite(s.generate()).all()
assert "FreeU: 1.5,1.6,0.9,0.2" in s.infotext, s.infotext
for k, v in [("pag-scale", 0.0), ("method", "euler"), ("deepcache", 2),
             ("steps", 3), ("prompt", "a cat")]:
    s.option_set(k, v)
assert np.isfinite(s.generate()).all() and "DeepCache: 2" in s.infotext
api._model_types = lambda: {"sd3": testing.TINY_MODEL_TYPE_SD3}
testing.write_random_checkpoint("sd3.st", testing.TINY_MODEL_TYPE_SD3,
                                seed=3, dtype=np.float32)
testing.write_random_t5("t5.st", testing.TINY_T5_SD3, dtype=np.float32)
testing.write_tokenizer_json("tok.json", testing.unigram_tokenizer_spec(
    testing.random_unigram_pieces(512), eos=True))
s = api.MLImgSynth(device="cpu")
for k, v in [("model", "sd3.st"), ("image-dim", 64), ("steps", 2),
             ("t5", "t5.st"), ("t5-tokenizer", "tok.json"),
             ("prompt", "a cat")]:
    s.option_set(k, v)
assert np.isfinite(s.generate()).all()
assert s.tensors["cond"].shape == (1, 154, 80)
assert s.tensors["cond"][:, 77:].any()
# the second-stage and control paths: mask blur and full-resolution
# inpainting, an inpaint-variant UNet, ControlNet, the hires fix (latent
# and image), the upscale command, the refiner alone and as a second stage
from mlimgsynth_torch.models import esrgan
api._model_types = lambda: {"sd1": testing.TINY_MODEL_TYPE}
testing.write_random_controlnet("cn.st", testing.TINY_MODEL_TYPE,
                                dtype=np.float32)
testing.write_random_esrgan("x2.pth", esrgan.EsrganParams(
    n_feat=8, n_block=1, growth=4, unshuffle=2), old_names=True)
image.image_save("hint.png", rgba[:, :, :3])
assert cli.main(["generate", "-b", "cpu", "-m", path, "-d", "64", "-s", "2",
                 "-S", "1", "-p", "a cat", "-i", "in.png", "--f-t-ini", "0.7",
                 "--mask-blur", "2", "--inpaint-full-res", "1",
                 "--inpaint-full-res-padding", "8", "--control-net", "cn.st",
                 "--control-image", "hint.png", "-o", "cn.png", "-q"]) == 0
assert "Inpaint area: only masked" in image.png_read("cn.png")[1][
    "parameters"]
assert cli.main(["generate", "-b", "cpu", "-m", path, "-d", "64", "-s", "2",
                 "-S", "1", "-p", "a cat", "--hires-fix", "1.5",
                 "--hires-upscaler", "esrgan", "--upscaler", "x2.pth",
                 "-o", "hr.png", "-q"]) == 0
assert image.png_read("hr.png")[0].shape == (128, 128, 3)
assert cli.main(["upscale", "-b", "cpu", "--upscaler", "x2.pth", "-i",
                 "in.png", "--upscale-tile", "16", "-o", "up.png",
                 "-q"]) == 0
assert image.png_read("up.png")[0].shape == (128, 128, 3)
inp = testing.inpaint_variant(testing.TINY_MODEL_TYPE)
testing.write_random_checkpoint("inp.st", inp, dtype=np.float32)
s = api.MLImgSynth(device="cpu")
for k, v in [("model", "inp.st"), ("model-type", "sd1"), ("image-dim", 64),
             ("steps", 2), ("image", rgba), ("f-t-ini", 0.8),
             ("hires-fix", 1.5), ("prompt", "a cat")]:
    s.option_set(k, v)
assert np.isfinite(s.generate()).all() and s._mt.unet_p.n_ch_in == 9
api._model_types = lambda: {"sdxl": testing.TINY_MODEL_TYPE_XL,
                            "sdxl_refiner": testing.TINY_MODEL_TYPE_REFINER}
testing.write_random_checkpoint("xl.st", testing.TINY_MODEL_TYPE_XL,
                                dtype=np.float32)
testing.write_random_checkpoint("rf.st", testing.TINY_MODEL_TYPE_REFINER,
                                dtype=np.float32)
s = api.MLImgSynth(device="cpu")
for k, v in [("model", "xl.st"), ("model-type", "sdxl"), ("image-dim", 64),
             ("steps", 4), ("refiner", "rf.st"), ("prompt", "a cat")]:
    s.option_set(k, v)
assert np.isfinite(s.generate()).all() and "Refiner: rf.st" in s.infotext
# the serving front ends: a merged batch through the port's server
from mlimgsynth_torch import capi, server, tstore_util
from mlimgsynth_torch.utils import tensorstat
srv = server.Server(s, merge_window_s=0.0)
p = srv.submit({"prompt": "a fox", "seed": 2, "batch_size": 2})
assert p.event.wait(600) and p.error is None, p.error
assert p.imgs.shape == (2, 3, 64, 64) and "Seed: 3" in p.infotexts[1]
assert tstore_util.main(["-i", "rf.st", "-o", "rf.txt", "checksum"]) == 0
assert tensorstat.stat_line(p.imgs, "img").startswith("img")
assert callable(capi.build_shim)
new = {"mlimgsynth_torch.tokenizer_json", "mlimgsynth_torch.models.t5",
       "mlimgsynth_torch.errors", "mlimgsynth_torch.models.controlnet",
       "mlimgsynth_torch.models.esrgan", "mlimgsynth_torch.server",
       "mlimgsynth_torch.capi", "mlimgsynth_torch.tstore_util",
       "mlimgsynth_torch.utils.tensorstat"}
assert new <= set(sys.modules), new - set(sys.modules)
tpu = {m for m in sys.modules
       if m.split(".")[0] in ("mlimgsynth_tpu", "PIL")}
assert not tpu, tpu
print("jax" in sys.modules)
"""


def test_port_generate_never_imports_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(tmp_path / "t.safetensors")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"


# option_set calls in the forms the CLI and the C ABI pass: empty strings
# (the reference's defaults, or no change) and integer method and
# scheduler values (indexes into METHOD_NAMES / SCHED_NAMES)
OPTION_CALLS = {
    "empty": [("steps", 12), ("cfg-scale", 5.0), ("method", "dpmpp2m"),
              ("scheduler", "karras"), ("seed", 42), ("image-dim", 64),
              ("batch-size", 2), ("steps", ""), ("cfg-scale", ""),
              ("method", ""), ("scheduler", ""), ("seed", ""),
              ("batch-size", "")],
    "integer": [("method", 4), ("scheduler", 2), ("method", 1),
                ("scheduler", 1), ("steps", "7"), ("cfg-scale", " 3.5 ")],
    "image_dim_empty": [("image-dim", 64, 96), ("image-dim", "", "")],
    "ancestral": [("method", "euler_a"), ("s-noise", "1"), ("clip-skip", 2),
                  ("method", "dpm++2s-a"), ("s-ancestral", " 0.5 "),
                  ("method", 6), ("tae", "taesd.safetensors")],
}


@pytest.mark.parametrize("calls", list(OPTION_CALLS),
                         ids=list(OPTION_CALLS))
def test_option_values_match_jax(calls):
    """The same option_set calls leave the port's session and the JAX
    session with the same ``c`` entries and the same seed."""
    jax_s, torch_s = JaxSession(), torch_api.MLImgSynth(device="cpu")
    for s in (jax_s, torch_s):
        s.rng.seed = 7
        for name, *args in OPTION_CALLS[calls]:
            s.option_set(name, *args)
    shared = sorted(set(jax_s.c) & set(torch_s.c) - {"model", "model_type"})
    assert {"steps", "cfg_scale", "method", "scheduler", "width",
            "n_batch"} <= set(shared)
    assert {k: torch_s.c[k] for k in shared} == {k: jax_s.c[k]
                                                 for k in shared}
    assert torch_s.rng.seed == jax_s.rng.seed
