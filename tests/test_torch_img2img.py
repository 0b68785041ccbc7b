"""img2img, alpha-mask inpainting and LoRA: the port against the JAX package
on tiny SD1 checkpoints.

The VAE encoder's moments and latent sample against ``vae_encode_apply``
and ``latent_sample`` (SD1 and SD3 VAEs); whole sessions against the JAX
session from the same checkpoint, image, mask, LoRA file and seed:
img2img at ``f_t_ini`` 0.6 (batch 1 and 2), inpainting from an RGBA image,
and a LoRA given by option and by prompt tag, in f32 and in q8_0 (the merge
comes before quantization in both packages); then the LoRA list's changes
against fresh loads.  Tolerances as the txt2img legs
(tests/test_torch_e2e.py): per-step latents atol/rtol 1e-4, the final u8
image PSNR > 40 dB, moments 1e-4.
"""
import jax
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
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.models import vae as tvae
from torch_jax_memo import jax_spec_memo  # noqa: F401

PROMPT = "a (cat:1.3) riding a [bicycle]"
NPROMPT = "blurry, low quality"
OPTS = [("model-type", "sd1"), ("image-dim", 64), ("steps", 5),
        ("seed", 42), ("cfg-scale", 7.0), ("method", "euler"),
        ("prompt", PROMPT), ("nprompt", NPROMPT)]


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


def _rgba(seed=0, h=64, w=64):
    """A seeded random RGBA image: smooth colour ramps plus noise, its top
    half opaque (kept), its bottom half transparent (repainted)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 4, y * 4, (x + y) * 2], axis=-1) % 256
    rgb = (rgb + rng.integers(0, 40, rgb.shape)) % 256
    alpha = np.where(y < h // 2, 255, 0)[:, :, None]
    return np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)


@pytest.mark.parametrize("which", ["sd1", "sd3"])
def test_vae_encoder_matches_jax(which):
    """``VaeEncoder`` (the asymmetric-pad downsample, the mid-block
    attention, the SD1 ``quant_conv`` or none for SD3) against
    ``vae_encode_apply`` on random parameters, then ``latent_mean`` and
    ``latent_sample`` (logvar clamped, the shift subtracted) against the
    JAX functions on the same moments and noise."""
    P = TINY_VAE if which == "sd1" else T.TINY_VAE_SD3
    spec = JB.trace_spec(lambda c, x: jvae.vae_encode_apply(c, x, P),
                         jnp.zeros((1, 64, 48, 3)))
    assert ("vae.quant_conv.weight" in spec) == (which == "sd1")
    rng = np.random.default_rng(4)
    params = {k: (rng.standard_normal(ps.shape).astype(np.float32)
                  * np.float32(0.1 if ps.kind == JB.VEC else
                               float(np.prod(ps.shape[:-1])) ** -0.5))
              for k, ps in spec.items()}
    img = rng.uniform(-1, 1, (2, 64, 48, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jvae.vae_encode_apply(
        JB.Ctx(p, dtype=jnp.float32), x, P))(params, img))
    with torch.device("meta"):
        model = tvae.VaeEncoder(P)
    model = tweights.load_module(model, "vae.",
                                 tweights.params_from_jax(params)).eval()
    with torch.no_grad():
        mom = model(torch.from_numpy(np.ascontiguousarray(
            img.transpose(0, 3, 1, 2))))
    assert mom.shape == (2, 2 * P.ch_z, 8, 6)
    np.testing.assert_allclose(mom.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-4, rtol=1e-4)
    rand = rng.standard_normal((2, P.ch_z, 8, 6)).astype(np.float32)
    mom_j = want.copy()
    mom_j[..., P.ch_z:] *= 20.0          # reach both logvar clamps
    mom_t = torch.from_numpy(np.ascontiguousarray(mom_j.transpose(0, 3, 1,
                                                                  2)))
    got = tvae.latent_sample(mom_t, torch.from_numpy(rand), P).numpy()
    ref = np.asarray(jvae.latent_sample(jnp.asarray(mom_j), jnp.asarray(
        rand.transpose(0, 2, 3, 1)), P)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tvae.latent_mean(mom_t, P).numpy(),
        np.asarray(jvae.latent_mean(jnp.asarray(mom_j), P)).transpose(
            0, 3, 1, 2), atol=1e-6, rtol=1e-6)


@pytest.fixture
def tiny_ckpt(tmp_path, monkeypatch):
    path = tmp_path / "tiny.safetensors"
    write_tiny_checkpoint(path)
    patch_tiny_model_types(monkeypatch)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    return str(path)


def _run(session, ckpt, extra, weight_type="f32"):
    """One request: (per-step latents, image, the encoded latent)."""
    traj, enc = [], []
    session.option_set("model", ckpt)
    for k, *v in OPTS + [("weight-type", weight_type)] + extra:
        session.option_set(k, *v)
    if isinstance(session, JaxSession):
        session._dtype = jnp.float32   # a quantized type sets bf16
    encode = session.image_encode
    session.image_encode = lambda img, *a: enc.append(encode(img, *a)) \
        or enc[-1]
    session.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    img = np.asarray(session.generate(), np.float32)
    return traj, img, (np.asarray(enc[0]) if enc else None)


def _assert_same(jres, tres, n_step):
    (traj_j, img_j, enc_j), (traj_t, img_t, enc_t) = jres, tres
    if enc_j is not None:
        np.testing.assert_allclose(enc_t, enc_j, atol=1e-4, rtol=1e-4)
    assert len(traj_j) == len(traj_t) == n_step
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert img_t.shape == img_j.shape
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


@pytest.mark.parametrize("batch", [1, 2])
def test_img2img_matches_jax(tiny_ckpt, batch):
    """An RGB image at ``f_t_ini`` 0.6: the encode's noise moves the Philox
    offset before the plan draws, the schedule keeps 3 of 5 steps, the
    image repeats to the batch; the infotext says so."""
    img = _rgba(1)[:, :, :3]
    extra = [("image", img), ("f-t-ini", 0.6), ("batch-size", batch)]
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    jres, tres = _run(js, tiny_ckpt, extra), _run(ts, tiny_ckpt, extra)
    assert tres[2].shape == (batch, 4, 8, 8)
    _assert_same(jres, tres, 3)
    assert ts.infotext == js.infotext
    assert "Mode: img2img, f_t_ini: 0.6, Steps: 3" in ts.infotext
    # one-shot: the next request is txt2img at full length
    assert ts.c["tuflags"] == 0 and ts.c["f_t_ini"] == 1.0


def test_inpaint_matches_jax(tiny_ckpt):
    """An RGBA image: its alpha is the mask (1 = KEEP), block-mean
    downsized; the kept half of the final latent is the encoded latent,
    exactly, in both packages."""
    extra = [("image", _rgba(2)), ("f-t-ini", 0.8)]
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    jres, tres = _run(js, tiny_ckpt, extra), _run(ts, tiny_ckpt, extra)
    _assert_same(jres, tres, 4)
    assert "Mode: inpaint, f_t_ini: 0.8" in ts.infotext
    np.testing.assert_array_equal(ts.tensors["lmask"][0, 0, :4], 1.0)
    np.testing.assert_array_equal(ts.tensors["lmask"][0, 0, 4:], 0.0)
    final, enc = ts.tensors["latent"], tres[2]
    np.testing.assert_array_equal(final[:, :, :4], enc[:, :, :4])
    assert np.abs(final[:, :, 4:] - enc[:, :, 4:]).max() > 0.1


def test_image_mask_option_and_tensor_flags(tiny_ckpt):
    """``image_mask`` (one channel) with an RGB image equals the RGBA
    image's alpha; a mask of two channels is refused with ``E_IMAGE``."""
    rgba = _rgba(3)
    mask = rgba[None, None, :, :, 3].astype(np.float32) / 255.0
    a = _run(torch_api.MLImgSynth(device="cpu"), tiny_ckpt,
             [("image", rgba), ("f-t-ini", 0.7)])
    b = _run(torch_api.MLImgSynth(device="cpu"), tiny_ckpt,
             [("image", rgba[:, :, :3]), ("image-mask", mask),
              ("f-t-ini", 0.7)])
    np.testing.assert_array_equal(a[1], b[1])
    s = torch_api.MLImgSynth(device="cpu")
    with pytest.raises(torch_api.MlisError) as e:
        s.option_set("image_mask", np.zeros((1, 2, 8, 8), np.float32))
    assert e.value.code == torch_api.MlisError.E_IMAGE
    with pytest.raises(torch_api.MlisError) as e:
        s.option_set_str("image", "in.png")
    assert e.value.code == torch_api.MlisError.E_OPT_VALUE


# The quantizing geometry (input widths 128 and 256) in the JAX package's
# parameter classes
J_TINY_Q = jax_api.ModelTypeDef(
    "sd1", jclip.ClipParams(**vars(T.TINY_Q_CLIP)), None,
    junet.UnetParams(**vars(T.TINY_Q_UNET)), TINY_VAE, 64, 1)


def _write_q_ckpt(path):
    """A checkpoint of the quantizing geometry from the JAX package's
    parameter specs."""
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
    save_file(spec_to_checkpoint_arrays(spec, seed=7), str(path))


@pytest.mark.parametrize("how", ["option", "tag"])
@pytest.mark.parametrize("weight_type", ["f32", "q8_0"])
def test_lora_matches_jax(tmp_path, monkeypatch, how, weight_type):
    """A rank-4 LoRA on every UNet attention projection and CLIP's MLP
    (kohya names, written by ``testing.write_random_lora``; alpha 16, so
    scale 4) at 0.8, by the
    ``lora`` option or a ``<lora:NAME:0.8>`` tag: the same merged weights
    in both packages (the q8_0 ones quantized after the merge), and a
    request that differs from the LoRA-free one."""
    if weight_type == "f32":
        ckpt, mt = tmp_path / "tiny.safetensors", T.TINY_MODEL_TYPE
        write_tiny_checkpoint(ckpt)
        patch_tiny_model_types(monkeypatch)
    else:
        ckpt, mt = tmp_path / "tiny-q.safetensors", T.TINY_Q_MODEL_TYPE
        _write_q_ckpt(ckpt)
        patch_tiny_model_types(monkeypatch, {"sd1": J_TINY_Q})
    monkeypatch.setattr(torch_api, "_model_types", lambda: {"sd1": mt})
    lora = tmp_path / "style.safetensors"
    targets = T.lora_attention_targets(mt)
    T.write_random_lora(lora, mt, targets, rank=4, seed=1, alpha=16.0,
                        dtype=np.float32)
    extra = ([("lora", str(lora), 0.8)] if how == "option" else
             [("lora-dir", str(tmp_path)),
              ("prompt", PROMPT + " <lora:style:0.8>")])
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    jres = _run(js, str(ckpt), extra, weight_type)
    tres = _run(ts, str(ckpt), extra, weight_type)
    _assert_same(jres, tres, 5)
    assert ts._lora_prefixes == {"unet.", "clip.text."}
    assert ts.loras == ([] if how == "tag" else [(str(lora), 0.8, False)])
    plain = _run(torch_api.MLImgSynth(device="cpu"), str(ckpt), [],
                 weight_type)
    # the LoRA moves the result past the tolerance (3.3e-3 at |x| 32)
    assert np.abs(plain[0][-1] - tres[0][-1]).max() > 5e-3


def _state(session):
    return {p + k: v.clone() for p, m in session._models.items()
            for k, v in m.state_dict().items()}


def test_lora_changes_reload_like_a_fresh_load(tmp_path, monkeypatch):
    """After each change of the LoRA list (one added, a second added, the
    first's multiplier changed through a tag, cleared, a tag LoRA on one
    request and the next plain request) the session's weights equal, bit
    for bit, those of a fresh session loaded with that list; and only the
    modules the old or new list patches reload (the VAE stays)."""
    ckpt = tmp_path / "tiny.safetensors"
    write_tiny_checkpoint(ckpt)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    mt = T.TINY_MODEL_TYPE
    a, b = tmp_path / "a.safetensors", tmp_path / "b.safetensors"
    T.write_random_lora(a, mt, [n for n in T.lora_attention_targets(mt)
                                if n.startswith("unet.")], seed=1)
    T.write_random_lora(b, mt, T.lora_attention_targets(mt)[-4:], seed=2)

    def session(loras):
        s = torch_api.MLImgSynth(device="cpu")
        for k, v in [("model", str(ckpt)), ("image-dim", 64),
                     ("lora-dir", str(tmp_path))]:
            s.option_set(k, v)
        for path, mult in loras:
            s.option_set("lora", path, mult)
        s.setup()
        return s

    s = session([])
    vae = s._models["vae."]
    steps = [
        (lambda: s.option_set("lora", str(a), 0.5), [(str(a), 0.5)]),
        (lambda: s.option_set("lora", str(b)), [(str(a), 0.5), (str(b), 1)]),
        (lambda: s.option_set("lora-clear", ""), []),
        (lambda: s.option_set("prompt", "x <lora:b:0.7>"), [(str(b), 0.7)]),
    ]
    for change, loras in steps:
        change()
        s.setup()
        got, want = _state(s), _state(session(loras))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert s._models["vae."] is vae
    # the tag lasts one request; the next plain one reloads without it
    s.option_set("steps", 1)
    s.generate()
    assert s.loras == []
    s.option_set("prompt", "x")
    s.setup()
    for k, v in _state(session([])).items():
        assert torch.equal(_state(s)[k], v), k


def test_lora_errors(tmp_path, tiny_ckpt):
    """A missing LoRA file gives ``E_FILE_NOT_FOUND`` (option and tag); a
    merge that is not finite gives ``E_NAN``."""
    s = torch_api.MLImgSynth(device="cpu")
    for k, v in (("lora", str(tmp_path / "missing.safetensors")),
                 ("prompt", "a <lora:missing:1>")):
        with pytest.raises(torch_api.MlisError) as e:
            s.option_set(k, v)
        assert e.value.code == torch_api.MlisError.E_FILE_NOT_FOUND
    bad = tmp_path / "bad.safetensors"
    T.write_random_lora(bad, T.TINY_MODEL_TYPE,
                        ["unet.mid.1.transf.0.attn1.q_proj.weight"],
                        alpha=float("inf"), dtype=np.float32)
    for k, v in [("model", tiny_ckpt), ("lora", str(bad))]:
        s.option_set(k, v)
    with pytest.raises(torch_api.MlisError) as e:
        s.setup()
    assert e.value.code == torch_api.MlisError.E_NAN
