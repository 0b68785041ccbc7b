"""The port's SDXL slice against the JAX package: the labeled UNet, the
size-label and conditioning rows, and whole tiny SDXL sessions (float
weights with an empty and with a non-empty negative prompt, and q8_0 under
``MLIS_Q8_MODE=int8``): per-step latents and the final image.

The float sessions read the JAX package's ``write_checkpoint_sdxl`` (CLIP-L
in the CompVis layout, bigG in the OpenCLIP layout with fused q/k/v, the
labeled UNet); the quantizing one a checkpoint of the same layout at widths
that quantize.  Both packages run in f32 on the CPU from the same file,
prompts and seed; one JAX session per checkpoint serves every case of this
file.  Tolerances as the SD1 and SD3 legs (tests/test_torch_e2e.py):
per-step latents atol/rtol 1e-4, final u8 image PSNR > 40 dB.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from mlimgsynth_tpu import api as jax_api
from mlimgsynth_tpu import testing as jtesting
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.io.tensorstore import TensorStore
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import clip as jclip
from mlimgsynth_tpu.models import unet as junet
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.models import blocks as tblocks
from mlimgsynth_torch.models import unet as tunet
from mlimgsynth_torch.ops import quant_matmul as qmm
from torch_jax_memo import jax_spec_memo  # noqa: F401

PROMPT = "a (cat:1.3) riding a [bicycle]"
NPROMPT = "blurry, low quality"
OPTS = [("image-dim", 64), ("steps", 5), ("seed", 42), ("cfg-scale", 7.0),
        ("method", "euler"), ("scheduler", "uniform"), ("prompt", PROMPT)]


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


# The quantizing geometry in the JAX package's parameter classes
J_TINY_Q_XL = jax_api.ModelTypeDef(
    "sdxl", jclip.ClipParams(**vars(T.TINY_Q_CLIP)),
    jclip.ClipParams(**vars(T.TINY_Q_CLIP2)),
    junet.UnetParams(**vars(T.TINY_Q_UNET_XL)), jtesting.TINY_VAE, 64, 2)


def _write_q_xl(path):
    """A checkpoint of the quantizing SDXL geometry in the layout of
    ``write_checkpoint_sdxl``, written from the JAX package's parameter
    specs (its session also loads the VAE encoder)."""
    P = J_TINY_Q_XL
    spec = JB.trace_spec(
        lambda ctx, toks: jclip.clip_text_apply(ctx, toks, P.clip_p),
        jnp.zeros((1, 77), jnp.int32))
    spec.update(JB.trace_spec(
        lambda ctx, toks: jclip.clip_text_apply(
            ctx, toks, P.clip2_p, feat_tok_idx=jnp.zeros((1,), jnp.int32),
            pre="clip2"), jnp.zeros((1, 77), jnp.int32)))
    spec.update(JB.trace_spec(
        lambda ctx, x, t, c, l: junet.unet_apply(ctx, x, t, c, l, P.unet_p),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, P.unet_p.n_ctx)),
        jnp.zeros((1, P.unet_p.ch_adm_in))))
    spec.update(JB.trace_spec(
        lambda ctx, x: jvae.vae_encode_apply(ctx, x, P.vae_p),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(JB.trace_spec(
        lambda ctx, x: jvae.vae_decode_apply(ctx, x, P.vae_p),
        jnp.zeros((1, 8, 8, 4))))
    arrays = jtesting.spec_to_openclip_arrays(spec, "clip2.", seed=7)
    arrays.update(jtesting.spec_to_checkpoint_arrays(
        {k: v for k, v in spec.items() if not k.startswith("clip2.")},
        seed=8))
    save_file(arrays, str(path))


class _Sessions:
    """One JAX session and one port session per checkpoint, each request
    run once (keyed by its options) and kept for every case."""

    def __init__(self, ckpt, j_types, t_types, weight_type):
        self.ckpt, self.weight_type = ckpt, weight_type
        self.j_types, self.t_types = j_types, t_types
        self.js = self.ts = None
        self.done = {}

    def run(self, key, extra, monkeypatch):
        """(JAX, port) results of the request ``OPTS + extra``: per-step
        latents, the image, and the session's conditioning tensors."""
        if key in self.done:
            return self.done[key]
        monkeypatch.setattr(jax_api, "_model_types", lambda: self.j_types)
        monkeypatch.setattr(torch_api, "_model_types", lambda: self.t_types)
        if self.js is None:
            self.js = JaxSession()
            self.ts = torch_api.MLImgSynth(device="cpu")
        out = []
        for s in (self.js, self.ts):
            traj = []
            s.option_set("model", self.ckpt)
            for k, v in OPTS + [("weight-type", self.weight_type)] + extra:
                s.option_set(k, v)
            if s is self.js:
                s._dtype = jnp.float32    # a quantized type sets bf16
            s.step_observer = lambda i, lat: traj.append(
                np.asarray(lat, np.float32).copy())
            img = np.asarray(s.generate(), np.float32)
            tens = {k: (None if s.tensors.get(k) is None
                        else np.asarray(s.tensors[k], np.float32))
                    for k in ("cond", "ncond", "label", "nlabel")}
            out.append((traj, img, tens))
        self.done[key] = out
        return out


@pytest.fixture(scope="module")
def xl(tmp_path_factory):
    path = tmp_path_factory.mktemp("xl") / "tiny-xl.safetensors"
    jtesting.write_checkpoint_sdxl(path, seed=5)
    return _Sessions(str(path), {"sdxl": jtesting.TINY_MODEL_TYPE_XL},
                     {"sdxl": T.TINY_MODEL_TYPE_XL}, "f32")


@pytest.fixture(scope="module")
def xl_q(tmp_path_factory):
    path = tmp_path_factory.mktemp("xlq") / "tiny-q-xl.safetensors"
    _write_q_xl(path)
    return _Sessions(str(path), {"sdxl": J_TINY_Q_XL},
                     {"sdxl": T.TINY_Q_MODEL_TYPE_XL}, "q8_0")


def _assert_same_run(jax_res, port_res, rel_l2=None):
    """Per-step latents at atol/rtol 1e-4 (or, given ``rel_l2``, each
    step's relative L2 below it) and the final image's PSNR > 40 dB."""
    (traj_j, img_j, _), (traj_t, img_t, _) = jax_res, port_res
    assert len(traj_j) == len(traj_t) == 5
    assert traj_t[0].shape == (1, 4, 8, 8)
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        if rel_l2 is None:
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {i} latent mismatch")
        else:
            rel = np.linalg.norm(b - a) / np.linalg.norm(a)
            assert rel < rel_l2, f"step {i} latent relative L2 {rel}"
    assert img_t.shape == img_j.shape == (1, 3, 64, 64)
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


@pytest.mark.parametrize("nprompt", ["", NPROMPT])
def test_sdxl_generate_matches_jax(xl, monkeypatch, nprompt):
    """An empty negative prompt conditions the uncond rows on zero context
    and keeps the empty prompt's label; a non-empty one encodes both."""
    j, t = xl.run(nprompt, [("nprompt", nprompt)], monkeypatch)
    assert xl.ts.c["model_type"] == "sdxl" and xl.ts.c["clip_skip"] == 2
    _assert_same_run(j, t)
    tens = t[2]
    assert tens["cond"].shape == (1, 77, 64)
    assert tens["label"].shape == (1, 32 + 1536)
    assert (not tens["ncond"].any()) == (nprompt == "")
    assert tens["nlabel"].any()


@pytest.mark.parametrize("nprompt", ["", NPROMPT])
def test_sdxl_cond_and_label_rows_match_jax(xl, monkeypatch, nprompt):
    """The (cond, label) rows of a request against the JAX session's
    ``_text_cond_encode_rows`` on the same prompts, and the size label
    against the JAX package's ``timestep_embedding`` of [h, w, 0, 0, h, w]:
    the label is bigG's pooled projected feature, then 6 x 256 size
    embeddings.  atol/rtol 1e-5: torch's and XLA:CPU's f32 exp, cos and sin
    differ by a few ulps, and at arguments up to 64 one ulp of a frequency
    moves the cosine by about 1e-5."""
    xl.run(nprompt, [("nprompt", nprompt)], monkeypatch)
    js, ts = xl.js, xl.ts
    pts = [js._parse_prompt_text(PROMPT), js._parse_prompt_text(nprompt)]
    cond, label = js._text_cond_encode_rows(pts, uncond_rows=1)
    ts._prompt_set("prompt", PROMPT)
    ts._prompt_set("nprompt", nprompt)
    with torch.no_grad():
        tcond, tlabel = ts._text_cond([ts.prompt, ts.nprompt])
    np.testing.assert_allclose(tcond.numpy(), cond, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tlabel.numpy(), label, atol=1e-5, rtol=1e-5)
    sizes = np.array([64, 64, 0, 0, 64, 64], np.float32)
    want = np.asarray(JB.timestep_embedding(jnp.asarray(sizes), 256))
    got = tblocks.timestep_embedding(torch.from_numpy(sizes), 256).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tlabel.numpy()[:, 32:],
                                  np.tile(got.reshape(1, -1), (2, 1)))


LONG_PROMPT = ", ".join(["a detailed photograph of a red fox in the snow"]
                        * 9) + " BREAK a (cat:1.3) riding a [bicycle]"


def test_sdxl_multi_window_prompt_matches_jax(xl, monkeypatch):
    """A prompt of three windows (98 tokens, then a BREAK) against a
    one-window negative prompt: both towers encode every window, bigG's
    pooled feature is read from window 0, and the uncond rows are padded
    to the cond rows' windows."""
    j, t = xl.run("long", [("prompt", LONG_PROMPT), ("nprompt", NPROMPT)],
                  monkeypatch)
    _assert_same_run(j, t)
    tens = t[2]
    assert tens["cond"].shape == tens["ncond"].shape == (1, 3 * 77, 64)
    for k in ("cond", "ncond", "label", "nlabel"):
        np.testing.assert_allclose(tens[k], j[2][k], atol=1e-4, rtol=1e-4)


def test_sdxl_img2img_lora_matches_jax(xl, monkeypatch, tmp_path):
    """img2img at ``f_t_ini`` 0.6 with a LoRA (kohya ``lora_te1_`` /
    ``lora_te2_`` / ``lora_unet_`` names) on both text towers' MLPs, bigG's
    fused q and v thirds and every UNet attention projection."""
    mt = T.TINY_MODEL_TYPE_XL
    targets = T.lora_attention_targets(mt, ("clip.text.", "clip2.text."))
    targets += [f"clip2.text.encoder.layers.{i}.attn.{w}_proj.weight"
                for i in (0, 1) for w in "qv"]
    lora = tmp_path / "xl-style.safetensors"
    T.write_random_lora(lora, mt, targets, rank=4, seed=3, alpha=16.0,
                        dtype=np.float32)
    img = np.random.default_rng(4).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    try:
        j, t = xl.run("i2i-lora", [("nprompt", NPROMPT), ("image", img),
                                   ("f-t-ini", 0.6), ("lora", str(lora))],
                      monkeypatch)
        assert xl.ts._lora_prefixes == {"unet.", "clip.text.",
                                        "clip2.text."}
    finally:
        for s in (xl.js, xl.ts):
            s.option_set("lora-clear", "")
    (traj_j, img_j, _), (traj_t, img_t, _) = j, t
    assert len(traj_j) == len(traj_t) == 3
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"
    for k in ("cond", "ncond", "label", "nlabel"):
        np.testing.assert_allclose(t[2][k], j[2][k], atol=1e-4, rtol=1e-4)


def test_sdxl_q8_int8_mode_matches_jax(xl_q, monkeypatch):
    """The quantizing tiny SDXL at q8_0 with ``MLIS_Q8_MODE=int8`` in both
    packages: every quantized product quantizes its activations per (row,
    128-deep block) and runs the K8 twin (``q8_matmul_int8_xla`` in the JAX
    package).

    Tolerance: per-step latents within a relative L2 of 1e-3, not
    elementwise 1e-4.  Given the same input the two twins agree bit for bit
    (tests/test_torch_int8.py), but the mode is not continuous: an f32
    difference of one ulp upstream (torch's and XLA:CPU's layer norm or
    GELU) can move one activation across a rounding boundary of its
    quantization, a step of amax / 127.  Here one such step in CLIP moves
    the prompt's context rows by 3e-4 and the latents, after CFG, by up to
    5.5e-3 of values up to 37: 1.2e-4 in relative L2 at every step, and
    the final image agrees at 89 dB.  A wrong block scale, rounding or
    fold moves every product by the quantization's own order (a
    percent)."""
    monkeypatch.setenv("MLIS_Q8_MODE", "int8")
    ran = []
    orig = qmm.quant.q8_matmul_int8_plain
    monkeypatch.setattr(qmm.quant, "q8_matmul_int8_plain",
                        lambda *a: (ran.append(a[0].shape), orig(*a))[1])
    j, t = xl_q.run("int8", [("nprompt", NPROMPT)], monkeypatch)
    assert xl_q.ts.qbits == 8
    # both packages store the same linears quantized (both towers, the
    # UNet's, the label embedding among them)
    jax_names = {k for sub in xl_q.js._params.values() for k in sub
                 if k.endswith("_q8")}
    port_names = {prefix + k for prefix, m in xl_q.ts._models.items()
                  for k in m.state_dict() if k.endswith("_q8")}
    assert port_names == jax_names
    assert "unet.label_embed.0.weight_q8" in port_names
    assert any(n.startswith("clip2.") for n in port_names)
    _assert_same_run(j, t, rel_l2=1e-3)
    # the text towers' products once, then 5 steps of the UNet's
    assert len(ran) > 5 * 40 and any(s[-2:] == (2, 1664) for s in ran)
    assert set(qmm.LAUNCHES.values()) <= {0}


def test_unet_xl_denoise_matches_jax():
    """The labeled UNet (``label_embed`` added to the time embedding)
    against ``unet.denoise`` at TINY_UNET_XL, f32."""
    P = T.TINY_UNET_XL
    JP = jtesting.TINY_UNET_XL
    assert vars(P).items() <= vars(JP).items()
    spec = JB.trace_spec(
        lambda c, x, t, k, l: junet.unet_apply(c, x, t, k, l, JP),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, P.n_ctx)), jnp.zeros((1, P.ch_adm_in)))
    assert "unet.label_embed.0.weight" in spec
    rng = np.random.default_rng(3)
    params = {k: (rng.standard_normal(ps.shape).astype(np.float32)
                  * np.float32(0.1 if ps.kind == JB.VEC else
                               float(np.prod(ps.shape[:-1])) ** -0.5))
              for k, ps in spec.items()}
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32) * 3.0
    cond = rng.standard_normal((2, 77, P.n_ctx)).astype(np.float32)
    label = rng.standard_normal((2, P.ch_adm_in)).astype(np.float32)
    sigma, t = np.float32(3.0), np.float32(640.5)
    want = np.asarray(jax.jit(lambda p, x, k, l: junet.denoise(
        JB.Ctx(p, dtype=jnp.float32), x, sigma, t, k, l, JP))(
            params, x, cond, label)).transpose(0, 3, 1, 2)
    with torch.device("meta"):
        model = tunet.UNet(P)
    model = tweights.load_module(model, "unet.",
                                 tweights.params_from_jax(params)).eval()
    with torch.no_grad():
        got = tunet.denoise(model, torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))), sigma, t, torch.from_numpy(cond),
            torch.from_numpy(label)).numpy()
        unlabeled = tunet.denoise(model, torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 3, 1, 2))), sigma, t,
            torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(got - unlabeled).max() > 1e-3


def test_identify_sdxl(tmp_path):
    """SDXL's first UNet level has no attention: the model type comes from
    the cross-attention width of input block 4 (a tiny SDXL with attention
    at its second level only, in the port's sd_xl_base layout)."""
    mt = dataclasses.replace(T.TINY_MODEL_TYPE_XL, unet_p=dataclasses.replace(
        T.TINY_UNET_XL, attn_res=(2,)))
    path = str(tmp_path / "xl.safetensors")
    T.write_random_checkpoint(path, mt, seed=1, dtype=np.float32)
    store = TensorStore.open(path)
    try:
        name_map = tweights.build_name_map(store)
        assert "unet.in.1.1.transf.0.attn2.k_proj.weight" not in name_map
        assert "unet.in.4.1.transf.0.attn2.k_proj.weight" in name_map
        assert tweights.identify_model(
            store, name_map, {32: "sd1", 64: "sdxl"}) == "sdxl"
    finally:
        store.close()
