"""The port's SD2.1 slice against the JAX package: whole tiny SD2 sessions
(v-prediction UNet, the text tower in the OpenCLIP layout with fused q/k/v,
clip skip 2) for euler, dpmpp2m, heun, euler_a, taylor3, dpmpp2s,
dpmpp2m_sde and unipc (each solver's state carried through a real
UNet), the detection of the
sd2 type from a checkpoint's cross-attention width, and two modules at
geometries the tiny set does not reach: the v-prediction UNet with heads
of a fixed width (``d_head``, as ``UNET_SD2``) at the first and the last
sigma, and a text tower 1024 wide (tanh-GELU, as ViT-H) at clip skip 2.

Both packages run in f32 on the CPU from the JAX package's
``write_checkpoint_sd2`` file, with the same prompts and seed; one JAX and
one port session serve every case of this file.  Tolerances as the SD1,
SDXL and SD3 legs (tests/test_torch_e2e.py): per-step latents atol/rtol
1e-4, the last step included (near sigma 0 the v-prediction output is
mostly the c_skip term), and the final u8 image PSNR > 40 dB.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu import api as jax_api
from mlimgsynth_tpu import testing as jtesting
from mlimgsynth_tpu import weights as jweights
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.io.tensorstore import TensorStore as JaxTensorStore
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import clip as jclip
from mlimgsynth_tpu.models import unet as junet
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.io.tensorstore import TensorStore
from mlimgsynth_torch.models import clip as tclip
from mlimgsynth_torch.models import unet as tunet
from torch_jax_memo import jax_spec_memo  # noqa: F401

PROMPT = "a (cat:1.3) riding a [bicycle]"
NPROMPT = "blurry, low quality"
OPTS = [("image-dim", 64), ("steps", 6), ("seed", 42), ("cfg-scale", 7.0),
        ("scheduler", "karras"), ("prompt", PROMPT), ("nprompt", NPROMPT)]


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


class _Sessions:
    """One JAX session and one port session, each method run once."""

    def __init__(self, ckpt):
        self.ckpt = ckpt
        self.js = self.ts = None
        self.done = {}

    def run(self, method, monkeypatch):
        if method in self.done:
            return self.done[method]
        monkeypatch.setattr(jax_api, "_model_types", lambda: {
            "sd2": jtesting.TINY_MODEL_TYPE_SD2})
        monkeypatch.setattr(torch_api, "_model_types", lambda: {
            "sd2": T.TINY_MODEL_TYPE_SD2})
        if self.js is None:
            self.js = JaxSession()
            self.ts = torch_api.MLImgSynth(device="cpu")
        out = []
        for s in (self.js, self.ts):
            traj = []
            s.option_set("model", self.ckpt)
            s.option_set("weight-type", "f32")
            s.option_set("s-ancestral", 0)
            for k, v in OPTS + [("method", method)]:
                s.option_set(k, v)
            s.step_observer = lambda i, lat: traj.append(
                np.asarray(lat, np.float32).copy())
            img = np.asarray(s.generate(), np.float32)
            out.append((traj, img, np.asarray(s.tensors["cond"]),
                        s.infotext))
        self.done[method] = out
        return out


@pytest.fixture(scope="module")
def sd2(tmp_path_factory):
    path = tmp_path_factory.mktemp("sd2") / "tiny-sd2.safetensors"
    jtesting.write_checkpoint_sd2(path, seed=4)
    return _Sessions(str(path))


@pytest.mark.parametrize("method,n_step", [
    ("euler", 6), ("dpmpp2m", 6), ("heun", 3), ("euler_a", 6),
    ("taylor3", 6), ("dpmpp2s", 3), ("dpmpp2m_sde", 6), ("unipc", 6)])
def test_sd2_generate_matches_jax(sd2, monkeypatch, method, n_step):
    (traj_j, img_j, cond_j, info_j), (traj_t, img_t, cond_t, info_t) = \
        sd2.run(method, monkeypatch)
    ts = sd2.ts
    assert ts.c["model_type"] == "sd2" and ts.c["clip_skip"] == 2
    assert ts._mt.unet_p.vparam
    assert ts.c["s_ancestral"] == (1.0 if method.endswith("_a") else 0.0)
    assert cond_t.shape == (1, 77, 32)
    np.testing.assert_allclose(cond_t, cond_j, atol=1e-5, rtol=1e-5)
    assert len(traj_j) == len(traj_t) == n_step
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert img_t.shape == img_j.shape == (1, 3, 64, 64)
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"
    assert info_t == info_j


@pytest.mark.parametrize("width,want", [(768, "sd1"), (1024, "sd2"),
                                        (2048, "sdxl")])
def test_sd2_detected_by_context_width(tmp_path, width, want):
    """A checkpoint's first cross-attention k width names its type, as in
    the JAX package (the port's table is built from ``_model_types``, the
    JAX one is the reference's)."""
    name = ("model.diffusion_model.input_blocks.1.1.transformer_blocks.0."
            "attn2.to_k.weight")
    path = str(tmp_path / "probe.safetensors")
    T.write_safetensors(path, {name: (320, width)}, np.float16,
                        [(name, np.zeros((320, width), np.float16))])
    store = TensorStore.open(path)
    types = torch_api._model_types()
    got = tweights.identify_model(
        store, tweights.build_name_map(store),
        {d.unet_p.n_ctx: k for k, d in types.items()})
    store.close()
    jstore = JaxTensorStore.open(path)
    jgot, _ = jweights.identify_model(jstore,
                                      jweights.build_name_map(jstore))
    jstore.close()
    assert got == jgot == want
    if want == "sd2":
        mt = types["sd2"]
        assert (mt.clip_p.d_embed, mt.default_dim, mt.default_clip_skip,
                mt.unet_p.d_head, mt.unet_p.vparam) == (1024, 768, 2, 64,
                                                        True)


def test_sd2_checkpoint_layout_round_trips():
    """The full-width SD2.1 writer's names: the OpenCLIP tower with fused
    q/k/v under ``cond_stage_model.model.``, linear ``proj_in`` /
    ``proj_out``, every one mapping back to the port's parameters
    (``_checkpoint_layout`` raises otherwise); about 1.30 G parameters,
    the VAE encoder's 34 M among them."""
    lay = T._checkpoint_layout(torch_api._model_types()["sd2"])
    n = sum(int(np.prod(v[0])) for v in lay.values())
    assert 1.28e9 < n < 1.32e9
    assert ("first_stage_model.encoder.mid.attn_1.q.weight" in lay
            and "first_stage_model.quant_conv.weight" in lay)
    qkv = ("cond_stage_model.model.transformer.resblocks.23.attn."
           "in_proj_weight")
    assert lay[qkv][:2] == ((3072, 1024), "qkv")
    proj = "model.diffusion_model.output_blocks.11.1.proj_out.weight"
    assert lay[proj][:2] == ((320, 320), "linear")


def _params(spec, seed):
    """Seeded JAX-layout parameters, fan-in scaled (as
    tests/test_torch_models.py draws them)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, ps in spec.items():
        std = (ps.shape[0] ** -0.5 if ps.kind == JB.LINEAR_W else
               float(np.prod(ps.shape[:3])) ** -0.5 if ps.kind == JB.CONV_W
               else 0.1 if ps.kind == JB.VEC else 0.02)
        a = rng.standard_normal(ps.shape).astype(np.float32) * np.float32(std)
        if ps.kind == JB.VEC and name.endswith(".weight"):
            a += 1.0
        out[name] = a
    return out


def _port(module, prefix, params):
    mine = {k: v for k, v in tweights.params_from_jax(params).items()
            if k.startswith(prefix)}
    return tweights.load_module(module, prefix, mine).eval()


# UNET_SD2's rules at a tiny width: heads of 16 (2 at 32 channels, 4 at
# 64), v-prediction
UNET_V_DHEAD = dict(n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1),
                    attn_res=(1, 2), d_head=16, n_te=64, n_ctx=32,
                    vparam=True)


@pytest.mark.parametrize("sigma,t", [(14.6146, 999.0), (0.0292, 0.0)])
def test_unet_v_denoise_matches_jax(sigma, t):
    """Near sigma 0 the v-prediction output is mostly ``c_skip * x``; at
    sigma 14.6 mostly the UNet's.  atol/rtol 1e-4 (f32, summation order)."""
    jp = junet.UnetParams(**UNET_V_DHEAD)
    spec = JB.trace_spec(
        lambda c, x, tt, k: junet.unet_apply(c, x, tt, k, None, jp),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32)))
    params = _params(spec, seed=11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32) * sigma
    cond = rng.standard_normal((2, 77, 32)).astype(np.float32)
    sigma, t = np.float32(sigma), np.float32(t)
    want = np.asarray(jax.jit(lambda p, x, k: junet.denoise(
        JB.Ctx(p, dtype=jnp.float32), x, sigma, t, k, None, jp))(
        params, x, cond)).transpose(0, 3, 1, 2)
    model = _port(tunet.UNet(tunet.UnetParams(**UNET_V_DHEAD)), "unet.",
                  params)
    with torch.no_grad():
        got = tunet.denoise(model, torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))), sigma, t, torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_clip_1024_wide_matches_jax():
    """A two-layer tower 1024 wide with ViT-H's heads and MLP (tanh-GELU,
    no padding token) and a small vocabulary, at clip skip 2: the last
    layer is skipped and the final norm applied.  atol/rtol 1e-4."""
    geo = dict(n_vocab=1000, d_embed=1024, n_interm=4096, n_head=16,
               n_layer=2, tok_pad=0)
    jp = jclip.ClipParams(**geo)
    spec = JB.trace_spec(lambda c, tk: jclip.clip_text_apply(c, tk, jp),
                         jnp.zeros((1, 77), jnp.int32))
    params = _params(spec, seed=13)
    tokens = np.random.default_rng(14).integers(0, 1000, (2, 77))
    want = np.asarray(jax.jit(lambda p, tk: jclip.clip_text_apply(
        JB.Ctx(p, dtype=jnp.float32), tk, jp, clip_skip=2)[0])(
        params, jnp.asarray(tokens, jnp.int32)))
    model = _port(tclip.ClipText(tclip.ClipParams(**geo)), "clip.text.",
                  params)
    assert model.encoder["layers"][0].mlp.act is tclip.B.gelu_tanh
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
