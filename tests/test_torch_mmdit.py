"""The port's SD3 modules against the JAX package's at the tiny SD3
geometry: the MMDiT forward and its flow ``denoise``, the bigG text tower
with its projected pooled feature, the SD3 VAE decode, and the large-S
attention route (the K3 gate).

Parameters are seeded f32 numpy in the JAX layout (fan-in scaled), handed
to the JAX models through a ``Ctx`` and to the port through
``params_from_jax``.  Tolerance atol/rtol 1e-4 in f32: summation order
between XLA:CPU and torch over the depth of each model.  The MMDiT also
meets ``tests/torch_ref.torch_mmdit``, written from the SD3 block structure
and not from either package, as a second witness.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import clip as jclip
from mlimgsynth_tpu.models import mmdit as jmmdit
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_tpu.ops import stock_flash as jstock
from mlimgsynth_tpu.testing import TINY_CLIP2 as J_TINY_CLIP2
from mlimgsynth_tpu.testing import TINY_MMDIT as J_TINY_MMDIT
from mlimgsynth_tpu.testing import TINY_VAE_SD3 as J_TINY_VAE_SD3
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.models import blocks as tblocks
from mlimgsynth_torch.models import clip as tclip
from mlimgsynth_torch.models import mmdit as tmmdit
from mlimgsynth_torch.models import vae as tvae
from mlimgsynth_torch.ops import attention as tattn
from mlimgsynth_torch.ops import flash_attention as tfa
from mlimgsynth_torch.weights import load_module, params_from_jax

from torch_ref import torch_mmdit
from torch_jax_memo import jax_spec_memo  # noqa: F401

ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores (and the tensors are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(spec, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, ps in spec.items():
        if ps.kind == JB.LINEAR_W:
            std = ps.shape[0] ** -0.5
        elif ps.kind == JB.CONV_W:
            std = float(np.prod(ps.shape[:3])) ** -0.5
        elif ps.kind == JB.VEC:
            std = 0.1
        else:
            std = 0.02
        a = rng.standard_normal(ps.shape).astype(np.float32) * np.float32(std)
        if ps.kind == JB.VEC and name.endswith(".weight"):
            a += 1.0
        out[name] = a
    return out


def _jax_run(fn, params, *args):
    return jax.jit(lambda p, *a: fn(JB.Ctx(p, dtype=jnp.float32), *a))(
        params, *args)


def _port(module, prefix, params):
    mine = {k: v for k, v in params_from_jax(params).items()
            if k.startswith(prefix)}
    return load_module(module, prefix, mine).eval()


def _mmdit_case(P, hw=16, n=2, s_ctx=7, seed=0):
    """JAX-layout params of the JAX package's MMDiT ``P`` and seeded
    inputs (x NCHW)."""
    spec = JB.trace_spec(
        lambda ctx, x, t, c, y: jmmdit.mmdit_apply(ctx, x, t, c, y, P),
        jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
        jnp.zeros((1, 5, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
    params = _params(spec, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, P.n_ch_in, hw, hw)).astype(np.float32)
    t = np.array([700.0, 300.0][:n], np.float32)
    cond = rng.standard_normal((n, s_ctx, P.d_ctx_in)).astype(np.float32)
    pooled = rng.standard_normal((n, P.d_pooled)).astype(np.float32)
    return params, x, t, cond, pooled


def test_tiny_geometry_matches_jax():
    """The port's tiny SD3 set carries the JAX package's values."""
    ported = vars(T.TINY_MMDIT)
    assert ported == {k: getattr(J_TINY_MMDIT, k) for k in ported}
    assert vars(T.TINY_CLIP2) == vars(J_TINY_CLIP2)
    assert vars(T.TINY_VAE_SD3) == vars(J_TINY_VAE_SD3)


def test_mmdit_matches_jax_and_torch_ref():
    P = T.TINY_MMDIT
    params, x, t, cond, pooled = _mmdit_case(J_TINY_MMDIT)
    want = np.asarray(_jax_run(
        lambda c, x, t, k, y: jmmdit.mmdit_apply(c, x, t, k, y,
                                                 J_TINY_MMDIT),
        params, x.transpose(0, 2, 3, 1), t, cond, pooled)).transpose(
            0, 3, 1, 2)
    model = _port(tmmdit.MMDiT(P), "mmdit.", params)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t, cond, pooled))).numpy()
        ckpt = {k: v.numpy() for k, v in params_from_jax(params).items()}
        ref = torch_mmdit(ckpt, *map(torch.from_numpy, (x, t, cond, pooled)),
                          J_TINY_MMDIT).numpy()
    assert got.shape == (2, P.n_ch_out, 16, 16)
    assert float(np.abs(want).mean()) > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_denoise_is_velocity():
    """The flow wrapper returns the model output as dx/dsigma, in f32, with
    the timestep broadcast over the batch (``mmdit.denoise``)."""
    P = T.TINY_MMDIT
    params, x, _, cond, pooled = _mmdit_case(J_TINY_MMDIT, seed=4)
    sigma = np.float32(0.7)
    t = sigma * np.float32(P.n_step_train)
    want = np.asarray(_jax_run(
        lambda c, x, k, y: jmmdit.denoise(c, x, sigma, t, k, y,
                                          J_TINY_MMDIT),
        params, x.transpose(0, 2, 3, 1), cond, pooled)).transpose(0, 3, 1, 2)
    model = _port(tmmdit.MMDiT(P), "mmdit.", params)
    with torch.no_grad():
        got = tmmdit.denoise(model, torch.from_numpy(x), sigma, t,
                             torch.from_numpy(cond), torch.from_numpy(pooled))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_pos_embed_crop_is_centered():
    P = T.TINY_MMDIT
    with torch.device("meta"):
        model = tmmdit.MMDiT(P)
    g = P.pos_embed_max
    model.pos_embed = torch.nn.Parameter(
        torch.arange(g * g, dtype=torch.float32).view(1, g * g, 1)
        .expand(1, g * g, P.width).clone())
    got = model._pos_embed_crop(2, 2)[0, :, 0]
    want = torch.arange(g * g, dtype=torch.float32).view(g, g)[3:5, 3:5]
    assert torch.equal(got, want.reshape(-1))


@pytest.mark.parametrize("clip_skip", [1, 2])
def test_bigg_tower_and_pooled_feature_match_jax(clip_skip):
    """The second tower (the bigG geometry's tok_pad 0): the skip-layer
    hidden and the projected pooled feature of one pass, read at each row's
    end token."""
    P = T.TINY_CLIP2
    toks = jnp.zeros((1, 77), jnp.int32)
    spec = JB.trace_spec(lambda c, t: jclip.clip_text_apply(
        c, t, J_TINY_CLIP2, feat_tok_idx=jnp.zeros((1,), jnp.int32),
        pre="clip2"), toks)
    assert "clip2.text.text_proj" in spec
    params = _params(spec, seed=6)
    tokens = np.random.default_rng(7).integers(0, 49408, (3, 77))
    fidx = np.array([5, 76, 11], np.int32)
    emb_j, feat_j = _jax_run(lambda c, t, f: jclip.clip_text_apply(
        c, t, J_TINY_CLIP2, clip_skip=clip_skip, norm=False,
        feat_tok_idx=f, pre="clip2"), params, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(fidx))
    model = _port(tclip.ClipText(P, proj=True), "clip2.text.", params)
    with torch.no_grad():
        emb, feat = model.encode(torch.from_numpy(tokens), clip_skip, False,
                                 torch.from_numpy(fidx).long())
    np.testing.assert_allclose(emb.numpy(), np.asarray(emb_j), atol=ATOL,
                               rtol=RTOL)
    assert feat.dtype == torch.float32 and feat.shape == (3, P.d_embed)
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_j), atol=ATOL,
                               rtol=RTOL)


def test_sd3_vae_decode_matches_jax():
    """The SD3 VAE: shift factor, no post-quant conv."""
    P = T.TINY_VAE_SD3
    spec = JB.trace_spec(
        lambda c, z: jvae.vae_decode_apply(c, z, J_TINY_VAE_SD3),
        jnp.zeros((1, 8, 8, P.ch_z)))
    assert not any("post_quant_conv" in k for k in spec)
    params = _params(spec, seed=8)
    z = np.random.default_rng(9).standard_normal((1, 16, 16, P.ch_z)).astype(
        np.float32)
    want = np.asarray(_jax_run(
        lambda c, z: jvae.vae_decode_apply(c, z, J_TINY_VAE_SD3), params,
        z)).transpose(0, 3, 1, 2)
    model = _port(tvae.VaeDecoder(P), "vae.", params)
    assert not hasattr(model, "post_quant_conv")
    with torch.no_grad():
        got = model(torch.from_numpy(np.ascontiguousarray(
            z.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# (q shape [B, H, S, D], dtype): the K3 gate's decisions in auto mode.  Not
# here: shapes the JAX gate leaves to its VMEM-promoted kernels (the SD1 VAE
# mid-block, [1, 1, 4096, 512]), which the port's gate, without those TPU
# rules, sends to the same wide kernel as the flash gate would.
GATE_CASES = [
    ((2, 24, 4250, 64), "bfloat16"),    # SD3-medium 1024^2, CFG batch
    ((1, 1, 16384, 512), "bfloat16"),   # SD3 VAE mid-block at 1024^2
    ((2, 24, 2047, 64), "bfloat16"),    # below the S floor
    ((2, 24, 4250, 64), "float32"),     # f32 stays off the route
    ((1, 2, 4096, 160), "bfloat16"),    # d > 128 and not a multiple of 128
]


@pytest.mark.parametrize("shape,dtype", GATE_CASES)
def test_stock_gate_matches_jax(monkeypatch, shape, dtype):
    monkeypatch.delenv("MLIS_FLASH_STOCK", raising=False)
    jq = jax.ShapeDtypeStruct(shape, getattr(jnp, dtype))
    q = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    assert tattn.stock_eligible(q, q, q) == jstock.eligible(jq, jq, jq,
                                                            False)
    assert not tattn.stock_eligible(q, q, q, causal=True)


def test_attention_routes(monkeypatch):
    """bf16 CPU tensors: a joint attention past the K3 gate takes
    flash_attn_joint, a 512-wide head past it the wide kernel; the UNet's
    ``attention_t`` route never takes the K3 gate (its S=4096 self-attention
    stays on flash_attn_fwd)."""
    calls = []
    for name in ("flash_attn_joint", "flash_attn_fwd_wide", "flash_attention"):
        orig = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _o=orig, **k: (
            calls.append(_n), _o(*a, **k))[1])

    def run(fn, b, h, s, d):
        q = torch.zeros(b, h, s, d, dtype=torch.bfloat16)
        fn(q, q, q)

    run(tattn.attention, 1, 2, 2048, 64)
    run(tattn.attention, 1, 1, 2048, 512)
    run(tattn.attention_t, 1, 2, 2048, 40)
    run(tattn.attention, 1, 2, 1024, 64)
    assert calls == ["flash_attn_joint", "flash_attn_fwd_wide",
                     "flash_attention", "flash_attention"]


def test_unet_self_attention_keeps_its_route(monkeypatch):
    """``AttnMHead`` (the UNet and CLIP) goes through ``attention_t``."""
    seen = []
    monkeypatch.setattr(tattn, "stock_eligible",
                        lambda *a, **k: seen.append(1) or True)
    attn = tblocks.AttnMHead(64, 64, 64, 64, 2).bfloat16()
    with torch.no_grad():
        attn(torch.zeros(1, 2048, 64, dtype=torch.bfloat16))
    assert not seen
