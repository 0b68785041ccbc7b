"""Quantized weights on the other DiT families (SD3.5's qk-norm MMDiT-X and
Flux) against the JAX package, and the torch quantizers against the numpy
ones.

- The torch quantizers (``quant.quantize_weight_torch``,
  ``quantize_weight_q4_torch``, ``percol_from_blocks_torch``), which the
  session runs where the weights lie (on the card there), against the
  numpy copies of the JAX package's, bit for bit: seeded weights with an
  even (24, Flux's K 3072) and an odd (19, SD3.5-large's 2432) count of
  128-deep blocks, an all-zero block, and exact .5 ties.
- The stored weights of the quantizing tiny Flux and MMDiT-X
  (``testing.TINY_Q_FLUX_DEV``, ``TINY_Q_MMDIT_X``) in q8_0, q4_0 and q8_0
  per column, against the JAX package's ``quantize_linear_weights``, bit for
  bit.
- One forward of each on weights stored per column, at the token counts
  where the W8A8 route runs (Flux 768^2: 2,304 image tokens; the MMDiT-X
  512^2 CFG batch: 2 x 1,024), held to a relative L2 of 1e-3 and to a
  tenth of what the quantization itself moves the output, as
  tests/test_torch_int8ws.py holds the MMDiT.

Parameters are seeded f32 numpy in the JAX layout; the port gets their
transposes (``params_from_jax``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu import weights as jweights
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import flux as jflux
from mlimgsynth_tpu.models import mmdit as jmmdit
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.models import flux as tflux
from mlimgsynth_torch.models import mmdit as tmmdit
from mlimgsynth_torch.models.blocks import QLinear
from mlimgsynth_torch.ops import quant, quant_plan
from mlimgsynth_torch.ops import quant_matmul as qmm
from torch_jax_memo import jax_spec_memo  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """Several pytest workers share a few cores; the JAX package's
    decisions in their auto modes."""
    for var in ("MLIS_Q8_WS", "MLIS_Q8_RS", "MLIS_Q8_INT8WS", "MLIS_Q8_MODE"):
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weight(kind: str) -> np.ndarray:
    """A [N, K] weight: seeded N(0, 1/K) with an even (``even``: 24) or odd
    (``odd``: 19) count of 128-deep blocks, with its first block of row 0
    zero (``zero``), or (``ties``) rows whose values divide by their scale
    to exact halves: a block of amax 127 (q8 scale 1) or 7 (q4 scale 1)
    holding k + 0.5."""
    rng = np.random.default_rng(len(kind))
    k = {"even": 3072, "odd": 2432}.get(kind, 1024)
    w = (rng.standard_normal((40, k)) / np.sqrt(k)).astype(np.float32)
    if kind == "zero":
        w[0, :128] = 0.0
        w[3, :] = 0.0
    if kind == "ties":
        half = (np.arange(128) % 120 - 60 + 0.5).astype(np.float32)
        w[0, :128] = half
        w[0, 0] = 127.0
        w[1, :128] = np.clip(half, -6.5, 6.5)
        w[1, 0] = 7.0
    return w


@pytest.mark.parametrize("kind", ["even", "odd", "zero", "ties"])
@pytest.mark.parametrize("fn", ["q8", "q4", "percol"])
def test_torch_quantizer_matches_numpy(kind, fn):
    """Values and scales bit for bit; per column also the scale ratio, whose
    median of an even block count is the mean of the two middle scales (a
    lower-median would move it)."""
    w = _weight(kind)
    if fn == "percol":
        q, s = quant.quantize_weight(w)
        if kind == "ties":
            # a column of amax 127 at scale 1 beside blocks at scale 0.5
            # and odd values: w / s_col lands on halves
            q[0, :128], s[0, 0] = 127, 1.0
            q[0, 128:256] = np.arange(128) % 61 * 2 - 61
            s[0, 1] = 0.5
        want = quant.percol_from_blocks(q, s)
        got = quant.percol_from_blocks_torch(torch.from_numpy(q),
                                             torch.from_numpy(s))
        assert got[2] == want[2]
        if kind == "even":
            srt = np.sort(s, axis=1)
            assert not np.array_equal(srt[:, 11], np.median(s, axis=1))
    else:
        np_fn, t_fn = ((quant.quantize_weight, quant.quantize_weight_torch)
                       if fn == "q8" else
                       (quant.quantize_weight_q4,
                        quant.quantize_weight_q4_torch))
        want, got = np_fn(w), t_fn(torch.from_numpy(w))
        if kind == "ties":      # the halves meet a scale of 1
            assert want[1][0 if fn == "q8" else 1, 0] == 1.0
    for a, b in zip(want[:2], got[:2]):
        assert b.dtype == torch.from_numpy(a).dtype
        assert np.array_equal(b.numpy(), a)


def _params(spec, seed):
    """Seeded f32 params in the JAX layout: fan-in scaled matrices, norm
    scales about 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, ps in spec.items():
        std = (ps.shape[0] ** -0.5 if ps.kind == JB.LINEAR_W
               else float(np.prod(ps.shape[:3])) ** -0.5
               if ps.kind == JB.CONV_W else 0.1 if ps.kind == JB.VEC else 0.02)
        a = rng.standard_normal(ps.shape).astype(np.float32) * np.float32(std)
        if ps.kind == JB.VEC and name.endswith((".weight", ".scale")):
            a += 1.0
        out[name] = a
    return out


def _jax_params(P):
    return (jflux.FluxParams(**{**vars(P), "ch_adm_in": P.d_pooled})
            if getattr(P, "flux", False) else
            jmmdit.MmditParams(**{**vars(P), "ch_adm_in": P.d_pooled}))


# (model, tiny geometry, image side, prefix): the side at which the session
# stores per column (Flux: no CFG batch, 768^2)
MODELS = {"flux": (T.TINY_Q_FLUX_DEV, 768, "flux."),
          "mmdit_x": (T.TINY_Q_MMDIT_X, 512, "mmdit.")}


def _case(model, seed=11):
    """(P, JP, params, spec, m_hint, prefix) of a quantizing tiny model."""
    P, side, prefix = MODELS[model]
    JP = _jax_params(P)
    if model == "flux":
        spec = JB.trace_spec(
            lambda c, x, t, k, y: jflux.flux_apply(
                c, x, t, k, y, JP, guidance=jnp.zeros((1,))),
            jnp.zeros((1, 8, 8, P.n_ch_in // 4)), jnp.zeros((1,)),
            jnp.zeros((1, 5, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
    else:
        spec = JB.trace_spec(
            lambda c, x, t, k, y: jmmdit.mmdit_apply(c, x, t, k, y, JP),
            jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
            jnp.zeros((1, 5, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
    m_hint = quant_plan.dit_m_hint(side, side, flux=model == "flux")
    return P, JP, _params(spec, seed), spec, m_hint, prefix


def _module(P):
    with torch.device("meta"):
        return tflux.Flux(P) if getattr(P, "flux", False) else tmmdit.MMDiT(P)


def _quantized(model, bits, percol):
    """Both packages' stored weights of ``model``: (port module, port
    params, JAX host params, float params, JP)."""
    P, JP, params, spec, m_hint, prefix = _case(model)
    hint = m_hint if percol else None
    host = dict(params)
    jweights.quantize_linear_weights(host, spec, bits=bits,
                                     percol_m_hint=hint)
    module = _module(P)
    mine = tweights.params_from_jax(params)
    tweights.quantize_linear_weights(module, prefix, mine, bits, hint)
    return module, mine, host, params, JP


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("wt", ["q8_0", "q4_0", "q8_0_percol"])
def test_stored_weights_match_jax(model, wt):
    """Every stored weight, quantized or not, bit for bit; per column only
    where the storage decision at the session's image side says so, and
    there for the products that run the W8A8 route."""
    bits = 4 if wt == "q4_0" else 8
    module, mine, host, _, _ = _quantized(model, bits, wt.endswith("percol"))
    theirs = tweights.params_from_jax(host)
    assert mine.keys() == theirs.keys()
    for name, v in mine.items():
        assert torch.equal(v, theirs[name]), name
    prefix = MODELS[model][2]
    q = {n: m for n, m in module.named_modules() if isinstance(m, QLinear)}
    n_lin = sum(k.endswith(f".weight_q{bits}") for k in host)
    assert len(q) == n_lin > 10
    percol = {n for n, m in q.items() if m.weight_scale.dim() == 1}
    for n in q:
        assert (f"{prefix}{n}.weight_scale" in mine
                and mine[f"{prefix}{n}.weight_scale"].dim() == 1) == (
                    n in percol)
    want_percol = ({"double_blocks.0.img_attn.qkv", "single_blocks.0.linear1"}
                   if model == "flux" else
                   {"joint_blocks.0.x_block.attn.qkv",
                    "joint_blocks.0.x_block.attn2.qkv"})
    assert want_percol <= percol if wt.endswith("percol") else not percol
    if model == "flux":     # img_in (16 packed channels) stays float
        assert "flux.img_in.weight" in mine


def _forward(model, P, JP, host, params, module, mine):
    """The JAX forward on the quantized and on the float params, and the
    port's on its quantized module, at the W8A8 route's rows; the W8A8
    twin's calls counted."""
    rng = np.random.default_rng(5)
    if model == "flux":     # 768^2: 48 x 48 patches, 16 text rows
        x = rng.standard_normal((1, 4, 96, 96)).astype(np.float32)
        t = np.array([700.0], np.float32)
        cond = rng.standard_normal((1, 16, P.d_ctx_in)).astype(np.float32)
        pooled = rng.standard_normal((1, P.d_pooled)).astype(np.float32)
        g = np.array([3.5], np.float32)

        def jfn(p):
            return jax.jit(lambda p, *a: jflux.flux_apply(
                JB.Ctx(p, dtype=jnp.float32), *a[:4], JP, guidance=a[4]))(
                    p, x.transpose(0, 2, 3, 1), t, cond, pooled, g)
        args = (x, t, cond, pooled, g)
    else:                   # 512^2 CFG batch: 2 x 32 x 32 patches
        x = rng.standard_normal((2, 4, 64, 64)).astype(np.float32)
        t = np.array([700.0, 700.0], np.float32)
        cond = rng.standard_normal((2, 154, P.d_ctx_in)).astype(np.float32)
        pooled = rng.standard_normal((2, P.d_pooled)).astype(np.float32)

        def jfn(p):
            return jax.jit(lambda p, *a: jmmdit.mmdit_apply(
                JB.Ctx(p, dtype=jnp.float32), *a, JP))(
                    p, x.transpose(0, 2, 3, 1), t, cond, pooled)
        args = (x, t, cond, pooled)
    want = np.asarray(jfn(host)).transpose(0, 3, 1, 2)
    want_f = np.asarray(jfn(params)).transpose(0, 3, 1, 2)
    model_t = tweights.load_module(module, MODELS[model][2], mine).eval()
    calls = []
    orig = quant.q8_ws_int8_plain
    quant.q8_ws_int8_plain = lambda *a: (calls.append(a[0].shape),
                                         orig(*a))[1]
    qmm.reset_counts()
    try:
        with torch.no_grad():
            got = model_t(*map(torch.from_numpy, args)).numpy()
    finally:
        quant.q8_ws_int8_plain = orig
    return want, want_f, got, calls


@pytest.mark.parametrize("model", list(MODELS))
def test_quantized_forward_matches_jax(model):
    """One forward on per-column weights: the image-stream products (Flux's
    double-block qkv and MLP input over 2,304 tokens, its single block's
    ``linear1`` over 2,320; the MMDiT-X x-stream qkv, attn2 qkv and fc1
    over 2 x 1,024) run the W8A8 twin.  Tolerance: the activations are
    quantized to int8 per (row, slab), so an f32 ulp between XLA:CPU and
    torch upstream can move one activation a step, which the attention
    spreads; a relative L2 of 1e-3 and a tenth of the quantization's own
    effect (a wrong slab, scale or rounding moves it by that effect or
    more)."""
    module, mine, host, params, JP = _quantized(model, 8, True)
    P = MODELS[model][0]
    want, want_f, got, calls = _forward(model, P, JP, host, params, module,
                                        mine)
    rows = {s[0] * s[1] if len(s) == 3 else s[0] for s in calls}
    if model == "flux":
        assert len(calls) == 3 and rows == {2304, 2320}
    else:
        assert len(calls) == 2 * 2 + 1 and rows == {2048}
    assert set(qmm.LAUNCHES.values()) == {0}
    quant_effect = np.linalg.norm(want_f - want) / np.linalg.norm(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3 and rel < 0.1 * quant_effect, (rel, quant_effect)
