"""The port's W8A8 route on per-column weights against the JAX package:
the plain version of the K7 kernel against ``q8_ws_int8_xla``, the
per-column conversion ``percol_from_blocks``, the storage and dispatch
decisions (``percol_eligible``, ``pick_large_m_plan``) on every SD3-medium
linear, the ``q8_dot`` dispatch, and a quantized tiny MMDiT stored per
column at 2,048 tokens.

Inputs are seeded f32 numpy handed to both packages; the port keeps
nn.Linear's [N, K] orientation, the transposes of the JAX package's arrays.
The CUDA kernel itself is tested in tests/test_torch_quant_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mlimgsynth_tpu import weights as jweights
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import mmdit as jmmdit
from mlimgsynth_tpu.ops import q8_matmul as jq8
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.models import mmdit as tmmdit
from mlimgsynth_torch.models.blocks import QLinear
from mlimgsynth_torch.ops import quant, quant_plan
from mlimgsynth_torch.ops import quant_matmul as qmm
from torch_jax_memo import jax_spec_memo  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores (and the tensors are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _auto_modes(monkeypatch):
    """The JAX package's decisions in their auto modes (the port has no
    knobs)."""
    for var in ("MLIS_Q8_WS", "MLIS_Q8_RS", "MLIS_Q8_INT8WS", "MLIS_Q8_MODE"):
        monkeypatch.delenv(var, raising=False)


def _x(m, k, seed):
    """Activations with a spread of row scales, one all-zero row (the
    amax 0 branch) and one outlier."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x *= np.exp(rng.standard_normal((m, 1))).astype(np.float32)
    x[min(1, m - 1)] = 0.0
    x[m // 2, 3] = 40.0
    return x


def _percol_pair(k, n, seed):
    """A per-column weight in the JAX orientation: int8 [K, N], f32 [N]."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random(n) * 0.01 + 1e-3).astype(np.float32)
    return q, s


# slab None: the slab rule (_ws_slab) of K
@pytest.mark.parametrize("m,k,n,slab", [(37, 512, 96, 256), (19, 1024, 64, 512),
                                        (5, 2048, 40, 1024), (13, 1536, 128, None),
                                        (3, 384, 16, None)])
def test_twin_matches_xla(m, k, n, slab):
    """The int8 activations and their amax exactly; the output (f32 in,
    f32 out) within 1e-6 of its largest value: the integer products are
    exact on both sides, and only the f32 sum over slabs may round in
    another order."""
    x = _x(m, k, seed=m + k)
    jq, js = _percol_pair(k, n, seed=k + n)
    sl = slab or quant._ws_slab(k)
    assert quant._ws_slab(k) == jq8._ws_slab(k) and k % sl == 0
    x2 = jnp.asarray(x).reshape(-1, k // sl, sl)
    jamax = jnp.max(jnp.abs(x2), axis=2, keepdims=True)
    jinv = jnp.where(jamax > 0, 127.0 / jamax, 0.0)
    jxq = np.asarray(jnp.round(x2 * jinv))
    xq, amax = quant.quantize_slabs(torch.from_numpy(x), sl)
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(amax.numpy(), np.asarray(jamax))
    assert np.abs(jxq).max() == 127

    want = np.asarray(jq8.q8_ws_int8_xla(jnp.asarray(x), jnp.asarray(jq),
                                         jnp.asarray(js), slab=slab))
    got = quant.q8_ws_int8_plain(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(jq.T)),
        torch.from_numpy(js), slab).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_activation_quantization_of_bf16_values_matches_jax():
    """bf16 activations (the card's) put many x / amax ratios exactly on a
    rounding tie of ``x * 127 / amax``, so ``127 / amax`` must round once,
    as the JAX package's division does: a reciprocal times 127 moves
    about 200 of these 512 x 1024 values by one step."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((512, 1024)).astype(
        np.float32)).bfloat16().float()
    x2 = jnp.asarray(x.numpy()).reshape(-1, 4, 256)
    jamax = jnp.max(jnp.abs(x2), axis=2, keepdims=True)
    want = np.asarray(jnp.round(x2 * jnp.where(jamax > 0, 127.0 / jamax,
                                                0.0)))
    xq, _ = quant.quantize_slabs(x, 256)
    np.testing.assert_array_equal(xq.numpy(), want)


def test_slab_rule_matches_jax():
    for k in (128, 256, 384, 640, 1536, 3072, 4224, 4608, 6144, 8192):
        assert quant._ws_slab(k) == jq8._ws_slab(k), k


@pytest.mark.parametrize("k,n", [(256, 384), (1536, 256), (384, 200)])
def test_percol_from_blocks_bit_for_bit(k, n):
    rng = np.random.default_rng(k + n)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    w[:128, 0] = 0.0          # an all-zero block (the 1e-30 floors)
    w[5, 1] = 3.0             # an outlier block
    jq, js = jq8.quantize_weight(w)
    jq2, js2, jratio = jq8.percol_from_blocks(jq, js)
    tq, ts = quant.quantize_weight(np.ascontiguousarray(w.T))
    q2, s2, ratio = quant.percol_from_blocks(tq, ts)
    assert q2.dtype == np.int8 and s2.dtype == np.float32
    np.testing.assert_array_equal(q2, jq2.T)
    np.testing.assert_array_equal(s2, js2)
    assert ratio == jratio
    assert quant.PERCOL_MAX_SCALE_RATIO == jq8.PERCOL_MAX_SCALE_RATIO


def _sd3_medium_linear_shapes():
    """(K, N) of every SD3-medium MMDiT linear, from the port's module tree
    on the meta device, held against the JAX package's parameter spec."""
    with torch.device("meta"):
        model = tmmdit.MMDiT(tmmdit.MMDIT_SD3_MEDIUM)
    shapes = {(m.in_features, m.out_features) for m in model.modules()
              if isinstance(m, nn.Linear)}
    P = jmmdit.MMDIT_SD3_MEDIUM
    spec = JB.trace_spec(
        lambda c, x, t, k, y: jmmdit.mmdit_apply(c, x, t, k, y, P),
        jnp.zeros((1, 16, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 154, 4096)), jnp.zeros((1, 2048)))
    assert shapes == {ps.shape for ps in spec.values()
                      if ps.kind == JB.LINEAR_W}
    return sorted(shapes)


def test_storage_and_dispatch_decisions_match_jax():
    """At 1024^2 (m_hint 8704): 9 of the 10 distinct shapes are stored per
    column (all but final_layer.linear, N = 64); the W8A8 plan wins at the
    x stream's 8192 rows only, never at the context stream's 308 or the
    adaLN's 2."""
    m_hint = quant_plan.dit_m_hint(1024, 1024)
    assert m_hint == jq8.dit_m_hint(1024, 1024) == 8704
    shapes = _sd3_medium_linear_shapes()
    percol = [s for s in shapes if quant_plan.percol_eligible(*s, m_hint)]
    assert percol == [s for s in shapes if jq8.percol_eligible(*s, m_hint)]
    assert len(shapes) == 10 and set(shapes) - set(percol) == {(1536, 64)}
    for (k, n) in shapes:
        pc = (k, n) in percol
        for m in (2, 308, 8192):
            for isz in (4, 2):     # f32 (the CPU tests), bf16 (the card)
                got = quant_plan.pick_large_m_plan(m, k, n, isz, percol=pc)
                want = jq8.pick_large_m_plan(m, k, n, isz, percol=pc)
                assert got == want, (m, k, n, isz)
            tag = (got or ("none",))[0]
            assert (tag == "int8ws") == (pc and m == 8192), (m, k, n, tag)


@pytest.mark.parametrize("m", [2, 308, 2048])
def test_q8_dot_dispatch_matches_jax(monkeypatch, m):
    """A per-column weight: the W8A8 twin where the plan picks it (2,048
    rows at f32), else the dequantizing twin on broadcast scales; f32."""
    k, n = 256, 384
    x = _x(m, k, seed=m)
    jq, js = _percol_pair(k, n, seed=1)
    ran = []
    for name in ("q8_ws_int8_plain", "q8_matmul_plain"):
        orig = getattr(quant, name)
        monkeypatch.setattr(quant, name, lambda *a, _n=name, _o=orig: (
            ran.append(_n), _o(*a))[1])
    want = np.asarray(jq8.q8_dot(jnp.asarray(x), jnp.asarray(jq),
                                 jnp.asarray(js)))
    got = qmm.q8_dot(torch.from_numpy(x),
                     torch.from_numpy(np.ascontiguousarray(jq.T)),
                     torch.from_numpy(js)).numpy()
    assert ran == (["q8_ws_int8_plain"] if m == 2048 else ["q8_matmul_plain"])
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_quantized_tiny_mmdit_matches_jax():
    """The quantizing tiny MMDiT at 512^2 (2 x 1024 image tokens, m_hint
    2560): both packages store the same weights per column bit for bit,
    and the forward runs its x-stream qkv and fc1 products through the
    W8A8 twin.

    Tolerance: the activations are quantized to int8 per (row, slab), and
    an f32 difference of one ulp between XLA:CPU and torch upstream can move
    a value across a rounding boundary of that quantization: one step of
    amax / 127 in one activation, which the joint attention spreads over
    every token.  So the two forwards are held to a relative L2 of 1e-3
    (3.5e-4 measured) and to a tenth of what the quantization itself moves
    the output (1.2e-2, against the JAX forward on the float weights); a
    wrong slab, scale or rounding moves it by the quantization's order or
    more."""
    P = T.TINY_Q_MMDIT
    JP = jmmdit.MmditParams(**vars(P))
    spec = JB.trace_spec(
        lambda c, x, t, k, y: jmmdit.mmdit_apply(c, x, t, k, y, JP),
        jnp.zeros((1, 8, 8, P.n_ch_in)), jnp.zeros((1,)),
        jnp.zeros((1, 5, P.d_ctx_in)), jnp.zeros((1, P.d_pooled)))
    rng = np.random.default_rng(11)
    params = {}
    for name, ps in spec.items():
        std = (ps.shape[0] ** -0.5 if ps.kind == JB.LINEAR_W
               else float(np.prod(ps.shape[:3])) ** -0.5
               if ps.kind == JB.CONV_W else 0.1 if ps.kind == JB.VEC else 0.02)
        params[name] = rng.standard_normal(ps.shape).astype(
            np.float32) * np.float32(std)
    m_hint = quant_plan.dit_m_hint(512, 512)
    host = dict(params)
    jweights.quantize_linear_weights(host, spec, bits=8, percol_m_hint=m_hint)

    with torch.device("meta"):
        model = tmmdit.MMDiT(P)
    mine = {k: v for k, v in tweights.params_from_jax(params).items()}
    tweights.quantize_linear_weights(model, "mmdit.", mine, 8, m_hint)
    jmine = tweights.params_from_jax(host)
    assert mine.keys() == jmine.keys()
    for name, v in mine.items():
        assert torch.equal(v, jmine[name]), name
    model = tweights.load_module(model, "mmdit.", mine).eval()
    percol = [n for n, m in model.named_modules()
              if isinstance(m, QLinear) and m.weight_scale.dim() == 1]
    assert "joint_blocks.0.x_block.attn.qkv" in percol
    assert "joint_blocks.0.x_block.mlp.fc1" in percol

    x = rng.standard_normal((2, P.n_ch_in, 64, 64)).astype(np.float32)
    t = np.array([700.0, 700.0], np.float32)
    cond = rng.standard_normal((2, 154, P.d_ctx_in)).astype(np.float32)
    pooled = rng.standard_normal((2, P.d_pooled)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, *a: jmmdit.mmdit_apply(
        JB.Ctx(p, dtype=jnp.float32), *a, JP))(
            host, x.transpose(0, 2, 3, 1), t, cond, pooled)).transpose(
                0, 3, 1, 2)
    qmm.reset_counts()
    calls = []
    orig = quant.q8_ws_int8_plain
    quant.q8_ws_int8_plain = lambda *a: (calls.append(a[0].shape), orig(*a))[1]
    try:
        with torch.no_grad():
            got = model(*map(torch.from_numpy, (x, t, cond, pooled))).numpy()
    finally:
        quant.q8_ws_int8_plain = orig
    assert len(calls) == 2 * P.depth and all(
        s[:2] == (2, 1024) for s in calls)
    assert set(qmm.LAUNCHES.values()) == {0}
    want_f = np.asarray(jax.jit(lambda p, *a: jmmdit.mmdit_apply(
        JB.Ctx(p, dtype=jnp.float32), *a, JP))(
            params, x.transpose(0, 2, 3, 1), t, cond, pooled)).transpose(
                0, 3, 1, 2)
    quant_effect = np.linalg.norm(want_f - want) / np.linalg.norm(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3 and rel < 0.1 * quant_effect, (rel, quant_effect)
