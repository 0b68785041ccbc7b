"""The port's ``MLIS_Q8_MODE=int8`` route against the JAX package: the plain
version of the K8 kernel (W8A8 on per-block weights) against
``q8_matmul_int8_xla``, and ``q8_dot``'s choice of kernel under both modes
at every quantized product of an SDXL and an SD3-medium model.

Inputs are seeded numpy handed to both packages; the port keeps nn.Linear's
[N, K] orientation, the transposes of the JAX package's arrays.  The CUDA
kernel itself is tested in tests/test_torch_quant_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mlimgsynth_tpu.ops import q8_matmul as jq8
from mlimgsynth_torch.models import mmdit as tmmdit
from mlimgsynth_torch.models import unet as tunet
from mlimgsynth_torch.ops import quant, quant_plan
from mlimgsynth_torch.ops import quant_matmul as qmm


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
    knobs but the mode)."""
    for var in ("MLIS_Q8_WS", "MLIS_Q8_RS", "MLIS_Q8_INT8WS", "MLIS_Q8_MODE"):
        monkeypatch.delenv(var, raising=False)


def _x(m, k, seed, bf16):
    """Activations with a spread of row scales, an all-zero row (the amax 0
    branch) and an outlier; ``bf16``: on the bf16 grid, where many
    x * 127 / amax sit exactly on a rounding tie."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x *= np.exp(rng.standard_normal((m, 1))).astype(np.float32)
    x[min(1, m - 1)] = 0.0
    x[m // 2, 3] = 40.0
    if bf16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _block_pair(k, n, seed):
    """A per-block q8 weight, (int8 [N, K], f32 [N, K/128]), from the
    port's quantizer (bit for bit the JAX package's)."""
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)
    return quant.quantize_weight(w)


# K / 128 blocks: 1, 5, 10, 16, 22 and 40 (SDXL's K = 5120)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 128, 8), (37, 640, 96), (2, 1280, 40),
                                   (154, 2048, 72), (5, 2816, 200),
                                   (19, 5120, 64)])
def test_twin_matches_xla(m, k, n, bf16):
    """Bit for bit up to 32 blocks: the same activation quantization, the
    exact integer block products, the same association and the blocks
    added in order.  Beyond 32 blocks XLA:CPU adds the terms of a reduction
    as two sequential halves and then the halves (measured; the twin, the
    kernel and the Pallas kernel add them in block order), so there the
    twin is held to a relative 1e-6 of the largest output."""
    x = _x(m, k, seed=m + k, bf16=bf16)
    q, s = _block_pair(k, n, seed=k + n)
    want = np.asarray(jq8.q8_matmul_int8_xla(
        jnp.asarray(x), jnp.asarray(np.ascontiguousarray(q.T)),
        jnp.asarray(np.ascontiguousarray(s.T))))
    got = quant.q8_matmul_int8_plain(torch.from_numpy(x),
                                     torch.from_numpy(q),
                                     torch.from_numpy(s)).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    if k // quant.KBLOCK <= 32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))


def _linear_shapes(model):
    return sorted({(m.in_features, m.out_features) for m in model.modules()
                   if isinstance(m, nn.Linear)
                   and m.in_features % quant.KBLOCK == 0})


def _sdxl_products():
    """(M, K, N, per column) of every quantized product of an SDXL q8_0
    UNet at 1024^2 (CFG batch 2): the embeddings at 2 rows, the
    cross-attention k/v at 2 x 77, the 64 x 64 level at 8,192 and the
    32 x 32 level at 2,048 tokens; the UNet stores nothing per column."""
    with torch.device("meta"):
        unet = tunet.UNet(tunet.UNET_SDXL)
    out = set()
    for name, m in unet.named_modules():
        if not isinstance(m, nn.Linear) or m.in_features % quant.KBLOCK:
            continue
        k, n = m.in_features, m.out_features
        if "embed" in name or "emb_proj" in name:
            rows = [2]
        elif "attn2.k_proj" in name or "attn2.v_proj" in name:
            rows = [154]
        else:
            rows = [8192 if n in (640, 5120) or k == 2560 else 2048]
        out.update((r, k, n, False) for r in rows)
    return sorted(out)


def _sd3_products():
    """(M, K, N, per column) of SD3-medium's MMDiT linears at the rows its
    streams give them (2, 308, 8192), stored per column where the JAX
    package's ``percol_eligible`` says so at 1024^2."""
    with torch.device("meta"):
        model = tmmdit.MMDiT(tmmdit.MMDIT_SD3_MEDIUM)
    m_hint = quant_plan.dit_m_hint(1024, 1024)
    return [(m, k, n, jq8.percol_eligible(k, n, m_hint))
            for k, n in _linear_shapes(model) for m in (2, 308, 8192)]


# the plain function each package's dispatch reaches, by route
_PORT = {"q8_ws_int8_plain": "int8ws", "q8_matmul_int8_plain": "int8",
         "q8_matmul_plain": "dq"}
_JAX = {"q8_ws_int8_xla": "int8ws", "q8_matmul_int8_xla": "int8",
        "q8_matmul_xla": "dq"}


@pytest.mark.parametrize("model", ["sdxl", "sd3"])
@pytest.mark.parametrize("mode", ["dq", "int8"])
def test_q8_dot_route_matches_jax(monkeypatch, model, mode):
    """Under each mode, each product takes the reference's route: a
    per-column weight whose plan is ``int8ws`` keeps the per-column W8A8
    kernel (K7) in both modes; under ``int8`` every other product runs K8,
    under ``dq`` the dequantizing kernels.  The plain functions are stubbed
    to record the route (no product is computed); bf16 activations, as on
    the card."""
    monkeypatch.setenv("MLIS_Q8_MODE", mode)
    ran = []
    for name, route in _PORT.items():
        monkeypatch.setattr(quant, name, lambda x, w, s, _r=route: (
            ran.append(_r), torch.zeros(1))[1])
    for name, route in _JAX.items():
        monkeypatch.setattr(jq8, name, lambda x, w, s, _r=route: (
            ran.append(_r), jnp.zeros(1))[1])
    products = _sdxl_products() if model == "sdxl" else _sd3_products()
    routes = []
    for m, k, n, percol in products:
        w = torch.zeros(n, k, dtype=torch.int8)
        s = torch.ones(n) if percol else torch.ones(n, k // quant.KBLOCK)
        ran.clear()
        qmm.q8_dot(torch.zeros(m, k, dtype=torch.bfloat16), w, s)
        jq8.q8_dot(jnp.zeros((m, k), jnp.bfloat16), jnp.zeros((k, n),
                                                                jnp.int8),
                   jnp.ones(n) if percol else jnp.ones((k // 128, n)))
        assert len(ran) == 2 and ran[0] == ran[1], (m, k, n, percol, ran)
        routes.append(ran[0])
    assert set(qmm.LAUNCHES.values()) == {0}
    if model == "sdxl":
        assert set(routes) == {mode}
        assert {m for m, *_ in products} == {2, 154, 2048, 8192}
    else:
        # each per-column shape at 8,192 rows (9 of the 10 shapes; the
        # model gives that many rows to the x stream's products only)
        assert routes.count("int8ws") == 9
        assert set(routes) == {"int8ws", mode}


@pytest.mark.parametrize("m", [2, 308, 2048])
def test_q8_dot_int8_mode_matches_jax(monkeypatch, m):
    """The numbers under ``int8``: per-block weights through the K8 twin,
    and a per-column weight through the K7 twin where the plan picks it
    (2,048 rows at f32), else through the K8 twin on broadcast scales;
    f32, bit for bit up to the f32 rounding of the per-column fold."""
    monkeypatch.setenv("MLIS_Q8_MODE", "int8")
    k, n = 256, 384
    x = _x(m, k, seed=m, bf16=False)
    q, s = _block_pair(k, n, seed=1)
    want = np.asarray(jq8.q8_dot(jnp.asarray(x),
                                 jnp.asarray(np.ascontiguousarray(q.T)),
                                 jnp.asarray(np.ascontiguousarray(s.T))))
    got = qmm.q8_dot(torch.from_numpy(x), torch.from_numpy(q),
                     torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)
    qc, sc, _ = quant.percol_from_blocks(q, s)
    want = np.asarray(jq8.q8_dot(jnp.asarray(x),
                                 jnp.asarray(np.ascontiguousarray(qc.T)),
                                 jnp.asarray(sc)))
    got = qmm.q8_dot(torch.from_numpy(x), torch.from_numpy(qc),
                     torch.from_numpy(sc)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
