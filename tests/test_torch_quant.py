"""The port's weight-only quantization (mlimgsynth_torch.ops.quant, the
dispatch in ops.quant_matmul and models.blocks.QLinear) against the JAX
package's ops/q8_matmul.py and ops/q4_matmul.py.

The same seeded numpy weights go through both quantizers, which must agree
bit for bit; the port keeps nn.Linear's [N, K] orientation, so its arrays
are the transposes of the JAX package's.  The plain twins run in f32 on the
CPU against ``q8_matmul_xla`` / ``q4_matmul_xla`` and against the Pallas
kernels in TPU interpret mode, as tests/test_q8_matmul.py runs them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.ops import q4_matmul as jq4
from mlimgsynth_tpu.ops import q8_matmul as jq8
from mlimgsynth_torch.models.blocks import QLinear
from mlimgsynth_torch.ops import _build, quant
from mlimgsynth_torch.ops import quant_matmul as qmm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores (and the tensors are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _weight(k, n, seed):
    """[K, N] in the JAX orientation: N(0, 0.05), one all-zero 128-row
    group in the first column (the 1e-30 scale floor), and a large outlier
    (a coarse scale for its group)."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32) * 0.05
    w[:128, 0] = 0.0
    w[5, 1] = 3.0
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", [(256, 320), (1280, 64), (384, 200)])
def test_quantizers_match_jax_bit_for_bit(bits, k, n):
    w = _weight(k, n, seed=k + n)
    jfn, tfn = ((jq4.quantize_weight_q4, quant.quantize_weight_q4) if bits == 4
                else (jq8.quantize_weight, quant.quantize_weight))
    jq, js = jfn(w)
    tq, ts = tfn(np.ascontiguousarray(w.T))
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tq, jq.T)
    np.testing.assert_array_equal(ts, js.T)


def _inputs(m, k, n, bits, seed=0):
    """x [m, k] f32, the JAX pair ([K, N] layout) and the port's ([N, K])."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32) * 0.3
    w = _weight(k, n, seed + 1)
    jq, js = (jq4.quantize_weight_q4 if bits == 4 else jq8.quantize_weight)(w)
    tq = torch.from_numpy(np.ascontiguousarray(jq.T))
    ts = torch.from_numpy(np.ascontiguousarray(js.T))
    return x, (jnp.asarray(jq), jnp.asarray(js)), (tq, ts)


def _plain(bits):
    return quant.q4_matmul_plain if bits == 4 else quant.q8_matmul_plain


# f32 throughout: both dequantize to the same f32 weight (one exact
# q * scale product per element); the products differ only in summation
# order between XLA:CPU and torch, about 1e-6 of |x| |w| sqrt(K).
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(13, 256, 320), (2, 1280, 64)])
def test_plain_matches_xla(bits, m, k, n):
    x, (jq, js), (tq, ts) = _inputs(m, k, n, bits)
    jfn = jq4.q4_matmul_xla if bits == 4 else jq8.q8_matmul_xla
    want = np.asarray(jfn(jnp.asarray(x), jq, js))
    got = _plain(bits)(torch.from_numpy(x), tq, ts).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("kernel,m,k,n", [
    ("q8_matmul", 13, 256, 320),
    ("q8_matmul_ws", 13, 256, 320),
    ("q4_matmul", 13, 256, 320),
    ("q4_matmul_ws", 24, 384, 128),
])
def test_plain_matches_pallas_kernels(interpret_mode, kernel, m, k, n):
    """The TPU kernels K5, K6, K9 and K10 in interpret mode (f32: the
    kernels round the dequantized weight to x.dtype, so no rounding), with
    an M that is not a multiple of 8."""
    bits = 4 if kernel.startswith("q4") else 8
    x, (jq, js), (tq, ts) = _inputs(m, k, n, bits, seed=m + k)
    fn = getattr(jq4 if bits == 4 else jq8, kernel)
    want = np.asarray(fn(jnp.asarray(x), jq, js))
    got = _plain(bits)(torch.from_numpy(x), tq, ts).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_dispatch_rule():
    """ws from the JAX package's _WS_MIN_M rows at any K (the ws kernel
    keeps no full-K stripe); tile below."""
    assert qmm.WS_MIN_M == jq8._WS_MIN_M == 2048
    assert qmm.use_ws(2048, 640) and qmm.use_ws(8192, 1280)
    assert qmm.use_ws(2048, 2560) and qmm.use_ws(4096, 3328)
    assert not qmm.use_ws(2047, 640) and not qmm.use_ws(154, 768)
    assert qmm.use_ws(8192, 3456) and qmm.use_ws(2048, 5120)


@pytest.mark.parametrize("bits", [8, 4])
def test_qlinear_on_cpu_builds_nothing(monkeypatch, bits):
    """On CPU tensors a QLinear runs the plain twin on both sides of the
    dispatch rule, builds no kernel and counts no launch."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    qmm.reset_counts()
    k, n = 256, 64
    _, _, (tq, ts) = _inputs(1, k, n, bits)
    lin = QLinear(k, n, bits)
    lin.load_state_dict({f"weight_q{bits}": tq, "weight_scale": ts,
                         "bias": torch.linspace(-1, 1, n)})
    for m in (3, qmm.WS_MIN_M):
        x = torch.from_numpy(np.random.default_rng(m).standard_normal(
            (1, m, k)).astype(np.float32))
        want = _plain(bits)(x, tq, ts) + torch.linspace(-1, 1, n)
        torch.testing.assert_close(lin(x), want, rtol=0, atol=0)
    assert set(qmm.LAUNCHES.values()) == {0}
    assert quant.PLAIN_CUDA_CALLS == 0


def test_launch_refuses_cpu_tensors():
    _, _, (tq, ts) = _inputs(1, 256, 64, 8)
    with pytest.raises(ValueError, match="CUDA"):
        qmm._launch("q8_matmul_tile", torch.zeros(4, 256), tq, ts, 8)
