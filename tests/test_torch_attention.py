"""The port's attention (mlimgsynth_torch.ops) against the JAX package.

The plain twin is held against JAX ``attention_xla`` and against the two
Pallas kernels it stands in for on the CPU (``flash_attention_t`` and
``flash_attention``, run in interpret mode as tests/test_flash_attention.py
runs them).  Inputs are f32 numpy from a seed, fed to both.  The CUDA
kernels themselves are tested in tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.ops import attention as jax_attn
from mlimgsynth_tpu.ops import flash_attention as jax_fa
from mlimgsynth_torch.ops import attention as tattn
from mlimgsynth_torch.ops import flash_attention as tfa


def _qkv(b, h, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    if jax.default_backend() == "tpu":
        yield
        return
    with pltpu.force_tpu_interpret_mode():
        yield


# Plain twin vs attention_xla: both are f32 logits + softmax, so the only
# difference is summation order between XLA:CPU and torch (atol 1e-5).
@pytest.mark.parametrize("sq,sk,d,causal", [
    (77, 77, 40, True),       # CLIP-style causal
    (256, 77, 80, False),     # cross-attention
    (512, 512, 40, False),    # UNet level 0 head width
    (512, 600, 80, False),    # ragged Sk, UNet level 1 head width
    (520, 512, 64, False),    # ragged Sq, SDXL head width
    (512, 513, 160, False),   # wide-d route, ragged Sk
])
def test_plain_matches_attention_xla(sq, sk, d, causal):
    q, k, v = _qkv(2, 2, sq, sk, d, seed=sq + sk + d)
    want = np.asarray(jax_attn.attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = tattn.attention_xla(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# Plain twin vs the Pallas kernel it replaces, in interpret mode.  The
# Pallas kernels take the softmax in blocks (K1 with a static max), so the
# tolerance is the one tests/test_flash_attention.py holds them to.
@pytest.mark.parametrize("kernel,sq,sk,d", [
    ("flash_attention_t", 512, 512, 40),
    ("flash_attention_t", 512, 512, 80),
    ("flash_attention_t", 512, 600, 64),     # ragged Sk
    ("flash_attention", 512, 512, 160),      # wide d, narrow stand-in for 512
    ("flash_attention", 512, 600, 160),      # wide d, ragged Sk
])
def test_plain_matches_pallas_interpret(interpret_mode, kernel, sq, sk, d):
    q, k, v = _qkv(1, 2, sq, sk, d, seed=d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if kernel == "flash_attention_t":
        want = jax_fa.flash_attention_t(jq, jk, jv.swapaxes(-1, -2),
                                        block_q=256, block_k=256)
        want = np.asarray(want).swapaxes(-1, -2)
    else:
        want = np.asarray(jax_fa.flash_attention(jq, jk, jv, block_q=256,
                                                 block_k=256))
    tq, tk, tv = _t(q, k, v)
    wrapper = tfa.flash_attn_fwd if d <= 160 else tfa.flash_attn_fwd_wide
    np.testing.assert_allclose(wrapper(tq, tk, tv).numpy(), want,
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("sq,sk,d,causal", [
    (4096, 4096, 40, False),   # SD1 UNet level 0
    (1024, 1024, 80, False),   # SD1 UNet level 1
    (4096, 4096, 512, False),  # SD1 VAE mid-block
    (256, 256, 160, False),    # SD1 UNet level 2: below the size gate
    (4096, 77, 40, False),     # cross-attention
    (77, 77, 64, True),        # CLIP
    (4096, 4096, 40, True),    # causal: no port kernel
    (512, 512, 513, False),    # wider than any kernel
])
def test_gate_routes_like_jax(monkeypatch, sq, sk, d, causal):
    q = torch.zeros(1, 1, sq, d)
    k = torch.zeros(1, 1, sk, d)
    # the JAX gate ignores ``causal`` (its kernel K2 has a causal branch);
    # the port's kernels are non-causal, so causal attention stays plain
    want = jax_fa.flash_attention_compatible(
        jnp.zeros((1, 1, sq, d)), jnp.zeros((1, 1, sk, d)),
        jnp.zeros((1, 1, sk, d)), causal) and not causal
    assert tattn.flash_attention_compatible(q, k, k, causal) == want
    routed = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: routed.append(1) or a[0])
    monkeypatch.setattr(tattn, "attention_xla",
                        lambda q, *a, **kw: q)
    tattn.attention(q, k, k, causal=causal)
    assert bool(routed) == want
