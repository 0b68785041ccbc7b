"""The port's building blocks (mlimgsynth_torch.models.blocks) against the
JAX package's, one parametrised test over the blocks.

Each case runs a JAX block under a ``Ctx`` of seeded f32 numpy parameters
in the JAX layout and the port's module loaded with ``params_from_jax`` of
the same parameters; activations go NHWC to the JAX side and NCHW to the
port.  Tolerance atol/rtol 1e-5 in f32: summation order differs between
XLA:CPU and torch (and the JAX upsample folds the nearest repeat into a
4x4 lhs-dilated conv, the same sum in another order).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_torch.models import blocks as TB
from mlimgsynth_torch.weights import params_from_jax
from torch_jax_memo import jax_spec_memo  # noqa: F401


def _nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2)) if a.ndim == 4 else a


# name: (JAX block (ctx, *inputs), port module factory or None,
#        port call (module, *inputs), input shapes; 4-D inputs are NHWC)
CASES = {
    "linear": (lambda c, x: JB.linear(c, "m", x, 24),
               lambda: TB.linear(16, 24), lambda m, x: m(x), [(2, 5, 16)]),
    "conv2d": (lambda c, x: JB.conv2d(c, "m", x, 12),
               lambda: TB.conv2d(8, 12), lambda m, x: m(x), [(2, 7, 6, 8)]),
    "layer_norm": (lambda c, x: JB.layer_norm(c, "m", x),
                   lambda: TB.LayerNorm(16), lambda m, x: m(x),
                   [(2, 5, 16)]),
    "group_norm": (lambda c, x: JB.group_norm(c, "m", x),
                   lambda: TB.GroupNorm(64), lambda m, x: m(x),
                   [(2, 5, 6, 64)]),
    "upsample": (lambda c, x: JB.upsample(c, "m", x, 8),
                 lambda: TB.Upsample(8, 8), lambda m, x: m(x),
                 [(2, 5, 6, 8)]),
    "downsample": (lambda c, x: JB.downsample(c, "m", x, 8),
                   lambda: TB.Downsample(8, 8), lambda m, x: m(x),
                   [(2, 10, 9, 8)]),
    "resnet": (lambda c, x, e: JB.resnet(c, "m", x, e, 64),
               lambda: TB.Resnet(32, 64, 16), lambda m, x, e: m(x, e),
               [(2, 6, 6, 32), (2, 16)]),
    "resnet_no_emb": (lambda c, x: JB.resnet(c, "m", x, None, 32),
                      lambda: TB.Resnet(32, 32), lambda m, x: m(x),
                      [(1, 6, 6, 32)]),
    "geglu": (lambda c, x: JB.geglu(c, "m", x, 24),
              lambda: TB.GEGLU(16, 24), lambda m, x: m(x), [(2, 5, 16)]),
    "feed_forward": (lambda c, x: JB.feed_forward(c, "m", x, 16),
                     lambda: TB.FeedForward(16, 16), lambda m, x: m(x),
                     [(2, 5, 16)]),
    "attn_mhead_self": (
        lambda c, x: JB.attn_mhead(c, "m", x, x, x, 32, 32, 4),
        lambda: TB.AttnMHead(32, 32, 32, 32, 4), lambda m, x: m(x),
        [(2, 9, 32)]),
    # Sq = Sk = 512 passes the flash size gate: the port takes the flash
    # wrapper (its plain twin on the CPU), the JAX side attention_xla
    "attn_mhead_flash_size": (
        lambda c, x: JB.attn_mhead(c, "m", x, x, x, 32, 32, 4),
        lambda: TB.AttnMHead(32, 32, 32, 32, 4), lambda m, x: m(x),
        [(1, 512, 32)]),
    "attn_mhead_cross": (
        lambda c, x, k: JB.attn_mhead(c, "m", x, k, k, 32, 32, 4),
        lambda: TB.AttnMHead(32, 24, 32, 32, 4), lambda m, x, k: m(x, k),
        [(2, 9, 32), (2, 7, 24)]),
    "attn_mhead_causal_bias": (
        lambda c, x: JB.attn_mhead(c, "m", x, x, x, 32, 32, 4, mask=True,
                                   bias=True),
        lambda: TB.AttnMHead(32, 32, 32, 32, 4, bias=True),
        lambda m, x: m(x, mask=True), [(2, 9, 32)]),
    "basic_transformer": (
        lambda c, x, k: JB.basic_transformer(c, "m", x, k, 32, 32, 4),
        lambda: TB.BasicTransformer(32, 24, 4), lambda m, x, k: m(x, k),
        [(2, 9, 32), (2, 7, 24)]),
    "timestep_embedding": (lambda c, t: JB.timestep_embedding(t * 100, 32),
                           None, lambda m, t: TB.timestep_embedding(t * 100,
                                                                    32),
                           [(3,)]),
    "silu": (lambda c, x: JB.silu(x), None, lambda m, x: TB.silu(x),
             [(2, 33)]),
    "gelu_tanh": (lambda c, x: JB.gelu_tanh(x), None,
                  lambda m, x: TB.gelu_tanh(x), [(2, 33)]),
    "gelu_exact": (lambda c, x: JB.gelu_exact(x), None,
                   lambda m, x: TB.gelu_exact(x), [(2, 33)]),
    "gelu_quick": (lambda c, x: JB.gelu_quick(x), None,
                   lambda m, x: TB.gelu_quick(x), [(2, 33)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_jax(name):
    jax_fn, make, call, shapes = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    inputs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    spec = JB.trace_spec(jax_fn, *[jnp.asarray(a) for a in inputs])
    params = {k: rng.standard_normal(ps.shape).astype(np.float32) * 0.3
              for k, ps in spec.items()}
    want = np.asarray(jax_fn(JB.Ctx(params, dtype=jnp.float32),
                             *[jnp.asarray(a) for a in inputs]))
    module = None
    if make is not None:
        module = make()
        sd = {k[len("m."):]: v for k, v in params_from_jax(params).items()}
        module.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = call(module, *[torch.from_numpy(_nchw(a)) for a in inputs])
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=1e-5,
                               rtol=1e-5)
