"""Attention: the plain softmax path and the flash-kernel dispatch.

Port of ``mlimgsynth_tpu/ops/attention.py`` (``attention_xla``,
``attention``, ``attention_t``).  Large non-causal attention goes to the
hand-written CUDA flash kernels (``ops/flash_attention.py``); everything else
(the 77-token cross-attention, CLIP's causal attention, the UNet's 256- and
64-token levels) runs the plain softmax, as the JAX package runs
``attention_xla``.

Under a session's mesh with sp > 1 (``parallel/mesh.scope``), every
non-causal attention whose sequence divides the sp ranks goes through them
first, as the JAX package's ``_sp_attention`` route (``attention.py:
64-126``): the ring for self and joint attention, the q-sharded path for
a short context; a shape that does not divide takes the paths below with
the JAX package's warning.  Under tp and dp the attention sees a rank's
heads and rows, which take the flash gates unchanged.
"""
from __future__ import annotations

import torch

from ..parallel import mesh as pmesh
from . import flash_attention as fa


def attention_xla(q, k, v, scale=None, causal: bool = False):
    """Plain attention.  q, k, v: [B, H, Sq|Sk, D] -> [B, H, Sq, D].

    Logits and softmax in f32 whatever the input dtype; the probabilities
    are cast back to the input dtype before the product with v (as
    ``attention_xla`` in the JAX package)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w, v)


def flash_attention_compatible(q, k, v, causal: bool = False) -> bool:
    """The JAX package's flash gate (4-D, d <= 512, Sq and Sk >= 512;
    ``mlimgsynth_tpu/ops/flash_attention.py:329-341``), and non-causal:
    the port's kernels have no causal mask, which no caller of the gate
    needs (CLIP's causal attention is 77 tokens)."""
    return (q.dim() == 4 and q.shape[-1] <= 512 and not causal
            and q.shape[-2] >= 512 and k.shape[-2] >= 512)


# the large-S floor of the K3 gate (``stock_flash.eligible``'s ``sk >= 2048``)
STOCK_MIN_S = 2048


def stock_eligible(q, k, v, causal: bool = False) -> bool:
    """The K3 gate in its auto mode (``stock_flash.eligible``,
    ``mlimgsynth_tpu/ops/stock_flash.py:136-165``): non-causal self or joint
    attention (Sq == Sk, v shaped like k), bf16, d <= 128 or a multiple of
    128, S >= 2048.  Its VMEM-promotion and q-padding rules (``_padded_sq``,
    ``_MAX_QPAD``) and its small-S UNet regime are TPU artifacts: the padded
    q rows are sliced off and the padded kv columns masked, so they change
    no number."""
    if causal or q.dim() != 4:
        return False
    d, sq, sk = q.shape[-1], q.shape[-2], k.shape[-2]
    if sq != sk or v.shape[-2] != sk or v.shape[-1] != d:
        return False
    if q.dtype != torch.bfloat16 or (d > 128 and d % 128):
        return False
    return sk >= STOCK_MIN_S


def _sp_route(q, k, v, scale, causal):
    """The attention through the sp ranks of the current mesh, or None
    where there is none or the shape does not divide it."""
    mesh = pmesh.current()
    if causal or mesh is None or mesh.size(pmesh.SP_AXIS) == 1:
        return None
    from ..parallel import ring_attention as ring
    if not ring.sp_compatible(mesh, q.shape[0], q.shape[1], q.shape[2],
                              k.shape[2], local=True):
        ring.warn_fallback(q.shape, k.shape)
        return None
    return ring.sp_attention(q, k, v, mesh, scale)


def attention(q, k, v, scale=None, causal: bool = False):
    """Route to a flash kernel where a gate allows, else the plain path.

    In the JAX package's order (``attention.py:172-199``): the K3 gate
    first, then the flash gate.  Past the K3 gate, head dims up to 128 run
    :func:`flash_attn_joint`; wider ones (the VAE mid-block's single
    512-wide head) run :func:`flash_attn_fwd_wide`, which computes the same
    function.  The sp route goes first."""
    o = _sp_route(q, k, v, scale, causal)
    if o is not None:
        return o
    if stock_eligible(q, k, v, causal):
        if q.shape[-1] <= 128:
            return fa.flash_attn_joint(q, k, v, scale)
        return fa.flash_attn_fwd_wide(q, k, v, scale)
    if flash_attention_compatible(q, k, v, causal):
        return fa.flash_attention(q, k, v, scale)
    return attention_xla(q, k, v, scale=scale, causal=causal)


def attention_t(q, k, v, scale=None, causal: bool = False):
    """The route of the JAX package's ``attention_t``
    (``attention.py:237-262``), which ``attn_mhead`` takes for the UNet's
    large self-attention: the flash gate only, never the K3 gate.  The port
    keeps v in its natural layout (the transposed-v layout is a TPU
    artifact).  The sp route goes first."""
    o = _sp_route(q, k, v, scale, causal)
    if o is not None:
        return o
    if flash_attention_compatible(q, k, v, causal):
        return fa.flash_attention(q, k, v, scale)
    return attention_xla(q, k, v, scale=scale, causal=causal)
