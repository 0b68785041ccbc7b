"""Sequence-parallel attention over the ``sp`` ranks (port of
``mlimgsynth_tpu/parallel/ring_attention.py``).

- **Ring attention** (self or joint attention, Sq == Sk): each rank holds
  S/sp rows of q, k and v.  ``sp - 1`` steps each fold the resident k/v
  block into an online softmax and pass it one hop around the ring
  (:func:`comm.ring_shift`); the last resident block is folded after the
  loop, so exactly ``sp - 1`` hops are made.
- **Q-sharded cross attention** (a short context): q is split over the
  ranks, k and v are whole on each; no collective.

The block products are plain matrix products, as the JAX package's
einsums outside any Pallas kernel: logits and softmax statistics in f32,
the PV product of p cast to v's dtype with f32 accumulation.  The
transposed-v variants (``ring_attention_t``, ``sp_cross_attention_t``) are
a TPU layout and are not ported.
"""
from __future__ import annotations

import torch

from ..utils.log import g_logger as log
from . import comm
from .mesh import DP_AXIS, SP_AXIS, TP_AXIS


def _fold(q, kc, vc, m, l, o, scale):
    """One online-softmax step over the block (kc, vc)."""
    s = torch.matmul(q.float(), kc.float().transpose(-1, -2)) * scale
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(vc.dtype).float(), vc.float())
    return m_new, l_new, o * alpha + pv


def ring_attention(q, k, v, ranks, group, scale=None):
    """Self-attention over a sequence split across the ring ``ranks``
    (global ranks in sp order, ``group`` their process group): q, k, v are
    this rank's [B, H, S/sp, D] rows; returns its rows of the output in
    q's dtype (``ring_attention``, ``ring_attention.py:57-106``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bq = q.shape[:3] + (1,)
    m = torch.full(bq, float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros(bq, dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32,
                    device=q.device)
    kc, vc = k, v
    for _ in range(len(ranks) - 1):
        m, l, o = _fold(q, kc, vc, m, l, o, scale)
        kc, vc = comm.ring_shift((kc, vc), ranks, group)
    m, l, o = _fold(q, kc, vc, m, l, o, scale)    # the last block: no hop
    return (o / l).to(q.dtype)


def sp_cross_attention(q, k, v, scale=None):
    """Cross attention of this rank's q rows against the whole k and v
    (``sp_cross_attention``, ``ring_attention.py:109-127``): plain softmax
    attention, the probabilities in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def sp_compatible(mesh, b: int, h: int, sq: int, sk: int,
                  local: bool = False) -> bool:
    """True when (b, h, sq) divide the mesh's (dp, tp, sp) axes
    (``sp_compatible``, ``ring_attention.py:210-223``).  ``local``: b and
    h are this rank's share already (the port slices the batch over dp
    and loads n_head/tp heads before attention), so only the sequence is
    checked."""
    dp = 1 if local else mesh.shape.get(DP_AXIS, 1)
    tp = 1 if local else mesh.shape.get(TP_AXIS, 1)
    sp = mesh.shape.get(SP_AXIS, 1)
    if b % dp or h % tp or sq % sp:
        return False
    if sq == sk:
        return sk % sp == 0
    return True


_FALLBACK_SEEN: set = set()


def warn_fallback(q_shape, k_shape) -> None:
    """Say once a shape that ``sp`` was asked for but that cannot ride the
    ring takes the replicated path (the JAX package's
    ``_warn_sp_fallback``, ``ops/attention.py:99-113``)."""
    key = (tuple(q_shape), tuple(k_shape))
    if key in _FALLBACK_SEEN:
        return
    _FALLBACK_SEEN.add(key)
    log.warning(f"sp: attention q{tuple(q_shape)} x kv{tuple(k_shape)} "
                "does not divide the sp mesh axis; falling back to the "
                "replicated path for this shape (no ring attention)")


def sp_attention(q, k, v, mesh, scale=None):
    """Attention of whole (replicated) q, k, v [B, H, S, D] through the sp
    ranks: this rank takes its S/sp rows of q (and, for the ring, of k and
    v), and the output rows are gathered back over the sp group."""
    sp, r = mesh.size(SP_AXIS), mesh.index(SP_AXIS)
    group = mesh.group(SP_AXIS)
    sq = q.shape[2] // sp
    rows = slice(r * sq, (r + 1) * sq)
    if q.shape[2] == k.shape[2]:
        o = ring_attention(q[:, :, rows], k[:, :, rows], v[:, :, rows],
                           mesh.ranks(SP_AXIS), group, scale)
    else:
        o = sp_cross_attention(q[:, :, rows], k, v, scale)
    return comm.all_gather(o, group, dim=2)
