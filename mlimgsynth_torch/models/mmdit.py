"""MMDiT diffusion transformer, SD3-medium, SD3.5-large and SD3.5-medium
(port of ``mlimgsynth_tpu/models/mmdit.py``).

``state_dict`` names match the internal scheme below the ``mmdit.`` prefix
(``joint_blocks.N.x_block.attn.qkv.weight`` ...), which is the sd3
single-file layout's.  SD3.5 adds the per-head RMSNorm of q and k
(``qk_norm``, ``attn.ln_q`` / ``attn.ln_k``) and, on medium (MMDiT-X), a
second latent-only self-attention (``x_block.attn2``) in the first 13
blocks.  Skip-layer guidance leaves joint blocks out by index.  Not
ported: the block cache, pipeline-stacked blocks.  The fused qkv stays
one linear (one product, and one quantized weight on the q8 path, as the
JAX package's ``_qkv`` ``B.linear`` branch, ``:139-148``).  Activations are
[N, S, d] token streams; the latent at the boundary is NCHW.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from . import blocks as B


@dataclass(frozen=True)
class MmditParams:
    """ref: ``mlimgsynth_tpu/models/mmdit.py:35-76``.  Width is
    ``64 * depth`` with ``depth`` heads of 64 unless given."""
    depth: int = 24
    d_model: int = 0            # 0 -> 64 * depth
    n_head: int = 0             # 0 -> depth
    patch: int = 2
    n_ch_in: int = 16
    n_ch_out: int = 16
    d_ctx_in: int = 4096        # context token width (T5's; CLIP padded)
    d_pooled: int = 2048        # pooled conditioning width (CLIP-L + bigG)
    pos_embed_max: int = 192    # side of the learned pos-embed grid
    d_t_embed: int = 256
    qk_norm: bool = False       # RMSNorm on per-head q and k (SD3.5)
    # MMDiT-X (SD3.5-medium): the blocks whose x-block carries a second
    # self-attention over the latent tokens only (attn2, a 9-chunk adaLN)
    x_self_attn_layers: Tuple[int, ...] = ()
    # fields shared with UnetParams that the session and sampler read
    n_ctx: int = 4096
    clip_norm: bool = False
    n_step_train: int = 1000
    flow: bool = True
    flow_shift: float = 3.0

    @property
    def width(self) -> int:
        return self.d_model or 64 * self.depth

    @property
    def heads(self) -> int:
        return self.n_head or self.depth


MMDIT_SD3_MEDIUM = MmditParams(depth=24)
# ``mlimgsynth_tpu/models/mmdit.py:79-84``: large is 38 blocks of width 2432
# with qk-norm; medium is SD3-medium's geometry with qk-norm, a 384-side
# pos-embed grid and MMDiT-X in blocks 0-12
MMDIT_SD35_LARGE = MmditParams(depth=38, qk_norm=True)
MMDIT_SD35_MEDIUM = MmditParams(depth=24, qk_norm=True, pos_embed_max=384,
                                x_self_attn_layers=tuple(range(13)))


def _linear_f32(lin, x):
    """``B.linear`` on the f32 conditioning vector (``_block_mod``): the
    product in f32, as the JAX package casts the weight to the input's
    type.  A quantized linear takes its input in the compute dtype, which
    its kernels require, and returns f32."""
    if isinstance(lin, nn.Linear):
        return F.linear(x, lin.weight.float(),
                        None if lin.bias is None else lin.bias.float())
    dtype = lin.bias.dtype if lin.bias is not None else torch.bfloat16
    return lin(x.to(dtype)).float()


class _AdaLN(nn.Module):
    """adaLN modulation: SiLU(c) -> linear -> ``n`` f32 [N, d] chunks
    (``_block_mod``).  Named ``adaLN_modulation.1``."""

    def __init__(self, d: int, n: int):
        super().__init__()
        self.n = n
        self.adaLN_modulation = nn.ModuleDict({"1": B.linear(d, n * d)})

    def mods(self, c):
        y = _linear_f32(self.adaLN_modulation["1"], F.silu(c))
        return y.chunk(self.n, dim=-1)


class _Attn(nn.Module):
    def __init__(self, d: int, proj: bool, d_head: int = 0):
        super().__init__()
        self.qkv = B.linear(d, 3 * d)
        if proj:
            self.proj = B.linear(d, d)
        if d_head:      # qk-norm
            self.ln_q = B.RMSNorm(d_head)
            self.ln_k = B.RMSNorm(d_head)

    def heads(self, x, n_head: int):
        """[N, S, d] -> q, k, v [N, H, S, D], views of one fused product,
        q and k normed per head under qk-norm (``_qkv``,
        ``mmdit.py:101-148``)."""
        y = self.qkv(x)
        n, s, _ = y.shape
        y = y.view(n, s, 3, n_head, -1).permute(2, 0, 3, 1, 4)
        q, k, v = y[0], y[1], y[2]
        if hasattr(self, "ln_q"):
            q, k = self.ln_q(q), self.ln_k(k)
        return q, k, v

    def out(self, o):
        """[N, H, S, D] attention output -> [N, S, d] through ``proj``."""
        n, h, s, dh = o.shape
        return self.proj(o.transpose(1, 2).reshape(n, s, h * dh))


class _Mlp(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1 = B.linear(d, 4 * d)
        self.fc2 = B.linear(4 * d, d)

    def forward(self, x):
        return self.fc2(B.gelu_tanh(self.fc1(x)))


class _Stream(_AdaLN):
    """One stream of a joint block (``context_block`` or ``x_block``);
    ``pre_only`` (the last block's context side) feeds the attention and
    ends there; ``x_self_attn`` (MMDiT-X) adds ``attn2`` and three more
    adaLN chunks."""

    def __init__(self, P: MmditParams, pre_only: bool,
                 x_self_attn: bool = False):
        super().__init__(P.width, 2 if pre_only else
                         9 if x_self_attn else 6)
        self.pre_only = pre_only
        d_head = P.width // P.heads if P.qk_norm else 0
        self.norm1 = B.LayerNorm(P.width, eps=1e-6, affine=False)
        self.attn = _Attn(P.width, not pre_only, d_head)
        if x_self_attn:
            self.attn2 = _Attn(P.width, True, d_head)
        if not pre_only:
            self.norm2 = B.LayerNorm(P.width, eps=1e-6, affine=False)
            self.mlp = _Mlp(P.width)

    def post(self, x, o, gate, shift2, scale2, gate2, extra=None):
        """Residual updates after the attention: proj, then ``extra`` (the
        gated MMDiT-X branch, added before ``norm2``), then the MLP."""
        dt = x.dtype
        x = x + gate[:, None, :].to(dt) * self.attn.out(o)
        if extra is not None:
            x = x + extra
        xn = B.modulate(self.norm2(x), shift2, scale2)
        return x + gate2[:, None, :].to(dt) * self.mlp(xn)


class JointBlock(nn.Module):
    """ref: ``joint_block`` (``mmdit.py:181-248``): both streams project
    q/k/v, one attention runs over the concatenated sequence (context
    tokens first), the outputs split back per stream.  With
    ``x_self_attn`` the x-stream also runs ``attn2`` over its own tokens,
    off the same ``norm1`` output with its own shift and scale."""

    def __init__(self, P: MmditParams, ctx_pre_only: bool,
                 x_self_attn: bool = False):
        super().__init__()
        self.n_head = P.heads
        self.context_block = _Stream(P, ctx_pre_only)
        self.x_block = _Stream(P, False, x_self_attn)

    def forward(self, cx, x, c):
        cb, xb = self.context_block, self.x_block
        cm = cb.mods(c)
        xm = xb.mods(c)
        cq, ck, cv = cb.attn.heads(B.modulate(cb.norm1(cx), cm[0], cm[1]),
                                   self.n_head)
        xn0 = xb.norm1(x)
        xq, xk, xv = xb.attn.heads(B.modulate(xn0, xm[0], xm[1]),
                                   self.n_head)
        sc = cx.shape[1]
        o = attention(torch.cat([cq, xq], dim=2), torch.cat([ck, xk], dim=2),
                      torch.cat([cv, xv], dim=2))
        extra = None
        if len(xm) == 9:    # MMDiT-X: attn2 over the latent tokens
            o2 = attention(*xb.attn2.heads(B.modulate(xn0, xm[6], xm[7]),
                                           self.n_head))
            extra = xm[8][:, None, :].to(x.dtype) * xb.attn2.out(o2)
        x = xb.post(x, o[:, :, sc:], *xm[2:6], extra=extra)
        if cb.pre_only:
            return None, x
        return cb.post(cx, o[:, :, :sc], *cm[2:]), x


class _Embedder(nn.Module):
    """``{t,y}_embedder.mlp.{0,2}``: linear, SiLU, linear."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.mlp = nn.ModuleDict({"0": B.linear(d_in, d),
                                  "2": B.linear(d, d)})

    def forward(self, x):
        return self.mlp["2"](F.silu(self.mlp["0"](x)))


class _PatchEmbed(nn.Module):
    def __init__(self, P: MmditParams):
        super().__init__()
        self.proj = B.conv2d(P.n_ch_in, P.width, kernel=P.patch,
                             stride=P.patch, pad=0)


class _FinalLayer(_AdaLN):
    def __init__(self, P: MmditParams):
        super().__init__(P.width, 2)
        self.norm_final = B.LayerNorm(P.width, eps=1e-6, affine=False)
        self.linear = B.linear(P.width, P.patch * P.patch * P.n_ch_out)


class MMDiT(nn.Module):
    """ref: ``mmdit_apply`` (``mmdit.py:273-387``).  ``state_dict`` names
    are the internal names without the ``mmdit.`` prefix."""

    def __init__(self, P: MmditParams):
        super().__init__()
        self.P = P
        g = P.pos_embed_max
        self.x_embedder = _PatchEmbed(P)
        self.pos_embed = nn.Parameter(torch.empty(1, g * g, P.width))
        self.t_embedder = _Embedder(P.d_t_embed, P.width)
        self.y_embedder = _Embedder(P.d_pooled, P.width)
        self.context_embedder = B.linear(P.d_ctx_in, P.width)
        self.joint_blocks = nn.ModuleList(
            JointBlock(P, i == P.depth - 1, i in P.x_self_attn_layers)
            for i in range(P.depth))
        self.final_layer = _FinalLayer(P)

    def _pos_embed_crop(self, hp: int, wp: int):
        """Center crop of the pos-embed grid to [hp, wp] patches
        (``_pos_embed_crop``, ``mmdit.py:251-260``)."""
        g = self.P.pos_embed_max
        pe = self.pos_embed.view(g, g, -1)
        top, left = (g - hp) // 2, (g - wp) // 2
        return pe[top:top + hp, left:left + wp].reshape(1, hp * wp, -1)

    def forward(self, x, t, cond, pooled, skip_layers=()):
        """x: [N, C, H, W] latent, t: [N] timesteps (0..1000 scale), cond:
        [N, S, d_ctx_in] context tokens, pooled: [N, d_pooled] -> the
        velocity [N, C, H, W] in the parameters' dtype.  The joint blocks
        whose indices ``skip_layers`` names are left out (skip-layer
        guidance's degraded pass, ``mmdit.py:280-284``, ``:360-366``)."""
        P = self.P
        dtype = self.pos_embed.dtype
        n, _, h, w = x.shape
        p = P.patch
        hp, wp = h // p, w // p
        xe = self.x_embedder.proj(x.to(dtype)).flatten(2).transpose(1, 2)
        xe = xe + self._pos_embed_crop(hp, wp).to(dtype)
        te = self.t_embedder(B.timestep_embedding(t, P.d_t_embed).to(dtype))
        ye = self.y_embedder(pooled.to(dtype))
        c = (te + ye).float()
        cx = self.context_embedder(cond.to(dtype))
        for i, blk in enumerate(self.joint_blocks):
            if i not in skip_layers:
                cx, xe = blk(cx, xe, c)
        fl = self.final_layer
        shift, scale = fl.mods(c)
        xe = fl.linear(B.modulate(fl.norm_final(xe), shift, scale))
        # unpatchify [N, hp*wp, p*p*C] -> [N, C, H, W]
        out = xe.view(n, hp, wp, p, p, P.n_ch_out)
        return out.permute(0, 5, 1, 3, 2, 4).reshape(n, P.n_ch_out,
                                                      hp * p, wp * p)


def denoise(model: MMDiT, x, sigma, t, cond, label, skip_layers=()):
    """Rectified-flow wrapper (``denoise``, ``mmdit.py:390-408``): the
    model predicts the velocity ``noise - x0 = dx/dsigma``, so its output
    is the solver's derivative with no input or output scaling; ``t`` is
    ``sigma * n_step_train``, scalar or [N].  Returns f32."""
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=x.device).expand(x.shape[0])
    return model(x, t, cond, label, skip_layers).float()
