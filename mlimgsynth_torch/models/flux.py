"""Flux.1 rectified-flow transformer, schnell and dev (port of
``mlimgsynth_tpu/models/flux.py``).

19 double-stream blocks (image and text tokens each with their own
modulation, qkv and MLP, one joint attention over text ++ image) and 38
single-stream blocks (one linear for qkv and the MLP's input, one for the
attention output and the MLP's) at width 3072, 24 heads of 128; 3-axis
rotary position embeddings over (id, y, x) of adjacent pairs; per-head
RMSNorm of q and k; T5 context and the CLIP-L pooled row as conditioning;
dev adds an embedded guidance input in place of CFG.

``state_dict`` names are the internal names below the ``flux.`` prefix,
which are the bare BFL checkpoint names (``double_blocks.0.img_attn.qkv.
weight`` ...).  Skip-layer guidance leaves blocks out by index, DeepCache
runs the first double blocks alone (``dc_split``); under pipeline
parallelism (``set_stage``) a rank holds one stage of each block stack,
and under tensor parallelism each attention runs n_head / tp heads.  The
modulation vectors are products in the compute dtype taken to f32, and a
shift or scale is cast back to the activation's dtype before it multiplies
(``_mod_apply``); the RoPE rotation and the norms compute in f32.
Activations are [N, S, d] token streams; the latent at the boundary is
NCHW.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..parallel import pipeline as pipe
from . import blocks as B


@dataclass(frozen=True)
class FluxParams:
    """ref: ``FluxParams`` (``mlimgsynth_tpu/models/flux.py:29-62``)."""
    depth_double: int = 19
    depth_single: int = 38
    d_model: int = 3072
    n_head: int = 24
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    n_ch_in: int = 64           # packed 2x2 patches of the 16-ch latent
    n_ch_out: int = 64
    d_ctx_in: int = 4096        # T5's width
    d_pooled: int = 768         # CLIP-L's pooled row
    mlp_ratio: int = 4
    guidance_embed: bool = False   # dev: the distilled guidance input
    # fields the session and the sampler read (as on the other families)
    n_ctx: int = 4096
    clip_norm: bool = False
    uncond_empty_zero: bool = False
    n_step_train: int = 1000
    flow: bool = True
    flux: bool = True
    # the schedule's shift: 1 on schnell; dev's grows with the image
    # (``dynamic_flow_shift``) between exp(shift_base) at 256 patches and
    # exp(shift_max) at 4096
    flow_shift: float = 1.0
    shift_base: float = 0.5
    shift_max: float = 1.15
    dynamic_shift: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head


FLUX_SCHNELL = FluxParams()
FLUX_DEV = FluxParams(guidance_embed=True, dynamic_shift=True)


def dynamic_flow_shift(P: FluxParams, h_lat: int, w_lat: int) -> float:
    """exp(mu), mu linear in the count of packed 2x2 patches between
    (256, shift_base) and (4096, shift_max), for dev; ``flow_shift``
    otherwise (``flux.py:69-77``)."""
    if not P.dynamic_shift:
        return P.flow_shift
    seq = (h_lat // 2) * (w_lat // 2)
    m = (P.shift_max - P.shift_base) / (4096 - 256)
    return float(math.exp(P.shift_base + m * (seq - 256)))


def rope_tables(P: FluxParams, hp: int, wp: int, s_txt: int):
    """(cos, sin), f32 numpy [s_txt + hp wp, d_head / 2], of the text ++
    image sequence (``flux.py:80-100``): the angles in float64 on the
    host, axis by axis; text ids are zero, image ids (0, y, x)."""
    ids = np.zeros((s_txt + hp * wp, 3), np.float64)
    yy, xx = np.mgrid[0:hp, 0:wp]
    ids[s_txt:, 1] = yy.reshape(-1)
    ids[s_txt:, 2] = xx.reshape(-1)
    parts_cos, parts_sin = [], []
    for ax, dim in enumerate(P.axes_dim):
        half = dim // 2
        freqs = 1.0 / (P.theta ** (np.arange(half, dtype=np.float64) * 2
                                   / dim))
        ang = ids[:, ax:ax + 1] * freqs[None, :]
        parts_cos.append(np.cos(ang))
        parts_sin.append(np.sin(ang))
    return (np.concatenate(parts_cos, axis=-1).astype(np.float32),
            np.concatenate(parts_sin, axis=-1).astype(np.float32))


def rope_apply(x, cos, sin):
    """x [N, H, S, D]: each adjacent pair (x[2i], x[2i+1]) rotated by its
    position's angle, in f32, cast back to x's dtype (``_rope_apply``,
    ``flux.py:103-114``)."""
    xf = x.float()
    x_even, x_odd = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x_even * cos - x_odd * sin,
                       x_even * sin + x_odd * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# LayerNorm without parameters, f32, eps 1e-6 (``_ln``, ``flux.py:166-170``)
_ln = B.LayerNorm(0, eps=1e-6, affine=False)


class _QKNorm(nn.Module):
    def __init__(self, d_head: int):
        super().__init__()
        self.query_norm = B.RMSNorm(d_head, "scale")
        self.key_norm = B.RMSNorm(d_head, "scale")


def _heads(y, n_head: int):
    """[N, S, 3 d] fused product -> q, k, v [N, H, S, D] views
    (``_qkv_split``, ``flux.py:129-138``)."""
    n, s, _ = y.shape
    y = y.view(n, s, 3, n_head, -1).permute(2, 0, 3, 1, 4)
    return y[0], y[1], y[2]


class _SelfAttn(nn.Module):
    """A double block's stream attention: ``qkv``, ``norm``, ``proj``."""

    def __init__(self, P: FluxParams):
        super().__init__()
        self.qkv = B.linear(P.d_model, 3 * P.d_model)
        self.norm = _QKNorm(P.d_head)
        self.proj = B.linear(P.d_model, P.d_model)

    def qkv_split(self, x, n_head: int):
        q, k, v = _heads(self.qkv(x), n_head)
        return self.norm.query_norm(q), self.norm.key_norm(k), v

    def out(self, o):
        n, h, s, dh = o.shape
        return self.proj(o.transpose(1, 2).reshape(n, s, h * dh))


class _Modulation(nn.Module):
    """SiLU(vec) -> ``lin`` -> ``n`` f32 [N, d] chunks (``_modulation``,
    ``flux.py:153-158``): the product in the compute dtype."""

    def __init__(self, d: int, n: int):
        super().__init__()
        self.n = n
        self.lin = B.linear(d, n * d)

    def forward(self, vec):
        return self.lin(F.silu(vec)).float().chunk(self.n, dim=-1)


class _Mlp(nn.ModuleDict):
    """``{img,txt}_mlp.{0,2}``: linear, tanh-GELU, linear."""

    def __init__(self, P: FluxParams):
        d = P.d_model
        super().__init__({"0": B.linear(d, P.mlp_ratio * d),
                          "2": B.linear(P.mlp_ratio * d, d)})

    def forward(self, x):
        return self["2"](B.gelu_tanh(self["0"](x)))


class DoubleBlock(nn.Module):
    """ref: ``double_block`` (``flux.py:173-208``): separate image and
    text modulation, qkv and MLP; one attention over text ++ image with
    RoPE."""

    def __init__(self, P: FluxParams):
        super().__init__()
        self.n_head = P.n_head
        self.img_mod = _Modulation(P.d_model, 6)
        self.txt_mod = _Modulation(P.d_model, 6)
        self.img_attn = _SelfAttn(P)
        self.txt_attn = _SelfAttn(P)
        self.img_mlp = _Mlp(P)
        self.txt_mlp = _Mlp(P)

    def forward(self, img, txt, vec, cos, sin):
        im = self.img_mod(vec)
        tm = self.txt_mod(vec)
        iq, ik, iv = self.img_attn.qkv_split(
            B.modulate(_ln(img), im[0], im[1]), self.n_head)
        tq, tk, tv = self.txt_attn.qkv_split(
            B.modulate(_ln(txt), tm[0], tm[1]), self.n_head)
        st = txt.shape[1]
        q = rope_apply(torch.cat([tq, iq], dim=2), cos, sin)
        k = rope_apply(torch.cat([tk, ik], dim=2), cos, sin)
        o = attention(q, k, torch.cat([tv, iv], dim=2))
        img = img + im[2][:, None, :].to(img.dtype) * self.img_attn.out(
            o[:, :, st:])
        img = img + im[5][:, None, :].to(img.dtype) * self.img_mlp(
            B.modulate(_ln(img), im[3], im[4]))
        txt = txt + tm[2][:, None, :].to(txt.dtype) * self.txt_attn.out(
            o[:, :, :st])
        txt = txt + tm[5][:, None, :].to(txt.dtype) * self.txt_mlp(
            B.modulate(_ln(txt), tm[3], tm[4]))
        return img, txt


class SingleBlock(nn.Module):
    """ref: ``single_block`` (``flux.py:211-232``): ``linear1`` gives qkv
    (3 d) and the MLP's input (4 d) from one modulated norm; ``linear2``
    takes the attention output beside tanh-GELU of the MLP input."""

    def __init__(self, P: FluxParams):
        super().__init__()
        d = P.d_model
        self.n_head = P.n_head
        self.d_head = P.d_head
        self.modulation = _Modulation(d, 3)
        self.linear1 = B.linear(d, 3 * d + P.mlp_ratio * d)
        self.linear2 = B.linear(d + P.mlp_ratio * d, d)
        self.norm = _QKNorm(P.d_head)

    def forward(self, x, vec, cos, sin):
        shift, scale, gate = self.modulation(vec)
        y = self.linear1(B.modulate(_ln(x), shift, scale))
        d3 = 3 * self.n_head * self.d_head     # this rank's q, k, v
        q, k, v = _heads(y[..., :d3], self.n_head)
        q = rope_apply(self.norm.query_norm(q), cos, sin)
        k = rope_apply(self.norm.key_norm(k), cos, sin)
        o = attention(q, k, v)
        n, h, s, dh = o.shape
        o = o.transpose(1, 2).reshape(n, s, h * dh)
        out = self.linear2(torch.cat([o, B.gelu_tanh(y[..., d3:])],
                                     dim=-1))
        return x + gate[:, None, :].to(x.dtype) * out


class _MlpEmbedder(nn.Module):
    """``MLPEmbedder``: ``in_layer``, SiLU, ``out_layer``."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.in_layer = B.linear(d_in, d)
        self.out_layer = B.linear(d, d)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class _FinalLayer(nn.Module):
    def __init__(self, P: FluxParams):
        super().__init__()
        self.adaLN_modulation = nn.ModuleDict(
            {"1": B.linear(P.d_model, 2 * P.d_model)})
        self.linear = B.linear(P.d_model, P.n_ch_out)


class Flux(nn.Module):
    """ref: ``flux_apply`` (``flux.py:246-386``).  ``state_dict`` names
    are the internal names without the ``flux.`` prefix."""

    def __init__(self, P: FluxParams):
        super().__init__()
        self.P = P
        d = P.d_model
        self.img_in = B.linear(P.n_ch_in, d)
        self.txt_in = B.linear(P.d_ctx_in, d)
        self.time_in = _MlpEmbedder(256, d)
        if P.guidance_embed:
            self.guidance_in = _MlpEmbedder(256, d)
        self.vector_in = _MlpEmbedder(P.d_pooled, d)
        self.double_blocks = nn.ModuleList(
            DoubleBlock(P) for _ in range(P.depth_double))
        self.single_blocks = nn.ModuleList(
            SingleBlock(P) for _ in range(P.depth_single))
        self.final_layer = _FinalLayer(P)
        self._rope = {}
        # this rank's pipeline stage (``set_stage``), None without --pp
        self.stage = None

    def set_stage(self, stage: pipe.Stage) -> None:
        """Keep only ``stage``'s share of each block stack (on the meta
        device, before the weights are read) and run both stacks as
        pipelines, double then single (``flux.py:296-338``); the stages
        are the JAX package's padded partition without its identity
        blocks, so the last ones may hold fewer blocks."""
        for blocks, depth in ((self.double_blocks, self.P.depth_double),
                              (self.single_blocks, self.P.depth_single)):
            pipe.keep_stage(blocks, *pipe.stage_range(depth, stage.n,
                                                      stage.index))
        self.stage = stage

    def rope(self, hp: int, wp: int, s_txt: int, device):
        """The RoPE tables of a sequence, on ``device`` (kept per shape)."""
        key = (hp, wp, s_txt, str(device))
        if key not in self._rope:
            self._rope[key] = tuple(torch.from_numpy(t).to(device) for t in
                                    rope_tables(self.P, hp, wp, s_txt))
        return self._rope[key]

    def forward(self, x, t, cond, pooled, guidance=None, skip_layers=(),
                want_cache: bool = False, use_cache=None):
        """x: [N, C, H, W] latent, t: [N] timesteps (sigma * 1000), cond:
        [N, S, d_ctx_in] T5 rows, pooled: [N, d_pooled] CLIP-L's pooled
        row, ``guidance``: [N] embedded-guidance values (dev; None is 0)
        -> the velocity [N, C, H, W] in the parameters' dtype.  The blocks
        whose indices ``skip_layers`` names are left out: 0 .. depth_double
        - 1 the double blocks, then the single blocks (``flux.py:254-256``,
        ``:346-367``).  DeepCache (``flux.py:258-264``, ``:346-371``):
        ``want_cache`` also returns the residual of the joint (text ++
        image) stream after the first :func:`dc_split` double blocks;
        ``use_cache`` (that residual) runs only those blocks and adds
        it."""
        P = self.P
        dtype = self.img_in.weight.dtype
        n, cl, hh, ww = x.shape
        hp, wp = hh // 2, ww // 2
        # pack 2x2 patches -> [N, hp wp, 4 C], in the JAX package's order
        # (dy, dx, c)
        img = x.to(dtype).view(n, cl, hp, 2, wp, 2).permute(0, 2, 4, 3, 5, 1)
        img = self.img_in(img.reshape(n, hp * wp, 4 * cl))
        txt = self.txt_in(cond.to(dtype))
        tf = t.float() / float(P.n_step_train)
        vec = self.time_in(B.timestep_embedding(tf * 1000.0, 256).to(dtype))
        if P.guidance_embed:
            g = (torch.zeros(n, device=x.device) if guidance is None
                 else guidance.float().expand(n))
            vec = vec + self.guidance_in(
                B.timestep_embedding(g * 1000.0, 256).to(dtype))
        vec = vec + self.vector_in(pooled.to(dtype))
        s_txt = cond.shape[1]
        cos, sin = self.rope(hp, wp, s_txt, x.device)
        dc = want_cache or use_cache is not None
        if self.stage is not None:
            if dc or skip_layers:
                # backstops: the session refuses both under a mesh
                raise ValueError("deepcache and skip-layer guidance are "
                                 "not supported with --pp")
            dbl = pipe.present(self.double_blocks)
            sgl = pipe.present(self.single_blocks)

            def dfn(acts):          # the joint (txt ++ img) stream
                xx_, vec_ = acts
                img_, txt_ = xx_[:, s_txt:], xx_[:, :s_txt]
                for blk in dbl:
                    img_, txt_ = blk(img_, txt_, vec_, cos, sin)
                return torch.cat([txt_, img_], dim=1), vec_

            def sfn(acts):
                xx_, vec_ = acts
                for blk in sgl:
                    xx_ = blk(xx_, vec_, cos, sin)
                return xx_, vec_

            xx = torch.cat([txt, img], dim=1)
            xx = pipe.pipeline_apply(self.stage, dfn, (xx, vec))
            xx = pipe.pipeline_apply(self.stage, sfn, (xx, vec))
            return self._final(xx[:, s_txt:], vec, n, cl, hh, ww)
        if dc and skip_layers:
            raise ValueError("deepcache: incompatible with skip_layers")
        split = dc_split(P.depth_double) if dc else P.depth_double
        for i, blk in enumerate(self.double_blocks[:split]):
            if i not in skip_layers:
                img, txt = blk(img, txt, vec, cos, sin)
        xx = torch.cat([txt, img], dim=1)
        shallow = xx
        if use_cache is not None:
            xx = xx + use_cache.to(xx.dtype)
        else:
            for i, blk in enumerate(self.double_blocks[split:], split):
                if i not in skip_layers:
                    img, txt = blk(img, txt, vec, cos, sin)
            if split < P.depth_double:
                xx = torch.cat([txt, img], dim=1)
            for i, blk in enumerate(self.single_blocks, P.depth_double):
                if i not in skip_layers:
                    xx = blk(xx, vec, cos, sin)
        cache = xx - shallow if want_cache else None
        img = self._final(xx[:, s_txt:], vec, n, cl, hh, ww)
        return (img, cache) if want_cache else img

    def _final(self, img, vec, n: int, cl: int, hh: int, ww: int):
        """The final layer and the unpack [N, hp wp, 4 C] ->
        [N, C, H, W]."""
        fl = self.final_layer
        shift, scale = fl.adaLN_modulation["1"](F.silu(vec)).float().chunk(
            2, dim=-1)
        img = fl.linear(B.modulate(_ln(img), shift, scale))
        img = img.view(n, hh // 2, ww // 2, 2, 2, cl).permute(
            0, 5, 1, 3, 2, 4)
        return img.reshape(n, cl, hh, ww)


def dc_split(depth_double: int) -> int:
    """DeepCache's split: the first ``max(1, depth_double // 8)`` double
    blocks always run (``_dc_split``, ``flux.py:234-243``)."""
    return max(1, depth_double // 8)


def denoise(model: Flux, x, sigma, t, cond, label, skip_layers=(),
            want_cache: bool = False, use_cache=None):
    """Rectified-flow wrapper (``denoise``, ``flux.py:389-411``): the
    velocity is the solver's derivative; ``t`` is ``sigma *
    n_step_train``, scalar or [N]; on dev the label's column ``d_pooled``
    is the embedded-guidance value.  Returns f32."""
    P = model.P
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=x.device).expand(x.shape[0])
    guidance = None
    if P.guidance_embed:
        guidance = label[:, P.d_pooled].float()
        label = label[:, :P.d_pooled]
    out = model(x, t, cond, label, guidance, skip_layers, want_cache,
                use_cache)
    if want_cache:
        return out[0].float(), out[1]
    return out.float()
