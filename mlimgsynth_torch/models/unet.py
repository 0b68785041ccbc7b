"""Stable Diffusion UNet (port of ``mlimgsynth_tpu/models/unet.py``).

Parameter names below the ``unet.`` prefix match the JAX package's internal
scheme (``in.1.1.transf.0.attn2.k_proj.weight`` ...).  NCHW activations;
CFG runs as one batched forward (cond and uncond rows stacked).  SDXL's
label (the pooled text feature and the size embeddings) enters through
``label_embed``, added to the time embedding.  SD2.1 is SD1's UNet with
heads of 64, a 1024-wide context and v-prediction (``denoise``).  Not ported: FreeU,
ControlNet, DeepCache and PAG.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from . import blocks as B


@dataclass(frozen=True)
class UnetParams:
    """ref: src/unet.c:21-83."""
    n_ch_in: int = 4
    n_ch_out: int = 4
    n_res_blk: int = 2
    attn_res: Tuple[int, ...] = (4, 2, 1)
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    transf_depth: Tuple[int, ...] = (1, 1, 1, 1)
    n_te: int = 1280
    n_head: int = 0
    d_head: int = 0
    n_ctx: int = 768
    n_ch: int = 320
    # width of the label vector (0: no label embedding)
    ch_adm_in: int = 0
    clip_norm: bool = True
    # conditioned on a label built from the text encoders (SDXL)
    cond_label: bool = False
    # CFG with an empty negative prompt conditions on zero context rows
    uncond_empty_zero: bool = False
    vparam: bool = False


UNET_SD1 = UnetParams(n_head=8, n_ctx=768)
# SD2.1-768-v: heads of 64 (5, 10, 20 by width), the OpenCLIP ViT-H
# context, v-prediction
UNET_SD2 = UnetParams(d_head=64, n_ctx=1024, vparam=True)
UNET_SDXL = UnetParams(
    attn_res=(4, 2), ch_mult=(1, 2, 4), transf_depth=(1, 2, 10),
    d_head=64, n_ctx=2048, ch_adm_in=2816, clip_norm=False,
    cond_label=True, uncond_empty_zero=True)


def _n_head(P: UnetParams, d_embed: int) -> int:
    return P.n_head or d_embed // P.d_head


class SpatialTransformer(nn.Module):
    """ref: mlb_spatial_transf.  x: [N, C, H, W], cond: [N, S_ctx, n_ctx]."""

    def __init__(self, ch: int, P: UnetParams, depth: int):
        super().__init__()
        self.norm = B.GroupNorm(ch)
        self.proj_in = B.conv2d(ch, ch, 1, 1, 0)
        self.transf = nn.ModuleList(
            B.BasicTransformer(ch, P.n_ctx, _n_head(P, ch))
            for _ in range(depth))
        self.proj_out = B.conv2d(ch, ch, 1, 1, 0)

    def forward(self, x, cond):
        n, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        y = y.flatten(2).transpose(1, 2)            # [N, HW, C]
        for blk in self.transf:
            y = blk(y, cond)
        y = y.transpose(1, 2).reshape(n, c, h, w)
        return self.proj_out(y) + x


class UNet(nn.Module):
    """ref: mlb_unet_denoise + mlb_unet__in/__mid/__out.  ``state_dict``
    names are the internal names without the ``unet.`` prefix."""

    def __init__(self, P: UnetParams):
        super().__init__()
        self.P = P
        self.time_embed = nn.ModuleDict({"0": B.linear(P.n_ch, P.n_te),
                                         "2": B.linear(P.n_te, P.n_te)})
        if P.ch_adm_in:
            self.label_embed = nn.ModuleDict(
                {"0": B.linear(P.ch_adm_in, P.n_te),
                 "2": B.linear(P.n_te, P.n_te)})
        n_levels = len(P.ch_mult)
        blocks_in = {"conv": B.conv2d(P.n_ch_in, P.n_ch)}
        skip_ch = [P.n_ch]
        ch, ds, i_blk = P.n_ch, 1, 0
        for im in range(n_levels):
            if im:
                ds *= 2
                i_blk += 1
                blocks_in[str(i_blk)] = nn.ModuleDict(
                    {"0": B.Downsample(ch, ch)})
                skip_ch.append(ch)
            for _ in range(P.n_res_blk):
                i_blk += 1
                ch_out = P.n_ch * P.ch_mult[im]
                blk = {"0": B.Resnet(ch, ch_out, P.n_te)}
                ch = ch_out
                if ds in P.attn_res:
                    blk["1"] = SpatialTransformer(ch, P, P.transf_depth[im])
                blocks_in[str(i_blk)] = nn.ModuleDict(blk)
                skip_ch.append(ch)
        self.add_module("in", nn.ModuleDict(blocks_in))
        self.mid = nn.ModuleDict({
            "0": B.Resnet(ch, ch, P.n_te),
            "1": SpatialTransformer(ch, P, P.transf_depth[-1]),
            "2": B.Resnet(ch, ch, P.n_te)})
        blocks_out = {}
        i_oblk = 0
        for im in range(n_levels - 1, -1, -1):
            ch_out = P.n_ch * P.ch_mult[im]
            for j in range(P.n_res_blk + 1):
                blk = {"0": B.Resnet(ch + skip_ch.pop(), ch_out, P.n_te)}
                ch = ch_out
                if ds in P.attn_res:
                    blk[str(len(blk))] = SpatialTransformer(
                        ch, P, P.transf_depth[im])
                if im != 0 and j == P.n_res_blk:
                    blk[str(len(blk))] = B.Upsample(ch, ch)
                    ds //= 2
                blocks_out[str(i_oblk)] = nn.ModuleDict(blk)
                i_oblk += 1
        blocks_out["norm"] = B.GroupNorm(ch)
        blocks_out["conv"] = B.conv2d(ch, P.n_ch_out)
        self.out = nn.ModuleDict(blocks_out)

    def embed(self, t, label=None):
        """ref: mlb_unet__embed (``unet_embed``).  t: [N] continuous train
        step; label: [N, ch_adm_in] or None."""
        dtype = self._modules["in"]["conv"].weight.dtype
        emb = B.timestep_embedding(t, self.P.n_ch).to(dtype)
        emb = self.time_embed["2"](B.silu(self.time_embed["0"](emb)))
        if self.P.ch_adm_in and label is not None:
            le = self.label_embed["0"](label.to(dtype))
            emb = emb + self.label_embed["2"](B.silu(le))
        return emb

    def forward(self, x, t, cond, label=None):
        """x: [N, 4, H, W], t: [N], cond: [N, S_ctx, n_ctx], label: [N,
        ch_adm_in] or None -> [N, 4, H, W] in the parameters' dtype."""
        dtype = self._modules["in"]["conv"].weight.dtype
        x, cond = x.to(dtype), cond.to(dtype)
        emb = self.embed(t, label)
        blocks_in = self._modules["in"]
        x = blocks_in["conv"](x)
        stack = [x]
        for name, blk in blocks_in.items():
            if name == "conv":
                continue
            x = self._run(blk, x, emb, cond)
            stack.append(x)
        for blk in self.mid.values():
            x = self._run(blk, x, emb, cond)
        for name, blk in self.out.items():
            if name in ("norm", "conv"):
                continue
            x = self._run(blk, torch.cat([x, stack.pop()], dim=1), emb, cond)
        return self.out["conv"](B.silu(self.out["norm"](x)))

    @staticmethod
    def _run(blk, x, emb, cond):
        for m in (blk.values() if isinstance(blk, nn.ModuleDict) else [blk]):
            if isinstance(m, B.Resnet):
                x = m(x, emb)
            elif isinstance(m, SpatialTransformer):
                x = m(x, cond)
            else:
                x = m(x)
        return x


def _bcast(s, x):
    return s.reshape(s.shape + (1,) * (x.dim() - s.dim()))


def denoise(unet: UNet, x, sigma, t, cond, label=None):
    """k-diffusion wrapper: input scaling ``c_in = 1/sqrt(sigma^2 + 1)`` and,
    for v-param models, ``c_skip``/``c_out`` (ref: unet_denoise_run).
    Returns the f32 derivative ``dx/dsigma`` the solvers use.  ``sigma`` and
    ``t`` are scalars or [N]; ``label`` [N, ch_adm_in] for SDXL."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
    c_in = 1.0 / torch.sqrt(sigma * sigma + 1.0)
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=x.device).expand(x.shape[0])
    out = unet(x * _bcast(c_in, x), t, cond, label).float()
    if unet.P.vparam:
        c_skip = sigma / (sigma * sigma + 1.0)
        c_out = 1.0 / torch.sqrt(sigma * sigma + 1.0)
        out = out * _bcast(c_out, out) + x.float() * _bcast(c_skip, x)
    return out
