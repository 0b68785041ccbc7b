"""KL autoencoder (port of ``mlimgsynth_tpu/models/vae.py``): the encoder
(img2img and inpainting), the decoder, and the latent's mean and sample.

``state_dict`` names match the internal scheme below the ``vae.`` prefix
(``encoder.down.0.block.0.norm1.weight``,
``decoder.up.0.block.0.norm1.weight`` ...).  Both mid-blocks' single-head
attention over the whole 512-wide feature map reaches the K2 kernel on the
card (``ops/attention.py``).
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
class VaeParams:
    """ref: src/vae.c:22-44."""
    ch_x: int = 3
    ch_z: int = 4
    ch: int = 128
    n_res: int = 4
    n_res_blk: int = 2
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    d_embed: int = 4
    f_down: int = 8
    scale_factor: float = 0.18215
    # latent shift (z_model = (z - shift) * scale; SD3's VAE uses 0.0609)
    shift_factor: float = 0.0
    # SD1's VAE wraps the latent in a 1x1 post-quant conv; SD3's drops it
    quant_conv: bool = True


VAE_SD1 = VaeParams(scale_factor=0.18215)
VAE_SDXL = VaeParams(scale_factor=0.13025)
# SD3 family: 16-channel latent, shift factor, no quant convs
# (``mlimgsynth_tpu/models/vae.py:42-43``)
VAE_SD3 = VaeParams(ch_z=16, d_embed=16, scale_factor=1.5305,
                    shift_factor=0.0609, quant_conv=False)
# Flux: the SD3 autoencoder at another scale and shift
# (``mlimgsynth_tpu/models/vae.py:44-46``)
VAE_FLUX = VaeParams(ch_z=16, d_embed=16, scale_factor=0.3611,
                     shift_factor=0.1159, quant_conv=False)


class Attn2dSelf(nn.Module):
    """Single-head 2D self-attention mid-block (ref: mlb_attn_2d_self).
    The 1x1 convs run as linears on the [N, HW, C] view."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = B.GroupNorm(ch)
        self.q = B.conv2d(ch, ch, 1, 1, 0)
        self.k = B.conv2d(ch, ch, 1, 1, 0)
        self.v = B.conv2d(ch, ch, 1, 1, 0)
        self.proj_out = B.conv2d(ch, ch, 1, 1, 0)

    @staticmethod
    def _lin(conv, x):
        return F.linear(x, conv.weight.flatten(1), conv.bias)

    def forward(self, x):
        n, c, h, w = x.shape
        t = self.norm(x).flatten(2).transpose(1, 2)          # [N, HW, C]
        q, k, v = (self._lin(m, t)[:, None] for m in (self.q, self.k, self.v))
        o = attention(q, k, v)[:, 0]                          # scale 1/sqrt(C)
        o = self._lin(self.proj_out, o)
        return o.transpose(1, 2).reshape(n, c, h, w) + x


class _DownLevel(nn.Module):
    def __init__(self, ch_in: int, ch_out: int, n_blk: int, downsample: bool):
        super().__init__()
        self.block = nn.ModuleList(
            B.Resnet(ch_in if j == 0 else ch_out, ch_out)
            for j in range(n_blk))
        if downsample:
            self.downsample = B.Downsample(ch_out, ch_out, vae=True)


class KlEncoder(nn.Module):
    """ref: mlb_kl_encoder (``kl_encoder``,
    ``mlimgsynth_tpu/models/vae.py:64-82``): ``ch_out`` output channels
    (the moments: mean and log-variance)."""

    def __init__(self, P: VaeParams, ch_out: int):
        super().__init__()
        self.conv_in = B.conv2d(P.ch_x, P.ch)
        down, ch = [], P.ch
        for i in range(P.n_res):
            ch_out_i = P.ch * P.ch_mult[i]
            down.append(_DownLevel(ch, ch_out_i, P.n_res_blk,
                                   i + 1 != P.n_res))
            ch = ch_out_i
        self.down = nn.ModuleList(down)
        self.mid = nn.ModuleDict({"block_1": B.Resnet(ch, ch),
                                  "attn_1": Attn2dSelf(ch),
                                  "block_2": B.Resnet(ch, ch)})
        self.norm_out = B.GroupNorm(ch)
        self.conv_out = B.conv2d(ch, ch_out)

    def forward(self, x):
        x = self.conv_in(x)
        for lvl in self.down:
            for blk in lvl.block:
                x = blk(x)
            if hasattr(lvl, "downsample"):
                x = lvl.downsample(x)
        for m in self.mid.values():
            x = m(x)
        return self.conv_out(B.silu(self.norm_out(x)))


class VaeEncoder(nn.Module):
    """image [N, 3, H, W] in [-1, 1] -> moments [N, 2 ch_z, H/8, W/8] in
    the compute dtype (ref: mlb_sdvae_encoder, ``vae_encode_apply``,
    ``mlimgsynth_tpu/models/vae.py:105-112``), through the ``quant_conv``
    where the VAE has one.  Names below the ``vae.`` prefix."""

    def __init__(self, P: VaeParams):
        super().__init__()
        self.P = P
        self.encoder = KlEncoder(P, P.ch_z * 2)
        if P.quant_conv:
            self.quant_conv = B.conv2d(P.ch_z * 2, P.ch_z * 2, 1, 1, 0)

    def forward(self, img):
        x = self.encoder(img.to(self.encoder.conv_in.weight.dtype))
        if self.P.quant_conv:
            x = self.quant_conv(x)
        return x


def latent_mean(moments, P: VaeParams):
    """moments [N, 2 ch_z, h, w] -> (mean - shift) * scale, f32
    (ref: sdvae_latent_mean, ``mlimgsynth_tpu/models/vae.py:128-131``)."""
    return (moments[:, :P.ch_z].float() - P.shift_factor) * P.scale_factor


def latent_sample(moments, rand, P: VaeParams):
    """((mean + exp(logvar / 2) * rand) - shift) * scale in f32, the
    log-variance clamped to [-30, 20] (ref: sdvae_latent_sample,
    ``mlimgsynth_tpu/models/vae.py:134-140``); ``rand`` is standard normal
    of the latent's shape."""
    m = moments.float()
    mean = m[:, :P.ch_z]
    logvar = m[:, P.ch_z:].clamp(-30.0, 20.0)
    z = mean + torch.exp(logvar * 0.5) * rand.float()
    return (z - P.shift_factor) * P.scale_factor


class _UpLevel(nn.Module):
    def __init__(self, ch_in: int, ch_out: int, n_blk: int, upsample: bool):
        super().__init__()
        self.block = nn.ModuleList(
            B.Resnet(ch_in if j == 0 else ch_out, ch_out)
            for j in range(n_blk))
        if upsample:
            self.upsample = B.Upsample(ch_out, ch_out)


class KlDecoder(nn.Module):
    """ref: mlb_kl_decoder."""

    def __init__(self, P: VaeParams):
        super().__init__()
        ch = P.ch * P.ch_mult[P.n_res - 1]
        self.conv_in = B.conv2d(P.d_embed, ch)
        self.mid = nn.ModuleDict({"block_1": B.Resnet(ch, ch),
                                  "attn_1": Attn2dSelf(ch),
                                  "block_2": B.Resnet(ch, ch)})
        up = [None] * P.n_res
        for i in range(P.n_res - 1, -1, -1):
            ch_out = P.ch * P.ch_mult[i]
            up[i] = _UpLevel(ch, ch_out, P.n_res_blk + 1, i != 0)
            ch = ch_out
        self.up = nn.ModuleList(up)
        self.norm_out = B.GroupNorm(ch)
        self.conv_out = B.conv2d(ch, P.ch_x)

    def forward(self, x):
        x = self.conv_in(x)
        for m in self.mid.values():
            x = m(x)
        for lvl in reversed(self.up):
            for blk in lvl.block:
                x = blk(x)
            if hasattr(lvl, "upsample"):
                x = lvl.upsample(x)
        return self.conv_out(B.silu(self.norm_out(x)))


class VaeDecoder(nn.Module):
    """latent [N, ch_z, h, w] (scaled) -> image [N, 3, 8h, 8w] in [-1, 1]
    (ref: mlb_sdvae_decoder, ``vae_decode_apply``,
    ``mlimgsynth_tpu/models/vae.py:115-125``).  Names below the ``vae.``
    prefix."""

    def __init__(self, P: VaeParams):
        super().__init__()
        self.P = P
        if P.quant_conv:
            self.post_quant_conv = B.conv2d(P.ch_z, P.d_embed, 1, 1, 0)
        self.decoder = KlDecoder(P)

    def forward(self, latent):
        P = self.P
        dtype = self.decoder.conv_in.weight.dtype
        x = latent.to(dtype) * (1.0 / P.scale_factor)
        if P.shift_factor:
            x = x + torch.tensor(P.shift_factor, dtype=torch.float32).to(dtype)
        if P.quant_conv:
            x = self.post_quant_conv(x)
        return self.decoder(x)
