"""Stable Diffusion UNet (port of ``mlimgsynth_tpu/models/unet.py``).

Parameter names below the ``unet.`` prefix match the JAX package's internal
scheme (``in.1.1.transf.0.attn2.k_proj.weight`` ...).  NCHW activations;
CFG runs as one batched forward (cond and uncond rows stacked).  SDXL's
label (the pooled text feature and the size embeddings) enters through
``label_embed``, added to the time embedding.  SD2.1 is SD1's UNet with
heads of 64, a 1024-wide context and v-prediction (``denoise``).  The
sampler's options reach into the forward: FreeU at each decoder block
(``_freeu_apply``), perturbed-attention guidance's identity self-attention
in the mid transformer (``pag``) and DeepCache's split at the feature
entering the level-0 decoder (``want_cache`` / ``use_cache``;
``mlimgsynth_tpu/models/unet.py:108-246``).  ControlNet's residuals
(``models/controlnet.py``) are added to the middle block's output and to
each skip as the decoder takes it; an inpaint-variant UNet (``n_ch_in`` =
2 ch_z + 1) takes its extra conditioning channels after the input scaling
(``denoise``).  The SDXL refiner is ``UNET_SDXL_REFINER``: one bigG tower
and a label of its pooled feature and five size and aesthetic-score
embeddings.
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
# SDXL-refiner (stability's sd_xl_refiner.yaml; ``mlimgsynth_tpu/models/
# unet.py:49-61``): the OpenCLIP bigG tower alone (n_ctx 1280), 4 levels
# with attention at ds 2 and 4 only, label = the pooled feature and 5 x 256
# embeddings of (orig_h, orig_w, crop_top, crop_left, aesthetic score)
UNET_SDXL_REFINER = UnetParams(
    attn_res=(4, 2), ch_mult=(1, 2, 4, 4), transf_depth=(4, 4, 4, 4),
    n_ch=384, n_te=1536, d_head=64, n_ctx=1280, ch_adm_in=2560,
    clip_norm=False, cond_label=True, uncond_empty_zero=True)
# the refiner label's aesthetic score, of the cond rows and of the uncond
# rows (sgm's defaults)
AESTHETIC_SCORE = 6.0
AESTHETIC_NSCORE = 2.5


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

    def forward(self, x, cond, self_identity: bool = False):
        n, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        y = y.flatten(2).transpose(1, 2)            # [N, HW, C]
        for blk in self.transf:
            y = blk(y, cond, self_identity)
        y = y.transpose(1, 2).reshape(n, c, h, w)
        return self.proj_out(y) + x


def add_embed(m: nn.Module, P: UnetParams) -> None:
    """The time embedding and, for a labeled UNet, the label embedding of
    ``m`` (the UNet or its ControlNet copy)."""
    m.time_embed = nn.ModuleDict({"0": B.linear(P.n_ch, P.n_te),
                                  "2": B.linear(P.n_te, P.n_te)})
    if P.ch_adm_in:
        m.label_embed = nn.ModuleDict({"0": B.linear(P.ch_adm_in, P.n_te),
                                       "2": B.linear(P.n_te, P.n_te)})


def unet_embed(m: nn.Module, t, label=None):
    """ref: mlb_unet__embed (``unet_embed``) of ``m``, a module that
    :func:`add_embed` filled and that holds its input conv at
    ``in.conv``.  t: [N] continuous train step; label: [N,
    ch_adm_in] or None."""
    P = m.P
    dtype = m._modules["in"]["conv"].weight.dtype
    emb = B.timestep_embedding(t, P.n_ch).to(dtype)
    emb = m.time_embed["2"](B.silu(m.time_embed["0"](emb)))
    if P.ch_adm_in and label is not None:
        le = m.label_embed["0"](label.to(dtype))
        emb = emb + m.label_embed["2"](B.silu(le))
    return emb


def encoder_blocks(P: UnetParams):
    """The input blocks by name (``in.*``) of the UNet or its ControlNet
    copy: (blocks, the channels of each skip in push order, the channels
    and the downsampling factor after the last block)."""
    blocks_in = {"conv": B.conv2d(P.n_ch_in, P.n_ch)}
    skip_ch = [P.n_ch]
    ch, ds, i_blk = P.n_ch, 1, 0
    for im in range(len(P.ch_mult)):
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
    return blocks_in, skip_ch, ch, ds


def mid_block(ch: int, P: UnetParams) -> nn.ModuleDict:
    return nn.ModuleDict({
        "0": B.Resnet(ch, ch, P.n_te),
        "1": SpatialTransformer(ch, P, P.transf_depth[-1]),
        "2": B.Resnet(ch, ch, P.n_te)})


class UNet(nn.Module):
    """ref: mlb_unet_denoise + mlb_unet__in/__mid/__out.  ``state_dict``
    names are the internal names without the ``unet.`` prefix."""

    def __init__(self, P: UnetParams):
        super().__init__()
        self.P = P
        add_embed(self, P)
        blocks_in, skip_ch, ch, ds = encoder_blocks(P)
        n_levels = len(P.ch_mult)
        self.add_module("in", nn.ModuleDict(blocks_in))
        self.mid = mid_block(ch, P)
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
        return unet_embed(self, t, label)

    def forward(self, x, t, cond, label=None, freeu=None, pag: bool = False,
                want_cache: bool = False, use_cache=None, control=None):
        """x: [N, n_ch_in, H, W], t: [N], cond: [N, S_ctx, n_ctx], label:
        [N, ch_adm_in] or None -> [N, 4, H, W] in the parameters' dtype.
        ``freeu`` (b1, b2, s1, s2) reweights each decoder block's backbone
        feature and skip; ``pag`` gives the mid transformer the identity
        self-attention map.  ``want_cache`` also returns the feature
        entering the level-0 decoder; ``use_cache`` (that feature) runs only
        the shallow path: the level-0 encoder and decoder blocks and the
        head (``unet_apply``, ``mlimgsynth_tpu/models/unet.py:143-246``).
        ``control``: ControlNet's residuals, one per skip in push order and
        the middle's last; the middle's is added to the middle block's
        output, each other to its skip as the decoder pops it."""
        P = self.P
        dtype = self._modules["in"]["conv"].weight.dtype
        x, cond = x.to(dtype), cond.to(dtype)
        emb = self.embed(t, label)
        blocks_in = self._modules["in"]
        x = blocks_in["conv"](x)
        stack = [x]
        names = [k for k in blocks_in if k != "conv"]
        outs = [k for k in self.out if k not in ("norm", "conv")]
        i0 = (len(P.ch_mult) - 1) * (P.n_res_blk + 1)   # level 0's first
        if use_cache is not None:
            names, outs = names[:P.n_res_blk], outs[i0:]
        for name in names:
            x = self._run(blocks_in[name], x, emb, cond)
            stack.append(x)
        cache = ctrl = None
        if use_cache is not None:
            x = use_cache.to(dtype)
        else:
            for name, blk in self.mid.items():
                x = self._run(blk, x, emb, cond, pag and name == "1")
            if control is not None:
                if len(control) != len(stack) + 1:
                    raise ValueError(f"{len(control)} ControlNet residuals "
                                     f"for {len(stack)} skips")
                x = x + control[-1].to(x.dtype)
                ctrl = list(control[:-1])
        for name in outs:
            if want_cache and name == str(i0):
                cache = x
            h = stack.pop()
            if ctrl is not None:
                h = h + ctrl.pop().to(h.dtype)
            if freeu is not None:
                x, h = _freeu_apply(x, h, P, freeu)
            x = self._run(self.out[name], torch.cat([x, h], dim=1), emb,
                          cond)
        out = self.out["conv"](B.silu(self.out["norm"](x)))
        return (out, cache) if want_cache else out

    @staticmethod
    def _run(blk, x, emb, cond, self_identity: bool = False):
        for m in (blk.values() if isinstance(blk, nn.ModuleDict) else [blk]):
            if isinstance(m, B.Resnet):
                x = m(x, emb)
            elif isinstance(m, SpatialTransformer):
                x = m(x, cond, self_identity)
            else:
                x = m(x)
        return x


def _freeu_filter(h, scale, threshold: int = 1):
    """FreeU's skip-connection Fourier filter (``_freeu_filter``,
    ``mlimgsynth_tpu/models/unet.py:108-120``): the ``threshold`` lowest
    spatial frequencies of each side scaled, an f32 FFT over H and W."""
    hf = torch.fft.fft2(h.float(), dim=(2, 3))
    H, W = h.shape[2], h.shape[3]
    ih = torch.arange(H, device=h.device)
    iw = torch.arange(W, device=h.device)
    mh = (ih < threshold) | (ih >= H - threshold)
    mw = (iw < threshold) | (iw >= W - threshold)
    mask = torch.where(mh[:, None] & mw[None, :],
                       torch.tensor(float(scale), device=h.device),
                       torch.tensor(1.0, device=h.device))
    return torch.fft.ifft2(hf * mask, dim=(2, 3)).real.to(h.dtype)


def _freeu_apply(x, h, P: UnetParams, freeu):
    """FreeU at one decoder block (``_freeu_apply``, ``unet.py:123-140``):
    the first half of the backbone feature's channels scaled by b and the
    skip low-pass filtered by s, (b1, s1) where the feature has 4 n_ch
    channels, (b2, s2) where it has 2 n_ch, nothing elsewhere."""
    b1, b2, s1, s2 = freeu
    cb = x.shape[1]
    if cb == P.n_ch * 4:
        b, s = b1, s1
    elif cb == P.n_ch * 2:
        b, s = b2, s2
    else:
        return x, h
    half = cb // 2
    b = torch.tensor(float(b), dtype=x.dtype, device=x.device)
    x = torch.cat([x[:, :half] * b, x[:, half:]], dim=1)
    return x, _freeu_filter(h, s)


def _bcast(s, x):
    return s.reshape(s.shape + (1,) * (x.dim() - s.dim()))


def denoise(unet: UNet, x, sigma, t, cond, label=None, freeu=None,
            pag: bool = False, want_cache: bool = False, use_cache=None,
            control=None, extra_ch=None):
    """k-diffusion wrapper: input scaling ``c_in = 1/sqrt(sigma^2 + 1)`` and,
    for v-param models, ``c_skip``/``c_out`` (ref: unet_denoise_run).
    Returns the f32 derivative ``dx/dsigma`` the solvers use (with
    ``want_cache``, and the cache: :meth:`UNet.forward`).  ``sigma`` and
    ``t`` are scalars or [N]; ``label`` [N, ch_adm_in] for SDXL.
    ``extra_ch`` ([1 or N, n_ch_in - 4, H, W]): an inpaint-variant UNet's
    conditioning channels, concatenated after the input scaling.
    ``control`` (a ``ControlNet``, its hint features [1 or N, n_ch, H, W],
    the strength): the ControlNet runs on the scaled input and its
    residuals, times the strength, go into the decoder
    (``mlimgsynth_tpu/models/unet.py:249-290``)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
    c_in = 1.0 / torch.sqrt(sigma * sigma + 1.0)
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=x.device).expand(x.shape[0])
    dtype = unet._modules["in"]["conv"].weight.dtype
    xs = (x * _bcast(c_in, x)).to(dtype)
    if extra_ch is not None:
        e = extra_ch.to(dtype).expand(x.shape[0], -1, -1, -1)
        xs = torch.cat([xs, e], dim=1)
    residuals = None
    if control is not None:
        cnet, hint_feat, strength = control
        residuals = [r * torch.tensor(float(strength), dtype=r.dtype,
                                      device=r.device)
                     for r in cnet(xs, t, cond, label, hint_feat)]
    out = unet(xs, t, cond, label, freeu=freeu, pag=pag,
               want_cache=want_cache, use_cache=use_cache,
               control=residuals)
    cache = None
    if want_cache:
        out, cache = out
    out = out.float()
    if unet.P.vparam:
        c_skip = sigma / (sigma * sigma + 1.0)
        c_out = 1.0 / torch.sqrt(sigma * sigma + 1.0)
        out = out * _bcast(c_out, out) + x.float() * _bcast(c_skip, x)
    return (out, cache) if want_cache else out
