"""ControlNet (port of ``mlimgsynth_tpu/models/controlnet.py``).

A trainable copy of the UNet's encoder and middle (the same
``UnetParams``, built from the UNet's own blocks) that takes the scaled
latent plus the encoded hint image and gives one 1x1 "zero conv" residual
per encoder skip and one for the middle, which the UNet's decoder adds in
(``UNet.forward(control=...)``).

Parameter names below ``cnet.`` follow the UNet's (``in.N.*``, ``mid.*``,
``time_embed.*``, ``label_embed.*``); the ControlNet's own parts are the
hint encoder ``hint.0`` - ``hint.7``, the zero convs ``zc.N`` and
``mid.out``.  A checkpoint's names (``control_model.*``, or the diffusers
``ControlNetModel`` layout) map through ``nameconv.normalize_cnet_name``.

The hint encoder does not depend on the latent or the step: the sampler
runs it once a request (:meth:`ControlNet.hint_features`) and its batch-1 features
broadcast over the CFG rows.
"""
from __future__ import annotations

import torch
from torch import nn

from . import blocks as B
from .unet import (UnetParams, UNet, add_embed, encoder_blocks, mid_block,
                   unet_embed)

# The hint encoder: 8 3x3 convs, silu between, three stride-2 stages (image
# resolution -> latent resolution, /8); the channels and strides of the
# first seven, the last gives the UNet's width
HINT_CH = (16, 16, 32, 32, 96, 96, 256)
HINT_STRIDE = (1, 1, 2, 1, 2, 1, 2)


class ControlNet(nn.Module):
    """The ControlNet of a UNet of parameters ``P``; ``state_dict`` names
    are the internal names without the ``cnet.`` prefix."""

    def __init__(self, P: UnetParams):
        super().__init__()
        self.P = P
        add_embed(self, P)
        blocks_in, skip_ch, ch, _ = encoder_blocks(P)
        self.add_module("in", nn.ModuleDict(blocks_in))
        self.mid = mid_block(ch, P)
        self.mid["out"] = B.conv2d(ch, ch, 1, 1, 0)
        self.zc = nn.ModuleDict({str(i): B.conv2d(c, c, 1, 1, 0)
                                 for i, c in enumerate(skip_ch)})
        chans = (3,) + HINT_CH
        hint = {str(i): B.conv2d(chans[i], chans[i + 1], 3, st, 1)
                for i, st in enumerate(HINT_STRIDE)}
        hint[str(len(HINT_CH))] = B.conv2d(HINT_CH[-1], P.n_ch)
        self.hint = nn.ModuleDict(hint)

    def hint_features(self, img):
        """The hint image [N, 3, H, W] in [0, 1] -> its features [N, n_ch,
        H/8, W/8] (``hint_apply``): once a request."""
        x = img.to(self._modules["in"]["conv"].weight.dtype)
        for i in range(len(HINT_CH)):
            x = B.silu(self.hint[str(i)](x))
        return self.hint[str(len(HINT_CH))](x)

    def forward(self, x, t, cond, label, hint_feat):
        """x: [N, n_ch_in, H, W] (scaled), t: [N], hint_feat: [1 or N,
        n_ch, H, W] -> the residuals (``controlnet_apply``): one per
        encoder skip in push order, the middle's last."""
        dtype = self._modules["in"]["conv"].weight.dtype
        x, cond = x.to(dtype), cond.to(dtype)
        emb = unet_embed(self, t, label)
        blocks_in = self._modules["in"]
        x = blocks_in["conv"](x) + hint_feat.to(dtype)
        outs = [self.zc["0"](x)]
        for i, name in enumerate(k for k in blocks_in if k != "conv"):
            x = UNet._run(blocks_in[name], x, emb, cond)
            outs.append(self.zc[str(i + 1)](x))
        for name in ("0", "1", "2"):
            x = UNet._run(self.mid[name], x, emb, cond)
        outs.append(self.mid["out"](x))
        return outs
