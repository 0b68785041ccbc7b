"""Tiny autoencoder (port of ``mlimgsynth_tpu/models/tae.py``;
madebyollin/taesd, the diffusers AutoencoderTiny layout): the encoder and
the decoder.

``state_dict`` names match the taesd file below the ``tae.`` prefix
(``encoder.layers.N.conv.0.weight``, ``decoder.layers.N.conv.0.weight``
...): the session loads the TAE from its own file.  Neither has
attention.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import blocks as B


@dataclass(frozen=True)
class TaeParams:
    """ref: src/tae.c:17-22."""
    ch_x: int = 3
    ch_inner: int = 64
    ch_z: int = 4
    n_blk: int = 3


TAE_SD1 = TaeParams()


def tae_params_from_shapes(shapes: Mapping[str, Tuple[int, ...]]
                           ) -> TaeParams:
    """The decoder's geometry from a taesd file's tensor shapes (names
    without prefix): ``ch_z`` and ``ch_inner`` from the first conv
    (``decoder.layers.0.weight``, [ch_inner, ch_z, 3, 3]; taesd is 4-channel,
    taesd3/taef1 16), ``n_blk`` from the number of decoder layers (2 + 3 x
    (n_blk + 2) + 2)."""
    co, ci = shapes["decoder.layers.0.weight"][:2]
    n_layers = 1 + max(int(k.split(".")[2]) for k in shapes
                       if k.startswith("decoder.layers."))
    n_blk, rem = divmod(n_layers - 10, 3)
    if rem or n_blk < 1:
        raise ValueError(f"not a taesd decoder: {n_layers} layers")
    return TaeParams(ch_inner=int(co), ch_z=int(ci), n_blk=n_blk)


class TaeBlock(nn.Module):
    """ref: mlb_sdtae_block (``tae_block``)."""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.conv = nn.ModuleDict({"0": B.conv2d(ch_in, ch_out),
                                   "2": B.conv2d(ch_out, ch_out),
                                   "4": B.conv2d(ch_out, ch_out)})
        if ch_in != ch_out:
            self.skip = nn.Conv2d(ch_in, ch_out, 1, bias=False)

    def forward(self, x):
        y = F.relu(self.conv["0"](x))
        y = self.conv["4"](F.relu(self.conv["2"](y)))
        return F.relu(y + (self.skip(x) if hasattr(self, "skip") else x))


class TaeEncoder(nn.Module):
    """image [N, 3, H, W] in [0, 1] -> latent [N, ch_z, H/8, W/8] (the
    sampler's latent, unscaled) (ref: mlb_sdtae_encoder,
    ``tae_encode_apply``, ``mlimgsynth_tpu/models/tae.py:42-56``): a conv,
    a block, then three times a stride-2 conv without bias and ``n_blk``
    blocks, and the output conv."""

    def __init__(self, P: TaeParams = TAE_SD1):
        super().__init__()
        self.P = P
        ch = P.ch_inner
        layers = {"0": B.conv2d(P.ch_x, ch), "1": TaeBlock(ch, ch)}
        i = 2
        for _ in range(3):
            layers[str(i)] = B.conv2d(ch, ch, 3, 2, 1, bias=False)
            i += 1
            for _ in range(P.n_blk):
                layers[str(i)] = TaeBlock(ch, ch)
                i += 1
        layers[str(i)] = B.conv2d(ch, P.ch_z)
        self.encoder = nn.ModuleDict({"layers": nn.ModuleDict(layers)})

    def forward(self, img):
        layers = self.encoder["layers"]
        x = img.to(layers["0"].weight.dtype)
        for m in layers.values():
            x = m(x)
        return x


class TaeDecoder(nn.Module):
    """latent [N, ch_z, h, w] (the sampler's latent, unscaled) -> image
    [N, 3, 8h, 8w] in about [0, 1] (ref: mlb_sdtae_decoder,
    ``tae_decode_apply``, ``mlimgsynth_tpu/models/tae.py:59-75``): the
    tanh clamp, a conv, then three times ``n_blk`` blocks, a nearest x2
    upsample and a conv without bias, a last block and the output conv.
    The ReLU and upsample layers hold no weights; their indices are kept."""

    def __init__(self, P: TaeParams = TAE_SD1):
        super().__init__()
        self.P = P
        ch = P.ch_inner
        layers = {"0": B.conv2d(P.ch_z, ch)}
        i = 2
        for _ in range(3):
            for _ in range(P.n_blk):
                layers[str(i)] = TaeBlock(ch, ch)
                i += 1
            i += 1                              # nearest x2 upsample
            layers[str(i)] = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
            i += 1
        layers[str(i)] = TaeBlock(ch, ch)
        layers[str(i + 1)] = B.conv2d(ch, P.ch_x)
        self.decoder = nn.ModuleDict({"layers": nn.ModuleDict(layers)})

    def forward(self, latent):
        layers = self.decoder["layers"]
        x = latent.to(layers["0"].weight.dtype)
        x = torch.tanh(x / 3.0) * 3.0           # input clamp (src/tae.c:71-73)
        x = F.relu(layers["0"](x))
        for name, m in layers.items():
            if name == "0":
                continue
            if isinstance(m, nn.Conv2d) and m.bias is None:
                x = m(F.interpolate(x, scale_factor=2, mode="nearest"))
            else:
                x = m(x)
        return x
