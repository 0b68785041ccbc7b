"""ESRGAN / Real-ESRGAN image upscalers (port of
``mlimgsynth_tpu/models/esrgan.py``).

Two architectures, with basicsr's parameter names:

* ``RRDBNet`` (ESRGAN, Real-ESRGAN x4plus): a conv stem, ``n_block``
  residual-in-residual dense blocks (0.2 residual scaling), a trunk conv
  with a global residual, two nearest-2x + conv upsampling stages and an HR
  head, LeakyReLU(0.2) between; x2 and x1 checkpoints keep the trunk and
  feed it a pixel-unshuffled input, so that the fixed 4x upsampler nets
  out at 2x or 1x.
* ``SRVGGNetCompact`` (realesr-general-x4v3): a conv + PReLU stack, a
  pixel-shuffle tail, added to the nearest-upsampled input.

Both map [N, 3, H, W] in [0, 1] to [N, 3, s H, s W] in [0, 1], NCHW, in the
parameters' dtype.  The network is convolutions only (cuDNN on the card):
the JAX package has no Pallas kernel on this path.  ``load_esrgan`` reads
a ``.safetensors`` file (the port's tensorstore) or a torch ``.pth``
(``torch.load(weights_only=True)``), the old ESRGAN names (``model.N``)
mapped onto basicsr's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..io.tensorstore import TensorStore
from . import blocks as B


@dataclass(frozen=True)
class EsrganParams:
    n_feat: int = 64       # trunk width (conv_first's output channels)
    n_block: int = 23      # RRDB count (x4plus: 23; anime-6B: 6)
    growth: int = 32       # dense-block growth channels
    unshuffle: int = 1     # input pixel-unshuffle factor (1: x4, 2: x2, 4: x1)
    ch_img: int = 3

    @property
    def scale(self) -> int:
        return 4 // self.unshuffle


ESRGAN_X4 = EsrganParams()


@dataclass(frozen=True)
class SrvggParams:
    n_feat: int = 64
    n_conv: int = 32
    scale: int = 4
    ch_img: int = 3
    unshuffle: int = 1      # the surface of ``EsrganParams``


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class _RDB(nn.Module):
    """Residual dense block: 5 convs over dense concatenations, the
    output scaled by 0.2 and added to the input."""

    def __init__(self, nf: int, g: int):
        super().__init__()
        for k in range(1, 5):
            setattr(self, f"conv{k}", B.conv2d(nf + (k - 1) * g, g))
        self.conv5 = B.conv2d(nf + 4 * g, nf)

    def forward(self, x):
        feats = [x]
        for k in range(1, 5):
            conv = getattr(self, f"conv{k}")
            feats.append(_lrelu(conv(torch.cat(feats, 1)
                                     if len(feats) > 1 else x)))
        return x + 0.2 * self.conv5(torch.cat(feats, 1))


class _RRDB(nn.Module):
    def __init__(self, nf: int, g: int):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = (_RDB(nf, g) for _ in range(3))

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """``esrgan_apply``: img [N, 3, H, W] in [0, 1] -> [N, 3, s H, s W] in
    [0, 1]."""

    def __init__(self, P: EsrganParams):
        super().__init__()
        self.P = P
        nf = P.n_feat
        self.conv_first = B.conv2d(P.ch_img * P.unshuffle ** 2, nf)
        self.body = nn.ModuleList(_RRDB(nf, P.growth)
                                  for _ in range(P.n_block))
        self.conv_body = B.conv2d(nf, nf)
        self.conv_up1 = B.conv2d(nf, nf)
        self.conv_up2 = B.conv2d(nf, nf)
        self.conv_hr = B.conv2d(nf, nf)
        self.conv_last = B.conv2d(nf, P.ch_img)

    def forward(self, img):
        x = img.to(self.conv_first.weight.dtype)
        if self.P.unshuffle > 1:
            # basicsr's pixel_unshuffle: channels in [c, fh, fw] order
            x = F.pixel_unshuffle(x, self.P.unshuffle)
        fea = self.conv_first(x)
        h = fea
        for blk in self.body:
            h = blk(h)
        fea = fea + self.conv_body(h)
        for conv in (self.conv_up1, self.conv_up2):
            fea = _lrelu(conv(F.interpolate(fea, scale_factor=2.0,
                                            mode="nearest")))
        out = self.conv_last(_lrelu(self.conv_hr(fea)))
        return out.clamp(0.0, 1.0)


class _PReLU(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))

    def forward(self, x):
        a = self.weight.to(x.dtype)[None, :, None, None]
        return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


class SRVGGNetCompact(nn.Module):
    """``srvgg_apply``: conv + PReLU pairs (``body.2i`` / ``body.2i+1``),
    a last conv to 3 s^2 channels, pixel-shuffled and added to the
    nearest-upsampled input, clamped to [0, 1]."""

    def __init__(self, P: SrvggParams):
        super().__init__()
        self.P = P
        layers = [B.conv2d(P.ch_img, P.n_feat), _PReLU(P.n_feat)]
        for _ in range(P.n_conv):
            layers += [B.conv2d(P.n_feat, P.n_feat), _PReLU(P.n_feat)]
        layers.append(B.conv2d(P.n_feat, P.ch_img * P.scale * P.scale))
        self.body = nn.ModuleList(layers)

    def forward(self, img):
        x = img.to(self.body[0].weight.dtype)
        h = x
        for m in self.body:
            h = m(h)
        out = F.pixel_shuffle(h, self.P.scale)
        base = F.interpolate(x, scale_factor=float(self.P.scale),
                             mode="nearest")
        return (out + base).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------

# old-arch ESRGAN (sequential "model.N" naming) -> basicsr RRDBNet names
_OLD_FIXED = {
    "model.0": "conv_first",
    "model.3": "conv_up1",
    "model.6": "conv_up2",
    "model.8": "conv_hr",
    "model.10": "conv_last",
}


def _canon_name(name: str, n_block_hint: int) -> str:
    """Map an old-arch key prefix onto the basicsr name; new names pass
    through unchanged."""
    if not name.startswith("model."):
        return name
    for old, new in _OLD_FIXED.items():
        if name.startswith(old + "."):
            return new + name[len(old):]
    if name.startswith("model.1.sub."):
        rest = name[len("model.1.sub."):]
        idx, _, tail = rest.partition(".")
        if int(idx) == n_block_hint:          # trailing trunk conv
            return "conv_body." + tail
        tail = tail.replace(".0.", ".")       # convN.0.weight -> convN.weight
        return f"body.{idx}." + tail.replace("RDB", "rdb")
    return name


def load_esrgan_state(path: str) -> Dict[str, np.ndarray]:
    """Read a .safetensors or torch .pth ESRGAN checkpoint into a flat
    f32 {basicsr name: array} dict (torch layouts, OIHW convs)."""
    raw: Dict[str, np.ndarray] = {}
    if path.endswith((".pth", ".pt", ".ckpt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for k in ("params_ema", "params", "state_dict"):
            if isinstance(sd, dict) and k in sd:
                sd = sd[k]
                break
        for k, v in sd.items():
            raw[k] = v.to(torch.float32).numpy()
    else:
        st = TensorStore.open(path)
        try:
            for name in st.names():
                # a copy: the reads are views of the mapped file
                raw[name] = np.array(st.read(name, "f32"))
        finally:
            st.close()
    n_block_hint = -1
    subs = [k for k in raw if k.startswith("model.1.sub.")]
    if subs:
        n_block_hint = max(int(k.split(".")[3]) for k in subs)
    return {_canon_name(k, n_block_hint): v for k, v in raw.items()}


def infer_params(state: Dict[str, np.ndarray]) -> EsrganParams:
    """RRDBNet geometry from the checkpoint's shapes (OIHW convs)."""
    try:
        first = state["conv_first.weight"]
        g = state["body.0.rdb1.conv1.weight"].shape[0]
    except KeyError as e:
        raise ValueError(f"not an ESRGAN/RRDBNet checkpoint: missing {e}")
    n_feat, ch_in = first.shape[0], first.shape[1]
    n_block = 1 + max(int(k.split(".")[1]) for k in state
                      if k.startswith("body."))
    if ch_in % 3 != 0 or int((ch_in // 3) ** 0.5) ** 2 * 3 != ch_in:
        raise ValueError(f"unsupported ESRGAN input channels {ch_in}")
    return EsrganParams(n_feat=n_feat, n_block=n_block, growth=g,
                        unshuffle=int((ch_in // 3) ** 0.5))


def _infer_srvgg(state: Dict[str, np.ndarray]) -> SrvggParams:
    idx = sorted(int(k.split(".")[1]) for k in state
                 if k.startswith("body.") and k.endswith(".weight"))
    last = idx[-1]
    n_conv = (last - 2) // 2
    n_feat = state["body.0.weight"].shape[0]
    out_ch = state[f"body.{last}.weight"].shape[0]
    ch_img = state["body.0.weight"].shape[1]
    r2 = out_ch // ch_img
    return SrvggParams(n_feat=n_feat, n_conv=n_conv,
                       scale=int(round(r2 ** 0.5)), ch_img=ch_img)


def build_upscaler(P) -> nn.Module:
    """The module of ``P`` (``EsrganParams`` or ``SrvggParams``) on the
    meta device."""
    with torch.device("meta"):
        return (SRVGGNetCompact(P) if isinstance(P, SrvggParams)
                else RRDBNet(P))


def load_esrgan(path: str, device, dtype: torch.dtype
                ) -> Tuple[nn.Module, object]:
    """A checkpoint -> (the upscaler on ``device`` in ``dtype``, its
    params); ``ValueError`` for a file of neither architecture or with
    tensors missing."""
    state = load_esrgan_state(path)
    if "conv_first.weight" in state:
        P = infer_params(state)
    elif "body.0.weight" in state:          # SRVGGNetCompact
        P = _infer_srvgg(state)
    else:
        raise ValueError("not an ESRGAN/RRDBNet/SRVGG checkpoint")
    m = build_upscaler(P)
    names = list(m.state_dict())
    missing = [n for n in names if n not in state]
    if missing:
        raise ValueError(
            f"{len(missing)} tensors missing from ESRGAN checkpoint, "
            "e.g. " + ", ".join(missing[:5]))
    m.load_state_dict({n: torch.from_numpy(state[n]).to(device, dtype)
                       for n in names}, strict=True, assign=True)
    return m.eval(), P
