"""NN building blocks (port of ``mlimgsynth_tpu/models/blocks.py``).

The JAX package requests parameters by hierarchical name from a ``Ctx``;
here every block is an ``nn.Module`` whose ``state_dict`` names are exactly
the JAX package's internal names below the model prefix, so a checkpoint
maps onto the modules through the ``nameconv`` rules.

Conventions: NCHW activations, torch weight layouts (linear [out, in],
conv OIHW), compute in the parameters' dtype; norms take their statistics
in f32 and softmax runs in f32 (``ops/attention.py``).

Seamless tiling (the JAX package's ``Ctx(tiling=True)``, ``blocks.py:
53-59``, ``:143-146``, ``:244-247``) is a switch on the loaded modules:
:func:`set_tiling` makes every padded conv pad circularly, so the conv
stack is wrap-equivariant; the weights stay where they are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant_matmul as qmm
from ..ops.attention import attention_t


# ---------------------------------------------------------------------------
# Activations (ggml-exact variants)
# ---------------------------------------------------------------------------

def silu(x):
    return F.silu(x)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    return F.gelu(x)


def gelu_quick(x):
    # ggml_gelu_quick: x * sigmoid(1.702 x)
    return x * torch.sigmoid(1.702 * x)


# ---------------------------------------------------------------------------
# Core layers
# ---------------------------------------------------------------------------

def linear(n_in: int, n_out: int, bias: bool = True) -> nn.Linear:
    """ref: mlb_nn_linear.  Weight [out, in]."""
    return nn.Linear(n_in, n_out, bias=bias)


class QLinear(nn.Module):
    """Weight-only quantized linear (ref: the ``.weight_q8`` / ``.weight_q4``
    branch of ``linear``, ``mlimgsynth_tpu/models/blocks.py:110-131``).

    Buffers ``weight_q8`` (int8 [out, in]) or ``weight_q4`` (packed int8
    [out, in/2]) and ``weight_scale``: f32 [out, in/128], or f32 [out] for
    an 8-bit weight stored per column (``percol``, the DiT families' W8A8
    candidates).  The bias stays in the compute dtype and is added after
    the product.  The product goes to ``ops/quant_matmul``: a CUDA kernel on
    CUDA tensors, the plain version on CPU tensors.

    ``plan_kn``: the (K, N) of the whole weight where this module holds a tp
    rank's share of it (``parallel/tensor_parallel.py``): the per-column
    weight's route (``pick_large_m_plan``) is decided on the whole weight,
    as one rank decides it."""

    def __init__(self, n_in: int, n_out: int, bits: int, bias: bool = True,
                 percol: bool = False, plan_kn=None):
        super().__init__()
        if bits not in (4, 8) or n_in % 128 or (percol and bits != 8):
            raise ValueError(f"QLinear: {bits}-bit, input width {n_in}, "
                             f"per column {percol}")
        self.bits = bits
        self.in_features, self.out_features = n_in, n_out
        self.plan_kn = tuple(plan_kn or (n_in, n_out))
        self.register_buffer(
            "weight_q4" if bits == 4 else "weight_q8",
            torch.empty(n_out, n_in // 2 if bits == 4 else n_in,
                        dtype=torch.int8))
        self.register_buffer("weight_scale", torch.empty(
            (n_out,) if percol else (n_out, n_in // 128)))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def product(self, x):
        """x . deq(W)^T, without the bias."""
        if self.bits == 4:
            return qmm.q4_dot(x, self.weight_q4, self.weight_scale)
        return qmm.q8_dot(x, self.weight_q8, self.weight_scale,
                          plan_kn=self.plan_kn)

    def forward(self, x):
        y = self.product(x)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def conv2d(ch_in: int, ch_out: int, kernel: int = 3, stride: int = 1,
           pad: int = 1, bias: bool = True) -> nn.Conv2d:
    """ref: mlb_nn_conv2d.  Weight OIHW, symmetric zero padding;
    ``kernel=stride=p, pad=0`` is the DiT's patchify."""
    return nn.Conv2d(ch_in, ch_out, kernel, stride=stride, padding=pad,
                     bias=bias)


def set_tiling(module: nn.Module, on: bool) -> None:
    """Seamless tiling on or off for every padded conv of ``module``: the
    conv pads circularly (``padding_mode``), and the VAE encoder's
    asymmetric downsampling pad wraps too.  Unpadded convs (1x1, the DiT's
    patchify) are left alone."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d) and any(m.padding):
            m.padding_mode = "circular" if on else "zeros"
        elif isinstance(m, Downsample):
            m.tiling = on


class LayerNorm(nn.Module):
    """ref: mlb_nn_layer_norm.  Normalizes the last dim; f32 statistics.
    ``affine=False`` has no parameters (the MMDiT's norms, eps 1e-6)."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), x.shape[-1:], w, b,
                            self.eps).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm over the last dim, f32 statistics, eps 1e-6: the per-head
    q/k norms of SD3.5 (``mlimgsynth_tpu/models/mmdit.py:93-98``, its scale
    named ``weight``) and Flux (``flux.py:117-122``, ``scale``)."""

    def __init__(self, dim: int, param: str = "weight"):
        super().__init__()
        self.param = param
        self.register_parameter(param, nn.Parameter(torch.ones(dim)))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
        return (n * getattr(self, self.param).float()).to(x.dtype)


def modulate(x, shift, scale):
    """adaLN modulation (``mlimgsynth_tpu/models/mmdit.py:87-90``): shift
    and scale are f32 [N, d], x is [N, S, d] in the compute dtype."""
    dt = x.dtype
    return (x * (1.0 + scale[:, None, :]).to(dt)
            + shift[:, None, :].to(dt))


class GroupNorm(nn.Module):
    """ref: mlb_nn_groupnorm32 (32 groups, eps 1e-6).  x: [N, C, H, W];
    f32 statistics."""

    def __init__(self, ch: int, n_grp: int = 32, eps: float = 1e-6):
        super().__init__()
        self.n_grp, self.eps = n_grp, eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.group_norm(x.float(), self.n_grp, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Downsample(nn.Module):
    """ref: mlb_downsample.  Stride-2 3x3 conv, symmetric pad 1; the VAE
    encoder's (``vae=True``) pads 0 before and 1 after on both spatial dims
    (``mlimgsynth_tpu/models/blocks.py:213-219``)."""

    def __init__(self, ch_in: int, ch_out: int, vae: bool = False):
        super().__init__()
        self.vae = vae
        self.tiling = False
        self.conv = conv2d(ch_in, ch_out, 3, 2, 0 if vae else 1)

    def forward(self, x):
        if self.vae:
            x = F.pad(x, (0, 1, 0, 1),
                      mode="circular" if self.tiling else "constant")
        return self.conv(x)


class Upsample(nn.Module):
    """ref: mlb_upsample.  Nearest 2x, then a 3x3 conv.  (The JAX package
    folds both into one lhs-dilated 4x4 conv: the same sum in another
    order.)"""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.conv = conv2d(ch_in, ch_out)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Resnet(nn.Module):
    """ref: mlb_resnet.  ``n_emb`` > 0 adds the time-embedding projection."""

    def __init__(self, ch_in: int, ch_out: int, n_emb: int = 0):
        super().__init__()
        self.norm1 = GroupNorm(ch_in)
        self.conv1 = conv2d(ch_in, ch_out)
        if n_emb:
            self.emb_proj = linear(n_emb, ch_out)
        self.norm2 = GroupNorm(ch_out)
        self.conv2 = conv2d(ch_out, ch_out)
        if ch_in != ch_out:
            self.skip_conv = conv2d(ch_in, ch_out, 1, 1, 0)

    def forward(self, x, emb=None):
        h = self.conv1(silu(self.norm1(x)))
        if emb is not None:
            h = h + self.emb_proj(silu(emb))[:, :, None, None].to(h.dtype)
        h = self.conv2(silu(self.norm2(h)))
        if hasattr(self, "skip_conv"):
            x = self.skip_conv(x)
        return h + x


class GEGLU(nn.Module):
    """ref: mlb_GEGLU."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = linear(d_in, d_out * 2)

    def forward(self, x):
        xh, g = self.proj(x).chunk(2, dim=-1)
        return xh * gelu_tanh(g)


class FeedForward(nn.Module):
    """ref: mlb_feed_forward.  Names ``net.0.proj`` and ``net.2``."""

    def __init__(self, d: int, d_out: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleDict({"0": GEGLU(d, d * mult),
                                  "2": linear(d * mult, d_out)})

    def forward(self, x):
        return self.net["2"](self.net["0"](x))


class AttnMHead(nn.Module):
    """ref: mlb_attn_mhead.  q: [N, Sq, d_q], kv: [N, Sk, d_kv] ->
    [N, Sq, d_out]; ``mask`` makes it causal.  The attention takes the
    route of the JAX package's ``attention_t`` (the flash gate, never the
    large-S K3 gate), as ``attn_mhead`` sends the UNet's self-attention."""

    def __init__(self, d_q: int, d_kv: int, d_out: int, d_embed: int,
                 n_head: int, bias: bool = False, bias_out: bool = True):
        super().__init__()
        self.n_head = n_head
        self.q_proj = linear(d_q, d_embed, bias)
        self.k_proj = linear(d_kv, d_embed, bias)
        self.v_proj = linear(d_kv, d_embed, bias)
        self.out_proj = linear(d_embed, d_out, bias_out)

    def forward(self, x, kv=None, mask: bool = False,
                identity: bool = False):
        """``identity``: perturbed-attention mode (``attn_mhead``,
        ``mlimgsynth_tpu/models/blocks.py:389-396``): the attention map is
        the identity, so the output is ``out_proj(v_proj(kv))``."""
        kv = x if kv is None else kv
        if identity:
            return self.out_proj(self.v_proj(kv))
        n, sq, sk = x.shape[0], x.shape[1], kv.shape[1]
        h = self.n_head

        def heads(t, s):    # [N, S, H*D] -> [N, H, S, D] view
            return t.view(n, s, h, -1).transpose(1, 2)

        o = attention_t(heads(self.q_proj(x), sq), heads(self.k_proj(kv), sk),
                        heads(self.v_proj(kv), sk), causal=mask)
        return self.out_proj(o.transpose(1, 2).reshape(n, sq, -1))


class BasicTransformer(nn.Module):
    """ref: mlb_basic_transf.  x: [N, S, d], c: [N, S_ctx, d_ctx];
    ``self_identity`` gives the self-attention the identity map (PAG)."""

    def __init__(self, d: int, d_ctx: int, n_head: int):
        super().__init__()
        self.norm1 = LayerNorm(d)
        self.attn1 = AttnMHead(d, d, d, d, n_head)
        self.norm2 = LayerNorm(d)
        self.attn2 = AttnMHead(d, d_ctx, d, d, n_head)
        self.norm3 = LayerNorm(d)
        self.ff = FeedForward(d, d)

    def forward(self, x, c, self_identity: bool = False):
        x = x + self.attn1(self.norm1(x), identity=self_identity)
        x = x + self.attn2(self.norm2(x), c)
        return x + self.ff(self.norm3(x))


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """CompVis sinusoidal embedding, cos half then sin half.  t: [N] ->
    [N, dim] f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
