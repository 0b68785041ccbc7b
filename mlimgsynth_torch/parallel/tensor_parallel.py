"""Megatron tensor parallelism over the ``tp`` ranks (port of
``mlimgsynth_tpu/parallel/shard_map_tp.py`` and of the tp rules of
``mesh.py``).

:func:`shard` turns a model built on the meta device into this rank's
share, and slices its float state dict to match:

- a linear that ``mesh.param_spec`` makes column-parallel keeps its share
  of the output rows; a row-parallel one (:class:`RowLinear`) its share of
  the input columns, its partial products summed over the tp group in f32
  and its bias added once, after the sum;
- a fused projection gives each rank whole heads of each of its parts,
  where GSPMD re-tiled across them: the MMDiT's and Flux's ``qkv`` (q, k,
  v), Flux's ``linear1`` ([q | k | v | mlp]) and ``linear2`` (input
  [attn | mlp]), and the GEGLU ``ff.net.0.proj`` (value_i, gate_i), as
  ``shard_transformer_params`` reorders it;
- the attention modules run n_head / tp heads, and T5's relative-position
  bias keeps its rank's heads (``[buckets, n_head]`` sliced by column).

A quantized linear (``blocks.QLinear``) is quantized whole first, so that
every decision keyed on its shape (per-column storage, its uniformity
group, the W8A8 slab, the route) is one rank's; then:

- column-parallel, a rank keeps its rows of the int8 / packed int4 weight
  and of its scales (per block or per column): the whole product's rows,
  bit for bit;
- row-parallel, a per-block weight keeps its whole 128-blocks of K (and of
  the scales) where every part's share is a multiple of 128, so that each
  activation block of the ``MLIS_Q8_MODE=int8`` route is quantized as on
  one rank (:class:`QRowLinear`, partial products summed in f32 as
  :class:`RowLinear`); a per-column weight (the W8A8 route's, whose
  activations are quantized per slab of the whole K), and a weight whose
  K does not split into whole blocks, stays whole on every rank with its
  input all-gathered (:class:`QGatherLinear`): its product is one rank's,
  bit for bit, as the JAX package keeps every quantized weight whole.

Which models take tp is the session's choice (the UNet, ControlNet, the
DiTs and T5; CLIP and the VAE stay whole on every rank).
"""
from __future__ import annotations

import re
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..errors import MlisError
from ..models.blocks import QLinear
from ..ops import quant
from . import comm
from .mesh import TP_AXIS, param_spec


class RowLinear(nn.Linear):
    """A row-parallel linear: this rank's input columns; the partial
    product in f32 (as one rank's product accumulates before its one
    rounding), summed over ``group`` in f32, the bias added once and the
    result cast once to the input's dtype."""

    group = None

    def forward(self, x):
        y = comm.all_reduce_sum(F.linear(x.float(), self.weight.float()),
                                self.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class QRowLinear(QLinear):
    """A row-parallel quantized linear: this rank's whole 128-blocks of the
    input (:class:`RowLinear`'s sum and bias)."""

    group = None

    def forward(self, x):
        y = comm.all_reduce_sum(self.product(x).float(), self.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class QGatherLinear(QLinear):
    """A quantized linear kept whole on every rank behind a column-parallel
    one: the ranks' input shares are gathered (each fused part's shares in
    rank order) and the whole product runs on every rank."""

    group = None
    parts: List[int] = []
    tp = 1

    def forward(self, x):
        return super().forward(gather_parts(x, self.parts, self.tp,
                                            self.group))


def gather_parts(x: torch.Tensor, parts: List[int], tp: int, group
                 ) -> torch.Tensor:
    """The whole last dimension from the ranks' shares of it: each rank
    holds its share of every part of ``parts`` (:func:`_take`); the result
    holds every part whole, in order."""
    g = comm.all_gather(x, group, dim=-1)
    share = x.shape[-1]
    out = []
    o = 0
    for p in parts:
        w = p // tp
        out += [g.narrow(-1, r * share + o, w) for r in range(tp)]
        o += w
    return torch.cat(out, dim=-1)


def _q_splits_rows(m: QLinear, parts: List[int], tp: int) -> bool:
    """Whether a row-parallel quantized linear keeps its share of K: a
    per-block weight whose every part's share is whole 128-blocks (an
    activation block never spans two ranks)."""
    return m.weight_scale.dim() == 2 and all(
        p % tp == 0 and (p // tp) % quant.KBLOCK == 0 for p in parts)


def _shard_q(m: QLinear, full: str, out: Dict[str, torch.Tensor], col: bool,
             parts: List[int], tp: int, r: int, group) -> nn.Module:
    """Rank ``r``'s module for the quantized linear ``m`` at ``full``, its
    tensors in ``out`` cut to match (module docstring)."""
    bits = m.bits
    wkey = f"{full}.weight_q{bits}"
    skey = full + ".weight_scale"
    percol = out[skey].dim() == 1
    bias = m.bias is not None
    kn = (m.in_features, m.out_features)
    if col:
        out[wkey] = _take(out[wkey], 0, parts, tp, r)
        out[skey] = _take(out[skey], 0, parts, tp, r)
        if bias:
            out[full + ".bias"] = _take(out[full + ".bias"], 0, parts, tp, r)
        n_out = out[skey].shape[0]
        with torch.device("meta"):
            return QLinear(m.in_features, n_out, bits, bias, percol, kn)
    if _q_splits_rows(m, parts, tp):
        per_byte = 2 if bits == 4 else 1
        out[wkey] = _take(out[wkey], 1, [p // per_byte for p in parts], tp,
                          r)
        out[skey] = _take(out[skey], 1, [p // quant.KBLOCK for p in parts],
                          tp, r)
        with torch.device("meta"):
            new = QRowLinear(m.in_features // tp, m.out_features, bits, bias,
                             percol, kn)
    else:
        with torch.device("meta"):
            new = QGatherLinear(m.in_features, m.out_features, bits, bias,
                                percol)
        new.parts, new.tp = parts, tp
    new.group = group
    return new


def _parts(name: str, n_out: int, n_in: int, col: bool) -> List[int]:
    """The widths of the fused parts of a linear's split dimension, each
    split over the ranks on its own."""
    if col and re.search(r"\.(qkv)$", name):
        return [n_out // 3] * 3
    if col and name.endswith(".ff.net.0.proj"):
        return [n_out // 2] * 2
    if re.search(r"\.single_blocks\.\d+\.linear1$", name):
        # [q | k | v | mlp]: 3 d + mlp_ratio d with d = n_in
        return [n_in] * 3 + [n_out - 3 * n_in]
    if re.search(r"\.single_blocks\.\d+\.linear2$", name):
        # input [attn | mlp]: d + mlp_ratio d with d = n_out
        return [n_out, n_in - n_out]
    return [n_out if col else n_in]


def _take(t: torch.Tensor, dim: int, parts: List[int], tp: int,
          r: int) -> torch.Tensor:
    """Rank ``r``'s share of each part of ``t`` along ``dim``,
    concatenated."""
    out, o = [], 0
    for p in parts:
        if p % tp:
            raise MlisError(MlisError.E_OPT_VALUE,
                            f"tp {tp} does not divide a width of {p}")
        w = p // tp
        out.append(t.narrow(dim, o + r * w, w))
        o += p
    return torch.cat(out, dim=dim).contiguous()


def _replace(model: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    owner = model.get_submodule(parent) if parent else model
    if isinstance(owner, (nn.ModuleDict, nn.ModuleList)):
        owner[leaf] = new
    else:
        setattr(owner, leaf, new)


def shard(model: nn.Module, prefix: str, params: Dict[str, torch.Tensor],
          tp: int, r: int, group) -> Dict[str, torch.Tensor]:
    """Make ``model`` (on the meta device, its full geometry, its linears
    quantized or not) rank ``r``'s tp share in place, and return ``params``
    (its full state dict under ``prefix``) sliced to match."""
    out = dict(params)
    for name, m in list(model.named_modules()):
        full = prefix + name
        if isinstance(m, QLinear):
            spec = param_spec(full + ".weight", 2)
            if TP_AXIS not in spec:
                continue
            col = spec[1] == TP_AXIS
            new = _shard_q(m, full, out, col,
                           _parts(full, m.out_features, m.in_features, col),
                           tp, r, group)
            _replace(model, name, new)
        elif isinstance(m, nn.Linear):
            spec = param_spec(full + ".weight", 2)
            if TP_AXIS not in spec:
                continue
            col = spec[1] == TP_AXIS          # [in, out]: output split
            parts = _parts(full, m.out_features, m.in_features, col)
            w = out[full + ".weight"]
            out[full + ".weight"] = _take(w, 0 if col else 1, parts, tp, r)
            n_out = out[full + ".weight"].shape[0]
            n_in = out[full + ".weight"].shape[1]
            bias = m.bias is not None
            if bias and col:
                out[full + ".bias"] = _take(out[full + ".bias"], 0, parts,
                                            tp, r)
            with torch.device("meta"):
                new = (nn.Linear if col else RowLinear)(n_in, n_out,
                                                        bias=bias)
            if not col:
                new.group = group
            _replace(model, name, new)
        elif name.endswith("SelfAttention") and hasattr(
                m, "relative_attention_bias"):
            key = full + ".relative_attention_bias.weight"
            out[key] = _take(out[key], 1, [out[key].shape[1]], tp, r)
            with torch.device("meta"):
                m.relative_attention_bias = nn.Embedding(*out[key].shape)
    for name, m in model.named_modules():
        if isinstance(getattr(m, "n_head", None), int):
            if m.n_head % tp:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"tp {tp} does not divide the {m.n_head} "
                                f"heads of {prefix}{name}")
            m.n_head //= tp
    return out
