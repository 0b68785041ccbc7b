"""T5 v1.1 encoder, SD3's third text tower (port of
``mlimgsynth_tpu/models/t5.py``).

RMSNorm with f32 statistics and eps 1e-6, no mean, no bias; UNSCALED
dot-product attention whose logits take block 0's relative-position bias
(32 buckets, max distance 128) in every layer; the gated feed-forward
``wo(gelu_tanh(wi_0 x) * wi_1 x)``; no linear has a bias and no padding
mask is applied (pad positions are context, as in the public SD3
pipelines).  ``state_dict`` names are the HF ``T5EncoderModel`` names below
the ``t5.`` prefix (``shared.weight``, ``encoder.block.N.layer.0.
SelfAttention.q.weight`` ...), as the sd3 single-file layout and a bare T5
file ship them.

The sequence is at most a few hundred tokens with a logits bias, so the
attention is plain torch (f32 logits and softmax): the JAX package runs it
on the XLA softmax path too, with no Pallas kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..errors import MlisError
from ..tokenizer_json import Tokenizer
from . import blocks as B


@dataclass(frozen=True)
class T5Params:
    d_model: int = 4096
    d_kv: int = 64
    n_head: int = 64
    d_ff: int = 10240
    n_layer: int = 24
    n_vocab: int = 32128
    rel_buckets: int = 32
    rel_max_dist: int = 128


T5_XXL = T5Params()

T5_PAD_ID = 0
T5_EOS_ID = 1

_BIAS = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def params_from_spec_shapes(shapes: Mapping[str, Tuple[int, ...]]
                            ) -> T5Params:
    """The T5 geometry from tensor shapes (internal ``t5.`` names, the
    checkpoint's [out, in] layout), for any T5 v1.1 size."""
    n_vocab, d_model = shapes["t5.shared.weight"]
    inner = shapes["t5.encoder.block.0.layer.0.SelfAttention.q.weight"][0]
    rel = shapes["t5." + _BIAS]
    n_head = rel[1]
    d_ff = shapes["t5.encoder.block.0.layer.1.DenseReluDense.wi_0.weight"][0]
    n_layer = 0
    while f"t5.encoder.block.{n_layer}.layer.0.layer_norm.weight" in shapes:
        n_layer += 1
    return T5Params(d_model=int(d_model), d_kv=int(inner) // int(n_head),
                    n_head=int(n_head), d_ff=int(d_ff), n_layer=n_layer,
                    n_vocab=int(n_vocab), rel_buckets=int(rel[0]))


def _rel_bucket_np(rel_pos: np.ndarray, num_buckets: int,
                   max_dist: int) -> np.ndarray:
    """Bidirectional relative-position bucketing (T5 convention):
    rel_pos = memory_pos - context_pos."""
    nb = num_buckets // 2
    ret = (rel_pos > 0).astype(np.int64) * nb
    n = np.abs(rel_pos)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / math.log(max_dist / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return ret + np.where(n < max_exact, n, large)


def rel_bias_indices(s: int, num_buckets: int = 32,
                     max_dist: int = 128) -> np.ndarray:
    """[s, s] bucket ids for a length-s sequence (on the host)."""
    ctx_pos = np.arange(s, dtype=np.int64)[:, None]
    mem_pos = np.arange(s, dtype=np.int64)[None, :]
    return _rel_bucket_np(mem_pos - ctx_pos, num_buckets, max_dist)


class _Norm(nn.Module):
    """T5 LayerNorm: RMS only, f32 statistics, a scale, no bias."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        y = (xf * torch.reciprocal(torch.sqrt(var + self.eps))).to(x.dtype)
        return y * self.weight.to(x.dtype)


class _Attention(nn.Module):
    def __init__(self, P: T5Params, bias_table: bool):
        super().__init__()
        inner = P.n_head * P.d_kv
        self.P = P
        self.q = B.linear(P.d_model, inner, bias=False)
        self.k = B.linear(P.d_model, inner, bias=False)
        self.v = B.linear(P.d_model, inner, bias=False)
        self.o = B.linear(inner, P.d_model, bias=False)
        if bias_table:
            self.relative_attention_bias = nn.Embedding(P.rel_buckets,
                                                        P.n_head)

    def forward(self, x, bias):
        """x [N, S, d]; bias f32 [1, H, S, S]."""
        n, s, _ = x.shape
        P = self.P

        def heads(t):
            return t.reshape(n, s, P.n_head, P.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        # f32 logits of the compute-dtype operands, no 1/sqrt(d) scale
        logits = q.float() @ k.float().transpose(-1, -2) + bias
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        o = (w @ v).transpose(1, 2).reshape(n, s, P.n_head * P.d_kv)
        return self.o(o)


class _Ffn(nn.Module):
    def __init__(self, P: T5Params):
        super().__init__()
        self.wi_0 = B.linear(P.d_model, P.d_ff, bias=False)
        self.wi_1 = B.linear(P.d_model, P.d_ff, bias=False)
        self.wo = B.linear(P.d_ff, P.d_model, bias=False)

    def forward(self, x):
        return self.wo(B.gelu_tanh(self.wi_0(x)) * self.wi_1(x))


class _AttnLayer(nn.Module):
    def __init__(self, P: T5Params, bias_table: bool):
        super().__init__()
        self.SelfAttention = _Attention(P, bias_table)
        self.layer_norm = _Norm(P.d_model)


class _FfnLayer(nn.Module):
    def __init__(self, P: T5Params):
        super().__init__()
        self.DenseReluDense = _Ffn(P)
        self.layer_norm = _Norm(P.d_model)


class _Block(nn.Module):
    def __init__(self, P: T5Params, first: bool):
        super().__init__()
        self.layer = nn.ModuleList([_AttnLayer(P, first), _FfnLayer(P)])

    def forward(self, x, bias):
        a, f = self.layer
        x = x + a.SelfAttention(a.layer_norm(x), bias)
        return x + f.DenseReluDense(f.layer_norm(x))


class _Encoder(nn.Module):
    def __init__(self, P: T5Params):
        super().__init__()
        self.block = nn.ModuleList(_Block(P, i == 0)
                                   for i in range(P.n_layer))
        self.final_layer_norm = _Norm(P.d_model)


class T5Encoder(nn.Module):
    """tokens [N, S] int -> hidden [N, S, d_model] in the parameters'
    dtype (``t5_encode_apply``, ``mlimgsynth_tpu/models/t5.py:134-154``)."""

    def __init__(self, P: T5Params):
        super().__init__()
        self.P = P
        self.shared = nn.Embedding(P.n_vocab, P.d_model)
        self.encoder = _Encoder(P)
        # (sequence length, device) -> bucket ids there: the copy to the
        # card waits for the queued work, so it is made once
        self._bias_idx = {}

    def forward(self, tokens):
        P = self.P
        x = self.shared(tokens)
        key = (tokens.shape[1], tokens.device)
        if key not in self._bias_idx:
            self._bias_idx[key] = torch.from_numpy(rel_bias_indices(
                key[0], P.rel_buckets, P.rel_max_dist)).to(tokens.device)
        table = self.encoder.block[0].layer[0].SelfAttention \
            .relative_attention_bias.weight.float()
        bias = table[self._bias_idx[key]].permute(2, 0, 1)[None]
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)


def tokenize(texts: Sequence[str], n_token: int = 77,
             tokenizer_json: Optional[str] = None) -> np.ndarray:
    """int32 [len(texts), n_token]: each text's ids from the
    ``tokenizer.json`` (``tokenizer_json.Tokenizer``, the ids of the HF
    ``tokenizers`` package), cut to ``n_token - 1``, then EOS (1), then
    padding (0), as the JAX package's ``tokenize``.  A file whose
    post-processor appends ``</s>`` already gives ids that end in EOS; the
    JAX package appends a second one, and so does this function."""
    if not tokenizer_json:
        raise MlisError(MlisError.E_OPT_VALUE,
                        "T5 tokenization needs a tokenizer.json path "
                        "(option t5_tokenizer)")
    tok = Tokenizer(tokenizer_json)
    out = np.full((len(texts), n_token), T5_PAD_ID, np.int32)
    for i, text in enumerate(texts):
        ids: List[int] = tok.encode(text)[:n_token - 1] + [T5_EOS_ID]
        out[i, :len(ids)] = ids
    return out
