"""CLIP text encoder (port of ``mlimgsynth_tpu/models/clip.py``).

``state_dict`` names match the internal scheme below the ``clip.text.``
prefix (``encoder.layers.N.attn.q_proj.weight`` ...).  The MLP activation is
chosen by width as in the reference: gelu_quick for SD1's 768, tanh-gelu
for 1024/1280.
"""
from __future__ import annotations

from torch import nn

from ..tokenizer import CLIP_VIT_L_14, ClipParams
from . import blocks as B

__all__ = ["ClipParams", "CLIP_VIT_L_14", "ClipText", "clip_skip_layers"]


class _Embed(nn.Module):
    def __init__(self, P: ClipParams):
        super().__init__()
        self.token = nn.Embedding(P.n_vocab, P.d_embed)
        self.position = nn.Embedding(P.n_token, P.d_embed)


class _Mlp(nn.Module):
    def __init__(self, P: ClipParams):
        super().__init__()
        self.fc1 = B.linear(P.d_embed, P.n_interm)
        self.fc2 = B.linear(P.n_interm, P.d_embed)
        self.act = B.gelu_tanh if P.d_embed in (1024, 1280) else B.gelu_quick

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _Layer(nn.Module):
    """ref: mlb_clip_layer (causal self-attention, pre-norm)."""

    def __init__(self, P: ClipParams):
        super().__init__()
        self.norm1 = B.LayerNorm(P.d_embed)
        self.attn = B.AttnMHead(P.d_embed, P.d_embed, P.d_embed, P.d_embed,
                                P.n_head, bias=True)
        self.norm2 = B.LayerNorm(P.d_embed)
        self.mlp = _Mlp(P)

    def forward(self, x):
        x = x + self.attn(self.norm1(x), mask=True)
        return x + self.mlp(self.norm2(x))


def clip_skip_layers(P: ClipParams, clip_skip: int) -> int:
    """Layers run for a given clip skip (1 or 0: all of them)."""
    return P.n_layer - (clip_skip - 1) if clip_skip > 1 else P.n_layer


class ClipText(nn.Module):
    """Text tower.  tokens [N, n_token] int -> hidden [N, n_token, d]."""

    def __init__(self, P: ClipParams):
        super().__init__()
        self.P = P
        self.embed = _Embed(P)
        self.encoder = nn.ModuleDict(
            {"layers": nn.ModuleList(_Layer(P) for _ in range(P.n_layer))})
        self.ln_final = B.LayerNorm(P.d_embed)

    def forward(self, tokens, clip_skip: int = 0, norm: bool = True):
        x = self.embed.token(tokens) + self.embed.position.weight
        for layer in self.encoder["layers"][:clip_skip_layers(self.P,
                                                              clip_skip)]:
            x = layer(x)
        return self.ln_final(x) if norm else x

    def encode_windows(self, tokens, clip_skip: int = 0, norm: bool = True):
        """tokens [N, W, n_token]: every 77-token window encoded in one
        batch, concatenated on the sequence axis -> [N, W*n_token, d]
        (A1111 long-prompt chunking)."""
        n, w, t = tokens.shape
        emb = self(tokens.reshape(n * w, t), clip_skip, norm)
        return emb.reshape(n, w * t, -1)
