"""CLIP text encoder (port of ``mlimgsynth_tpu/models/clip.py``).

``state_dict`` names match the internal scheme below the ``clip.text.``
(or ``clip2.text.``) prefix (``encoder.layers.N.attn.q_proj.weight`` ...).
The MLP activation is chosen by width as in the reference: gelu_quick for
SD1's 768, tanh-gelu for 1024 (SD2's OpenCLIP ViT-H) and 1280 (bigG).  A
tower built with ``proj=True`` also holds ``text_proj`` [d, d] (JAX layout,
``rows @ text_proj``) and gives the projected pooled feature (SD3's two
towers; SDXL's second); one without gives the unprojected pooled row (HF
``pooler_output``, Flux's label; ``feat_proj=False`` in the JAX package).
"""
from __future__ import annotations

import torch
from torch import nn

from ..tokenizer import (CLIP_VIT_BIGG_14, CLIP_VIT_H_14, CLIP_VIT_L_14,
                         ClipParams)
from . import blocks as B

__all__ = ["ClipParams", "CLIP_VIT_L_14", "CLIP_VIT_H_14", "CLIP_VIT_BIGG_14",
           "ClipText", "clip_skip_layers"]


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

    def __init__(self, P: ClipParams, proj: bool = False):
        super().__init__()
        self.P = P
        self.embed = _Embed(P)
        self.encoder = nn.ModuleDict(
            {"layers": nn.ModuleList(_Layer(P) for _ in range(P.n_layer))})
        self.ln_final = B.LayerNorm(P.d_embed)
        if proj:
            self.text_proj = nn.Parameter(torch.empty(P.d_embed, P.d_embed))

    def forward(self, tokens, clip_skip: int = 0, norm: bool = True):
        return self.encode(tokens, clip_skip, norm)[0]

    def encode(self, tokens, clip_skip: int = 0, norm: bool = True,
               feat_idx=None):
        """ref: ``clip_text_apply`` (``mlimgsynth_tpu/models/clip.py:
        50-95``).  Returns (hidden [N, n_token, d], feat): the hidden after
        ``clip_skip`` (normed if ``norm``) and, where ``feat_idx`` [N] is
        given, the pooled feature f32 [N, d] of that token, read from the
        full stack after the final norm and projected by ``text_proj``
        where the tower has one.  One pass serves both: the skip hidden is
        taken mid-stack."""
        n_eff = clip_skip_layers(self.P, clip_skip)
        layers = self.encoder["layers"]
        n_run = len(layers) if feat_idx is not None else n_eff
        x = self.embed.token(tokens) + self.embed.position.weight
        x_skip = x if n_eff == 0 else None
        for i, layer in enumerate(layers[:n_run]):
            x = layer(x)
            if i + 1 == n_eff:
                x_skip = x
        feat = None
        if feat_idx is not None:
            rows = self.ln_final(x)[torch.arange(x.shape[0],
                                                 device=x.device), feat_idx]
            feat = rows.float()
            if hasattr(self, "text_proj"):
                feat = feat @ self.text_proj.float()
        return (self.ln_final(x_skip) if norm else x_skip), feat

    def encode_windows(self, tokens, clip_skip: int = 0, norm: bool = True,
                       feat_idx=None):
        """tokens [N, W, n_token]: every 77-token window encoded in one
        batch, concatenated on the sequence axis -> ([N, W*n_token, d],
        feat) (A1111 long-prompt chunking, ``clip_text_apply_nd``); the
        pooled feature is read from window 0 at ``feat_idx`` [N]."""
        n, w, t = tokens.shape
        full = None
        if feat_idx is not None:
            full = torch.zeros(n * w, dtype=torch.long, device=tokens.device)
            full[::w] = feat_idx
        emb, feat = self.encode(tokens.reshape(n * w, t), clip_skip, norm,
                                full)
        return emb.reshape(n, w * t, -1), (None if feat is None
                                           else feat[::w])
