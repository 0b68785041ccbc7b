"""CLIP BPE tokenizer.

Reimplements the reference tokenizer (reference: src/clip.c:59-315), which in
turn follows OpenAI CLIP's ``simple_tokenizer.py``:

* token ids 0..255 are byte tokens, 256..511 the same bytes with an
  end-of-word marker, 512..512+n_merges-1 are merge results in merge-table
  order, then <|startoftext|>=49406 and <|endoftext|>=49407.
* text is split into words following CLIP's regex
  (``'s|'t|'re|'ve|'m|'ll|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` — note the
  reference's string list omits ``'d`` and we reproduce that exactly,
  src/clip.c:228-230), each word is lower-cased per codepoint, encoded to
  UTF-8 byte tokens with the last byte eow-marked, then greedily merged by
  lowest merge rank.
"""
from __future__ import annotations

import os
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data", "clip_merges.npy")

_merges: np.ndarray | None = None
_merge_rank: Dict[Tuple[int, int], int] | None = None


def _load_merges():
    global _merges, _merge_rank
    if _merges is None:
        _merges = np.load(_DATA)
        _merge_rank = {}
        for i, (l, r) in enumerate(_merges.tolist()):
            _merge_rank[(l, r)] = i
    return _merges, _merge_rank


@dataclass(frozen=True)
class ClipParams:
    """Text-encoder hyperparameters (reference: src/clip.c:23-57)."""
    n_vocab: int = 49408
    n_token: int = 77
    d_embed: int = 768
    n_interm: int = 3072
    n_head: int = 12
    n_layer: int = 24
    tok_start: int = 49406
    tok_end: int = 49407
    tok_pad: int = 49407


CLIP_VIT_L_14 = ClipParams(d_embed=768, n_interm=3072, n_head=12, n_layer=12,
                           tok_pad=49407)
CLIP_VIT_H_14 = ClipParams(d_embed=1024, n_interm=4096, n_head=16, n_layer=24,
                           tok_pad=0)
CLIP_VIT_BIGG_14 = ClipParams(d_embed=1280, n_interm=5120, n_head=20,
                              n_layer=32, tok_pad=0)


def byte_to_token(b: int) -> int:
    """Map a UTF-8 byte to its CLIP vocabulary token (src/clip.c:117-128)."""
    if b <= 32:
        return b + 188
    if b <= 126:
        return b - 33
    if b <= 160:
        return b + 94
    if b <= 172:
        return b - 67
    if b == 173:
        return 255
    return b - 68


def token_to_byte(t: int) -> int:
    if t <= 93:
        return t + 33
    if t <= 105:
        return t + 67
    if t <= 187:
        return t + 68
    if t <= 220:
        return t - 188
    if t <= 254:
        return t - 94
    if t == 255:
        return 173
    return -1


# Contraction strings the reference matches (case-insensitive); note the
# duplicated 've / missing 'd is faithful to src/clip.c:228-230.
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll")

_ASCII_SPACE = set(" \t\n\r\v\f")


def _is_space(ch: str) -> bool:
    return ch in _ASCII_SPACE or unicodedata.category(ch)[0] == "Z"


def word_split(text: str) -> List[str]:
    """Split text into tokenizer words (src/clip.c:209-253)."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        while i < n and _is_space(text[i]):
            i += 1
        if i >= n:
            break
        beg = i
        cat_in_progress = None
        while i < n:
            matched = None
            low = text[i:i + 3].lower()
            for c in _CONTRACTIONS:
                if low.startswith(c):
                    matched = c
                    break
            if matched is not None:
                if cat_in_progress is None:
                    i += len(matched)
                break
            ch = text[i]
            if _is_space(ch):
                break
            cat = unicodedata.category(ch)[0]
            if cat not in ("N", "L"):
                cat = "P"
            if cat_in_progress is None:
                cat_in_progress = cat
            elif cat != cat_in_progress:
                break
            i += 1
        words.append(text[beg:i])
    return [w for w in words if w]


def word_to_byte_tokens(word: str) -> List[int]:
    """Lower-case each codepoint and map UTF-8 bytes to byte tokens."""
    toks: List[int] = []
    for ch in word:
        lc = ch.lower()
        for b in lc.encode("utf-8"):
            toks.append(byte_to_token(b))
    return toks


def bpe_word(word: str) -> List[int]:
    """Byte-pair encode one word (src/clip.c:168-207)."""
    _, rank = _load_merges()
    toks = word_to_byte_tokens(word)
    if not toks:
        return []
    toks[-1] += 256  # end-of-word marker
    while len(toks) > 1:
        best_rank = None
        best_pos = 0
        for i in range(1, len(toks)):
            r = rank.get((toks[i - 1], toks[i]))
            if r is not None and (best_rank is None or r < best_rank):
                best_rank = r
                best_pos = i
        if best_rank is None:
            break
        toks[best_pos - 1] = best_rank + 512
        del toks[best_pos]
    return toks


def tokenize(text: str) -> List[int]:
    """Tokenize text into CLIP token ids (no start/end/pad added)."""
    out: List[int] = []
    for w in word_split(text):
        out.extend(bpe_word(w))
    return out


def token_decode(token: int) -> bytes:
    """Decode a token id back to bytes, for debugging (src/clip.c:280-306)."""
    merges, _ = _load_merges()
    if token < 0:
        raise ValueError("invalid token")
    if token <= 256:
        return bytes([token_to_byte(token)])
    if token <= 511:
        return bytes([token_to_byte(token - 256)]) + b" "
    idx = token - 512
    if idx >= len(merges):
        return b"<|SPECIAL|>"
    l, r = int(merges[idx, 0]), int(merges[idx, 1])
    return token_decode(l) + token_decode(r)


def token_str(token: int) -> str:
    try:
        return token_decode(token).decode("utf-8", errors="replace")
    except ValueError:
        return "<|INVALID|>"


def wrap_tokens(params: ClipParams, toks: List[int]) -> List[int]:
    """Add start/end tokens and pad to n_token (src/clip.c:448-455)."""
    if len(toks) + 2 > params.n_token:
        raise ValueError(f"prompt too long (max: {params.n_token - 2})")
    out = [params.tok_start] + list(toks) + [params.tok_end]
    out += [params.tok_pad] * (params.n_token - len(out))
    return out


# Sentinel token id marking a forced encoder-window break (prompt BREAK).
BREAK_TOKEN = -1


def split_windows(params: ClipParams, toks: List[int],
                  wts: List[float] | None = None, n_window: int = 0):
    """Split a token stream into (n_token-2)-token encoder windows (A1111
    long-prompt chunking; the reference instead errors past 75 tokens,
    src/clip.c:448-455).  ``BREAK_TOKEN`` sentinels force a window
    boundary.  Each window is wrapped start+toks+end and padded to
    ``params.n_token``; ``n_window`` larger than the natural count appends
    empty windows (used to align every row of a batched encode).

    Returns ``(windows [W][n_token], wrows [W][n_token], fidx0)``:
    per-token emphasis-weight rows aligned with the wrapped layout, and
    the end-token position of window 0 — the pooled feature is read from
    the FIRST chunk (the A1111/Comfy long-prompt convention).
    """
    cap = params.n_token - 2
    groups: List[List[Tuple[int, float]]] = [[]]
    for k, t in enumerate(toks):
        if t == BREAK_TOKEN:
            groups.append([])
            continue
        if len(groups[-1]) >= cap:
            groups.append([])
        groups[-1].append((t, wts[k] if wts is not None else 1.0))
    while len(groups) < max(1, n_window):
        groups.append([])
    windows, wrows = [], []
    for g in groups:
        row = [params.tok_start] + [t for t, _ in g] + [params.tok_end]
        wrow = [1.0] + [w for _, w in g] + [1.0]
        pad = params.n_token - len(row)
        windows.append(row + [params.tok_pad] * pad)
        wrows.append(wrow + [1.0] * pad)
    return windows, wrows, len(groups[0]) + 1
