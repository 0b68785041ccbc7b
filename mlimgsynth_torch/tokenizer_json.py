"""A reader of Hugging Face ``tokenizer.json`` files: the ids that
``tokenizers.Tokenizer.from_file(path).encode(text).ids`` gives, without
the ``tokenizers`` package (T5's tokenizer, ``models/t5.py``).

The pipeline is that of ``tokenizers``: added tokens are cut out of the
text first (leftmost longest); each other piece is normalized,
pre-tokenized and run through the model; the post-processor wraps the
ids.  The components read:

* models: ``WordLevel`` and ``Unigram`` (the Viterbi best segmentation
  over the piece scores on the text's UTF-8 positions, a character with no
  one-character piece taking ``unk_id`` at the lowest score less 10, runs
  of such characters fused into one unknown token);
* normalizers: ``Sequence``, ``Precompiled`` (sentencepiece's
  ``precompiled_charsmap``: a u32 trie size, a Darts double array, then the
  replacement strings; applied per grapheme cluster, as ``tokenizers``
  applies it), ``Replace`` (string or regex), ``NFKC``, ``Lowercase`` and
  ``Strip``;
* pre-tokenizers: ``Whitespace``, ``WhitespaceSplit`` and ``Metaspace``;
* post-processor: ``TemplateProcessing`` (its ``single`` template).

Any other component, option or value raises ``MlisError`` naming it.
"""
from __future__ import annotations

import base64
import json
import re
import struct
import unicodedata
from typing import Callable, Dict, List, Optional, Tuple

from .errors import MlisError

# Unicode White_Space, the set of Rust's ``char::is_whitespace``
_WHITE_SPACE = frozenset(
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B)) + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000])
# Other_Alphabetic characters outside the letter and mark categories
_OTHER_ALPHA = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                (0x1F170, 0x1F189))
_UNK_PENALTY = 10.0


def _unsupported(what: str) -> MlisError:
    return MlisError(MlisError.E_OPT_VALUE,
                     f"tokenizer.json: {what} is not supported")


def _is_space(ch: str) -> bool:
    return ord(ch) in _WHITE_SPACE


def _is_word(ch: str) -> bool:
    """The regex class ``\\w`` of ``tokenizers`` (Rust, Unicode): Alphabetic,
    marks, decimal digits, connector punctuation and the joiners."""
    cat = unicodedata.category(ch)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or ch in "\u200c\u200d":
        return True
    cp = ord(ch)
    return any(a <= cp <= b for a, b in _OTHER_ALPHA)


# -- grapheme clusters (UAX #29, extended) for the Precompiled normalizer ----

_GB_PREPEND = frozenset([0x0600, 0x0601, 0x0602, 0x0603, 0x0604, 0x0605,
                         0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2, 0x0D4E,
                         0x110BD, 0x110CD, 0x111C2, 0x111C3, 0x1193F,
                         0x11941, 0x11A3A, 0x11A84, 0x11A85, 0x11A86,
                         0x11A87, 0x11A88, 0x11A89, 0x11D46, 0x11F02])
# Other_Grapheme_Extend outside Mn / Me (Mc, Lm and the tag characters)
_GB_EXTEND_EXTRA = frozenset(
    [0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5, 0x0CD6,
     0x0D3E, 0x0D57, 0x0DCF, 0x0DDF, 0x1B35, 0x200C, 0x302E, 0x302F, 0xFF9E,
     0xFF9F, 0x1133E, 0x11357, 0x114B0, 0x114BD, 0x115AF, 0x11930, 0x1D165,
     0x1D16E, 0x1D16F, 0x1D170, 0x1D171, 0x1D172]
    + list(range(0x1F3FB, 0x1F400)) + list(range(0xE0020, 0xE0080)))
# Mc characters that are not SpacingMark
_GB_NOT_SPACING = frozenset(
    [0x102B, 0x102C, 0x1038, 0x1062, 0x1063, 0x1064, 0x1067, 0x1068, 0x1069,
     0x106A, 0x106B, 0x106C, 0x106D, 0x1083, 0x1087, 0x1088, 0x1089, 0x108A,
     0x108B, 0x108C, 0x108F, 0x109A, 0x109B, 0x109C, 0x1A61, 0x1A63, 0x1A64,
     0xAA7B, 0xAA7D, 0x11720, 0x11721])
# Extended_Pictographic
_EXT_PICT = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747),
    (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
    (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
    (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))


def _gcb(ch: str) -> str:
    """The Grapheme_Cluster_Break class of ``ch`` (UAX #29), from its
    general category and the lists above."""
    cp = ord(ch)
    if ch == "\r":
        return "CR"
    if ch == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if cp in _GB_PREPEND:
        return "Prepend"
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me") or cp in _GB_EXTEND_EXTRA:
        return "Extend"
    if cat in ("Cc", "Zl", "Zp", "Cf", "Cs"):
        return "Control"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if cat == "Mc" and cp not in _GB_NOT_SPACING or cp in (0x0E33, 0x0EB3):
        return "SpacingMark"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return "Other"


def _ext_pict(ch: str) -> bool:
    cp = ord(ch)
    return any(a <= cp <= b for a, b in _EXT_PICT)


def graphemes(s: str) -> List[str]:
    """``s`` cut into extended grapheme clusters (UAX #29 rules GB3-GB13,
    GB999)."""
    out: List[str] = []
    if not s:
        return out
    start, prev = 0, _gcb(s[0])
    ri_run = 1 if prev == "RI" else 0
    # GB11: ``pict`` while the cluster so far ends in an
    # Extended_Pictographic and Extend*, ``after_zwj`` right after its ZWJ
    pict, after_zwj = _ext_pict(s[0]), False
    for i in range(1, len(s)):
        cur = _gcb(s[i])
        if prev == "CR" and cur == "LF":
            join = True
        elif prev in ("Control", "CR", "LF") or cur in ("Control", "CR",
                                                         "LF"):
            join = False
        elif (prev == "L" and cur in ("L", "V", "LV", "LVT")
              or prev in ("LV", "V") and cur in ("V", "T")
              or prev in ("LVT", "T") and cur == "T"):
            join = True
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True
        elif after_zwj and _ext_pict(s[i]):
            join = True
        else:
            join = prev == "RI" and cur == "RI" and ri_run % 2 == 1
        if not join:
            out.append(s[start:i])
            start = i
        if cur == "ZWJ":
            after_zwj, pict = pict, False
        else:
            after_zwj = False
            pict = _ext_pict(s[i]) or (pict and cur == "Extend")
        ri_run = ri_run + 1 if cur == "RI" else 0
        prev = cur
    out.append(s[start:])
    return out


class _CharsMap:
    """sentencepiece's precompiled charsmap: a Darts double array over the
    UTF-8 bytes of each key, whose leaf values are byte offsets of
    NUL-terminated replacements."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise _unsupported("a Precompiled charsmap shorter than 4 bytes")
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        if 4 + trie_size > len(blob) or trie_size % 4:
            raise _unsupported(f"a Precompiled trie of {trie_size} bytes")
        self.units = list(struct.unpack_from(f"<{trie_size // 4}I", blob, 4))
        self.strings = blob[4 + trie_size:]

    def _value(self, off: int) -> Optional[str]:
        end = self.strings.find(b"\0", off)
        end = len(self.strings) if end < 0 else end
        try:
            return self.strings[off:end].decode("utf-8")
        except UnicodeDecodeError:
            return None

    def transform(self, s: str) -> Optional[str]:
        """The replacement of the shortest key that begins ``s`` (as
        ``spm_precompiled``'s ``transform`` takes its first match)."""
        units = self.units
        n = len(units)

        def offset(u):
            return (u >> 10) << ((u & (1 << 9)) >> 6)

        pos = offset(units[0])
        for c in s.encode("utf-8"):
            if c == 0:
                return None
            pos ^= c
            if pos >= n:
                return None
            u = units[pos]
            if (u & ((1 << 31) | 0xFF)) != c:
                return None
            pos ^= offset(u)
            if (u >> 8) & 1:
                return self._value(units[pos] & ((1 << 31) - 1))
        return None

    def normalize(self, s: str) -> str:
        out = []
        for g in graphemes(s):
            if len(g.encode("utf-8")) < 6:
                r = self.transform(g)
                if r is not None:
                    out.append(r)
                    continue
            for ch in g:
                r = self.transform(ch)
                out.append(ch if r is None else r)
        return "".join(out)


def _strip(s: str, left: bool, right: bool) -> str:
    i, j = 0, len(s)
    while left and i < j and _is_space(s[i]):
        i += 1
    while right and j > i and _is_space(s[j - 1]):
        j -= 1
    return s[i:j]


def _normalizer(spec) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def seq(s):
            for f in steps:
                s = f(s)
            return s
        return seq
    if kind == "Precompiled":
        cm = spec.get("precompiled_charsmap")
        if not cm:
            raise _unsupported("a Precompiled normalizer without a charsmap")
        return _CharsMap(base64.b64decode(cm)).normalize
    if kind == "Replace":
        pat, content = spec["pattern"], spec["content"]
        if "String" in pat:
            lit = pat["String"]
            return lambda s: s.replace(lit, content) if lit else s
        if "Regex" in pat:
            rx = re.compile(pat["Regex"])
            return lambda s: rx.sub(lambda m: content, s)
        raise _unsupported(f"Replace pattern {pat}")
    if kind == "NFKC":
        return lambda s: unicodedata.normalize("NFKC", s)
    if kind == "Lowercase":
        # char by char, as Rust's ``char::to_lowercase`` (no final sigma)
        return lambda s: "".join(ch.lower() for ch in s)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right",
                                                             True)
        return lambda s: _strip(s, left, right)
    raise _unsupported(f"normalizer '{kind}'")


def _whitespace(s: str) -> List[str]:
    """``\\w+|[^\\w\\s]+`` matches, the rest dropped."""
    out, cur, cur_word = [], [], None
    for ch in s:
        if _is_space(ch):
            kind = None
        else:
            kind = _is_word(ch)
        if kind is None or kind != cur_word:
            if cur:
                out.append("".join(cur))
            cur = []
        if kind is not None:
            cur.append(ch)
        cur_word = kind
    if cur:
        out.append("".join(cur))
    return out


def _whitespace_split(s: str) -> List[str]:
    out, cur = [], []
    for ch in s:
        if _is_space(ch):
            if cur:
                out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def _pre_tokenizer(spec) -> Callable[[str], List[str]]:
    if spec is None:
        return lambda s: [s] if s else []
    kind = spec.get("type")
    if kind == "Whitespace":
        return _whitespace
    if kind == "WhitespaceSplit":
        return _whitespace_split
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = ("never" if spec.get("add_prefix_space") is False
                      else "always")
        if scheme not in ("always", "never"):
            raise _unsupported(f"Metaspace prepend_scheme '{scheme}'")
        split = spec.get("split", True)

        def metaspace(s):
            s = s.replace(" ", rep)
            if s and scheme == "always" and not s.startswith(rep):
                s = rep + s
            if not split:
                return [s] if s else []
            # a piece begins at each replacement character
            out, start = [], 0
            for i, ch in enumerate(s):
                if ch == rep and i > start:
                    out.append(s[start:i])
                    start = i
            if start < len(s):
                out.append(s[start:])
            return out
        return metaspace
    raise _unsupported(f"pre-tokenizer '{kind}'")


class _WordLevel:
    def __init__(self, spec):
        self.vocab: Dict[str, int] = spec["vocab"]
        unk = spec.get("unk_token")
        self.unk = self.vocab.get(unk) if unk is not None else None

    def __call__(self, piece: str) -> List[int]:
        i = self.vocab.get(piece, self.unk)
        if i is None:
            raise MlisError(MlisError.E_UNKNOWN,
                            f"tokenizer.json: '{piece}' is not in the "
                            "WordLevel vocabulary and it has no unk_token")
        return [i]


class _Unigram:
    def __init__(self, spec):
        if spec.get("byte_fallback"):
            raise _unsupported("Unigram byte_fallback")
        vocab = spec["vocab"]
        self.ids: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        for i, (piece, score) in enumerate(vocab):
            self.ids.setdefault(piece, i)
            self.scores.setdefault(piece, float(score))
        self.unk = spec.get("unk_id")
        self.max_len = max((len(p) for p in self.ids), default=0)
        self.unk_score = (min((float(s) for _, s in vocab), default=0.0)
                          - _UNK_PENALTY)

    def __call__(self, s: str) -> List[int]:
        if not s:
            return []
        n = len(s)
        # best[i] = (score, start, id) of the best path ending at char i
        best: List[Optional[Tuple[float, int, int]]] = [None] * (n + 1)
        best[0] = (0.0, -1, -1)
        for i in range(n):
            here = best[i][0]
            single = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                piece = s[i:j]
                pid = self.ids.get(piece)
                if pid is None:
                    continue
                cand = here + self.scores[piece]
                if best[j] is None or cand > best[j][0]:
                    best[j] = (cand, i, pid)
                if j == i + 1:
                    single = True
            if not single:
                if self.unk is None:
                    raise MlisError(MlisError.E_UNKNOWN,
                                    "tokenizer.json: Unigram model without "
                                    "an unk_id met an unknown character")
                cand = here + self.unk_score
                if best[i + 1] is None or cand > best[i + 1][0]:
                    best[i + 1] = (cand, i, self.unk)
        pieces: List[str] = []
        unk_run: List[str] = []
        end = n
        while end > 0:
            _, start, pid = best[end]
            if pid == self.unk:
                unk_run.append(s[start:end])
            else:
                if unk_run:
                    pieces.append("".join(reversed(unk_run)))
                    unk_run = []
                pieces.append(s[start:end])
            end = start
        if unk_run:
            pieces.append("".join(reversed(unk_run)))
        return [self.ids.get(p, self.unk) for p in reversed(pieces)]


def _model(spec):
    kind = spec.get("type")
    if kind == "WordLevel":
        return _WordLevel(spec)
    if kind == "Unigram":
        return _Unigram(spec)
    raise _unsupported(f"model '{kind}'")


def _post_processor(spec) -> Callable[[List[int]], List[int]]:
    if spec is None:
        return lambda ids: ids
    kind = spec.get("type")
    if kind != "TemplateProcessing":
        raise _unsupported(f"post-processor '{kind}'")
    special = spec.get("special_tokens", {})
    parts = []
    for item in spec["single"]:
        if "Sequence" in item:
            if item["Sequence"]["id"] != "A":
                raise _unsupported(f"template sequence {item}")
            parts.append(None)
        elif "SpecialToken" in item:
            tok = special.get(item["SpecialToken"]["id"])
            if tok is None:
                raise _unsupported(f"template token {item} (not listed in "
                                   "special_tokens)")
            parts.append(list(tok["ids"]))
        else:
            raise _unsupported(f"template piece {item}")

    def wrap(ids):
        out = []
        for p in parts:
            out.extend(ids if p is None else p)
        return out
    return wrap


class Tokenizer:
    """One ``tokenizer.json`` file; :meth:`encode` gives a text's ids."""

    def __init__(self, path: str):
        try:
            with open(path, encoding="utf-8") as f:
                spec = json.load(f)
        except FileNotFoundError:
            raise MlisError(MlisError.E_FILE_NOT_FOUND,
                            f"tokenizer file not found '{path}'")
        except (OSError, ValueError) as e:
            raise MlisError(MlisError.E_UNKNOWN,
                            f"tokenizer.json '{path}' unreadable: {e}")
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(f"'{key}'")
        self.added: Dict[str, int] = {}
        self.added_normalized: Dict[str, int] = {}
        for t in spec.get("added_tokens") or []:
            flags = [k for k in ("single_word", "lstrip", "rstrip")
                     if t.get(k)]
            if flags:
                raise _unsupported(f"added token '{t['content']}' with "
                                   + ", ".join(flags))
            (self.added_normalized if t.get("normalized")
             else self.added)[t["content"]] = t["id"]
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        self.post_process = _post_processor(spec.get("post_processor"))

    @staticmethod
    def _split_added(s: str, table: Dict[str, int]
                     ) -> List[Tuple[str, Optional[int]]]:
        """``s`` cut at the leftmost-longest occurrences of ``table``'s
        tokens: (text, None) pieces and (token, id) pieces in order."""
        if not table or not s:
            return [(s, None)] if s else []
        out, i, start = [], 0, 0
        by_len = sorted(table, key=len, reverse=True)
        while i < len(s):
            hit = next((t for t in by_len if t and s.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if start < i:
                out.append((s[start:i], None))
            out.append((hit, table[hit]))
            i = start = i + len(hit)
        if start < len(s):
            out.append((s[start:], None))
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece, tid in self._split_added(text, self.added):
            if tid is not None:
                ids.append(tid)
                continue
            norm = self.normalize(piece)
            for sub, sid in self._split_added(norm, self.added_normalized):
                if sid is not None:
                    ids.append(sid)
                    continue
                for w in self.pre_tokenize(sub):
                    ids.extend(self.model(w))
        return self.post_process(ids)
