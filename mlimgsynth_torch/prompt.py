"""A1111-compatible prompt preprocessing.

Parses stable-diffusion-webui style emphasis and ``<lora:NAME:MULT>`` tags
(reference: src/prompt_preproc.h:96-209):

* ``(x)`` multiplies the chunk weight by 1.1, ``[x]`` divides by 1.1, nesting
  multiplies, ``(x:1.5)`` sets an explicit weight, ``\\(`` escapes,
  ``<lora:NAME[:MULT]>`` is extracted into a lora list.  ``BREAK`` (which
  the reference drops, src/prompt_preproc.h:96-209) becomes a window-break
  marker chunk: the tokenizer starts a new 75-token CLIP window there
  (A1111 long-prompt chunking semantics).

Additive extension (beyond the reference tag set): ``<emb:NAME>`` /
``<embedding:NAME>`` inserts a textual-inversion embedding at that position
in the token stream.  The embedding occupies its place in ``chunks`` as a
marker chunk ``EMBED_MARK + name`` carrying the emphasis weight in effect
where the tag appears, so downstream token assembly can splice the learned
vectors in order and webui-style emphasis applies to them like any token.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

# Marker prefix for embedding chunks in PromptText.chunks.  A NUL byte can
# never survive tokenization of user text, so the prefix is unambiguous.
EMBED_MARK = "\x00emb:"
# Standalone marker chunk for a forced encoder-window break (``BREAK``).
BREAK_MARK = "\x00brk"


class PromptParseError(ValueError):
    pass


@dataclass
class PromptText:
    text: str = ""
    chunks: List[Tuple[str, float]] = field(default_factory=list)
    loras: List[Tuple[str, float]] = field(default_factory=list)
    embeds: List[str] = field(default_factory=list)
    # the raw text contains [from:to:when]/[a|b] editing constructs;
    # text/chunks hold the step-0 expansion (see editing_segments)
    editing: bool = False


def _parse_float_prefix(s: str) -> Tuple[float, int]:
    """strtof-like: parse a leading float, return (value, n_chars_consumed)."""
    i, n = 0, len(s)
    if i < n and s[i] in "+-":
        i += 1
    seen = False
    while i < n and s[i].isdigit():
        i += 1
        seen = True
    if i < n and s[i] == ".":
        i += 1
        while i < n and s[i].isdigit():
            i += 1
            seen = True
    if seen and i < n and s[i] in "eE":
        j = i + 1
        if j < n and s[j] in "+-":
            j += 1
        if j < n and s[j].isdigit():
            while j < n and s[j].isdigit():
                j += 1
            i = j
    if not seen:
        return 0.0, 0
    return float(s[:i]), i


def parse_lora_tag(body: str, loras: List[Tuple[str, float]]) -> None:
    """Parse the inside of a <...> tag (src/prompt_preproc.h:58-94)."""
    if not body.startswith("lora:"):
        raise PromptParseError(f"prompt: unknown option '{body}'")
    body = body[5:]
    sep = body.find(":")
    if sep < 0:
        loras.append((body, 1.0))
        return
    name, multstr = body[:sep], body[sep + 1:]
    val, used = _parse_float_prefix(multstr)
    if used != len(multstr):
        raise PromptParseError("prompt: invalid lora multiplier")
    loras.append((name, val))


def prompt_set_raw(text: str) -> PromptText:
    return PromptText(text=text, chunks=[(text, 1.0)], loras=[])


def prompt_set_parse(src: str) -> PromptText:
    out_text: List[str] = []
    chunks: List[Tuple[int, float]] = [(0, 1.0)]  # (start_index, weight)
    loras: List[Tuple[str, float]] = []
    # (char position, active chunk index, embedding name) — the chunk
    # index pins the emphasis weight in effect where the tag appears
    embeds: List[Tuple[int, int, str]] = []
    n_paren = 0
    n_bracket = 0

    def cur_len() -> int:
        return sum(len(s) for s in out_text)

    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c == "\\":
            if i + 1 < n:
                i += 1
                e = src[i]
                if e == "n":
                    e = "\n"
                out_text.append(e)
        elif c in "()[]":
            if c == "(":
                n_paren += 1
            elif c == ")":
                n_paren -= 1
            elif c == "[":
                n_bracket += 1
            else:
                n_bracket -= 1
            if n_paren < 0 or n_bracket < 0:
                raise PromptParseError("prompt: unmatched ')' or ']'")
            w = 1.1 ** (n_paren - n_bracket)
            pos = cur_len()
            start, _ = chunks[-1]
            # an embed tag counts as chunk content: never re-weight a
            # chunk that carries one (e.g. the ')' of "(<emb:x>:1.7)")
            has_embed = embeds and embeds[-1][1] == len(chunks) - 1
            if start == pos and not has_embed:
                chunks[-1] = (start, w)
            else:
                chunks.append((pos, w))
        elif c == ":" and (n_paren > 0 or n_bracket > 0):
            if not (n_paren == 1 and n_bracket == 0):
                raise PromptParseError(
                    "prompt: custom emphasis multiplier outside of '()'")
            rest = src[i + 1:]
            val, used = _parse_float_prefix(rest)
            j = i + 1 + used
            if used == 0 or j >= n or src[j] != ")":
                raise PromptParseError("prompt: invalid emphasis with ':'")
            chunks[-1] = (chunks[-1][0], val)
            i = j - 1
        elif c == "<":
            e = src.find(">", i + 1)
            if e < 0:
                raise PromptParseError("prompt: '<' not matched with '>'")
            body = src[i + 1:e]
            if body.startswith("emb:") or body.startswith("embedding:"):
                name = body.split(":", 1)[1]
                if not name:
                    raise PromptParseError("prompt: empty embedding name")
                embeds.append((cur_len(), len(chunks) - 1, name))
            else:
                parse_lora_tag(body, loras)
            i = e
        elif c == "B" and src.startswith("BREAK", i) and i + 5 < n:
            # window-break event, spliced into chunks like embeds are
            # (name=None distinguishes it from an embedding)
            embeds.append((cur_len(), len(chunks) - 1, None))
            i += 4
        else:
            out_text.append(c)
        i += 1

    text = "".join(out_text)
    result: List[Tuple[str, float]] = []
    bounds = [p for p, _ in chunks] + [len(text)]
    ei = 0
    for k, (start, w) in enumerate(chunks):
        end = bounds[k + 1]
        seg = start
        while ei < len(embeds) and embeds[ei][1] == k:
            p, _, name = embeds[ei]
            if p > seg:
                result.append((text[seg:p], w))
                seg = p
            result.append((EMBED_MARK + name, w) if name is not None
                          else (BREAK_MARK, w))
            ei += 1
        result.append((text[seg:end], w))
    return PromptText(text=text, chunks=result, loras=loras,
                      embeds=[name for _, _, name in embeds
                              if name is not None])


# ---------------------------------------------------------------------------
# A1111 prompt editing / alternation (additive extension; webui
# prompt_parser semantics).  ``[from:to:when]`` switches text at a step
# boundary (``when`` >= 1: step number; < 1: fraction of total steps);
# ``[to:when]`` adds text after the boundary, ``[from::when]`` removes it;
# ``[a|b|...]`` alternates per step.  Plain ``[x]`` stays emphasis.  The
# expansion runs BEFORE prompt_set_parse, per step, so emphasis/lora/embed
# handling is unchanged; downstream the session encodes each distinct
# expanded text once and the fused loop gathers per-step rows from the
# conditioning bank.
# ---------------------------------------------------------------------------

def _split_top(s: str, sep: str) -> List[str]:
    """Split at top-level (unbracketed, unescaped) occurrences of sep."""
    parts, depth, cur, i = [], 0, [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            cur.append(s[i:i + 2])
            i += 2
            continue
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        if c == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    parts.append("".join(cur))
    return parts


def _try_float(s: str):
    try:
        return float(s.strip())
    except ValueError:
        return None


def expand_editing(src: str, step: int, n_steps: int) -> Tuple[str, bool]:
    """Resolve editing/alternation groups for 0-based ``step`` of
    ``n_steps``.  Returns (text, any_substitution_made)."""
    out, i, n, changed = [], 0, len(src), False
    while i < n:
        c = src[i]
        if c == "\\" and i + 1 < n:
            out.append(src[i:i + 2])
            i += 2
            continue
        if c != "[":
            out.append(c)
            i += 1
            continue
        depth, j = 1, i + 1
        while j < n and depth:
            if src[j] == "\\":
                j += 1
            elif src[j] == "[":
                depth += 1
            elif src[j] == "]":
                depth -= 1
            j += 1
        if depth:  # unmatched: leave for the emphasis parser to reject
            out.append(src[i:])
            break
        body = src[i + 1:j - 1]
        alts = _split_top(body, "|")
        if len(alts) > 1:
            inner, _ = expand_editing(alts[step % len(alts)], step, n_steps)
            out.append(inner)
            changed = True
            i = j
            continue
        parts = _split_top(body, ":")
        when = _try_float(parts[-1]) if len(parts) >= 2 else None
        if when is not None:
            if len(parts) == 2:
                frm, to = "", parts[0]
            elif len(parts) == 3:
                frm, to = parts[0], parts[1]
            else:
                frm = to = None
            if frm is not None:
                b = int(when) if when >= 1 else int(when * n_steps)
                inner, _ = expand_editing(frm if step < b else to,
                                          step, n_steps)
                out.append(inner)
                changed = True
                i = j
                continue
        inner, sub = expand_editing(body, step, n_steps)
        changed = changed or sub
        out.append("[" + inner + "]")
        i = j
    return "".join(out), changed


def editing_segments(src: str, n_steps: int):
    """Per-step expansion, deduplicated: returns (texts, step_to_idx) —
    ``texts[step_to_idx[i]]`` is the prompt text for step i — or None when
    the prompt contains no editing constructs."""
    texts: List[str] = []
    idx: List[int] = []
    seen = {}
    any_changed = False
    for s in range(max(1, n_steps)):
        t, changed = expand_editing(src, s, n_steps)
        any_changed = any_changed or changed
        k = seen.get(t)
        if k is None:
            k = seen[t] = len(texts)
            texts.append(t)
        idx.append(k)
    if not any_changed:
        return None
    return texts, idx
