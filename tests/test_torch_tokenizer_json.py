"""The port's ``tokenizer.json`` reader against the ``tokenizers`` package.

Each case builds a tokenizer with ``tokenizers`` (or writes the JSON the
way ``tokenizers`` saves it), saves it, and holds
``mlimgsynth_torch.tokenizer_json.Tokenizer(path).encode(text)`` to
``tokenizers.Tokenizer.from_file(path).encode(text).ids``: WordLevel with
the Whitespace pre-tokenizer, WordLevel with WhitespaceSplit under NFKC,
Lowercase and Strip, Unigram with Metaspace and Replace, a Precompiled
charsmap the test builds (full-width letters, ``…`` -> ``...``, a
ligature, a two-character key), added tokens, and TemplateProcessing;
then a derandomized hypothesis run over Unicode text on the T5 form
(Precompiled, Replace, Metaspace, Unigram, TemplateProcessing).  Every
unsupported component raises ``MlisError``.
"""
import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import (Regex, Tokenizer, normalizers, pre_tokenizers,
                        processors)
from tokenizers.models import Unigram, WordLevel

from mlimgsynth_torch import testing as T
from mlimgsynth_torch.errors import MlisError
from mlimgsynth_torch.tokenizer_json import Tokenizer as PortTokenizer
from mlimgsynth_torch.tokenizer_json import graphemes

WORDS = {"<pad>": 0, "</s>": 1, "<unk>": 2, "a": 3, "cat": 4, "dog": 5,
         "photo": 6, "of": 7, "!": 8, "é": 9, "naïve": 10, "fi": 11,
         "...": 12, "東京": 13}
TEXTS = ["", " ", "a photo of a cat", "a  cat!!  dog...", "Naïve CAT",
         "ｃａｔ ａ", "ﬁ … 東京 tower", "\ta\ncat\r\n", " lead and trail  ",
         "é é", "ab🙂cd 👍🏽x", "Ｃａｔ́s", "x" * 300]
# charsmap rules: full-width Latin letters to ASCII, the ellipsis, a
# ligature, the ideographic space, a two-character key
RULES = {**{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
         **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
         "…": "...", "ﬁ": "fi", "　": " ", "é": "é"}


def _check(path, texts=TEXTS):
    ref = Tokenizer.from_file(str(path))
    port = PortTokenizer(str(path))
    for t in texts:
        assert port.encode(t) == ref.encode(t).ids, (t, ref.encode(t).tokens)


def test_wordlevel_whitespace(tmp_path):
    tok = Tokenizer(WordLevel(WORDS, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "t.json"))
    _check(tmp_path / "t.json")


def test_wordlevel_split_nfkc_lowercase_strip(tmp_path):
    tok = Tokenizer(WordLevel(WORDS, unk_token="<unk>"))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFKC(), normalizers.Lowercase(),
        normalizers.Strip(left=True, right=True)])
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(tmp_path / "t.json"))
    _check(tmp_path / "t.json")


def _unigram(pieces=None):
    pieces = pieces or T.random_unigram_pieces(400, seed=5)
    return Tokenizer(Unigram(pieces, unk_id=2, byte_fallback=False))


@pytest.mark.parametrize("pattern", ["string", "regex"])
def test_unigram_metaspace_replace(tmp_path, pattern):
    tok = _unigram()
    pat = " " if pattern == "string" else Regex(" {2,}")
    tok.normalizer = normalizers.Sequence([
        normalizers.Replace(pat, " "),
        normalizers.Strip(left=False, right=True)])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁",
                                                 prepend_scheme="always")
    tok.save(str(tmp_path / "t.json"))
    _check(tmp_path / "t.json")


def test_unigram_fuses_unknown_runs(tmp_path):
    """Characters without a one-character piece take the unknown id at
    the lowest score less 10, and a run of them is one token."""
    tok = _unigram([("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0),
                    ("▁", -1.0), ("▁a", -2.0), ("a", -3.0), ("b", -3.5),
                    ("ab", -4.0), ("▁ab", -6.5)])
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.save(str(tmp_path / "t.json"))
    _check(tmp_path / "t.json", TEXTS + ["xyz ab", "ab xy ba", "q"])
    # "▁xyz" is "▁" then one unknown token; "▁ab" scores best as "▁", "ab"
    assert PortTokenizer(str(tmp_path / "t.json")).encode("xyz ab") == [
        3, 2, 3, 7]


def test_precompiled_charsmap(tmp_path):
    """A charsmap built by ``testing.build_charsmap``: ``tokenizers``
    reads it as this reader does, grapheme by grapheme (a cluster of less
    than 6 bytes whose first key matches is replaced whole)."""
    tok = _unigram()
    tok.normalizer = normalizers.Sequence([
        normalizers.Precompiled(T.build_charsmap(RULES)),
        normalizers.Replace(Regex(" {2,}"), " ")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.save(str(tmp_path / "t.json"))
    _check(tmp_path / "t.json")
    ref = Tokenizer.from_file(str(tmp_path / "t.json"))
    assert ref.normalizer.normalize_str("ａ…") == "a..."


def test_template_processing_and_added_tokens(tmp_path):
    tok = _unigram()
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.add_special_tokens(["<pad>", "</s>", "<unk>"])
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    tok.save(str(tmp_path / "t.json"))
    _check(tmp_path / "t.json", TEXTS + ["a</s>b", "</s></s>", "x <pad>"])
    assert PortTokenizer(str(tmp_path / "t.json")).encode("")[-1] == 1


def test_graphemes():
    assert graphemes("éx") == ["é", "x"]
    assert graphemes("\r\na") == ["\r\n", "a"]
    assert graphemes("👨‍👩‍👧!") == ["👨‍👩‍👧", "!"]
    assert graphemes("🇫🇷🇩🇪🇮") == ["🇫🇷", "🇩🇪", "🇮"]
    assert graphemes("한글") == ["한", "글"]
    assert graphemes("각a") == ["각", "a"]


@pytest.fixture(scope="module")
def t5_form(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "t5.json"
    T.write_tokenizer_json(path, T.unigram_tokenizer_spec(
        T.random_unigram_pieces(600, seed=1), charsmap=T.build_charsmap(RULES),
        eos=True))
    return Tokenizer.from_file(str(path)), PortTokenizer(str(path))


_SAMPLE = st.sampled_from(list("ＡＢａｂ…ﬁ é́　abc؀👍🏽‍\r\n"))


@settings(derandomize=True, max_examples=400, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(st.text(alphabet=st.one_of(st.characters(), _SAMPLE), max_size=40))
def test_t5_form_matches_tokenizers_on_unicode(t5_form, text):
    ref, port = t5_form
    assert port.encode(text) == ref.encode(text).ids


def _edit(spec, path, **kv):
    for key, value in kv.items():
        node = spec
        *parents, leaf = key.split("__")
        for p in parents:
            node = node[p]
        node[leaf] = value
    T.write_tokenizer_json(path, spec)


@pytest.mark.parametrize("what,change", [
    ("model", {"model__type": "BPE"}),
    ("normalizer", {"normalizer": {"type": "BertNormalizer"}}),
    ("pre-tokenizer", {"pre_tokenizer": {"type": "ByteLevel"}}),
    ("prepend_scheme", {"pre_tokenizer__prepend_scheme": "first"}),
    ("post-processor", {"post_processor": {"type": "BertProcessing"}}),
    ("byte_fallback", {"model__byte_fallback": True}),
    ("truncation", {"truncation": {"max_length": 8}}),
    ("lstrip", {"added_tokens": [{"id": 1, "content": "</s>",
                                  "single_word": False, "lstrip": True,
                                  "rstrip": False, "normalized": False,
                                  "special": True}]}),
])
def test_unsupported_component_raises(tmp_path, what, change):
    spec = T.unigram_tokenizer_spec(T.random_unigram_pieces(300))
    _edit(spec, tmp_path / "t.json", **change)
    with pytest.raises(MlisError, match=what.split("_")[0]):
        PortTokenizer(str(tmp_path / "t.json"))


def test_unreadable_file_raises(tmp_path):
    (tmp_path / "bad.json").write_text("{not json")
    with pytest.raises(MlisError):
        PortTokenizer(str(tmp_path / "bad.json"))
    with pytest.raises(MlisError):
        PortTokenizer(str(tmp_path / "missing.json"))


def test_charsmap_layout():
    """``build_charsmap``'s blob: a u32 trie size, whole 256-unit blocks, then
    the replacements, each NUL-terminated."""
    blob = T.build_charsmap({"…": "...", "ﬁ": "fi"})
    size = int(np.frombuffer(blob[:4], np.uint32)[0])
    assert size % (4 * 256) == 0
    assert blob[4 + size:] == b"...\0fi\0"
    spec = T.unigram_tokenizer_spec([("<pad>", 0.0)], charsmap=blob)
    assert json.loads(json.dumps(spec))["normalizer"]["normalizers"][0][
        "type"] == "Precompiled"
