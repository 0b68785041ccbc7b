"""Textual-inversion embeddings (``<emb:NAME>``): the port's session against
the JAX session's on tiny checkpoints, in f32 on the CPU.

The cases of the JAX package's ``tests/test_embeddings.py``: an embedding
whose vectors are a word's token rows gives that word's conditioning and
latents exactly (at any emphasis weight), a multi-vector one registered
after the towers loaded, the ``.pt`` layout, SDXL's ``clip_l`` /
``clip_g`` tables (cond and label), SD3's two CLIP towers; each request's
per-step latents against the JAX session's at atol/rtol 1e-4 and the
infotext equal; every error an ``MlisError``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import (patch_tiny_model_types, write_checkpoint_sdxl,
                     write_tiny_checkpoint)
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.testing import (TINY_MODEL_TYPE_SD3 as J_SD3,
                                    write_checkpoint_sd3)
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import tokenizer as tok
from torch_jax_memo import jax_spec_memo  # noqa: F401

MLIS = torch_api.MlisError


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WRITERS = {"sd1": (write_tiny_checkpoint, None, T.TINY_MODEL_TYPE),
            "sdxl": (write_checkpoint_sdxl, "XL", T.TINY_MODEL_TYPE_XL),
            "sd3": (write_checkpoint_sd3, "SD3", T.TINY_MODEL_TYPE_SD3)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    out = {}
    for mt, (writer, _, _) in _WRITERS.items():
        out[mt] = str(d / f"{mt}.safetensors")
        writer(out[mt])
    return out


def _patch(monkeypatch, mt):
    from helpers import TINY_MODEL_TYPE_XL
    jmt = {"sd1": None, "sdxl": {"sdxl": TINY_MODEL_TYPE_XL},
           "sd3": {"sd3": J_SD3}}[mt]
    patch_tiny_model_types(monkeypatch, jmt)
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {mt: _WRITERS[mt][2]})


def _session(kind, ckpt, mt, embed_dir):
    s = JaxSession() if kind == "jax" else torch_api.MLImgSynth(device="cpu")
    if kind == "jax":
        s._dtype = jnp.float32
    for k, v in [("model", ckpt), ("model-type", mt), ("image-dim", 64),
                 ("steps", 3), ("seed", 7), ("cfg-scale", 5.0),
                 ("embed-dir", str(embed_dir))]:
        s.option_set(k, v)
    return s


def _request(s, prompt, nprompt="blurry"):
    traj = []
    s.option_set("seed", 7)
    s.option_set("prompt", prompt)
    s.option_set("nprompt", nprompt)
    s.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    return traj


def _word_rows(ts, word, prefix="clip.text."):
    ids = tok.tokenize(word)
    table = ts._models[prefix].embed.token.weight.detach().numpy()
    return table[np.asarray(ids)]


def _close(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(y, x, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")


@pytest.mark.parametrize("weight", ["", ":1.7"])
def test_embed_equals_word_and_matches_jax(ckpts, monkeypatch, tmp_path,
                                           weight):
    _patch(monkeypatch, "sd1")
    ts = _session("torch", ckpts["sd1"], "sd1", tmp_path)
    ts.setup()
    T.write_embedding(tmp_path / "likecat.safetensors",
                      {"emb_params": _word_rows(ts, "cat")})
    emb = f"a (<emb:likecat>{weight}) photo" if weight else \
        "a <emb:likecat> photo"
    word = f"a (cat{weight}) photo" if weight else "a cat photo"
    t_emb = _request(ts, emb)
    cond_emb = ts.tensors["cond"]
    t_word = _request(ts, word)
    np.testing.assert_array_equal(cond_emb, ts.tensors["cond"])
    for a, b in zip(t_emb, t_word):
        np.testing.assert_array_equal(a, b)
    js = _session("jax", ckpts["sd1"], "sd1", tmp_path)
    _close(_request(js, emb), t_emb)
    ts_info = ts.infotext
    _request(ts, emb)
    assert ts.infotext == js.infotext
    assert ts.infotext != ts_info and "<emb:likecat>" in ts.infotext


def test_multivector_registered_after_load(ckpts, monkeypatch, tmp_path):
    """A 2-vector embedding registered after a first request loaded the
    towers: the tower reloads with the rows appended (ids n_vocab, +1),
    and gives the phrase's latents; a third tag extends the table."""
    _patch(monkeypatch, "sd1")
    ts = _session("torch", ckpts["sd1"], "sd1", tmp_path)
    _request(ts, "warmup")
    rows = _word_rows(ts, "big cat")
    assert rows.shape[0] == 2
    T.write_embedding(tmp_path / "bigcat.safetensors", {"emb_params": rows})
    T.write_embedding(tmp_path / "dog1.safetensors",
                      {"emb_params": _word_rows(ts, "dog")})
    t_emb = _request(ts, "a <emb:bigcat> photo")
    assert ts._embeds["bigcat"]["ids"] == [49408, 49409]
    assert ts._models["clip.text."].embed.token.weight.shape[0] == 49410
    t_word = _request(ts, "a big cat photo")
    for a, b in zip(t_emb, t_word):
        np.testing.assert_array_equal(a, b)
    t2 = _request(ts, "<emb:bigcat> and <emb:dog1>")
    assert ts._models["clip.text."].embed.token.weight.shape[0] == 49411
    js = _session("jax", ckpts["sd1"], "sd1", tmp_path)
    _request(js, "warmup")
    _close(_request(js, "a <emb:bigcat> photo"), t_emb)
    _close(_request(js, "<emb:bigcat> and <emb:dog1>"), t2)


def test_pt_layout(ckpts, monkeypatch, tmp_path):
    _patch(monkeypatch, "sd1")
    ts = _session("torch", ckpts["sd1"], "sd1", tmp_path)
    ts.setup()
    torch.save({"string_to_param": {"*": torch.from_numpy(
        _word_rows(ts, "dog"))}}, str(tmp_path / "ptdog.pt"))
    t_emb = _request(ts, "<emb:ptdog> runs")
    t_word = _request(ts, "dog runs")
    for a, b in zip(t_emb, t_word):
        np.testing.assert_array_equal(a, b)
    js = _session("jax", ckpts["sd1"], "sd1", tmp_path)
    _close(_request(js, "<emb:ptdog> runs"), t_emb)


def test_sdxl_dual_tables(ckpts, monkeypatch, tmp_path):
    """clip_l rows in CLIP-L's table, clip_g rows in bigG's: cond and
    label equal the word's; latents against the JAX session."""
    _patch(monkeypatch, "sdxl")
    ts = _session("torch", ckpts["sdxl"], "sdxl", tmp_path)
    ts.setup()
    T.write_embedding(tmp_path / "xcat.safetensors", {
        "clip_l": _word_rows(ts, "cat"),
        "clip_g": _word_rows(ts, "cat", "clip2.text.")})
    t_emb = _request(ts, "a <emb:xcat> photo", "")
    cond, label = ts.tensors["cond"], ts.tensors["label"]
    t_word = _request(ts, "a cat photo", "")
    np.testing.assert_array_equal(cond, ts.tensors["cond"])
    np.testing.assert_array_equal(label, ts.tensors["label"])
    for a, b in zip(t_emb, t_word):
        np.testing.assert_array_equal(a, b)
    js = _session("jax", ckpts["sdxl"], "sdxl", tmp_path)
    _close(_request(js, "a <emb:xcat> photo", ""), t_emb)


def test_sd3_clip_towers(ckpts, monkeypatch, tmp_path):
    """SD3's CLIP-L and bigG take the embedding's two tables (T5 sees the
    tag's text, without T5 weights zero rows)."""
    _patch(monkeypatch, "sd3")
    ts = _session("torch", ckpts["sd3"], "sd3", tmp_path)
    ts.setup()
    T.write_embedding(tmp_path / "g.safetensors", {
        "clip_l": _word_rows(ts, "red fox"),
        "clip_g": _word_rows(ts, "red fox", "clip2.text.")})
    t_emb = _request(ts, "a <emb:g> in snow")
    t_word = _request(ts, "a red fox in snow")
    for a, b in zip(t_emb, t_word):
        np.testing.assert_array_equal(a, b)
    js = _session("jax", ckpts["sd3"], "sd3", tmp_path)
    _close(_request(js, "a <emb:g> in snow"), t_emb)


@pytest.mark.parametrize("case", ["missing", "width", "no_table", "counts",
                                  "layout", "pt_layout"])
def test_embed_errors(ckpts, monkeypatch, tmp_path, case):
    mt = "sdxl" if case in ("no_table", "counts") else "sd1"
    _patch(monkeypatch, mt)
    ts = _session("torch", ckpts[mt], mt, tmp_path)
    name, match, code = "bad", None, MLIS.E_UNKNOWN
    if case == "missing":
        name, code = "nosuchfile", MLIS.E_FILE_NOT_FOUND
    elif case == "width":
        T.write_embedding(tmp_path / "bad.safetensors",
                          {"emb_params": np.zeros((1, 16), np.float32)})
        match = "width"
    elif case == "no_table":
        T.write_embedding(tmp_path / "bad.safetensors",
                          {"emb_params": np.zeros((1, 32), np.float32)})
        match = "no table"
    elif case == "counts":
        T.write_embedding(tmp_path / "bad.safetensors", {
            "clip_l": np.zeros((1, 32), np.float32),
            "clip_g": np.zeros((2, 32), np.float32)})
        match = "counts differ"
    elif case == "layout":
        T.write_embedding(tmp_path / "bad.safetensors",
                          {"something": np.zeros((1, 32), np.float32)})
        match = "unrecognized"
    else:
        torch.save({"other": 1}, str(tmp_path / "bad.pt"))
        match = "unrecognized"
    ts.option_set("prompt", f"a <emb:{name}> photo")
    with pytest.raises(MLIS, match=match) as e:
        ts.generate()
    assert e.value.code == code


def test_embed_dir_change_and_lora_reload(ckpts, monkeypatch, tmp_path):
    """A new ``embed_dir`` forgets the registered embeddings (the towers
    reload without their rows); a LoRA change that reloads CLIP-L keeps
    them."""
    _patch(monkeypatch, "sd1")
    ts = _session("torch", ckpts["sd1"], "sd1", tmp_path)
    ts.setup()
    T.write_embedding(tmp_path / "likecat.safetensors",
                      {"emb_params": _word_rows(ts, "cat")})
    _request(ts, "<emb:likecat>")
    assert ts._models["clip.text."].embed.token.weight.shape[0] == 49409
    lora = tmp_path / "l.safetensors"
    T.write_random_lora(lora, T.TINY_MODEL_TYPE,
                        T.lora_attention_targets(T.TINY_MODEL_TYPE))
    ts.option_set("lora", str(lora), 0.5)
    t_lora = _request(ts, "<emb:likecat>")
    assert ts._models["clip.text."].embed.token.weight.shape[0] == 49409
    t_word = _request(ts, "cat")
    for a, b in zip(t_lora, t_word):
        np.testing.assert_array_equal(a, b)
    other = tmp_path / "other"
    other.mkdir()
    ts.option_set("embed-dir", str(other))
    assert not ts._embeds
    _request(ts, "cat")
    assert ts._models["clip.text."].embed.token.weight.shape[0] == 49408
    with pytest.raises(MLIS) as e:
        _request(ts, "<emb:likecat>")
    assert e.value.code == MLIS.E_FILE_NOT_FOUND
