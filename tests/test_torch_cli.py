"""The port's CLI (``mlimgsynth_torch.cli``) against the JAX package's
(``mlimgsynth_tpu.cli``): ``generate`` on one tiny SD2 checkpoint with the
same arguments and seed (the PNG read back with pillow here, its
``parameters`` text, the ``--olatent`` tensor, a batch's file names, ``-``
as stdout), ``tokenize``, ``help``, ``version``, and the exits with code 1:
an unknown command, an unknown option, the multi-device ``--tp``,
``--dp``, ``--sp`` on a command that does not run on ranks (every command
but ``generate``; tests/test_torch_parallel_cli.py runs ``generate``), and
``generate`` without ``-b cpu`` on a machine without a card.

Both CLIs run f32 on the CPU.  Tolerances: the image within 1 LSB (both
truncate an f32 value to u8, and the two f32 decodes differ by summation
order), the latent atol/rtol 1e-4 as the session legs
(tests/test_torch_e2e.py), the text equal.
"""
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mlimgsynth_tpu import api as jax_api
from mlimgsynth_tpu import cli as jcli
from mlimgsynth_tpu import testing as jtesting
from mlimgsynth_tpu.utils import image as jimage
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import cli as tcli
from mlimgsynth_torch import testing as T
from torch_jax_memo import jax_spec_memo  # noqa: F401

ARGS = ["-d", "64", "-s", "5", "--method", "dpmpp2m", "-S", "42",
        "-p", "a (cat:1.2) photo", "-n", "blurry", "--weight-type", "f32",
        "-q"]


@pytest.fixture(autouse=True)
def _tiny_types(monkeypatch):
    monkeypatch.setattr(jax_api, "_model_types", lambda: {
        "sd2": jtesting.TINY_MODEL_TYPE_SD2})
    monkeypatch.setattr(torch_api, "_model_types", lambda: {
        "sd2": T.TINY_MODEL_TYPE_SD2})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "tiny-sd2.safetensors"
    jtesting.write_checkpoint_sd2(path, seed=6)
    return str(path)


def _pil(path):
    im = Image.open(path)
    return np.asarray(im), im.info.get("parameters")


def test_generate_matches_jax_cli(ckpt, tmp_path):
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        png, lat = tmp_path / f"{name}.png", tmp_path / f"{name}.tensor"
        extra = ["-b", "cpu"] if name == "port" else []
        assert main(["generate", "-m", ckpt, *ARGS, *extra, "-o", str(png),
                     "--olatent", str(lat)]) == 0
        outs[name] = (*_pil(png), jimage.tensor_load(str(lat)))
    (img_j, info_j, lat_j), (img_t, info_t, lat_t) = outs["jax"], \
        outs["port"]
    assert img_t.shape == img_j.shape == (64, 64, 3)
    assert np.abs(img_t.astype(int) - img_j.astype(int)).max() <= 1
    assert info_t == info_j and "Sampler: dpmpp2m" in info_t
    assert "Clip skip: 2" in info_t and "Model: tiny-sd2" in info_t
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-4, rtol=1e-4)


def test_generate_batch_and_stdout(ckpt, tmp_path, capsysbinary):
    """A batch writes ``stem-idx.ext`` (the JAX CLI's names); ``-o -``
    writes PPM to stdout, the bytes the JAX CLI's pillow writer gives for
    the same pixels."""
    out = tmp_path / "b.png"
    assert tcli.main(["generate", "-b", "cpu", "-m", ckpt, *ARGS,
                      "--batch-size", "2", "-o", str(out)]) == 0
    assert sorted(os.listdir(tmp_path)) == ["b-0.png", "b-1.png"]
    imgs = [_pil(tmp_path / f"b-{i}.png")[0] for i in range(2)]
    assert not np.array_equal(imgs[0], imgs[1])
    capsysbinary.readouterr()
    assert tcli.main(["generate", "-b", "cpu", "-m", ckpt, *ARGS,
                      "-o", "-"]) == 0
    got = capsysbinary.readouterr().out
    want = io.BytesIO()
    Image.fromarray(np.asarray(Image.open(io.BytesIO(got)))).save(
        want, format="PPM")
    assert got.startswith(b"P6\n64 64\n255\n") and got == want.getvalue()


def test_tokenize_help_version(capsys):
    for main in (jcli.main, tcli.main):
        assert main(["tokenize", "-b", "cpu", "--model-type", "sd2",
                     "-p", "a dog jumping"]) == 0
    outs = capsys.readouterr().out.split("\n")
    assert outs[0] == outs[1] == "320 1929 11476"
    assert tcli.main(["-h"]) == 0
    out = capsys.readouterr().out
    assert "generate" in out and "--tae" in out and "dpm++2m_sde" in out
    for flag in ("--embed-dir", "--t5", "--t5-tokenizer", "--t5-tokens",
                 "--mask-blur", "--inpaint-full-res", "--control-net",
                 "--control-image", "--control-strength", "--upscaler",
                 "--upscale-factor", "--upscale-tile", "--hires-fix",
                 "--hires-denoise", "--hires-steps", "--hires-upscaler",
                 "--refiner", "--refiner-switch", "upscale"):
        assert flag in out
    assert tcli.main(["-V"]) == 0
    assert capsys.readouterr().out.startswith("mlimgsynth-torch v")


@pytest.mark.parametrize("argv", [
    ["frobnicate"],
    ["generate", "-b", "cpu", "--definitely-not-an-option", "1"],
    ["vae-encode", "-b", "cpu", "--sp", "2"],
    ["generate", "-b", "tpu"],
    ["serve", "-b", "tpu", "--tp", "2"],
    ["list-backends", "-b", "cpu", "--dp", "2"],
], ids=["unknown-command", "unknown-option", "not-ported", "backend",
        "serve", "list-backends"])
def test_errors_exit_1(argv):
    assert tcli.main(argv) == 1


@pytest.mark.parametrize("flag", ["-i", "--imask", "--lora", "--ilatent"])
def test_missing_input_file_exits_1(ckpt, tmp_path, capsys, flag):
    """A missing input image, mask, LoRA or latent file exits 1 with the
    session's ``E_FILE_NOT_FOUND`` message (the LoRA's when the option is
    set, the others' when ``generate`` reads them)."""
    missing = str(tmp_path / "missing.png")
    assert tcli.main(["generate", "-b", "cpu", "-m", ckpt, *ARGS, flag,
                      missing, "-o", str(tmp_path / "x.png")]) == 1
    assert "not found" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.png")


def _inputs(tmp_path):
    """An RGB PNG, a grey mask PNG (white keeps the top half) and a LoRA on
    the UNet's attention and the text tower's MLP."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    mask = np.zeros((64, 64), np.uint8)
    mask[:32] = 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    mt = T.TINY_MODEL_TYPE_SD2
    T.write_random_lora(tmp_path / "style.safetensors", mt,
                        T.lora_attention_targets(mt), rank=4, seed=2,
                        alpha=16.0, dtype=np.float32)


@pytest.mark.parametrize("how", ["image", "latent"])
def test_img2img_inpaint_lora_match_jax_cli(ckpt, tmp_path, how):
    """``-i``, ``--imask``, ``--f-t-ini``, ``--lora PATH,MULT`` and a
    ``<lora:NAME:MULT>`` tag found through ``--lora-dir``, against the JAX
    CLI on the same files; then (``latent``) ``--ilatent`` and ``--ilmask``
    from TENSOR files.  The PNG within 1 LSB, the text equal, the latent
    1e-4."""
    _inputs(tmp_path)
    if how == "image":
        extra = ["-i", str(tmp_path / "in.png"), "--imask",
                 str(tmp_path / "mask.png"), "--f-t-ini", "0.6",
                 "--lora", f"{tmp_path / 'style.safetensors'},0.7"]
    else:
        lat = np.random.default_rng(12).standard_normal(
            (1, 4, 8, 8)).astype(np.float32)
        lmask = np.zeros((1, 1, 8, 8), np.float32)
        lmask[:, :, :, :4] = 1.0
        jimage.tensor_save(str(tmp_path / "in.tensor"), lat)
        jimage.tensor_save(str(tmp_path / "in-mask.tensor"), lmask)
        extra = ["--ilatent", str(tmp_path / "in.tensor"), "--ilmask",
                 str(tmp_path / "in-mask.tensor"), "--f-t-ini", "0.5",
                 "--lora-dir", str(tmp_path), "-p", "a cat <lora:style:0.5>"]
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        png, lat = tmp_path / f"{name}.png", tmp_path / f"{name}.tensor"
        cpu = ["-b", "cpu"] if name == "port" else []
        assert main(["generate", "-m", ckpt, *ARGS, *cpu, *extra,
                     "-o", str(png), "--olatent", str(lat)]) == 0
        outs[name] = (*_pil(png), jimage.tensor_load(str(lat)))
    (img_j, info_j, lat_j), (img_t, info_t, lat_t) = outs["jax"], \
        outs["port"]
    assert np.abs(img_t.astype(int) - img_j.astype(int)).max() <= 1
    assert info_t == info_j and "Mode: inpaint, f_t_ini: " in info_t
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-4, rtol=1e-4)


def test_generate_needs_the_card_by_default(ckpt, capsys):
    """No ``-b``: the session is built on CUDA, which this machine lacks;
    the CLI exits 1 with the session's error and does not fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tcli.main(["generate", "-m", ckpt, *ARGS, "-o", "x.png"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def _cli_pair(ckpt, tmp_path, extra):
    """The JAX CLI and the port's on the same arguments: (PNG, its
    parameters text, the output latent) of each."""
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        png, lat = tmp_path / f"{name}.png", tmp_path / f"{name}.tensor"
        cpu = ["-b", "cpu"] if name == "port" else []
        assert main(["generate", "-m", ckpt, *ARGS, *cpu, *extra,
                     "-o", str(png), "--olatent", str(lat)]) == 0
        outs[name] = (*_pil(png), jimage.tensor_load(str(lat)))
    return outs["jax"], outs["port"]


def test_embed_dir_and_prompt_editing_match_jax_cli(ckpt, tmp_path):
    """``--embed-dir`` with an ``<emb:NAME>`` tag whose table is CLIP's rows
    of "cat", and prompt editing in both prompts: against the JAX CLI, and
    the embedding's latent equal to the word's."""
    s = torch_api.MLImgSynth(device="cpu")
    s.option_set("model", ckpt)
    s.setup()
    ids = s.text_tokenize("cat")
    table = s._models["clip.text."].embed.token.weight.detach().numpy()
    T.write_embedding(tmp_path / "likecat.safetensors",
                      {"emb_params": table[ids]})
    edit = ["--embed-dir", str(tmp_path), "-n", "[blurry|noisy]"]
    (img_j, info_j, lat_j), (img_t, info_t, lat_t) = _cli_pair(
        ckpt, tmp_path, edit + ["-p", "a <emb:likecat> [photo:picture:2]"])
    assert np.abs(img_t.astype(int) - img_j.astype(int)).max() <= 1
    assert info_t == info_j
    assert info_t.startswith("a <emb:likecat> [photo:picture:2]\n")
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-4, rtol=1e-4)
    word = tmp_path / "word.tensor"
    assert tcli.main(["generate", "-m", ckpt, *ARGS, "-b", "cpu", *edit,
                      "-p", "a cat [photo:picture:2]", "-o",
                      str(tmp_path / "w.png"), "--olatent", str(word)]) == 0
    np.testing.assert_array_equal(jimage.tensor_load(str(word)), lat_t)


def test_t5_options_match_jax_cli(tmp_path, monkeypatch):
    """``--t5``, ``--t5-tokenizer`` and ``--t5-tokens`` on a tiny SD3
    checkpoint with a tiny T5 file, against the JAX CLI."""
    monkeypatch.setenv("MLIS_TINY_MODELS", "1")
    monkeypatch.setattr(jax_api, "_model_types", lambda: {
        "sd3": jtesting.TINY_MODEL_TYPE_SD3})
    monkeypatch.setattr(torch_api, "_model_types", lambda: {
        "sd3": T.TINY_MODEL_TYPE_SD3})
    sd3, t5 = str(tmp_path / "sd3.safetensors"), str(tmp_path / "t5.st")
    jtesting.write_checkpoint_sd3(sd3, seed=3)
    T.write_random_t5(t5, T.TINY_T5_SD3, seed=4, dtype=np.float32)
    tok = str(tmp_path / "tokenizer.json")
    T.write_tokenizer_json(tok, T.unigram_tokenizer_spec(
        T.random_unigram_pieces(T.TINY_T5_SD3.n_vocab, seed=5), eos=True))
    (img_j, info_j, lat_j), (img_t, info_t, lat_t) = _cli_pair(
        sd3, tmp_path, ["--t5", t5, "--t5-tokenizer", tok,
                        "--t5-tokens", "96"])
    assert np.abs(img_t.astype(int) - img_j.astype(int)).max() <= 1
    assert info_t == info_j
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-4, rtol=1e-4)


def test_upscale_command_matches_jax_cli(tmp_path, capsys):
    """``upscale`` with a random 2x RRDBNet, tiled and resized to 3x,
    writes the PNG the JAX CLI writes (both f32 on the CPU: u8 within 1);
    without ``--upscaler`` or ``-i`` it exits 1."""
    from mlimgsynth_torch.models import esrgan as tesr
    up = str(tmp_path / "x2.pth")
    T.write_random_esrgan(up, tesr.EsrganParams(
        n_feat=8, n_block=1, growth=4, unshuffle=2), seed=8)
    src = str(tmp_path / "in.png")
    rgb = np.random.default_rng(8).integers(0, 256, (40, 36, 3), np.uint8)
    Image.fromarray(rgb).save(src)
    argv = ["upscale", "--upscaler", up, "-i", src, "--upscale-tile", "16",
            "--upscale-factor", "3", "-q"]
    jaxs = jax_api.MLImgSynth.__init__

    def jax_f32(self, *a, **kw):
        jaxs(self, *a, **kw)
        self._dtype = np.float32

    jax_api.MLImgSynth.__init__ = jax_f32
    try:
        assert jcli.main(argv + ["-o", str(tmp_path / "j.png")]) == 0
    finally:
        jax_api.MLImgSynth.__init__ = jaxs
    assert tcli.main(argv + ["-b", "cpu", "-o", str(tmp_path / "t.png")]) == 0
    j, t = _pil(tmp_path / "j.png")[0], _pil(tmp_path / "t.png")[0]
    assert t.shape == j.shape == (120, 108, 3)
    assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
    capsys.readouterr()
    for bad in (["upscale", "-b", "cpu", "-i", src, "-o", "x.png"],
                ["upscale", "-b", "cpu", "--upscaler", up, "-o", "x.png"]):
        assert tcli.main(bad) == 1
    assert "upscaler" in capsys.readouterr().err
