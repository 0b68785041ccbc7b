"""The port CLI's other commands against the JAX package's CLI on one tiny
SD2 checkpoint, f32 on the CPU: ``vae-encode``, ``vae-decode`` and
``vae-test`` (the latent atol/rtol 1e-4, the image within 1 LSB, the round
trip's error line), ``clip-encode`` (the embedding file, 1e-4),
``list-backends``, ``check`` (the same probes, all OK), ``serve`` (the
server entry point and its arguments) and ``-t``/``--threads``.
"""
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
from mlimgsynth_torch import server as tserver
from mlimgsynth_torch import testing as T

CLIS = (("jax", jcli.main, []), ("port", tcli.main, ["-b", "cpu"]))


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


@pytest.fixture
def image(tmp_path):
    rgb = np.random.default_rng(2).integers(0, 256, (64, 64, 3), np.uint8)
    Image.fromarray(rgb).save(tmp_path / "in.png")
    return str(tmp_path / "in.png")


def test_vae_commands_match_jax_cli(ckpt, image, tmp_path, capsys):
    """vae-encode writes the latent, vae-decode decodes it, vae-test does
    both and reports the round trip's error."""
    outs = {}
    for name, main, extra in CLIS:
        lat, png = tmp_path / f"{name}.tensor", tmp_path / f"{name}.png"
        base = ["-m", ckpt, "--weight-type", "f32", "-S", "7", "-q", *extra]
        assert main(["vae-encode", *base, "-i", image,
                     "--olatent", str(lat)]) == 0
        assert main(["vae-decode", *base, "--ilatent", str(lat),
                     "-o", str(png)]) == 0
        capsys.readouterr()
        assert main(["vae-test", *base, "-i", image]) == 0
        err = capsys.readouterr().err
        outs[name] = (jimage.tensor_load(str(lat)),
                      np.asarray(Image.open(png)),
                      err[err.index("Image encode/decode"):].splitlines()[0])
    (lat_j, img_j, line_j), (lat_t, img_t, line_t) = outs["jax"], \
        outs["port"]
    assert lat_t.shape == lat_j.shape == (1, 4, 8, 8)
    np.testing.assert_allclose(lat_t, lat_j, atol=1e-4, rtol=1e-4)
    assert img_t.shape == (64, 64, 3)
    assert np.abs(img_t.astype(int) - img_j.astype(int)).max() <= 1
    assert line_t == line_j


def test_clip_encode_matches_jax_cli(ckpt, tmp_path, monkeypatch):
    """clip-encode writes ``clip-embed.tensor`` in the working directory
    (the tiny SD2 tower has no projection: no feature file)."""
    got = {}
    for name, main, extra in CLIS:
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert main(["clip-encode", "-m", ckpt, "--weight-type", "f32",
                     "-p", "a (red:1.2) fox", "-q", *extra]) == 0
        got[name] = (jimage.tensor_load("clip-embed.tensor"),
                     sorted(os.listdir(d)))
    assert got["port"][1] == got["jax"][1] == ["clip-embed.tensor"]
    assert got["port"][0].shape == got["jax"][0].shape
    np.testing.assert_allclose(got["port"][0], got["jax"][0], atol=1e-4,
                               rtol=1e-4)


def test_check_and_list_backends(ckpt, capsys):
    """check runs the same probes, every one OK, without and with a model;
    list-backends names the CPU."""
    lines = {}
    for name, main, extra in CLIS:
        assert main(["check", "-q", *extra]) == 0
        assert main(["check", "-m", ckpt, "--weight-type", "f32", "-q",
                     *extra]) == 0
        out = capsys.readouterr().out.splitlines()
        lines[name] = [ln.split()[:2] for ln in out]
        assert main(["list-backends", *extra]) == 0
        lines[name + "_backends"] = capsys.readouterr().out.splitlines()[0]
    assert lines["port"] == lines["jax"]
    assert ["model:unet", "OK"] in lines["port"]
    assert lines["port"].count(["CHECK", "OK"]) == 2
    assert lines["port_backends"] == lines["jax_backends"] == "cpu"


def test_serve_and_threads(ckpt, tmp_path, monkeypatch):
    """serve hands the session, --port and --model-dir to the server;
    -t / --threads is stored, and generate runs with it."""
    calls = []
    monkeypatch.setattr(tserver, "serve",
                        lambda s, port, model_dir: calls.append(
                            (s.device.type, s.c["threads"], port,
                             model_dir)))
    assert tcli.main(["serve", "-b", "cpu", "-m", ckpt, "--port", "0",
                      "--model-dir", str(tmp_path), "-t", "3"]) == 0
    assert tcli.main(["serve", "-b", "cpu", "-m", ckpt]) == 0
    assert calls == [("cpu", 3, 0, str(tmp_path)), ("cpu", 0, 8188, "")]
    assert tcli.main(["generate", "-b", "cpu", "-m", ckpt, "--threads", "2",
                      "-d", "64", "-s", "1", "--weight-type", "f32", "-q",
                      "-o", str(tmp_path / "t.png")]) == 0
