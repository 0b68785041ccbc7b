"""Flux through the port's session and CLI against the JAX session, on the
JAX package's tiny component files (``write_tiny_flux_files``: a
transformer-only file in bare BFL names, an HF-layout CLIP-L without a
text projection, a bare VAE), read through the ``clip`` and ``vae``
options.

Identification (``guidance_in``: dev), schnell at cfg 3.5 (CFG with an
uncond batch), dev at guidance 3.5 (no uncond batch, the guidance value in
the label's last column, the resolution-dependent schedule shift) and dev
with T5 rows (a tiny T5 file and a Unigram ``tokenizer.json`` by
``testing.write_tokenizer_json``): every step's latent at atol/rtol 1e-4,
f32 on the CPU; the CLI's output latent and an img2img request likewise
(the JAX session's missing VAE shift corrected).  Prompt editing raises
``MlisError`` on Flux, as in the JAX session; a subprocess runs the port's
own random Flux files without jax.  Quantized weights, LoRAs and skip-layer
guidance on Flux: tests/test_torch_dit_quant*.py, test_torch_flux_lora.py
and test_torch_slg.py.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu import api as japi
from mlimgsynth_tpu import testing as JT
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import cli
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.models import t5 as t5_mod
from mlimgsynth_torch.utils import image as image_mod
from torch_jax_memo import jax_spec_memo  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a T5 narrower than the tiny Flux's 48-wide context: its rows zero-padded
TINY_T5_FLUX = t5_mod.T5Params(d_model=32, d_kv=8, n_head=4, d_ff=48,
                               n_layer=2, n_vocab=512)
PROMPT = "a (rope-rotated:1.2) cat"
OPTS = [("image-dim", 64), ("steps", 3), ("seed", 21), ("cfg-scale", 3.5),
        ("prompt", PROMPT), ("nprompt", "blurry")]
J_TYPES = {"flux_schnell": japi.ModelTypeDef(
    "flux_schnell", JT.TINY_CLIP, None, JT.TINY_FLUX_SCHNELL,
    JT.TINY_VAE_FLUX, 64, 1),
    "flux_dev": japi.ModelTypeDef("flux_dev", JT.TINY_CLIP, None,
                                  JT.TINY_FLUX_DEV, JT.TINY_VAE_FLUX, 64, 1)}
T_TYPES = {"flux_schnell": T.TINY_MODEL_TYPE_FLUX,
           "flux_dev": T.TINY_MODEL_TYPE_FLUX_DEV}


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(torch_api, "_model_types", lambda: dict(T_TYPES))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("flux")
    out = {"schnell": JT.write_tiny_flux_files(
               tmp_path_factory.mktemp("schnell")),
           "dev": JT.write_tiny_flux_files(tmp_path_factory.mktemp("dev"),
                                           P=JT.TINY_FLUX_DEV)}
    out["t5"] = str(d / "t5.safetensors")
    T.write_random_t5(out["t5"], TINY_T5_FLUX, seed=6, dtype=np.float32)
    out["junk"] = str(d / "junk.safetensors")     # names that map nowhere
    T.write_safetensors(out["junk"], {"shared.weight": (4, 2)}, np.float32,
                        iter([("shared.weight",
                               np.zeros((4, 2), np.float32))]))
    out["tok"] = str(d / "tokenizer.json")
    T.write_tokenizer_json(out["tok"], T.unigram_tokenizer_spec(
        T.random_unigram_pieces(TINY_T5_FLUX.n_vocab, seed=7), eos=True))
    return out


def _opts(files, kind, t5=False):
    f = files[kind]
    opts = [("model", f["model"]), ("clip", f["clip"]), ("vae", f["vae"])]
    if t5:
        opts += [("t5", files["t5"]), ("t5-tokenizer", files["tok"]),
                 ("t5-tokens", 16)]
    return opts + OPTS


def _run(s, opts):
    traj = []
    for k, v in opts:
        s.option_set(k, v)
    if isinstance(s, japi.MLImgSynth):
        s._dtype = jnp.float32
    s.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    img = s.generate()
    return traj, np.asarray(img, np.float32)


CASES = {"schnell": ("schnell", False), "dev": ("dev", False),
         "dev_t5": ("dev", True)}


@pytest.fixture(scope="module")
def jax_runs(files):
    """The JAX session's request in each case, once for the module:
    (trajectory, image, NFE, model type)."""
    out = {}
    saved = japi._model_types
    japi._model_types = lambda: dict(J_TYPES)
    try:
        for case, (kind, t5) in CASES.items():
            s = japi.MLImgSynth()
            traj, img = _run(s, _opts(files, kind, t5))
            out[case] = (traj, img, s.progress["nfe"], s.c["model_type"])
    finally:
        japi._model_types = saved
    return out


def _close(traj_t, traj_j):
    assert len(traj_t) == len(traj_j) == 3
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")


@pytest.mark.parametrize("case", list(CASES))
def test_flux_session_matches_jax(files, jax_runs, case):
    kind, t5 = CASES[case]
    traj_j, img_j, nfe_j, type_j = jax_runs[case]
    s = torch_api.MLImgSynth(device="cpu")
    traj_t, img_t = _run(s, _opts(files, kind, t5))
    assert s.c["model_type"] == type_j == f"flux_{kind}"
    assert s.c["clip_skip"] == 1
    _close(traj_t, traj_j)
    mse = np.mean((np.round(img_j * 255) - np.round(img_t * 255)) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 40.0
    # schnell at cfg 3.5 runs CFG (2 evaluations a step); dev embeds the
    # guidance (1)
    assert s._nfe == nfe_j == (3 if kind == "dev" else 6)
    cond, label = s.tensors["cond"], s.tensors["label"]
    rows = 16 if t5 else 77
    assert cond.shape == (1, rows, 48) and label.shape == (1, 32)
    if t5:
        assert np.abs(cond[..., :32]).max() > 0.1
        assert not cond[..., 32:].any()       # zero-padded to 48
    else:
        assert not cond.any()                 # no T5: zero rows
    assert s._denoiser() == "flux." and "flux." in s._models


def test_flux_dev_guidance_changes_image(files, jax_runs):
    s = torch_api.MLImgSynth(device="cpu")
    _run(s, _opts(files, "dev"))
    a = s.tensors["latent"]
    _run(s, _opts(files, "dev") + [("cfg-scale", 1.5)])
    assert np.abs(a - s.tensors["latent"]).max() > 1e-5


def test_flux_cli_matches_jax(files, jax_runs, tmp_path):
    """The CLI with --clip and --vae (and -b cpu): its output latent is the
    JAX session's last."""
    f = files["dev"]
    out = str(tmp_path / "lat.npy")
    rc = cli.main(["generate", "-b", "cpu", "-m", f["model"], "--clip",
                   f["clip"], "--vae", f["vae"], "-d", "64", "-s", "3",
                   "-S", "21", "--cfg-scale", "3.5", "-p", PROMPT,
                   "-n", "blurry", "--olatent", out,
                   "-o", str(tmp_path / "o.png"), "-q"])
    assert rc == 0
    lat = image_mod.tensor_load(out)
    np.testing.assert_allclose(lat, jax_runs["dev"][0][-1], atol=1e-4,
                               rtol=1e-4)
    assert "Clip skip: 1" in image_mod.png_read(
        str(tmp_path / "o.png"))[1]["parameters"]


def test_flux_img2img_matches_jax(files, monkeypatch):
    """Flux-dev img2img at ``f_t_ini`` 0.6 against the JAX session whose
    encode subtracts the VAE's shift as ``latent_sample`` does: the JAX
    session's ``_vae_encode`` leaves out ``shift_factor * scale_factor``
    (ROADMAP Queue C item 4; tests/test_torch_sd3_img2img.py)."""
    P = T.TINY_VAE_FLUX
    shift = np.float32(P.shift_factor) * np.float32(P.scale_factor)
    monkeypatch.setattr(japi, "_model_types", lambda: dict(J_TYPES))
    js = japi.MLImgSynth()
    encode = js._vae_encode
    monkeypatch.setattr(js, "_vae_encode",
                        lambda *a, **kw: encode(*a, **kw) - shift)
    img = np.random.default_rng(6).uniform(
        0, 1, (1, 3, 64, 64)).astype(np.float32)
    opts = _opts(files, "dev") + [("steps", 5), ("image", img),
                                  ("f-t-ini", 0.6)]
    (traj_j, img_j), (traj_t, img_t) = (
        _run(s, opts) for s in (js, torch_api.MLImgSynth(device="cpu")))
    assert len(traj_j) == len(traj_t) == 3
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    mse = np.mean((np.round(img_j * 255) - np.round(img_t * 255)) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 40.0


def _session(files, kind, *opts):
    s = torch_api.MLImgSynth(device="cpu")
    for k, v in _opts(files, kind) + list(opts):
        s.option_set(k, v)
    return s


def test_flux_prompt_editing_raises(files):
    s = _session(files, "dev", ("prompt", "a [cat:dog:2]"))
    with pytest.raises(torch_api.MlisError, match="prompt editing"):
        s.generate()


@pytest.mark.parametrize("opt", ["clip", "vae"])
def test_aux_file_errors_raise(files, tmp_path, opt):
    """A missing ``clip`` or ``vae`` file, and one that maps no tensor,
    raise; so does a transformer-only file without them (its text tower
    and VAE are missing)."""
    s = _session(files, "schnell", (opt, str(tmp_path / "none")))
    with pytest.raises(torch_api.MlisError, match="not found"):
        s.setup()
    s = _session(files, "schnell", (opt, files["junk"]))
    with pytest.raises(torch_api.MlisError, match="no .* tensors"):
        s.setup()
    s = _session(files, "schnell", (opt, ""))
    with pytest.raises(torch_api.MlisError, match="missing"):
        s.setup()


def test_flux_unet_split_stages_the_transformer(files, jax_runs):
    """Under --unet-split the ``flux.`` module is staged: on the host
    between requests, its latents those of the JAX session."""
    s = _session(files, "schnell", ("unet-split", 1))
    traj, _ = _run(s, [])
    assert "flux." in s._host and "flux." not in s.resident
    assert "clip.text." not in s.resident
    _close(traj, jax_runs["schnell"][0])


_NO_JAX = """
import json
import sys
import numpy as np
from mlimgsynth_torch import api, testing
out = {}
for name, mt in [("flux_dev", testing.TINY_MODEL_TYPE_FLUX_DEV),
                 ("flux_schnell", testing.TINY_MODEL_TYPE_FLUX)]:
    api._model_types = lambda name=name, mt=mt: {name: mt}
    paths = testing.write_random_flux_files(sys.argv[1], mt, seed=3,
                                            dtype=np.float32)
    s = api.MLImgSynth(device="cpu")
    for k, v in [("model", paths["model"]), ("clip", paths["clip"]),
                 ("vae", paths["vae"]), ("steps", 2), ("seed", 1),
                 ("cfg-scale", 3.5), ("prompt", "a cat")]:
        s.option_set(k, v)
    img = s.generate()
    out[name] = [s.c["model_type"], list(img.shape),
                 bool(np.isfinite(img).all()), float(img.std()) > 0]
out["tpu"] = sorted(m for m in sys.modules
                    if m.split(".")[0] == "mlimgsynth_tpu")
out["jax"] = "jax" in sys.modules
print(json.dumps(out))
"""


def test_port_flux_generate_never_imports_jax(tmp_path):
    """One interpreter that never imports jax writes the port's own random
    Flux component files (``write_random_flux_files``) and runs dev and
    schnell through the session."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert not res["jax"] and not res["tpu"], res
    for name in ("flux_dev", "flux_schnell"):
        assert res[name] == [name, [1, 3, 64, 64], True, True]
