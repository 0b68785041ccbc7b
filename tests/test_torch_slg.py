"""Skip-layer guidance in the port against the JAX session: the models'
``skip_layers`` (MMDiT joint blocks; Flux's double blocks 0.., then its
single blocks), the sampler's extra conditional evaluation on the steps of
its window (``out + slg_scale (d_cond - d_skip)``), the session's
``slg_*`` options, their errors and infotext, and the CLI's ``--slg-*``
(mirrors tests/test_sd3.py:350-425 and tests/test_flux.py:137).

Tiny SD3, SD3.5-medium (MMDiT-X) and Flux files of the JAX package, f32 on
the CPU: every step's latent at atol/rtol 1e-4, and the same NFE and SLG
infotext.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu import api as japi
from mlimgsynth_tpu import testing as JT
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import cli
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.utils import image as image_mod
from torch_jax_memo import jax_spec_memo  # noqa: F401

T_TYPES = {"sd3": T.TINY_MODEL_TYPE_SD3, "sd35_medium": T.TINY_MODEL_TYPE_SD35,
           "flux_dev": T.TINY_MODEL_TYPE_FLUX_DEV,
           "flux_schnell": T.TINY_MODEL_TYPE_FLUX, "sd1": T.TINY_MODEL_TYPE}
J_TYPES = {
    "sd3": JT.TINY_MODEL_TYPE_SD3,
    "sd35_medium": japi.ModelTypeDef(
        "sd35_medium", JT.TINY_CLIP, JT.TINY_CLIP2, JT.TINY_MMDIT_X,
        JT.TINY_VAE_SD3, 64, 2),
    "flux_dev": japi.ModelTypeDef("flux_dev", JT.TINY_CLIP, None,
                                  JT.TINY_FLUX_DEV, JT.TINY_VAE_FLUX, 64, 1),
    "flux_schnell": JT.TINY_MODEL_TYPE_FLUX, "sd1": JT.TINY_MODEL_TYPE}
SLG = [("slg-scale", 2.5), ("slg-layers", "1"), ("slg-end", 0.5)]
# the SLG part of both packages' infotext for SLG
SLG_TEXT = ", SLG scale: 2.5, SLG layers: 1, SLG start: 0.01, SLG end: 0.5"


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(torch_api, "_model_types", lambda: dict(T_TYPES))
    monkeypatch.setattr(japi, "_model_types", lambda: dict(J_TYPES))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Options naming each model's tiny files."""
    d = tmp_path_factory.mktemp("slg")
    out = {}
    for name, P in (("sd3", None), ("sd35_medium", JT.TINY_MMDIT_X)):
        path = str(d / f"{name}.safetensors")
        JT.write_checkpoint_sd3(path, P=P)
        out[name] = [("model", path), ("model-type", name)]
    for name, P in (("flux_dev", JT.TINY_FLUX_DEV),
                    ("flux_schnell", JT.TINY_FLUX_SCHNELL)):
        f = JT.write_tiny_flux_files(tmp_path_factory.mktemp(name), P=P)
        out[name] = [("model", f["model"]), ("clip", f["clip"]),
                     ("vae", f["vae"])]
    path = str(d / "sd1.safetensors")
    T.write_random_checkpoint(path, T.TINY_MODEL_TYPE, dtype=np.float32)
    out["sd1"] = [("model", path)]
    return out


def _opts(files, model, *extra):
    return files[model] + [
        ("image-dim", 64), ("steps", 4), ("seed", 13), ("cfg-scale", 4.0),
        ("prompt", "a guided (cat:1.1)"), ("nprompt", "blurry"),
        ("no-decode", 1), *extra]


def _run(s, opts):
    traj = []
    for k, v in opts:
        s.option_set(k, v)
    if isinstance(s, japi.MLImgSynth):
        s._dtype = jnp.float32
    s.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    return traj


# (model, method): schnell at cfg 4 runs CFG, dev embeds the guidance (no
# uncond batch); heun evaluates twice a step, both inside the step's window
CASES = [("sd3", "euler"), ("sd3", "heun"), ("sd35_medium", "euler"),
         ("flux_dev", "euler"), ("flux_schnell", "euler")]


@pytest.mark.parametrize("model,method", CASES)
def test_slg_matches_jax(files, model, method):
    """Layer 1 of 2 left out (the MMDiT's last joint block; Flux's single
    block) on steps 0-1 of 4: every step's latent, the NFE (the extra
    evaluations do not count) and the SLG infotext."""
    opts = _opts(files, model, ("method", method), *SLG)
    js, ts = japi.MLImgSynth(), torch_api.MLImgSynth(device="cpu")
    traj_j, traj_t = _run(js, opts), _run(ts, opts)
    plain = _run(torch_api.MLImgSynth(device="cpu"),
                 _opts(files, model, ("method", method)))
    assert len(traj_j) == len(traj_t) == (2 if method == "heun" else 4)
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert np.abs(traj_t[0] - plain[0]).max() > 1e-4
    assert ts._nfe == js._nfe
    assert SLG_TEXT in ts.infotext and SLG_TEXT in js.infotext


def test_slg_window_gating(files):
    """Outside its window SLG changes nothing: with the window at steps 2-3
    of 4 the first two latents are those without SLG, bit for bit, and the
    later ones differ; a window over every step differs from both."""
    def run(*extra):
        return _run(torch_api.MLImgSynth(device="cpu"),
                    _opts(files, "sd35_medium", *extra))
    plain = run()
    late = run(*SLG[:2], ("slg-start", 0.5), ("slg-end", 1.0))
    whole = run(*SLG[:2], ("slg-start", 0.0), ("slg-end", 1.0))
    for i in range(2):
        np.testing.assert_array_equal(late[i], plain[i])
    assert np.abs(late[2] - plain[2]).max() > 1e-4
    assert np.abs(whole[0] - plain[0]).max() > 1e-4
    assert np.abs(whole[3] - late[3]).max() > 1e-4


# (case, model, options): each an E_OPT_VALUE error in both packages, at
# option_set or at generate
ERRORS = {"not_a_dit": ("sd1", SLG),
          "empty_window": ("sd3", SLG + [("slg-start", 0.5)]),
          "out_of_range": ("sd35_medium", SLG + [("slg-layers", "9")]),
          "flux_out_of_range": ("flux_dev", SLG + [("slg-layers", "0,2")]),
          "negative_layer": ("sd3", SLG + [("slg-layers", "-1")]),
          "negative_scale": ("sd3", [("slg-scale", -1.0)]),
          "start_above_1": ("sd3", [("slg-start", 1.5)]),
          "bad_layers": ("sd3", [("slg-layers", "7,x")]),
          "no_layers": ("sd3", [("slg-layers", ",")])}


@pytest.mark.parametrize("case", list(ERRORS))
def test_slg_errors_match_jax(files, case):
    model, extra = ERRORS[case]
    for s in (japi.MLImgSynth(), torch_api.MLImgSynth(device="cpu")):
        err = (japi.MlisError if isinstance(s, japi.MLImgSynth)
               else torch_api.MlisError)
        with pytest.raises(err) as e:
            for k, v in _opts(files, model, *extra):
                s.option_set_str(k, str(v))
            if isinstance(s, japi.MLImgSynth):
                s._dtype = jnp.float32
            s.generate()
        assert e.value.code == err.E_OPT_VALUE, (type(s), e.value)


def test_slg_cli_matches_session(files, tmp_path):
    """``--slg-scale 2.5 --slg-layers 1 --slg-end 0.5`` through the CLI on
    SD3.5-medium: the output latent is the session's, and the PNG's
    parameters carry the SLG infotext."""
    path = dict(files["sd35_medium"])["model"]
    out, png = str(tmp_path / "lat.npy"), str(tmp_path / "o.png")
    assert cli.main(["generate", "-b", "cpu", "-m", path, "-d", "64", "-s",
                     "4", "-S", "13", "--cfg-scale", "4", "-p",
                     "a guided (cat:1.1)", "-n", "blurry", "--slg-scale",
                     "2.5", "--slg-layers", "1", "--slg-end", "0.5",
                     "--olatent", out, "-o", png, "-q"]) == 0
    traj = _run(torch_api.MLImgSynth(device="cpu"),
                _opts(files, "sd35_medium", *SLG))
    np.testing.assert_array_equal(image_mod.tensor_load(out), traj[-1])
    assert SLG_TEXT in image_mod.png_read(png)[1]["parameters"]
    assert "--slg-layers" in cli.HELP
