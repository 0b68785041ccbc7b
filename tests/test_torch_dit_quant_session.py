"""Quantized weight types on SD3.5 and Flux through the port's session
against the JAX session, and every weight type on every DiT type.

The JAX package's tiny files at widths that quantize (``write_tiny_flux_
files`` and ``write_checkpoint_sd3`` on ``testing.TINY_Q_FLUX_DEV``,
``TINY_Q_MMDIT_X`` and a qk-norm ``TINY_Q_MMDIT``, the SD3.5-large
pattern) run through both sessions, f32 on the CPU, without the decode
(``no_decode``):

- the stored weights of the denoiser, bit for bit the JAX session's
  (``_params["unet"]``).  Flux stores per column at 768^2 only with the
  token count of one evaluation (``dit_m_hint(flux=True)``, no CFG batch),
  which the JAX session gives its Flux transformer;
- every step's latent: the weight-only routes at atol/rtol 1e-4; where a
  product runs the W8A8 route the activations are quantized, and an f32
  ulp upstream can move one activation a step, which later layers spread
  (tests/test_torch_int8ws.py).  Weights stored per column at the
  session's size (only the image-stream products quantize their
  activations) are held to a relative L2 of 1e-3 a step.  Under
  ``MLIS_Q8_MODE=int8`` every product quantizes them: one step moved in
  the first block's MLP input of 65,536 gives the tiny MMDiT-X 1.8e-3 at
  its output, so these are held to a quarter of what the route itself
  moves the latent (the port's latent in the default mode against its own
  in int8 mode: 1.4e-2 on the MMDiT-X, where the port and the JAX session
  differ by 1.6e-3; 3.7e-3 on Flux, 7.7e-5); a wrong slab, scale or
  rounding moves it by that effect or more;
- a q8_0 GGUF Flux transformer in bare BFL names (the JAX package's
  tests/test_flux_session.py:243).

Every weight type of ``api._WEIGHT_TYPES`` on SD3.5-medium, the
SD3.5-large pattern, Flux-dev and Flux-schnell runs through the session
(the port's own random files), and some through the CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu import api as japi
from mlimgsynth_tpu import testing as JT
from mlimgsynth_tpu.models import flux as jflux
from mlimgsynth_tpu.models import mmdit as jmmdit
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import cli
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.io.tensorstore import TensorStore, write_gguf
from mlimgsynth_torch.models.blocks import QLinear
from mlimgsynth_torch.utils import image as image_mod
from torch_jax_memo import jax_spec_memo  # noqa: F401

# the SD3.5-large pattern: qk-norm blocks without attn2, at widths that
# quantize (its type set by the option: a tiny width cannot tell 2432)
T_LARGE = dataclasses.replace(T.TINY_Q_MMDIT, d_pooled=64, qk_norm=True)
T_TYPES = {
    "flux_dev": T.TINY_Q_MODEL_TYPE_FLUX_DEV,
    "flux_schnell": T.TINY_Q_MODEL_TYPE_FLUX,
    "sd35_medium": T.TINY_Q_MODEL_TYPE_SD35,
    "sd35_large": torch_api.ModelTypeDef("sd35_large", T.TINY_CLIP, T_LARGE,
                                         T.TINY_VAE_SD3, 512, 2,
                                         T.TINY_CLIP2)}


def _jp(P):
    kw = {**vars(P), "ch_adm_in": P.d_pooled}
    return (jflux.FluxParams(**kw) if getattr(P, "flux", False)
            else jmmdit.MmditParams(**kw))


def _j_type(name):
    mt = T_TYPES[name]
    return japi.ModelTypeDef(name, JT.TINY_CLIP,
                             None if mt.clip2_p is None else JT.TINY_CLIP2,
                             _jp(mt.unet_p),
                             JT.TINY_VAE_FLUX if name.startswith("flux")
                             else JT.TINY_VAE_SD3, mt.default_dim,
                             mt.default_clip_skip)


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    for var in ("MLIS_Q8_WS", "MLIS_Q8_RS", "MLIS_Q8_INT8WS", "MLIS_Q8_MODE"):
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(torch_api, "_model_types", lambda: dict(T_TYPES))
    monkeypatch.setattr(japi, "_model_types",
                        lambda: {k: _j_type(k) for k in T_TYPES})
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX package's tiny files of the quantizing geometries."""
    d = tmp_path_factory.mktemp("dit_q")
    flux = JT.write_tiny_flux_files(d, P=_jp(T.TINY_Q_FLUX_DEV))
    out = {"flux_dev": [("model", flux["model"]), ("clip", flux["clip"]),
                        ("vae", flux["vae"])]}
    for name in ("sd35_medium", "sd35_large"):
        path = str(d / f"{name}.safetensors")
        JT.write_checkpoint_sd3(path, P=_jp(T_TYPES[name].unet_p))
        out[name] = [("model", path), ("model-type", name)]
    return out


# (model, weight type, MLIS_Q8_MODE, image side, W8A8 route): the per-column
# storage at Flux's 768^2 and the MMDiT-X's 512^2; the 4-bit and int8-mode
# cases at a smaller side
CASES = {"flux_dev-q8_0": ("flux_dev", "q8_0", "dq", 768, True),
         "flux_dev-q8_0-int8": ("flux_dev", "q8_0", "int8", 256, True),
         "flux_dev-q4_0": ("flux_dev", "q4_0", "dq", 256, False),
         "sd35_medium-q8_0": ("sd35_medium", "q8_0", "dq", 512, True),
         "sd35_medium-q8_0-int8": ("sd35_medium", "q8_0", "int8", 128, True),
         "sd35_medium-q4_k": ("sd35_medium", "q4_k", "dq", 128, False),
         "sd35_large-q8_0": ("sd35_large", "q8_0", "dq", 512, True)}


def _run(s, opts):
    """Every step's latent of a request (and, with ``no_decode``, the
    request's result: the last)."""
    traj = []
    for k, v in opts:
        s.option_set(k, v)
    if isinstance(s, japi.MLImgSynth):
        s._dtype = jnp.float32
    s.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    out = s.generate()
    np.testing.assert_array_equal(out, traj[-1])
    return traj


def _opts(files, model, wt, side):
    return files[model] + [
        ("weight-type", wt), ("image-dim", side), ("steps", 2),
        ("seed", 9), ("cfg-scale", 3.5 if model == "flux_dev" else 5.0),
        ("prompt", "a quantized (lighthouse:1.2)"), ("nprompt", "blurry"),
        ("no-decode", 1)]


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_session_matches_jax(files, monkeypatch, case):
    model, wt, mode, side, w8a8 = CASES[case]
    opts = _opts(files, model, wt, side)
    if mode == "int8":
        # the port's own default-mode latents, for the route's effect; the
        # JAX package reads the mode when it traces, so no program traced
        # in the other mode may be reused
        effect = _run(torch_api.MLImgSynth(device="cpu"), opts)
        jax.clear_caches()
    monkeypatch.setenv("MLIS_Q8_MODE", mode)
    js, ts = japi.MLImgSynth(), torch_api.MLImgSynth(device="cpu")
    traj_j, traj_t = _run(js, opts), _run(ts, opts)
    assert ts.c["model_type"] == js.c["model_type"] == model
    prefix = ts._denoiser()
    mine = {prefix + k: v for k, v in ts._models[prefix].state_dict().items()}
    theirs = tweights.params_from_jax(
        {k: np.asarray(v) for k, v in js._params["unet"].items()})
    assert mine.keys() == theirs.keys()
    for name, v in mine.items():
        assert torch.equal(v, theirs[name]), name
    percol = [n for n, m in ts._models[prefix].named_modules()
              if isinstance(m, QLinear) and m.weight_scale.dim() == 1]
    assert bool(percol) == (wt == "q8_0" and mode == "dq" and w8a8)
    assert len(traj_j) == len(traj_t) == 2
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        rel = np.linalg.norm(b - a) / np.linalg.norm(a)
        if mode == "int8":
            route = np.linalg.norm(b - effect[i]) / np.linalg.norm(b)
            assert rel < 0.25 * route, (i, rel, route)
        elif w8a8:
            assert rel < 1e-3, (i, rel)
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {i} latent mismatch")
    assert ts.tensors["image"] is None


def test_flux_gguf_q8_0_matches_jax(files, tmp_path):
    """A q8_0 GGUF Flux transformer (bare ``double_blocks.*`` names, the
    port's own GGUF writer) beside the safetensors CLIP and VAE: without a
    ``weight-type`` the session takes the file's, q8_0, as the JAX session
    does (``api.py:1066-1068``), and quantizes the weights it reads (the
    file's blocks dequantized to f32) as the JAX session with q8_0 set
    does (that one's compute type held at f32: the file's type would make
    it bf16)."""
    gg = str(tmp_path / "flux-q8_0.gguf")
    st = TensorStore.open(dict(files["flux_dev"])["model"])
    try:
        write_gguf(st, gg, dtype="q8_0")
    finally:
        st.close()
    opts = [("model", gg)] + _opts(files, "flux_dev", "", 128)[1:]
    traj_j = _run(japi.MLImgSynth(), opts + [("weight-type", "q8_0")])
    s = torch_api.MLImgSynth(device="cpu")
    traj_t = _run(s, opts)
    assert s.c["model_type"] == "flux_dev" and s.qbits == 8
    assert s.dtype == torch.float32
    assert {m.bits for m in s._models["flux."].modules()
            if isinstance(m, QLinear)} == {8}
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")


@pytest.fixture(scope="module")
def port_files(tmp_path_factory):
    """The port's own random files of each type, f32."""
    d = tmp_path_factory.mktemp("dit_q_port")
    out = {}
    for name, mt in T_TYPES.items():
        if name.startswith("flux"):
            (d / name).mkdir()
            f = T.write_random_flux_files(d / name, mt, seed=2,
                                          dtype=np.float32)
            out[name] = [("model", f["model"]), ("clip", f["clip"]),
                         ("vae", f["vae"])]
        else:
            path = str(d / f"{name}.safetensors")
            T.write_random_checkpoint(path, mt, seed=2, dtype=np.float32)
            out[name] = [("model", path), ("model-type", name)]
    return out


@pytest.mark.parametrize("wt", list(torch_api._WEIGHT_TYPES))
@pytest.mark.parametrize("model", list(T_TYPES))
def test_every_weight_type_runs(port_files, model, wt):
    """One request of each DiT type in each weight type: finite output,
    every linear of input width a multiple of 128 quantized to the type's
    bits (none for the float types), the compute dtype the type's."""
    s = torch_api.MLImgSynth(device="cpu")
    for k, v in port_files[model] + [
            ("weight-type", wt), ("image-dim", 64), ("steps", 1),
            ("seed", 3), ("prompt", "a cat"), ("no-decode", 1)]:
        s.option_set(k, v)
    lat = s.generate()
    dtype, bits = torch_api._WEIGHT_TYPES[wt]
    assert lat.shape == (1, 4, 8, 8) and np.isfinite(lat).all()
    assert s.c["model_type"] == model
    q = [m.bits for mod in s._models.values() for m in mod.modules()
         if isinstance(m, QLinear)]
    assert set(q) == ({bits} if bits else set())
    assert s.dtype == (dtype or torch.float32)


@pytest.mark.parametrize("model,wt", [("flux_schnell", "q5_k"),
                                      ("sd35_large", "q4_1")])
def test_quantized_cli_matches_session(port_files, tmp_path, model, wt):
    """The CLI's ``--weight-type`` on a DiT type: its output latent is the
    session's, and ``--no-decode`` writes no image."""
    opts = dict(port_files[model])
    out = str(tmp_path / "lat.npy")
    argv = ["generate", "-b", "cpu", "-m", opts["model"], "-d", "128",
            "-s", "2", "-S", "4", "-p", "a cat", "--weight-type", wt,
            "--olatent", out, "--no-decode", "1", "-o",
            str(tmp_path / "o.png"), "-q"]
    for k in ("clip", "vae", "model-type"):
        if k in opts:
            argv += [f"--{k}", opts[k]]
    assert cli.main(argv) == 0
    assert not (tmp_path / "o.png").exists()
    s = torch_api.MLImgSynth(device="cpu")
    for k, v in port_files[model] + [
            ("weight-type", wt), ("image-dim", 128), ("steps", 2),
            ("seed", 4), ("prompt", "a cat"), ("no-decode", 1)]:
        s.option_set(k, v)
    np.testing.assert_array_equal(image_mod.tensor_load(out), s.generate())
