"""Flux LoRAs in the port against the JAX session: kohya names
(``lora_unet_double_blocks_0_img_attn_qkv``) and diffusers-PEFT names
(``transformer.transformer_blocks.0.attn.to_q``, a slice of the fused qkv;
``proj_mlp``, four sevenths of a single block's ``linear1``), written by
``testing.write_random_flux_lora`` beside the JAX package's tiny Flux files
(``write_tiny_flux_files``).

Every step's latent at atol/rtol 1e-4 against the JAX session (f32 on the
CPU, as tests/test_flux_session.py:121-241 runs it there); the PEFT file
against its kohya twin bit for bit (the two merge into the same weights);
a ``<lora:NAME:MULT>`` tag, and a changed LoRA list reloading the Flux
transformer alone; a LoRA on a quantized Flux (the merge made before the
quantization, the stored weights the JAX session's); the CLI's
``--lora``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu import api as japi
from mlimgsynth_tpu import testing as JT
from mlimgsynth_tpu.models import flux as jflux
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import cli
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.utils import image as image_mod
from torch_jax_memo import jax_spec_memo  # noqa: F401


def _jp(P):
    return jflux.FluxParams(**{**vars(P), "ch_adm_in": P.d_pooled})


# (port type, JAX params) by name: the tiny schnell, and the one whose
# widths quantize
TYPES = {"tiny": (T.TINY_MODEL_TYPE_FLUX, JT.TINY_FLUX_SCHNELL),
         "tiny_q": (T.TINY_Q_MODEL_TYPE_FLUX, _jp(T.TINY_Q_FLUX_SCHNELL))}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _types(monkeypatch, which):
    mt, jp = TYPES[which]
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"flux_schnell": mt})
    monkeypatch.setattr(japi, "_model_types", lambda: {
        "flux_schnell": japi.ModelTypeDef("flux_schnell", JT.TINY_CLIP,
                                          None, jp, JT.TINY_VAE_FLUX, 64,
                                          1)})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """For each type: the JAX package's tiny files and a kohya and a PEFT
    LoRA of rank 2 (f32) in one directory, named ``kohya`` and ``peft``."""
    out = {}
    for which, (mt, jp) in TYPES.items():
        d = tmp_path_factory.mktemp(which)
        f = JT.write_tiny_flux_files(d, P=jp, seed=4)
        out[which] = {"opts": [("model", f["model"]), ("clip", f["clip"]),
                               ("vae", f["vae"])], "dir": str(d)}
        for kind in ("kohya", "peft"):
            path = str(d / f"{kind}.safetensors")
            out[which][kind] = path
            out[which][kind + "_deltas"] = T.write_random_flux_lora(
                path, mt, rank=2, seed=8, peft=kind == "peft",
                dtype=np.float32)
    return out


OPTS = [("image-dim", 64), ("steps", 3), ("seed", 21), ("cfg-scale", 3.5),
        ("prompt", "a stylized cat"), ("nprompt", "blurry"),
        ("no-decode", 1)]


def _run(s, opts, loras=()):
    traj = []
    for k, v in opts:
        s.option_set(k, v)
    for path, mult in loras:
        s.option_set("lora", path, mult)
    if isinstance(s, japi.MLImgSynth):
        s._dtype = jnp.float32
    s.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    return traj


def _close(traj_t, traj_j):
    assert len(traj_t) == len(traj_j) == 3
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")


@pytest.mark.parametrize("kind", ["kohya", "peft"])
def test_flux_lora_matches_jax(files, monkeypatch, kind):
    _types(monkeypatch, "tiny")
    f = files["tiny"]
    loras = [(f[kind], 0.8)]
    base = _run(torch_api.MLImgSynth(device="cpu"), f["opts"] + OPTS)
    s = torch_api.MLImgSynth(device="cpu")
    traj_t = _run(s, f["opts"] + OPTS, loras)
    _close(traj_t, _run(japi.MLImgSynth(), f["opts"] + OPTS, loras))
    assert np.abs(traj_t[-1] - base[-1]).max() > 1e-3
    assert s._lora_prefixes == {"flux."}
    # every patched weight is W + 0.8 up @ down (scale 1: kohya alpha =
    # rank, PEFT none), bit for bit in f32
    from mlimgsynth_torch.io.tensorstore import TensorStore
    st = TensorStore.open(dict(f["opts"])["model"])
    try:
        name_map = tweights.build_name_map(st)
        for name, (down, up, _) in f[kind + "_deltas"].items():
            w = tweights.read_entry(st, name_map[name]).astype(np.float32)
            want = w + (up @ down) * np.float32(0.8)
            mod = s._models["flux."].get_submodule(
                name[len("flux."):-len(".weight")])
            np.testing.assert_array_equal(mod.weight.detach().numpy(), want)
    finally:
        st.close()


def test_flux_peft_equals_kohya(files, monkeypatch):
    """The PEFT file and its kohya twin (the slices' up rows zero-padded
    into the fused weights) give the same latents, bit for bit."""
    _types(monkeypatch, "tiny")
    f = files["tiny"]
    a, b = (_run(torch_api.MLImgSynth(device="cpu"), f["opts"] + OPTS,
                 [(f[kind], 0.8)]) for kind in ("kohya", "peft"))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_flux_lora_tag_and_reload(files, monkeypatch):
    """``<lora:peft:0.8>`` (found under ``lora_dir``) gives the ``lora``
    option's latents; the next request, without the tag, reloads the Flux
    transformer alone (the text tower and VAE stay the same modules) and
    gives the latents without a LoRA."""
    _types(monkeypatch, "tiny")
    f = files["tiny"]
    base = _run(torch_api.MLImgSynth(device="cpu"), f["opts"] + OPTS)
    with_opt = _run(torch_api.MLImgSynth(device="cpu"), f["opts"] + OPTS,
                    [(f["peft"], 0.8)])
    s = torch_api.MLImgSynth(device="cpu")
    tagged = _run(s, f["opts"] + OPTS + [
        ("lora-dir", f["dir"]), ("prompt", "a stylized cat <lora:peft:0.8>")])
    for x, y in zip(tagged, with_opt):
        np.testing.assert_array_equal(x, y)
    clip, vae, flux = (s._models[p] for p in ("clip.text.", "vae.", "flux."))
    again = _run(s, OPTS)
    assert s._lora_state == () and s._lora_prefixes == set()
    assert s._models["clip.text."] is clip and s._models["vae."] is vae
    assert s._models["flux."] is not flux
    for x, y in zip(again, base):
        np.testing.assert_array_equal(x, y)


def test_flux_lora_on_quantized_session(files, monkeypatch):
    """q8_0 with a kohya LoRA on the Flux whose widths quantize: the merge
    comes before the quantization, so the stored weights are the JAX
    session's bit for bit, and every step's latent agrees at 1e-4 (at
    64^2 no weight is stored per column: only weight-only products)."""
    _types(monkeypatch, "tiny_q")
    f = files["tiny_q"]
    opts = f["opts"] + OPTS + [("weight-type", "q8_0")]
    loras = [(f["kohya"], 0.8)]
    s, js = torch_api.MLImgSynth(device="cpu"), japi.MLImgSynth()
    traj_t = _run(s, opts, loras)
    _close(traj_t, _run(js, opts, loras))
    mine = {"flux." + k: v for k, v in s._models["flux."].state_dict().items()}
    theirs = tweights.params_from_jax(
        {k: np.asarray(v) for k, v in js._params["unet"].items()})
    assert mine.keys() == theirs.keys()
    for name, v in mine.items():
        assert torch.equal(v, theirs[name]), name
    assert "flux.double_blocks.0.img_attn.qkv.weight_q8" in mine


def test_flux_cli_lora_matches_session(files, monkeypatch, tmp_path):
    """The CLI's ``--lora PATH,MULT`` on Flux: its output latent is the
    session's."""
    _types(monkeypatch, "tiny")
    f = dict(files["tiny"]["opts"])
    out = str(tmp_path / "lat.npy")
    assert cli.main(["generate", "-b", "cpu", "-m", f["model"], "--clip",
                     f["clip"], "--vae", f["vae"], "-d", "64", "-s", "3",
                     "-S", "21", "--cfg-scale", "3.5", "-p",
                     "a stylized cat", "-n", "blurry", "--lora",
                     files["tiny"]["kohya"] + ",0.8", "--olatent", out,
                     "--no-decode", "1", "-q"]) == 0
    traj = _run(torch_api.MLImgSynth(device="cpu"),
                files["tiny"]["opts"] + OPTS, [(files["tiny"]["kohya"], 0.8)])
    np.testing.assert_array_equal(image_mod.tensor_load(out), traj[-1])
