"""A1111 prompt editing (``[from:to:when]``, ``[a|b]``): the port's session
against the JAX session's on tiny checkpoints, in f32 on the CPU.

The cases of the JAX package's ``tests/test_prompt_editing.py``: an edit
that collapses to one segment equals the plain prompt exactly, a switch
follows the plain prompt up to its step and leaves it after, an
alternating negative prompt, SDXL's per-segment labels, heun's two
evaluations a step; per-step latents against the JAX session's at
atol/rtol 1e-4; SD3 raises ``MlisError`` in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import (TINY_MODEL_TYPE_XL, patch_tiny_model_types,
                     write_checkpoint_sdxl, write_tiny_checkpoint)
from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.api import MlisError as JaxError
from mlimgsynth_tpu.testing import (TINY_MODEL_TYPE_SD3 as J_SD3,
                                    write_checkpoint_sd3)
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.sampling.sampler import SamplerConfig, plan_n_step
from torch_jax_memo import jax_spec_memo  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    out = {"sd1": str(d / "sd1.safetensors"),
           "sdxl": str(d / "sdxl.safetensors"),
           "sd3": str(d / "sd3.safetensors")}
    write_tiny_checkpoint(out["sd1"])
    write_checkpoint_sdxl(out["sdxl"])
    write_checkpoint_sd3(out["sd3"])
    return out


_TYPES = {"sd1": (None, T.TINY_MODEL_TYPE),
          "sdxl": ({"sdxl": TINY_MODEL_TYPE_XL}, T.TINY_MODEL_TYPE_XL),
          "sd3": ({"sd3": J_SD3}, T.TINY_MODEL_TYPE_SD3)}


def _sessions(monkeypatch, ckpt, mt, **opts):
    jtypes, tmt = _TYPES[mt]
    patch_tiny_model_types(monkeypatch, jtypes)
    monkeypatch.setattr(torch_api, "_model_types", lambda: {mt: tmt})
    out = []
    for s in (JaxSession(), torch_api.MLImgSynth(device="cpu")):
        if isinstance(s, JaxSession):
            s._dtype = jnp.float32
        for k, v in [("model", ckpt), ("model-type", mt), ("image-dim", 64),
                     ("steps", 4), ("seed", 21), ("cfg-scale", 5.0),
                     *opts.items()]:
            s.option_set(k.replace("_", "-"), v)
        out.append(s)
    return out


def _request(s, prompt, nprompt=""):
    traj = []
    s.option_set("seed", 21)
    s.option_set("prompt", prompt)
    s.option_set("nprompt", nprompt)
    s.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    return traj


def _close(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(y, x, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")


def test_identity_edit_equals_plain(ckpts, monkeypatch):
    js, ts = _sessions(monkeypatch, ckpts["sd1"], "sd1")
    ts.option_set("prompt", "a [cat:cat:2] photo")
    assert ts.prompt.editing and ts.prompt.text == "a cat photo"
    edit = _request(ts, "a [cat:cat:2] photo")
    plain = _request(ts, "a cat photo")
    for a, b in zip(edit, plain):
        np.testing.assert_array_equal(a, b)
    _close(_request(js, "a [cat:cat:2] photo"), edit)


@pytest.mark.parametrize("prompt,when", [("a [cat:dog:2] photo", 2),
                                         ("a [cat:dog:0.5] photo", 2),
                                         ("a [dog:1] photo", 1)])
def test_switch_matches_jax(ckpts, monkeypatch, prompt, when):
    """Steps before the switch condition on the first text, as the plain
    prompt does, bit for bit; after it the trajectory leaves the plain
    one; every step matches the JAX session."""
    js, ts = _sessions(monkeypatch, ckpts["sd1"], "sd1")
    edit = _request(ts, prompt, "blurry")
    assert ts.tensors["cond"].shape[0] == 3      # two segments + negative
    assert ts.infotext.startswith(prompt + "\n")
    first = prompt.replace("[cat:dog:2]", "cat").replace(
        "[cat:dog:0.5]", "cat").replace("[dog:1]", "")
    plain = _request(ts, first, "blurry")
    for i in range(when):
        np.testing.assert_array_equal(edit[i], plain[i])
    assert not np.array_equal(edit[when], plain[when])
    _close(_request(js, prompt, "blurry"), edit)


def test_negative_prompt_alternation(ckpts, monkeypatch):
    """``[blurry|noisy]`` alternates per step; an edited-to-empty negative
    segment conditions on what an empty negative prompt gives."""
    js, ts = _sessions(monkeypatch, ckpts["sd1"], "sd1")
    for neg in ("[blurry|noisy]", "[blurry::2]"):
        _close(_request(js, "a photo", neg), _request(ts, "a photo", neg))
        assert ts.nprompt.editing


def test_sdxl_labels(ckpts, monkeypatch):
    """SDXL: the bank holds each segment's pooled label; an identity edit
    equals the plain prompt, a switch matches the JAX session, and an
    empty negative segment is zero rows with its label kept."""
    js, ts = _sessions(monkeypatch, ckpts["sdxl"], "sdxl")
    edit = _request(ts, "a [cat:cat:2] photo")
    plain = _request(ts, "a cat photo")
    for a, b in zip(edit, plain):
        np.testing.assert_array_equal(a, b)
    sw = _request(ts, "a [cat:dog:2] photo", "[:ugly:2]")
    cond, label = ts.tensors["cond"], ts.tensors["label"]
    assert cond.shape[0] == label.shape[0] == 4
    assert not cond[2].any() and cond[3].any() and label[2].any()
    _close(_request(js, "a [cat:dog:2] photo", "[:ugly:2]"), sw)


def test_heun_two_evaluations_a_step(ckpts, monkeypatch):
    """heun takes 2 evaluations a step: ``plan_n_step`` halves the steps
    and the bank's rows follow the loop's steps, as in the JAX loop."""
    js, ts = _sessions(monkeypatch, ckpts["sd1"], "sd1", method="heun",
                       steps=8)
    assert plan_n_step(SamplerConfig(method="heun", n_step=8), 2) == 4
    _close(_request(js, "a [cat|dog] photo", "x"),
           _request(ts, "a [cat|dog] photo", "x"))


def test_sd3_raises(ckpts, monkeypatch):
    js, ts = _sessions(monkeypatch, ckpts["sd3"], "sd3")
    for s, err in ((js, JaxError), (ts, torch_api.MlisError)):
        s.option_set("prompt", "a [cat:dog:2] photo")
        with pytest.raises(err, match="flow models"):
            s.generate()
