"""The port's SD3 session against the JAX package's on one tiny SD3
checkpoint: per-step latents and the final image.

The checkpoint is the JAX package's ``write_checkpoint_sd3`` (the sd3
single-file layout: MMDiT under ``model.diffusion_model.``, both text towers
under ``text_encoders.`` with Linear-stored text projections, the flow VAE);
the JAX session reads its tiny model types (``MLIS_TINY_MODELS``), the port
the same geometry from ``mlimgsynth_torch.testing``.  Both run in f32 on the
CPU from the same file, prompts and seed.  Tolerances as the SD1 legs
(tests/test_torch_e2e.py): per-step latents atol/rtol 1e-4, final u8 image
PSNR > 40 dB.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.testing import write_checkpoint_sd3
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch.testing import TINY_MODEL_TYPE_SD3
from torch_jax_memo import jax_spec_memo  # noqa: F401

PROMPT = "a (cat:1.3) riding a [bicycle]"
NPROMPT = "blurry, low quality"
OPTS = [("image-dim", 64), ("steps", 5), ("seed", 42), ("cfg-scale", 5.0),
        ("prompt", PROMPT), ("nprompt", NPROMPT)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores (and the tensors are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr_u8(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.fixture
def sd3_ckpt(tmp_path, monkeypatch):
    path = tmp_path / "tiny-sd3.safetensors"
    write_checkpoint_sd3(path, seed=5)
    monkeypatch.setenv("MLIS_TINY_MODELS", "1")
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd3": TINY_MODEL_TYPE_SD3})
    return str(path)


def _run(session, ckpt, method):
    """A request with no model type set: both sessions identify sd3 from
    the file."""
    traj = []
    session.option_set("model", ckpt)
    for k, v in OPTS + [("method", method)]:
        session.option_set(k, v)
    if isinstance(session, JaxSession):
        session._dtype = jnp.float32
    session.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    img = session.generate()
    return traj, np.asarray(img, np.float32)


@pytest.mark.parametrize("method", ["euler", "dpmpp2m"])
def test_sd3_generate_matches_jax(sd3_ckpt, method):
    traj_j, img_j = _run(JaxSession(), sd3_ckpt, method)
    ts = torch_api.MLImgSynth(device="cpu")
    traj_t, img_t = _run(ts, sd3_ckpt, method)
    assert ts.c["model_type"] == "sd3"
    assert len(traj_j) == len(traj_t) == 5
    assert traj_t[0].shape == (1, 4, 8, 8)
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert img_t.shape == img_j.shape == (1, 3, 64, 64)
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"
    # the conditioning: 77 CLIP rows (L ++ bigG, zero-padded to the T5
    # width) then 77 zero T5 rows; the label is the two pooled features
    cond, label = ts.tensors["cond"], ts.tensors["label"]
    assert cond.shape == (1, 154, 80) and label.shape == (1, 64)
    assert not cond[:, 77:].any() and not cond[:, :, 64:].any()


LONG_PROMPT = ", ".join(["a detailed photograph of a red fox in the snow"]
                        * 9) + " BREAK a cat"


def test_sd3_multi_window_prompt_matches_jax(sd3_ckpt, monkeypatch):
    """A prompt of three windows (98 tokens, then a BREAK): flow models
    condition on its first window only, in both packages."""
    monkeypatch.setattr(sys.modules[__name__], "OPTS",
                        OPTS[:-2] + [("prompt", LONG_PROMPT),
                                     ("nprompt", NPROMPT)])
    traj_j, img_j = _run(JaxSession(), sd3_ckpt, "euler")
    ts = torch_api.MLImgSynth(device="cpu")
    traj_t, img_t = _run(ts, sd3_ckpt, "euler")
    assert ts.tensors["cond"].shape == (1, 154, 80)
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    psnr = _psnr_u8(np.round(img_j * 255), np.round(img_t * 255))
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"


@pytest.mark.parametrize("name,value", [
    ("dp", 4), ("sp", 4), ("pp", 4), ("tp", 4),
])
def test_unported_sd3_options_raise(name, value):
    """Each mesh option on a session with no process group of that many
    ranks raises ``MlisError`` at ``setup``, naming the torchrun line."""
    s = torch_api.MLImgSynth(device="cpu")
    s.option_set(name, value)
    with pytest.raises(torch_api.MlisError) as e:
        s.setup()
    assert e.value.code == torch_api.MlisError.E_OPT_VALUE
    assert f"torchrun --nproc-per-node {value}" in str(e.value)


_NO_JAX = """
import json
import os
import sys
import numpy as np
from mlimgsynth_torch import api, testing
from mlimgsynth_torch.ops import quant
out = {}
mt = testing.TINY_Q_MODEL_TYPE_SD3
api._model_types = lambda: {"sd3": mt}
path = sys.argv[1]
testing.write_random_checkpoint(path, mt, seed=3, dtype=np.float32)
s = api.MLImgSynth(device="cpu")
for k, v in [("model", path), ("weight-type", "q8_0"), ("steps", 2),
             ("seed", 1), ("prompt", "a cat"), ("nprompt", "")]:
    s.option_set(k, v)
img = s.generate()
out["sd3"] = [s.c["model_type"], s.c["width"], list(img.shape),
              bool(np.isfinite(img).all())]
# SDXL q8_0 in the sd_xl_base layout, under MLIS_Q8_MODE=int8
mt = testing.TINY_Q_MODEL_TYPE_XL
api._model_types = lambda: {"sdxl": mt}
testing.write_random_checkpoint(path, mt, seed=4, dtype=np.float32)
k8 = []
plain = quant.q8_matmul_int8_plain
quant.q8_matmul_int8_plain = lambda *a: (k8.append(1), plain(*a))[1]
os.environ["MLIS_Q8_MODE"] = "int8"
s = api.MLImgSynth(device="cpu")
for k, v in [("model", path), ("weight-type", "q8_0"), ("steps", 2),
             ("seed", 1), ("prompt", "a cat"), ("nprompt", "")]:
    s.option_set(k, v)
img = s.generate()
out["sdxl"] = [s.c["model_type"], s.c["width"], list(img.shape),
               bool(np.isfinite(img).all()), len(k8)]
out["plain_cuda_calls"] = quant.PLAIN_CUDA_CALLS
out["tpu"] = sorted(m for m in sys.modules
                    if m.split(".")[0] == "mlimgsynth_tpu")
out["jax"] = "jax" in sys.modules
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def no_jax_run(tmp_path_factory):
    """One interpreter that never imports jax runs the port's own random
    writer and two quantizing tiny models through the session: SD3 at its
    512^2 default, q8_0 (its x-stream products run the W8A8 twin), then
    SDXL at 64^2, q8_0 under ``MLIS_Q8_MODE=int8`` (every product runs the
    K8 twin)."""
    tmp = tmp_path_factory.mktemp("nojax")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("MLIS_Q8_MODE", None)
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(tmp / "t.safetensors")],
        capture_output=True, text=True, env=env, cwd=str(tmp),
        timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert not res["jax"] and not res["tpu"], res
    assert res["plain_cuda_calls"] == 0
    return res


def test_port_sd3_q8_generate_never_imports_jax(no_jax_run):
    assert no_jax_run["sd3"] == ["sd3", 512, [1, 3, 512, 512], True]


def test_port_sdxl_q8_int8_generate_never_imports_jax(no_jax_run):
    model, width, shape, finite, k8_calls = no_jax_run["sdxl"]
    assert (model, width, shape, finite) == ("sdxl", 64, [1, 3, 64, 64], True)
    assert k8_calls > 0
