"""SD3 img2img: the port's encoded latent and session against the JAX
package, and the JAX session's missing latent shift.

The VAE of the SD3 family shifts its latent: the decoder adds
``shift_factor`` (0.0609) back after dividing by ``scale_factor`` (1.5305),
and the JAX package's ``latent_mean`` / ``latent_sample`` subtract it
(``mlimgsynth_tpu/models/vae.py:128-140``).  The JAX session's
``_vae_encode`` (``mlimgsynth_tpu/api.py:1969-1991``) does not, so its
initial img2img latent is off by ``shift_factor * scale_factor`` (0.0932) in
every element: a fault of the reference, which stays as it is.  The port
follows ``latent_sample``, the function the decoder inverts; the session
comparison holds it against the JAX session with that one term corrected.

f32 on the CPU, the JAX package's tiny SD3 checkpoint
(``write_checkpoint_sd3``).  Tolerances as the other session legs: latents
atol/rtol 1e-4, the image PSNR > 40 dB.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_tpu.rng import RngPhilox as JaxRng
from mlimgsynth_tpu.testing import write_checkpoint_sd3
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch.testing import TINY_MODEL_TYPE_SD3
from torch_jax_memo import jax_spec_memo  # noqa: F401

OPTS = [("image-dim", 64), ("steps", 5), ("seed", 42), ("cfg-scale", 5.0),
        ("method", "euler"), ("prompt", "a (cat:1.3) riding a [bicycle]"),
        ("nprompt", "blurry, low quality")]
P = TINY_MODEL_TYPE_SD3.vae_p
SHIFT = np.float32(P.shift_factor) * np.float32(P.scale_factor)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def sd3_ckpt(tmp_path, monkeypatch):
    path = tmp_path / "tiny-sd3.safetensors"
    write_checkpoint_sd3(path, seed=5)
    monkeypatch.setenv("MLIS_TINY_MODELS", "1")
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd3": TINY_MODEL_TYPE_SD3})
    return str(path)


def _image(seed=6):
    return np.random.default_rng(seed).uniform(
        0, 1, (1, 3, 64, 64)).astype(np.float32)


def _sessions(ckpt):
    out = []
    for s in (JaxSession(), torch_api.MLImgSynth(device="cpu")):
        s.option_set("model", ckpt)
        for k, v in OPTS:
            s.option_set(k, v)
        if isinstance(s, JaxSession):
            s._dtype = jnp.float32
        out.append(s)
    return out


def test_sd3_encoded_latent_and_the_jax_session_shift(sd3_ckpt):
    """The port's initial latent equals the JAX package's
    ``latent_sample(moments, rand, VAE_SD3)`` on the JAX encoder's moments
    and the seed's Philox draw; the JAX session's ``_vae_encode`` gives
    that plus ``shift_factor * scale_factor`` in every element."""
    js, ts = _sessions(sd3_ckpt)
    img = _image()
    got = ts.image_encode(img)
    jax_session = np.asarray(js.image_encode(img))
    assert ts.rng.offset == js.rng.offset > 0
    JP = js._mt.vae_p
    assert (JP.shift_factor, JP.scale_factor) == (P.shift_factor,
                                                  P.scale_factor)
    mom = np.asarray(jax.jit(lambda p, x: jvae.vae_encode_apply(
        JB.Ctx(p, dtype=jnp.float32), x, JP))(
        js._get_params("vae"), img.transpose(0, 2, 3, 1) * 2.0 - 1.0))
    rand = JaxRng(42, 0).randn_shaped((JP.ch_z, 8, 8)).astype(np.float32)
    want = np.asarray(jvae.latent_sample(
        jnp.asarray(mom), jnp.asarray(rand.transpose(1, 2, 0)[None]), JP)
    ).transpose(0, 3, 1, 2)
    assert got.shape == (1, 4, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(jax_session - want, SHIFT, atol=1e-5, rtol=0)
    assert abs(float(SHIFT) - 0.0932) < 1e-4


def test_sd3_img2img_matches_jax(sd3_ckpt, monkeypatch):
    """A whole SD3 img2img request at ``f_t_ini`` 0.6 (3 of 5 steps; the
    flow branch scales the encoded latent by 1 - sigma_0 before the noise)
    against the JAX session whose encode subtracts the shift as
    ``latent_sample`` does."""
    js, ts = _sessions(sd3_ckpt)
    encode = js._vae_encode
    monkeypatch.setattr(js, "_vae_encode",
                        lambda *a, **kw: encode(*a, **kw) - SHIFT)
    res = []
    for s in (js, ts):
        traj = []
        s.option_set("image", _image())
        s.option_set("f-t-ini", 0.6)
        s.step_observer = lambda i, lat: traj.append(
            np.asarray(lat, np.float32).copy())
        res.append((traj, np.asarray(s.generate(), np.float32)))
    (traj_j, img_j), (traj_t, img_t) = res
    assert len(traj_j) == len(traj_t) == 3
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    mse = np.mean((np.round(img_j * 255) - np.round(img_t * 255)) ** 2)
    psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    assert psnr > 40.0, f"final image PSNR {psnr:.1f} dB <= 40"
    assert "Mode: img2img, f_t_ini: 0.6" in ts.infotext
