"""The lcm method and seed variations in the port against the JAX package:
the lcm schedule and noise plan (the method implies the lcm grid under the
uniform scheduler), the subseed slerp of the initial noise (numpy on the
host, so bit for bit), the loop's consistency step, and the sessions'
``method lcm`` and ``subseed`` / ``subseed_strength`` with their infotext.

Plans and noise bit for bit; sessions on the tiny SD1 checkpoint of
``test_torch_guidance``: every step's latent at atol/rtol 1e-4 and the
final image at PSNR > 40 dB.
"""
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.rng import RngPhilox as JRng
from mlimgsynth_tpu.sampling import sampler as jsam
from mlimgsynth_torch import api as tapi
from mlimgsynth_torch.rng import RngPhilox as TRng
from mlimgsynth_torch.sampling import sampler as tsam

from test_torch_guidance import (OPTS, _tail, assert_sessions_match,  # noqa
                                 run_session, tiny, tiny_path)

PLAN_FIELDS = ("sigmas", "s_hat", "churn_sigma", "s_down", "s_up", "t_next",
               "noise0", "churn_noise", "anc_noise")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(shape, seed, **kw):
    """The JAX package's and the port's plans of one config, and each
    session stream's offset after it."""
    extra = {k: kw.pop(k) for k in ("subseeds", "subseed_strength",
                                    "nfe_per_dxdt") if k in kw}
    jr, tr = JRng(seed), TRng(seed)
    jp = jsam.make_plan(jsam.SamplerConfig(**kw), shape, jr, **extra)
    tp = tsam.make_plan(tsam.SamplerConfig(**kw), shape, tr, **extra)
    return jp, tp, (jr.offset, tr.offset)


@pytest.mark.parametrize("kw", [
    dict(method="lcm", n_step=4, cfg_scale=1.0),
    dict(method="lcm", n_step=8, f_t_ini=0.6),
    dict(method="lcm", n_step=60),
    dict(method="lcm", sched="karras", n_step=5),
    dict(method="lcm", sched="lcm", n_step=6, f_t_end=0.3),
], ids=["4", "img2img", "clamped", "karras", "lcm_sched"])
def test_lcm_plan_matches_jax(kw):
    """The plan, its noise and plan_n_step, bit for bit; the lcm table:
    no churn, a full re-noise to the next sigma, the solver slot unused."""
    jp, tp, (jo, to) = _plans((2, 4, 8, 8), 11, **kw)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    assert tp.n_step == jp.n_step and jo == to
    cfg = dict(kw)
    assert tsam.plan_n_step(tsam.SamplerConfig(**cfg)) \
        == jsam.plan_n_step(jsam.SamplerConfig(**cfg)) == tp.n_step
    assert np.all(tp.churn_sigma == 0) and np.all(tp.s_down == 0)
    np.testing.assert_array_equal(tp.s_up, tp.sigmas[1:])


@pytest.mark.parametrize("strength,sub,batch", [
    (0.3, [7], 1), (0.3, [5, 6], 2), (1.0, [9], 1),
    (0.05, [2 ** 31 + 4, 2 ** 31 + 5], 2)])
def test_subseed_noise_matches_jax(strength, sub, batch):
    """The slerped initial noise bit for bit (numpy on both sides); the
    per-step draws stay on the seed streams."""
    kw = dict(method="euler", s_ancestral=1.0, n_step=4,
              subseeds=sub, subseed_strength=strength)
    jp, tp, (jo, to) = _plans((batch, 4, 8, 8), 4, **kw)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    assert jo == to
    plain, _, _ = _plans((batch, 4, 8, 8), 4, method="euler",
                         s_ancestral=1.0, n_step=4)
    assert not np.array_equal(tp.noise0, plain.noise0)
    np.testing.assert_array_equal(tp.anc_noise, plain.anc_noise)


def test_noise_slerp_matches_jax():
    """Both branches of the slerp: nearly parallel noise (|cos| > 0.9995)
    is lerped, the rest slerped."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    b = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    b[1] = a[1] * np.float32(1.5)
    for t in (0.0, 0.25, 0.8):
        np.testing.assert_array_equal(tsam._noise_slerp(a, b, t),
                                      jsam._noise_slerp(a, b, t))


def test_lcm_session_matches_jax(tiny):
    """``method lcm`` on the tiny SD1 at 4 steps: the lcm grid and the
    loop's consistency step; the infotext's schedule is lcm."""
    js, ts = assert_sessions_match([("model", tiny)] + OPTS
                                   + [("method", "lcm")])
    assert "Sampler: lcm, Schedule type: lcm" in ts.infotext
    assert _tail(ts.infotext) == _tail(js.infotext)


@pytest.mark.parametrize("extra,text", [
    ([("subseed", 7), ("subseed-strength", 0.3)],
     "Seed: 21, Variation seed: 7, Variation seed strength: 0.3"),
    ([("subseed-strength", 0.5), ("batch-size", 2)],
     f"Seed: 21, Variation seed: {21 + 2 ** 31}, Variation seed strength: "
     "0.5")], ids=["subseed", "default_batch"])
def test_subseed_session_matches_jax(tiny, extra, text):
    """Seed variations: the given subseed, or by default seed + 2^31 (row i
    takes sub0 + i)."""
    js, ts = assert_sessions_match([("model", tiny)] + OPTS + extra)
    assert text in ts.infotext and text in js.infotext
    assert ts.c["subseed"] == js.c["subseed"]
