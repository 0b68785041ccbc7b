"""The port's sampling (mlimgsynth_torch.sampling) against the JAX
package's: the host plan bit for bit, the solver steps, CFG mixing and the
sigma-to-t map.  Inputs are seeded numpy, fed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.rng import RngPhilox
from mlimgsynth_tpu.sampling import sampler as jsam
from mlimgsynth_tpu.sampling import schedule as sch
from mlimgsynth_tpu.sampling import solvers as jsol
from mlimgsynth_torch.sampling import sampler as tsam
from mlimgsynth_torch.sampling import solvers as tsol

PLAN_FIELDS = ("sigmas", "s_hat", "churn_sigma", "s_down", "s_up", "t_next",
               "noise0", "churn_noise", "anc_noise")


# Every ported method; the ancestral ones (the ``_a`` suffix sets
# s_ancestral 1) and s_noise > 0 (churn) draw per step.  dpmpp2m_sde reads
# s_ancestral as its eta (0: the default 1) and s_noise as its noise
# multiplier: the eta 1 and 0.5 cases fail if the plan is not the SDE split.
PLAN_CASES = [
    ("euler", "uniform", 20, (1, 4, 8, 8), 0.0, 0.0),
    ("dpmpp2m", "karras", 5, (2, 4, 8, 6), 0.0, 0.0),
    ("euler", "exponential", 7, (1, 4, 4, 4), 1.0, 1.0),
    ("heun", "uniform", 9, (1, 4, 4, 4), 0.0, 0.0),
    ("heun", "karras", 8, (1, 4, 4, 4), 1.0, 0.0),
    ("taylor3", "uniform", 6, (1, 4, 4, 4), 1.0, 0.0),
    ("dpmpp2s", "karras", 8, (2, 4, 4, 4), 1.0, 0.0),
    ("dpmpp2s", "uniform", 7, (1, 4, 4, 4), 0.0, 1.5),
    ("unipc", "karras", 6, (1, 4, 4, 4), 0.0, 0.0),
    ("unipc", "uniform", 6, (1, 4, 4, 4), 1.0, 1.0),
    ("dpmpp2m", "uniform", 6, (1, 4, 4, 4), 0.0, 1.0),
    ("dpmpp2m_sde", "karras", 6, (1, 4, 4, 4), 0.0, 0.0),
    ("dpmpp2m_sde", "uniform", 6, (2, 4, 4, 4), 0.5, 0.0),
    ("dpmpp2m_sde", "karras", 6, (1, 4, 4, 4), 0.5, 1.5),
]


@pytest.mark.parametrize("method,sched,n_step,shape,anc,noise", PLAN_CASES)
def test_make_plan_bit_equal(method, sched, n_step, shape, anc, noise):
    cfg_kw = dict(method=method, sched=sched, n_step=n_step, s_noise=noise,
                  s_ancestral=anc)
    rj, rt = RngPhilox(42, 3), RngPhilox(42, 3)
    pj = jsam.make_plan(jsam.SamplerConfig(**cfg_kw), shape, rj, 2)
    pt = tsam.make_plan(tsam.SamplerConfig(**cfg_kw), shape, rt, 2)
    assert (pt.n_step, pt.nfe_per_step) == (pj.n_step, pj.nfe_per_step)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f),
                                      err_msg=f)
    assert rt.offset == rj.offset


def test_make_plan_seeds_per_sample():
    cfg = dict(method="euler", n_step=4)
    pj = jsam.make_plan(jsam.SamplerConfig(**cfg), (2, 4, 4, 4),
                        RngPhilox(0), seeds=[7, 9])
    pt = tsam.make_plan(tsam.SamplerConfig(**cfg), (2, 4, 4, 4),
                        RngPhilox(0), seeds=[7, 9])
    np.testing.assert_array_equal(pt.noise0, pj.noise0)
    with pytest.raises(ValueError):
        tsam.make_plan(tsam.SamplerConfig(**cfg), (2, 4, 4, 4),
                       RngPhilox(0), seeds=[7])


def _dxdt_pair(w):
    """The same linear toy denoiser derivative on both sides."""
    def dj(x, sigma):
        return x * jnp.float32(w) / sigma + jnp.float32(0.5)

    def dt(x, sigma):
        return x * np.float32(w) / sigma + np.float32(0.5)
    return dj, dt


def _state_to_port(state):
    """A JAX solver state as the port's: 0-d arrays as f32 numpy scalars,
    the others as tensors."""
    return {k: (np.float32(np.asarray(v)) if np.ndim(v) == 0
                else torch.from_numpy(np.array(v))) for k, v in state.items()}


def _assert_state_equal(statet, statej, msg):
    """The port's solver state against the JAX side's: the same keys, and
    each tensor and f32 scalar of the same dtype within atol/rtol 1e-6
    (infinities equal: dpmpp2m's h on the step to sigma 0)."""
    assert set(statet) == set(statej), msg
    for k, v in statej.items():
        got = statet[k]
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(v)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), \
            f"{msg} state {k}"
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6,
                                   err_msg=f"{msg} state {k}")


STEP_METHODS = ["euler", "heun", "taylor3", "dpmpp2m", "dpmpp2s",
                "dpmpp2m_sde", "unipc"]


# Whole trajectories along a real schedule (through the last step to sigma
# 0), each side carrying its own latent and state.  Both sides run the
# same f32 arithmetic, so the tolerance only covers the order XLA fuses it
# in: atol/rtol 1e-6, for the latent and the state after every step.
@pytest.mark.parametrize("method,sched", [
    ("euler", "uniform"), ("dpmpp2m", "karras"), ("heun", "uniform"),
    ("taylor3", "uniform"), ("dpmpp2s", "karras"),
    ("dpmpp2m_sde", "karras"), ("unipc", "karras")])
def test_solver_steps_match_jax(method, sched):
    sig = sch.make_schedule(6, sched, 1, 1, 1.0, 0.0).sigmas
    x0 = np.random.default_rng(0).standard_normal((1, 4, 5, 5)).astype(
        np.float32) * np.float32(sig[0])
    dj, dt = _dxdt_pair(0.3)
    sj, st = jsol.get_solver(method), tsol.get_solver(method)
    xj, xt = jnp.asarray(x0), torch.from_numpy(x0)
    statej, statet = sj.init_state(xj), st.init_state(xt)
    _assert_state_equal(statet, statej, "init")
    for i in range(len(sig) - 1):
        xj, statej = sj.step(dj, xj, statej, jnp.int32(i),
                             jnp.float32(sig[i]), jnp.float32(sig[i + 1]))
        xt, statet = st.step(dt, xt, statet, i, np.float32(sig[i]),
                             np.float32(sig[i + 1]))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6,
                                   rtol=1e-6, err_msg=f"step {i}")
        _assert_state_equal(statet, statej, f"step {i}")


# Steps along a real plan (through the last step to sigma 0), as the
# sampler loop takes them: churn before the step (t = s_hat), the step to
# s_down, the ancestral noise after it (t = t_next).  Each step starts both
# sides from the JAX side's latent and state, so every step is held to the
# tolerance on its own (atol/rtol 1e-6, as above): the latent and the
# state it returns.
@pytest.mark.parametrize("anc,noise", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)],
                         ids=["ode", "ancestral", "s_noise"])
@pytest.mark.parametrize("method", STEP_METHODS)
def test_solver_plan_steps_match_jax(method, anc, noise):
    sched = "karras" if method in ("dpmpp2m", "unipc") else "uniform"
    plan = jsam.make_plan(jsam.SamplerConfig(
        method=method, sched=sched, n_step=7, s_ancestral=anc,
        s_noise=noise), (1, 4, 5, 5), RngPhilox(3))
    x0 = plan.noise0 * np.float32(plan.sigmas[0])
    dj, dt = _dxdt_pair(0.3)
    sj, st = jsol.get_solver(method), tsol.get_solver(method)
    xj = jnp.asarray(x0)
    statej = sj.init_state(xj)
    t = np.float32(plan.sigmas[0])
    for i in range(plan.n_step):
        c = np.float32(plan.churn_sigma[i])
        if c > 0:
            xj = xj + jnp.asarray(plan.churn_noise[i]) * c
            t = np.float32(plan.s_hat[i])
        s_down = np.float32(plan.s_down[i])
        xt, statet = torch.from_numpy(np.array(xj)), _state_to_port(statej)
        xj, statej = sj.step(dj, xj, statej, jnp.int32(i), jnp.float32(t),
                             jnp.float32(s_down))
        xt, statet = st.step(dt, xt, statet, i, t, s_down)
        _assert_state_equal(statet, statej, f"step {i}")
        up = np.float32(plan.s_up[i])
        if up > 0:
            xj = xj + jnp.asarray(plan.anc_noise[i]) * up
            xt = xt + torch.from_numpy(plan.anc_noise[i]) * up
        t = np.float32(plan.t_next[i])
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6,
                                   rtol=1e-6, err_msg=f"step {i}")


def test_unipc_corrects_where_the_prediction_lands():
    """UniPC's corrector runs where a step starts at the previous step's
    target sigma (an f32 compare): on an ODE plan from the second step on,
    so the result differs from DPM++(2M)'s; the first step is the same."""
    sig = sch.make_schedule(5, "karras", 1, 1, 1.0, 0.0).sigmas
    x0 = np.random.default_rng(2).standard_normal((1, 4, 3, 3)).astype(
        np.float32) * np.float32(sig[0])
    _, dt = _dxdt_pair(0.3)
    xs = {}
    for m in ("dpmpp2m", "unipc"):
        sol = tsol.get_solver(m)
        x, state = torch.from_numpy(x0), sol.init_state(torch.from_numpy(x0))
        xs[m] = []
        for i in range(len(sig) - 1):
            x, state = sol.step(dt, x, state, i, np.float32(sig[i]),
                                np.float32(sig[i + 1]))
            xs[m].append(x.numpy())
    np.testing.assert_array_equal(xs["unipc"][0], xs["dpmpp2m"][0])
    assert not np.allclose(xs["unipc"][2], xs["dpmpp2m"][2], atol=1e-4)


def test_two_evaluation_solvers_skip_the_last():
    """heun and dpmpp2s evaluate the model twice a step, once on the last
    (to sigma 0): ``n_step * 2 - 1`` evaluations, as the JAX package
    counts its NFE."""
    sig = sch.make_schedule(8, "uniform", 2, 1, 1.0, 0.0).sigmas
    for m in ("heun", "dpmpp2s"):
        calls = []
        sol = tsol.get_solver(m)
        x = torch.ones(1, 4, 2, 2)
        state = sol.init_state(x)
        for i in range(len(sig) - 1):
            x, state = sol.step(lambda v, s: (calls.append(s), v)[1], x,
                                state, i, np.float32(sig[i]),
                                np.float32(sig[i + 1]))
        assert len(sig) - 1 == 4 and len(calls) == 7, (m, calls)


def test_unported_method_raises():
    """A method neither package has raises; the port's solver set (lcm
    included) is the JAX package's."""
    with pytest.raises(ValueError, match="not ported"):
        tsol.get_solver("ddim")
    assert tsol.METHOD_IDS == jsol.METHOD_IDS
    assert set(tsol.SOLVERS) == set(jsol.SOLVERS)


def test_cfg_mix_matches_jax():
    d = np.random.default_rng(1).standard_normal((4, 4, 3, 3)).astype(
        np.float32)
    want = jsam._cfg_mix(jnp.asarray(d), 2, 7.5, 0.0)
    got = tsam._cfg_mix(torch.from_numpy(d), 2, 7.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("sigma", [0.0292, 0.5, 1.0, 3.7, 14.6146])
def test_sigma_to_t_matches_jax(sigma):
    ls = np.asarray(sch.get_log_sigmas(), np.float32)
    want = float(jsam.jnp_sigma_to_t(jnp.asarray(ls), jnp.float32(sigma)))
    got = float(tsam.sigma_to_t(ls, sigma))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-4)
