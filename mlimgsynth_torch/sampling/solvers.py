"""k-diffusion ODE solvers (port of ``mlimgsynth_tpu/sampling/solvers.py``).

Each solver advances ``x`` from sigma ``t_cur`` to ``t_next`` given
``dxdt(x, sigma)``, the CFG-combined denoiser derivative.  Step scalars are
numpy float32, as the JAX package computes them in f32; its branchy
``jnp.where`` / ``lax.cond`` forms become host branches on those scalars
and on the Python step index, so a skipped model evaluation is not run.
Every method of the JAX package is ported.  lcm's step lives in the
sampler's loop (it needs the sigma -> timestep table, which a solver does
not see); its entry here is the JAX package's placeholder, never called.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

f32 = np.float32


@dataclass(frozen=True)
class SolverClass:
    name: str
    n_fe: int
    init_state: Callable  # (x) -> dict
    step: Callable        # (dxdt, x, state, i_step, t_cur, t_next) -> (x, state)


def _euler_init(x):
    return {}


def _euler_step(dxdt, x, state, i_step, t_cur, t_next):
    dt = f32(t_next) - f32(t_cur)
    return x + dxdt(x, t_cur) * dt, state


def _heun_step(dxdt, x, state, i_step, t_cur, t_next):
    """Karras Algorithm 1; the last step (to sigma 0) is Euler's."""
    t_cur, t_next = f32(t_cur), f32(t_next)
    dt = t_next - t_cur
    dx = dxdt(x, t_cur)
    x1 = x + dx * dt
    if not t_next > 0:
        return x1, state
    d1 = dxdt(x1, t_next)
    return x + (dx + d1) * (f32(0.5) * dt), state


def _taylor3_init(x):
    return {"dt_prev": f32(0.0), "dp1": torch.zeros_like(x),
            "dp2": torch.zeros_like(x)}


def _taylor3_step(dxdt, x, state, i_step, t_cur, t_next):
    dt = f32(t_next) - f32(t_cur)
    dx = dxdt(x, t_cur)
    x = x + dx * dt
    idtp = f32(1.0) / state["dt_prev"] if i_step >= 1 else f32(0.0)
    f2 = dt * dt / f32(2) if i_step >= 1 else f32(0.0)
    f3 = dt * dt * dt / f32(6) if i_step >= 2 else f32(0.0)
    d2 = (dx - state["dp1"]) * idtp
    d3 = (d2 - state["dp2"]) * idtp
    x = x + d2 * f2 + d3 * f3
    return x, {"dt_prev": dt, "dp1": dx, "dp2": d2}


def _dpmpp2m_init(x):
    return {"h_last": f32(0.0), "dprev": torch.zeros_like(x)}


def _dpmpp2m_step(dxdt, x, state, i_step, t_cur, t_next):
    t_cur, t_next = f32(t_cur), f32(t_next)
    a = t_next / t_cur
    with np.errstate(divide="ignore"):
        h = -np.log(a)          # inf on the final step to sigma 0
    c = (f32(0.0) if i_step == 0 or not t_next > 0
         else h / (2 * state["h_last"]))
    d0 = x - t_cur * dxdt(x, t_cur)
    d = (1 + c) * d0 - c * state["dprev"]
    return a * x + (1 - a) * d, {"h_last": h, "dprev": d0}


def _dpmpp2s_step(dxdt, x, state, i_step, t_cur, t_next):
    """DPM++(2S): a second evaluation at the geometric midpoint; the last
    step (to sigma 0) is Euler's."""
    t_cur, t_next = f32(t_cur), f32(t_next)
    dx = dxdt(x, t_cur)
    if not t_next > 0:
        return x + dx * (t_next - t_cur), state
    t1 = np.sqrt(t_next * t_cur)
    a = t_next / t_cur
    x1 = x + dx * (t1 - t_cur)
    d = x1 - t1 * dxdt(x1, t1)
    return a * x + (1 - a) * d, state


def _unipc_init(x):
    z = torch.zeros_like(x)
    s = f32(0.0)
    return {"m_prev": z, "m_prev2": z, "last_x": z, "x_pred": z,
            "h_prev": s, "h_prev2": s, "t_pred": s}


def _unipc_step(dxdt, x, state, i_step, t_cur, t_next):
    """UniPC order 2, bh2, data prediction (the JAX package's derivation,
    ``mlimgsynth_tpu/sampling/solvers.py:158-189``): the bh2 corrector of
    the arrival point in delta form, applied only where this step starts
    at the previous prediction's target sigma (an f32 compare), then the
    order-2 predictor, which is the DPM++(2M) update."""
    t_cur, t_next = f32(t_cur), f32(t_next)
    m_t = x - t_cur * dxdt(x, t_cur)
    hp = state["h_prev"] if state["h_prev"] > 0 else f32(1.0)
    x_use = x
    if i_step >= 1 and t_cur == state["t_pred"]:
        a_c = np.exp(-hp)
        b_h = a_c - f32(1.0)                 # expm1(-h_p): bh2's B(h)
        hh = -hp
        k1 = b_h / hh - f32(1.0)
        b1 = k1 / b_h
        b2 = (k1 / hh - f32(0.5)) * f32(2.0) / b_h
        d1_t = m_t - state["m_prev"]
        if i_step >= 2:
            r0 = -state["h_prev2"] / hp
            den = f32(1.0) - r0
            rho0, rho1 = (b1 - b2) / den, (b2 - r0 * b1) / den
            d1_p = (state["m_prev2"] - state["m_prev"]) / r0
            corr = rho0 * d1_p + rho1 * d1_t
        else:
            corr = f32(0.5) * d1_t
        x_c = a_c * state["last_x"] + (1 - a_c) * state["m_prev"]
        x_use = x + ((x_c - b_h * corr) - state["x_pred"])
    a = t_next / t_cur
    with np.errstate(divide="ignore"):
        h = -np.log(a)
    c = (f32(0.0) if i_step == 0 or not t_next > 0 else h / (2 * hp))
    d = (1 + c) * m_t - c * state["m_prev"]
    x_new = a * x_use + (1 - a) * d
    return x_new, {"m_prev": m_t, "m_prev2": state["m_prev"],
                   "last_x": x_use, "x_pred": x_new, "h_prev": h,
                   "h_prev2": state["h_prev"], "t_pred": t_next}


EULER = SolverClass("euler", 1, _euler_init, _euler_step)
HEUN = SolverClass("heun", 2, _euler_init, _heun_step)
TAYLOR3 = SolverClass("taylor3", 1, _taylor3_init, _taylor3_step)
DPMPP2M = SolverClass("dpmpp2m", 1, _dpmpp2m_init, _dpmpp2m_step)
DPMPP2S = SolverClass("dpmpp2s", 2, _euler_init, _dpmpp2s_step)
# DPM++(2M) SDE: the dpmpp2m step taken to sigma_down, with the SDE noise
# in the sampler's ancestral slot (the plan's sde split; see the JAX
# package's note at ``solvers.py:125-139``)
DPMPP2M_SDE = SolverClass("dpmpp2m_sde", 1, _dpmpp2m_init, _dpmpp2m_step)
UNIPC = SolverClass("unipc", 1, _unipc_init, _unipc_step)
# latent-consistency sampling: one evaluation a step, taken by the sampler's
# loop (``sampler.run_sampler``; ``mlimgsynth_tpu/sampling/solvers.py:
# 145-154``)
LCM = SolverClass("lcm", 1, _euler_init, _euler_step)

SOLVERS: Dict[str, SolverClass] = {
    s.name: s for s in (EULER, HEUN, TAYLOR3, DPMPP2M, DPMPP2S, DPMPP2M_SDE,
                        LCM, UNIPC)}

# Method ids matching MLIS_Method (the JAX package's ``METHOD_IDS``)
METHOD_IDS = {1: "euler", 2: "heun", 3: "taylor3", 4: "dpmpp2m",
              5: "dpmpp2s", 6: "dpmpp2m_sde", 7: "lcm", 8: "unipc"}


def get_solver(method: str) -> SolverClass:
    cls = SOLVERS.get(method)
    if cls is None:
        raise ValueError(f"sampling method {method!r} is not ported "
                         f"(have: {', '.join(SOLVERS)})")
    return cls
