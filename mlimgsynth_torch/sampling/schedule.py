"""Noise schedules: sigma tables, t<->sigma interpolation, step schedules.

Reference: src/unet.c:283-334 (beta-linear log-sigma table and interpolation)
and src/sampling.c:28-96 (uniform / Karras step schedules, NFE bookkeeping).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

N_STEP_TRAIN = 1000


def log_sigmas_sd(n: int = N_STEP_TRAIN, linear_start: float = 0.00085,
                  linear_end: float = 0.0120) -> np.ndarray:
    """Beta-linear noise schedule log-sigma table (src/unet.c:283-303)."""
    b = math.sqrt(linear_start)
    e = math.sqrt(linear_end)
    f = (e - b) / (n - 1)
    betas = b + f * np.arange(n, dtype=np.float64)
    alphas = 1.0 - betas * betas
    acp = np.cumprod(alphas)
    sigmas = np.sqrt((1 - acp) / acp)
    return np.log(sigmas).astype(np.float32)


def log_sigmas_flow(shift: float = 3.0, n: int = N_STEP_TRAIN) -> np.ndarray:
    """Rectified-flow (SD3) log-sigma table with the resolution shift.

    Table index t maps to u = (t+1)/n so index n-1 is sigma == 1.0 (pure
    noise) and index 0 is sigma == shift/(n + shift - 1) — the same grid the
    flow-matching schedulers use (timesteps 1..n with sigma = t/n, shifted
    sigma' = shift*sigma / (1 + (shift-1)*sigma)).  The flow model timestep
    is sigma * n (see sampler._make_body), NOT the table index."""
    u = (np.arange(n, dtype=np.float64) + 1.0) / n
    s = shift * u / (1.0 + (shift - 1.0) * u)
    return np.log(s).astype(np.float32)


_LOG_SIGMAS = None


def get_log_sigmas() -> np.ndarray:
    global _LOG_SIGMAS
    if _LOG_SIGMAS is None:
        _LOG_SIGMAS = log_sigmas_sd()
    return _LOG_SIGMAS


def t_to_sigma(t, log_sigmas: Optional[np.ndarray] = None):
    """Continuous t index -> sigma via linear interp (src/unet.c:305-334)."""
    ls = get_log_sigmas() if log_sigmas is None else log_sigmas
    n = len(ls)
    t = np.asarray(t, dtype=np.float32)
    ti = np.clip(t.astype(np.int32), 0, n - 1)
    v1 = ls[ti]
    v2 = ls[np.minimum(ti + 1, n - 1)]
    out = np.exp(v1 * (ti + 1 - t) + v2 * (t - ti))
    return out.astype(np.float32)


def sigma_to_t(sigma, log_sigmas: Optional[np.ndarray] = None):
    """Sigma -> continuous t index (bisect + linear est, src/unet.c:315-328)."""
    ls = get_log_sigmas() if log_sigmas is None else log_sigmas
    n = len(ls)
    lsig = np.log(np.asarray(sigma, dtype=np.float32))
    # index of first entry > lsig  (table is ascending)
    idx = np.searchsorted(ls, lsig, side="right") - 1
    idx = np.clip(idx, 0, n - 2)
    v1, v2 = ls[idx], ls[idx + 1]
    t = idx + (lsig - v1) / (v2 - v1)
    return np.clip(t, 0.0, n - 1).astype(np.float32)


SCHED_UNIFORM = "uniform"
SCHED_KARRAS = "karras"
SCHED_LCM = "lcm"
# beyond-reference grids (the k-diffusion / A1111 scheduler set)
SCHED_EXPONENTIAL = "exponential"
SCHED_SGM_UNIFORM = "sgm_uniform"
SCHED_BETA = "beta"


@dataclass
class StepSchedule:
    sigmas: np.ndarray          # [n_step+1], sigmas[-1] == 0
    n_step: int
    nfe_per_step: int


def make_schedule(n_step: int, sched: str = SCHED_UNIFORM,
                  solver_n_fe: int = 1, nfe_per_dxdt: int = 1,
                  f_t_ini: float = 1.0, f_t_end: float = 0.0,
                  n_step_train: int = N_STEP_TRAIN,
                  log_sigmas: Optional[np.ndarray] = None) -> StepSchedule:
    """Compute the inference sigma sequence (src/sampling.c:40-91)."""
    if n_step < 1:
        n_step = 20
    nfe_per_step = solver_n_fe
    if nfe_per_step > 1:
        n_step = (n_step + nfe_per_step - 1) // nfe_per_step
    nfe_per_step *= nfe_per_dxdt
    if not (f_t_ini > 0):
        f_t_ini = 1.0
    n_step = int(n_step * (f_t_ini - f_t_end) + 0.5)
    if n_step < 1:
        n_step = 1

    ls = get_log_sigmas() if log_sigmas is None else log_sigmas
    t_ini = (n_step_train - 1) * f_t_ini
    t_end = (n_step_train - 1) * f_t_end

    sigmas = np.zeros(n_step + 1, dtype=np.float32)
    if sched in (None, "", SCHED_UNIFORM):
        f = (t_end - t_ini) / (n_step - 1) if n_step > 1 else 0.0
        ts = np.float32(t_ini) + np.arange(n_step, dtype=np.float32) * np.float32(f)
        sigmas[:n_step] = t_to_sigma(ts, ls)
    elif sched == SCHED_KARRAS:
        smin = float(t_to_sigma(np.float32(t_end), ls))
        smax = float(t_to_sigma(np.float32(t_ini), ls))
        p = 7.0
        sminp = smin ** (1 / p)
        smaxp = smax ** (1 / p)
        f = (sminp - smaxp) / (n_step - 1) if n_step > 1 else 0.0
        sigmas[:n_step] = (smaxp + np.arange(n_step, dtype=np.float64) * f) ** p
    elif sched == SCHED_EXPONENTIAL:
        # k-diffusion get_sigmas_exponential: log-uniform in sigma
        smin = float(t_to_sigma(np.float32(t_end), ls))
        smax = float(t_to_sigma(np.float32(t_ini), ls))
        f = (math.log(smin) - math.log(smax)) / (n_step - 1) \
            if n_step > 1 else 0.0
        sigmas[:n_step] = np.exp(
            math.log(smax) + np.arange(n_step, dtype=np.float64) * f)
    elif sched == SCHED_SGM_UNIFORM:
        # sgm / A1111 "sgm uniform": n+1 uniform t points, the last (the
        # sigma(t_end) endpoint) dropped before the final jump to 0
        f = (t_end - t_ini) / n_step
        ts = np.float32(t_ini) + np.arange(n_step, dtype=np.float32) \
            * np.float32(f)
        sigmas[:n_step] = t_to_sigma(ts, ls)
    elif sched == SCHED_BETA:
        # A1111 "beta" grid ("Beta Sampling is All You Need", alpha =
        # beta = 0.6): sigma = smin + ppf(1-u)*(smax-smin) on a uniform
        # u grid including both endpoints
        try:
            from scipy.stats import beta as beta_dist
        except ImportError as e:
            # surface as a clean option error, not a raw ImportError
            # mid-generate (library convention: E_OPT_VALUE)
            from ..api import MlisError
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "the 'beta' schedule needs scipy (scipy.stats.beta), "
                "which is not installed") from e
        smin = float(t_to_sigma(np.float32(t_end), ls))
        smax = float(t_to_sigma(np.float32(t_ini), ls))
        u = (1.0 - np.linspace(0.0, 1.0, n_step)) if n_step > 1 \
            else np.ones(1)
        ppf = beta_dist.ppf(u, 0.6, 0.6)
        sigmas[:n_step] = smin + ppf * (smax - smin)
    elif sched == SCHED_LCM:
        # Latent-consistency timestep grid (diffusers LCMScheduler
        # set_timesteps): subsample the distillation's origin grid
        # (original_inference_steps = 50 over the n_step_train training
        # steps), highest noise first.  ``f_t_ini`` (img2img strength)
        # truncates the grid's high-noise end like the diffusers img2img
        # pipelines; ``f_t_end`` only scales the step count (above).
        origin = 50
        skipping = max(1, n_step_train // origin)
        origin_eff = max(1, int(origin * min(f_t_ini, 1.0) + 0.5))
        n_step = min(n_step, origin_eff)
        grid = (np.arange(1, origin_eff + 1) * skipping - 1)[::-1]
        idx = np.floor(np.arange(n_step) * origin_eff / n_step).astype(int)
        sigmas = np.zeros(n_step + 1, dtype=np.float32)
        sigmas[:n_step] = t_to_sigma(grid[idx].astype(np.float32), ls)
    else:
        raise ValueError(f"invalid sampling scheduler '{sched}'")
    return StepSchedule(sigmas=sigmas, n_step=n_step, nfe_per_step=nfe_per_step)


@dataclass
class StepNoise:
    """Per-step noise plan with the reference's exact draw semantics
    (src/sampling.c:119-178)."""
    s_hat: np.ndarray      # [n_step] effective sigma after churn (== sigma if none)
    churn_sigma: np.ndarray  # [n_step] extra noise std added before the step
    s_down: np.ndarray     # [n_step] sigma passed to the solver step
    s_up: np.ndarray       # [n_step] ancestral noise std added after the step
    t_next: np.ndarray     # [n_step] solver t after post-step noise


def plan_step_noise(sigmas: np.ndarray, s_ancestral: float = 0.0,
                    s_noise: float = 0.0, sde_eta: float = 0.0,
                    lcm: bool = False) -> StepNoise:
    """``sde_eta > 0`` selects the exponential-decay noise split of the SDE
    samplers (sigma_down = s2*(s2/s1)^eta, sigma_up = s2*sqrt(1-(s2/s1)^2eta)
    — k-diffusion sample_dpmpp_2m_sde) instead of the ancestral split; with
    it, ``s_noise`` multiplies the SDE noise (k-diffusion's s_noise) rather
    than adding churn.  ``lcm`` selects the latent-consistency plan: every
    step fully denoises (the solver slot is unused) then re-noises to the
    next sigma through the ancestral slot — s_up = sigma_next, no churn."""
    if lcm:
        n_step = len(sigmas) - 1
        z = np.zeros(n_step, dtype=np.float32)
        return StepNoise(s_hat=sigmas[:n_step].copy(), churn_sigma=z,
                         s_down=z.copy(), s_up=sigmas[1:].copy(),
                         t_next=sigmas[1:].copy())
    n_step = len(sigmas) - 1
    s_hat = sigmas[:n_step].copy()
    churn = np.zeros(n_step, dtype=np.float32)
    s_up = np.zeros(n_step, dtype=np.float32)
    s_down = sigmas[1:].copy()
    t_next = sigmas[1:].copy()
    for s in range(n_step):
        if sde_eta > 0:
            s1, s2 = float(sigmas[s]), float(sigmas[s + 1])
            if s1 > 0 and s2 > 0:
                decay = (s2 / s1) ** sde_eta
                s_down[s] = s2 * decay
                s_up[s] = (s2 * math.sqrt(max(1.0 - decay * decay, 0.0))
                           * (s_noise if s_noise > 0 else 1.0))
        else:
            if s_noise > 0 and s > 0:
                s_curr = sigmas[s]
                sh = s_curr * math.sqrt(2) * s_noise
                churn[s] = math.sqrt(sh * sh - s_curr * s_curr)
                s_hat[s] = sh
            if s_ancestral > 0:
                s1, s2 = float(sigmas[s]), float(sigmas[s + 1])
                up = math.sqrt((s2 * s2) * (s1 * s1 - s2 * s2) / (s1 * s1)) \
                    if s1 > 0 else 0.0
                up *= s_ancestral
                up = min(up, s2)
                s_up[s] = up
                s_down[s] = math.sqrt(s2 * s2 - up * up)
        if s_up[s] > 0 and s + 1 != n_step:
            t_next[s] = sigmas[s + 1]
        else:
            s_up[s] = s_up[s] if s + 1 != n_step else 0.0
            t_next[s] = s_down[s]
    return StepNoise(s_hat=s_hat, churn_sigma=churn, s_down=s_down,
                     s_up=s_up, t_next=t_next)
