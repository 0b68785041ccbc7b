"""Denoising loop (port of ``mlimgsynth_tpu/sampling/sampler.py``).

The schedule and all noise are computed on the host exactly as the JAX
package does (``make_plan``, the reference's Philox draw order); a Python
loop replaces ``lax.scan`` and runs CFG as one batched model call per step
(cond rows then uncond rows).  Latents at this module's boundary are NCHW
numpy float32, as in the JAX package.

Rectified-flow models (the MMDiT and Flux, ``flow_shift`` set) take the JAX
package's flow branch: the schedule on ``log_sigmas_flow(shift)``, the model
timestep ``sigma * n_step_train``, the velocity output used as dx/dsigma,
and the initial latent scaled by ``1 - sigma_0`` before the noise is added
(``mlimgsynth_tpu/sampling/sampler.py:118``, ``:162-166``, ``:318-335``,
``:622-625``).

Skip-layer guidance (the DiT families): on the steps of the window
``[round(slg_start n), max(round(slg_end n), i0 + 1))`` each evaluation
adds one conditional-only evaluation with the ``slg_layers`` blocks left
out and steers away from it, ``out + slg_scale (d_cond - d_skip)``
(``mlimgsynth_tpu/sampling/sampler.py:356-372``, ``:955-982``).

img2img starts from an encoded latent over a schedule cut by ``f_t_ini``;
inpainting also holds the kept region to that latent: a latent mask
(1 = KEEP) is applied after the initial noise, after a churn draw and after
every step (``_mask_apply``, JAX ``sampler.py:484-500``, ``:620-628``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..errors import MlisError
from ..models import flux as flux_mod
from ..models import mmdit as mmdit_mod
from ..models import unet as unet_mod
from ..rng import RngPhilox
from . import schedule as sch
from .solvers import get_solver


@dataclass
class SamplerConfig:
    """Mirrors the reference's DenoiseSampler config (src/sampling.h)."""
    method: str = "euler"
    sched: str = "uniform"
    n_step: int = 20
    cfg_scale: float = 7.0
    s_ancestral: float = 0.0
    s_noise: float = 0.0
    f_t_ini: float = 1.0
    f_t_end: float = 0.0
    # rectified-flow resolution shift (0: the SD beta-linear schedule)
    flow_shift: float = 0.0
    # skip-layer guidance (DiT families): one extra conditional evaluation
    # with ``slg_layers`` blocks left out on the steps in the [slg_start,
    # slg_end) fraction of the schedule; 0 is off
    slg_scale: float = 0.0
    slg_layers: tuple = (7, 8, 9)
    slg_start: float = 0.01
    slg_end: float = 0.2


@dataclass
class SamplingPlan:
    """Host-computed schedule + noise (NCHW)."""
    sigmas: np.ndarray
    n_step: int
    nfe_per_step: int
    s_hat: np.ndarray
    churn_sigma: np.ndarray
    s_down: np.ndarray
    s_up: np.ndarray
    t_next: np.ndarray
    noise0: np.ndarray
    churn_noise: np.ndarray
    anc_noise: np.ndarray


def _schedule(cfg: SamplerConfig, nfe_per_dxdt: int):
    ls = sch.log_sigmas_flow(cfg.flow_shift) if cfg.flow_shift else None
    return sch.make_schedule(cfg.n_step, cfg.sched,
                             get_solver(cfg.method).n_fe, nfe_per_dxdt,
                             cfg.f_t_ini, cfg.f_t_end, log_sigmas=ls)


def plan_n_step(cfg: SamplerConfig, nfe_per_dxdt: int = 1) -> int:
    """The loop's step count that ``make_plan`` will give (the schedule's
    length after the NFE division and the ``f_t`` cuts), wanted before the
    encode when prompt editing maps text segments onto steps
    (``mlimgsynth_tpu/sampling/sampler.py:110-121``, without its lcm and
    keep-tail branches, which this port has not)."""
    return _schedule(cfg, nfe_per_dxdt).n_step


def make_plan(cfg: SamplerConfig, latent_shape, rng: RngPhilox,
              nfe_per_dxdt: int = 1, seeds=None) -> SamplingPlan:
    """Sigma schedule and all noise, drawn in the reference's order
    (initial, then per step: churn draw, post-step ancestral draw).
    ``latent_shape`` is NCHW; batch sample i draws from its own stream
    seeded ``seed + i`` (or ``seeds[i]``).  The schedule's step count is
    that of ``n_step`` model evaluations: a 2-evaluation solver (heun,
    dpmpp2s) takes half as many steps.  The SDE methods read
    ``s_ancestral`` as their eta (default 1) and ``s_noise`` as the noise
    multiplier (``mlimgsynth_tpu/sampling/sampler.py:168-173``).  The JAX
    package's lcm, keep-tail and subseed branches are not ported."""
    solver = get_solver(cfg.method)
    s = _schedule(cfg, nfe_per_dxdt)
    sde_eta = 0.0
    if solver.name.endswith("_sde"):
        sde_eta = cfg.s_ancestral if cfg.s_ancestral > 0 else 1.0
    plan = sch.plan_step_noise(s.sigmas, cfg.s_ancestral, cfg.s_noise,
                               sde_eta, lcm=False)
    n_step = s.n_step
    n_batch = latent_shape[0]
    sample_shape = tuple(latent_shape[1:])
    if seeds is None:
        seeds = [rng.seed + i for i in range(n_batch)]
    if len(seeds) != n_batch:
        raise ValueError(f"{len(seeds)} seeds for a batch of {n_batch}")
    streams = [RngPhilox(sd, rng.offset) for sd in seeds]

    def draw():
        out = np.stack([st.randn_shaped(sample_shape) for st in streams])
        return out.astype(np.float32)

    noise0 = draw()
    churn = np.zeros((n_step,) + tuple(latent_shape), np.float32)
    anc = np.zeros_like(churn)
    for i in range(n_step):
        if plan.churn_sigma[i] > 0:
            churn[i] = draw()
        if plan.s_up[i] > 0:
            anc[i] = draw()
    rng.offset = streams[0].offset  # keep the session stream stateful
    return SamplingPlan(
        sigmas=s.sigmas, n_step=n_step, nfe_per_step=s.nfe_per_step,
        s_hat=plan.s_hat, churn_sigma=plan.churn_sigma, s_down=plan.s_down,
        s_up=plan.s_up, t_next=plan.t_next, noise0=noise0,
        churn_noise=churn, anc_noise=anc)


def sigma_to_t(log_sigmas: np.ndarray, sigma) -> np.float32:
    """sigma -> continuous train step, in f32 (``jnp_sigma_to_t``)."""
    ls = np.log(np.float32(sigma))
    n = log_sigmas.shape[0]
    idx = int(np.clip(np.searchsorted(log_sigmas, ls, side="right") - 1,
                      0, n - 2))
    v1, v2 = log_sigmas[idx], log_sigmas[idx + 1]
    t = np.float32(idx) + (ls - v1) / (v2 - v1)
    return np.clip(t, np.float32(0.0), np.float32(n - 1))


def _cfg_mix(d, n: int, cfg_scale: float):
    """CFG mixing of a stacked [cond; uncond] model output."""
    cfg_scale = np.float32(cfg_scale)
    return d[:n] * cfg_scale + d[n:] * (1 - cfg_scale)


def slg_plan(cfg: SamplerConfig, unet_p, n_step: int):
    """(scale, layers, i0, i1) of skip-layer guidance over a loop of
    ``n_step`` steps, or None when ``slg_scale`` is 0; ``MlisError``
    (``E_OPT_VALUE``) for a model that is not a DiT, layers out of range
    for its depth, or an empty window (``sampler.py:960-982``)."""
    if cfg.slg_scale <= 0:
        return None
    if not getattr(unet_p, "flow", False):
        raise MlisError(
            MlisError.E_OPT_VALUE,
            "skip-layer guidance requires a DiT model (SD3/SD3.5/Flux)")
    depth = (getattr(unet_p, "depth", 0)
             or getattr(unet_p, "depth_double", 0)
             + getattr(unet_p, "depth_single", 0))
    layers = tuple(sorted(int(v) for v in cfg.slg_layers))
    if not layers or min(layers) < 0 or max(layers) >= depth:
        raise MlisError(MlisError.E_OPT_VALUE,
                        f"slg layers out of range for depth {depth}: "
                        f"{layers}")
    if cfg.slg_end <= cfg.slg_start:
        raise MlisError(MlisError.E_OPT_VALUE,
                        "slg window is empty (slg_end <= slg_start)")
    i0 = int(round(cfg.slg_start * n_step))
    i1 = max(int(round(cfg.slg_end * n_step)), i0 + 1)
    return float(cfg.slg_scale), layers, i0, i1


def _mask_apply(x, x0, lmask):
    """Inpainting mask re-application (src/sampling.c:98-110): 1 keeps
    ``x0``."""
    return x0 * lmask + x * (1.0 - lmask)


def run_sampler(model, x_init: np.ndarray, plan: SamplingPlan,
                cond_all: torch.Tensor, cfg: SamplerConfig,
                step_observer: Optional[Callable] = None,
                label_all: Optional[torch.Tensor] = None,
                step_callback: Optional[Callable] = None,
                lmask: Optional[np.ndarray] = None,
                cond_steps: Optional[np.ndarray] = None) -> torch.Tensor:
    """Run the loop from ``x_init`` (NCHW f32 numpy) with ``model``, a
    UNet or a flow model (``model.P.flow``).  ``cond_all`` (and, for the
    MMDiT and the SDXL UNet, ``label_all``, the pooled vectors or labels)
    hold the cond rows, then (with CFG) the uncond rows, on the model's
    device.  ``lmask`` ([N or 1, 1, h, w], 1 = KEEP) holds its region to
    the un-noised ``x_init``.  With ``cond_steps`` (prompt editing, an int
    [n_step, rows] matrix) ``cond_all`` and ``label_all`` are a bank of
    encoded rows, and step i conditions on the rows ``cond_steps[i]``
    picks, in the same cond-then-uncond layout (the JAX loop's gather,
    ``mlimgsynth_tpu/sampling/sampler.py:312-316``, ``:862-875``).  With
    ``cfg.slg_scale`` set, the steps of the skip-layer window evaluate the
    cond rows once more with the layers left out (:func:`slg_plan`).
    ``step_observer(i_step, latent_nchw_numpy)`` sees every step, and
    ``step_callback(i_step, n_step)`` is told of each (the session's
    progress).  Returns the final latent, f32 on the device."""
    dev = cond_all.device
    use_cfg = cfg.cfg_scale > 1
    solver = get_solver(cfg.method)
    flow = bool(getattr(model.P, "flow", False))
    flow_denoise = (flux_mod.denoise if getattr(model.P, "flux", False)
                    else mmdit_mod.denoise)
    log_sigmas = np.asarray(sch.get_log_sigmas(), np.float32)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    bank, label_bank = cond_all, label_all
    if cond_steps is not None and len(cond_steps) != plan.n_step:
        raise ValueError(f"{len(cond_steps)} conditioning steps for a plan "
                         f"of {plan.n_step}")

    slg = slg_plan(cfg, model.P, plan.n_step)

    def dxdt_at(i):
        """The derivative of step ``i``: under skip-layer guidance inside
        its window, steered away from the cond rows' evaluation with the
        layers left out."""
        steer = slg is not None and slg[2] <= i < slg[3]

        def dxdt(x, sigma):
            n = x.shape[0]
            xb = torch.cat([x, x]) if use_cfg else x
            if flow:
                t = np.float32(sigma) * np.float32(model.P.n_step_train)
                d = flow_denoise(model, xb, np.float32(sigma), t, cond_all,
                                 label_all)
            else:
                t = sigma_to_t(log_sigmas, sigma)
                d = unet_mod.denoise(model, xb, np.float32(sigma), t,
                                     cond_all, label_all)
            out = _cfg_mix(d, n, cfg.cfg_scale) if use_cfg else d
            if steer:
                scale, layers, _, _ = slg
                d_skip = flow_denoise(
                    model, x, np.float32(sigma), t, cond_all[:n],
                    None if label_all is None else label_all[:n],
                    skip_layers=layers)
                out = out + scale * (d[:n] - d_skip)
            return out
        return dxdt

    f32 = np.float32
    x = to_dev(x_init).float()
    x0_keep = x
    mask = None if lmask is None else to_dev(lmask).float()
    if flow:    # x_t = (1 - sigma) x0 + sigma noise
        x = x * f32(1.0 - float(plan.sigmas[0]))
    x = x + to_dev(plan.noise0) * f32(plan.sigmas[0])
    if mask is not None:
        x = _mask_apply(x, x0_keep, mask)
    t = f32(plan.sigmas[0])
    state = solver.init_state(x)
    for i in range(plan.n_step):
        if cond_steps is not None:
            rows = torch.as_tensor(np.asarray(cond_steps[i], np.int64),
                                   device=dev)
            cond_all = bank[rows]
            label_all = None if label_bank is None else label_bank[rows]
        churn = f32(plan.churn_sigma[i])
        if churn > 0:       # stochastic churn (src/sampling.c:138-151)
            x = x + to_dev(plan.churn_noise[i]) * churn
            if mask is not None:
                x = _mask_apply(x, x0_keep, mask)
            t = f32(plan.s_hat[i])
        x, state = solver.step(dxdt_at(i), x, state, i, t,
                               f32(plan.s_down[i]))
        if plan.s_up[i] > 0:   # post-step ancestral noise
            x = x + to_dev(plan.anc_noise[i]) * f32(plan.s_up[i])
        t = f32(plan.t_next[i])
        if mask is not None:
            x = _mask_apply(x, x0_keep, mask)
        if step_observer is not None:
            step_observer(i + 1, x.cpu().numpy())
        if step_callback is not None:
            step_callback(i + 1, plan.n_step)
    return x
