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

The other guidance and sampling options of the JAX package: ``cfg_rescale``
(the CFG output's per-sample std pulled back toward the cond prediction's,
``_cfg_mix``, ``:267-283``), perturbed-attention guidance (one more
cond-only evaluation with the UNet's mid self-attention map the identity on
the steps of its window, ``:373-392``), DeepCache (the model's deep part
rerun only on refresh steps, its output cached in between, ``:242-265``,
``:427-482``), the lcm method (``:403-425``) and seed variations (the
initial noise slerped toward a subseed's, ``:127-143``, ``:199-205``).
FreeU reaches the UNet through ``run_sampler(freeu=...)``.

img2img starts from an encoded latent over a schedule cut by ``f_t_ini``;
inpainting also holds the kept region to that latent: a latent mask
(1 = KEEP) is applied after the initial noise, after a churn draw and after
every step (``_mask_apply``, JAX ``sampler.py:484-500``, ``:620-628``).
An inpaint-variant UNet takes loop-constant extra input channels instead
(``extra_ch``), and a ControlNet's residuals enter every UNet evaluation
(``control``; its hint encoder runs once, before the loop,
``sampler.py:300-311``).  The SDXL refiner ensemble's two knobs
(``sampler.py:52-59``): ``keep_tail`` stops the loop at sigma(``f_t_end``)
with that noise left in the latent, ``noise_add`` False starts from a
latent that is already at sigma(``f_t_ini``).

Data parallelism (a mesh with dp > 1, ``sampler.py:902-925``): where the
batch of N images divides dp, each rank runs its N / dp rows (its CFG pair
built from its own cond and uncond rows) and the latents are gathered over
the dp group at the end, and for the step observers; every rank draws the
whole noise from the seed and takes its rows.  Otherwise every rank runs
the whole batch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..errors import MlisError
from ..models import flux as flux_mod
from ..models import mmdit as mmdit_mod
from ..models import unet as unet_mod
from ..parallel import comm
from ..parallel.mesh import DP_AXIS
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
    # the ensemble handoff (diffusers' denoising_end / denoising_start):
    # ``keep_tail`` drops the schedule's last jump to zero, so the run stops
    # at sigma(f_t_end) with that much noise left (the handoff latent);
    # ``noise_add`` False adds no initial noise, the input latent being at
    # sigma(f_t_ini) already (the draw still happens, so that the later
    # draws of the stream are unchanged)
    keep_tail: bool = False
    noise_add: bool = True
    # rectified-flow resolution shift (0: the SD beta-linear schedule)
    flow_shift: float = 0.0
    # skip-layer guidance (DiT families): one extra conditional evaluation
    # with ``slg_layers`` blocks left out on the steps in the [slg_start,
    # slg_end) fraction of the schedule; 0 is off
    slg_scale: float = 0.0
    slg_layers: tuple = (7, 8, 9)
    slg_start: float = 0.01
    slg_end: float = 0.2
    # CFG rescale phi (0 is off): the CFG output blended toward itself
    # rescaled to the cond prediction's per-sample std
    cfg_rescale: float = 0.0
    # perturbed-attention guidance (SD UNets): one extra cond-only
    # evaluation with the mid transformer's self-attention map the
    # identity on the steps in the [pag_start, pag_end) fraction; 0 is off
    pag_scale: float = 0.0
    pag_start: float = 0.0
    pag_end: float = 1.0


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


# the solvers DeepCache composes with: one model evaluation a step (lcm
# evaluates once too but steps in the loop body; ``DC_METHODS``,
# ``mlimgsynth_tpu/sampling/sampler.py:242-245``)
DC_METHODS = ("euler", "dpmpp2m", "dpmpp2m_sde", "taylor3", "unipc")


def _schedule(cfg: SamplerConfig, nfe_per_dxdt: int):
    """The step schedule; the lcm method takes the lcm grid unless another
    scheduler than uniform was chosen (``sampler.py:155-168``)."""
    solver = get_solver(cfg.method)
    sched = cfg.sched
    if solver.name == "lcm" and sched in (None, "", sch.SCHED_UNIFORM):
        sched = sch.SCHED_LCM
    ls = None
    if cfg.flow_shift:
        if solver.name == "lcm":
            raise MlisError(MlisError.E_OPT_VALUE,
                            "lcm sampling is not defined for rectified-flow "
                            "models")
        ls = sch.log_sigmas_flow(cfg.flow_shift)
    return sch.make_schedule(cfg.n_step, sched, solver.n_fe, nfe_per_dxdt,
                             cfg.f_t_ini, cfg.f_t_end, log_sigmas=ls)


def _keep_tail(cfg: SamplerConfig, s):
    """The schedule ``s`` without its last jump to zero under
    ``keep_tail`` (and at least two steps)."""
    if cfg.keep_tail and s.n_step >= 2:
        return sch.StepSchedule(sigmas=s.sigmas[:s.n_step].copy(),
                                n_step=s.n_step - 1,
                                nfe_per_step=s.nfe_per_step)
    return s


def plan_n_step(cfg: SamplerConfig, nfe_per_dxdt: int = 1) -> int:
    """The loop's step count that ``make_plan`` will give (the schedule's
    length after the NFE division, the ``f_t`` cuts and ``keep_tail``),
    wanted before the encode when prompt editing maps text segments onto
    steps (``mlimgsynth_tpu/sampling/sampler.py:110-124``)."""
    return _keep_tail(cfg, _schedule(cfg, nfe_per_dxdt)).n_step


def _noise_slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Per-sample spherical interpolation over the flattened noise
    (A1111's seed variations; the JAX package's ``_noise_slerp``,
    ``sampler.py:127-143``, with its numpy arithmetic, so the noise is
    the same bit for bit)."""
    out = np.empty_like(a)
    for i in range(a.shape[0]):
        va, vb = a[i].ravel(), b[i].ravel()
        dot = float(np.dot(va, vb)
                    / (np.linalg.norm(va) * np.linalg.norm(vb)))
        if abs(dot) > 0.9995:
            out[i] = (1.0 - t) * a[i] + t * b[i]
        else:
            om = np.arccos(dot)
            so = np.sin(om)
            out[i] = ((np.sin((1.0 - t) * om) / so) * a[i]
                      + (np.sin(t * om) / so) * b[i])
    return out


def make_plan(cfg: SamplerConfig, latent_shape, rng: RngPhilox,
              nfe_per_dxdt: int = 1, seeds=None, subseeds=None,
              subseed_strength: float = 0.0) -> SamplingPlan:
    """Sigma schedule and all noise, drawn in the reference's order
    (initial, then per step: churn draw, post-step ancestral draw).
    ``latent_shape`` is NCHW; batch sample i draws from its own stream
    seeded ``seed + i`` (or ``seeds[i]``).  The schedule's step count is
    that of ``n_step`` model evaluations: a 2-evaluation solver (heun,
    dpmpp2s) takes half as many steps.  The SDE methods read
    ``s_ancestral`` as their eta (default 1) and ``s_noise`` as the noise
    multiplier (``mlimgsynth_tpu/sampling/sampler.py:168-173``).  The lcm
    method takes the lcm noise plan: a full re-noise to the next sigma on
    the ancestral slot.  With ``subseeds`` (one a sample) and a
    ``subseed_strength`` above 0, the initial noise is slerped toward each
    subseed's fresh stream; the per-step draws stay on the seed streams
    (``:199-205``).  ``keep_tail`` and ``noise_add``: see
    :class:`SamplerConfig` (``:174-183``, ``:206-211``)."""
    solver = get_solver(cfg.method)
    s = _keep_tail(cfg, _schedule(cfg, nfe_per_dxdt))
    sde_eta = 0.0
    if solver.name.endswith("_sde"):
        sde_eta = cfg.s_ancestral if cfg.s_ancestral > 0 else 1.0
    plan = sch.plan_step_noise(s.sigmas, cfg.s_ancestral, cfg.s_noise,
                               sde_eta, lcm=(solver.name == "lcm"))
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
    if subseed_strength > 0 and subseeds is not None and cfg.noise_add:
        sub = np.stack([RngPhilox(sd, 0).randn_shaped(sample_shape)
                        for sd in subseeds]).astype(np.float32)
        noise0 = _noise_slerp(noise0, sub, float(subseed_strength))
    if not cfg.noise_add:
        noise0 = np.zeros_like(noise0)
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


def _cfg_mix(d, n: int, cfg_scale: float, cfg_rescale: float = 0.0):
    """CFG mixing of a stacked [cond; uncond] model output; with
    ``cfg_rescale`` (phi) blended toward the mix rescaled to the cond
    prediction's per-sample std (ddof 1, in f32, floor 1e-8; Lin et al.
    2023, section 3.4; ``_cfg_mix``, ``sampler.py:267-283``)."""
    cfg_scale = np.float32(cfg_scale)
    out = d[:n] * cfg_scale + d[n:] * (1 - cfg_scale)
    if cfg_rescale > 0:
        ax = tuple(range(1, out.dim()))
        std_c = torch.std(d[:n].float(), dim=ax, keepdim=True,
                          correction=1)
        std_o = torch.std(out.float(), dim=ax, keepdim=True, correction=1)
        scaled = out * (std_c / torch.clamp(std_o, min=1e-8)).to(out.dtype)
        out = cfg_rescale * scaled + (1.0 - cfg_rescale) * out
    return out


def slg_plan(cfg: SamplerConfig, unet_p, n_step: int, deepcache: int = 0):
    """(scale, layers, i0, i1) of skip-layer guidance over a loop of
    ``n_step`` steps, or None when ``slg_scale`` is 0; ``MlisError``
    (``E_OPT_VALUE``) for a model that is not a DiT, layers out of range
    for its depth, an empty window, or with DeepCache
    (``sampler.py:960-982``)."""
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
    if deepcache > 1:
        raise MlisError(MlisError.E_OPT_VALUE,
                        "slg: unsupported with deepcache")
    i0 = int(round(cfg.slg_start * n_step))
    i1 = max(int(round(cfg.slg_end * n_step)), i0 + 1)
    return float(cfg.slg_scale), layers, i0, i1


def pag_plan(cfg: SamplerConfig, unet_p, n_step: int, deepcache: int = 0):
    """(scale, i0, i1) of perturbed-attention guidance over a loop of
    ``n_step`` steps, or None when ``pag_scale`` is 0; ``MlisError``
    (``E_OPT_VALUE``) for a model without an SD UNet's attention, with
    DeepCache, or an empty window (``sampler.py:983-998``)."""
    if cfg.pag_scale <= 0:
        return None
    if getattr(unet_p, "flow", False) or not getattr(unet_p, "attn_res", ()):
        raise MlisError(
            MlisError.E_OPT_VALUE,
            "perturbed-attention guidance requires an SD-UNet model")
    if deepcache > 1:
        raise MlisError(MlisError.E_OPT_VALUE,
                        "pag: unsupported with deepcache")
    if cfg.pag_end <= cfg.pag_start:
        raise MlisError(MlisError.E_OPT_VALUE,
                        "pag window is empty (pag_end <= pag_start)")
    i0 = int(round(cfg.pag_start * n_step))
    i1 = max(int(round(cfg.pag_end * n_step)), i0 + 1)
    return float(cfg.pag_scale), i0, i1


def deepcache_check(method: str, unet_p, deepcache: int,
                    cond_steps=None, control=None, extra_ch=None) -> int:
    """DeepCache's refresh interval (0 off, for ``deepcache`` <= 1);
    ``ValueError`` where the JAX loop refuses it: a solver of more than one
    evaluation a step, prompt editing, a ControlNet, an inpaint-variant
    UNet's extra channels, or a UNet of one level (``sampler.py:799-813``;
    the session checks first, with ``MlisError``)."""
    if deepcache <= 1:
        return 0
    if method not in DC_METHODS:
        raise ValueError("deepcache needs a 1-eval/step solver "
                         f"({', '.join(DC_METHODS)})")
    if (cond_steps is not None or control is not None
            or extra_ch is not None) or (not getattr(unet_p, "flow", False)
                                  and len(getattr(unet_p, "ch_mult", ()))
                                  < 2):
        raise ValueError("deepcache: unsupported configuration")
    return int(deepcache)


def _mask_apply(x, x0, lmask):
    """Inpainting mask re-application (src/sampling.c:98-110): 1 keeps
    ``x0``."""
    return x0 * lmask + x * (1.0 - lmask)


def _dp_rows(mesh, n: int):
    """This rank's rows of a batch of ``n`` under the mesh's dp axis, or
    None where every rank runs the whole batch."""
    dp = 1 if mesh is None else mesh.size(DP_AXIS)
    if dp == 1 or n % dp:
        return None
    per = n // dp
    r = mesh.index(DP_AXIS)
    return np.arange(r * per, (r + 1) * per)


def _dp_slice(rows, n: int, x_init, plan, cond_all, label_all, lmask,
              cond_steps):
    """The sampler's inputs cut to the batch rows ``rows``: the latent,
    the noise, the mask, and the cond then uncond rows of the
    conditioning (or of each step's bank rows)."""
    plan = dataclasses.replace(
        plan, noise0=plan.noise0[rows], churn_noise=plan.churn_noise[:, rows],
        anc_noise=plan.anc_noise[:, rows])
    width = cond_all.shape[0] if cond_steps is None else cond_steps.shape[1]
    cols = np.concatenate([rows + k * n for k in range(width // n)])
    if cond_steps is not None:
        cond_steps = np.asarray(cond_steps)[:, cols]
    else:
        idx = torch.as_tensor(cols, device=cond_all.device)
        cond_all = cond_all[idx]
        label_all = None if label_all is None else label_all[idx]
    if lmask is not None and lmask.shape[0] == n:
        lmask = lmask[rows]
    return x_init[rows], plan, cond_all, label_all, lmask, cond_steps


def run_sampler(model, x_init: np.ndarray, plan: SamplingPlan,
                cond_all: torch.Tensor, cfg: SamplerConfig,
                step_observer: Optional[Callable] = None,
                label_all: Optional[torch.Tensor] = None,
                step_callback: Optional[Callable] = None,
                lmask: Optional[np.ndarray] = None,
                cond_steps: Optional[np.ndarray] = None,
                deepcache: int = 0, freeu=None, control=None,
                extra_ch: Optional[np.ndarray] = None,
                step_latent: Optional[Callable] = None,
                mesh=None) -> torch.Tensor:
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
    cond rows once more with the layers left out (:func:`slg_plan`); with
    ``cfg.pag_scale``, the steps of the PAG window once more with the
    identity mid self-attention (:func:`pag_plan`).  ``deepcache`` k > 1
    runs the model whole on steps i with i % k == 0 or i < max(1, n_step
    // 10) and keeps its deep part's output, and only its shallow part on
    the others (``sampler.py:427-482``, ``:1001``).  ``freeu`` (b1, b2,
    s1, s2) goes to every UNet evaluation, as do ``extra_ch`` ([1, n, h, w]
    f32 numpy, an inpaint-variant UNet's repaint mask and masked-image
    latent) and ``control`` ((a ``ControlNet``, the hint image [1, 3, H, W]
    in [0, 1] on the device, the strength): the hint features are computed
    here, once).  The lcm method takes its step
    here: the boundary-scaled x0 prediction (sigma_data 0.5, timestep
    scaling 10), then a full re-noise to the next sigma
    (``sampler.py:403-425``).  ``step_observer(i_step,
    latent_nchw_numpy)`` sees every step, and ``step_callback(i_step,
    n_step)`` is told of each (the session's progress), and
    ``step_latent(i_step, n_step, x)`` sees the latent on the device after
    each (the batch's previews and cancellation).  ``mesh``: the session's
    mesh, whose dp axis splits the batch (see the module docstring).
    Returns the final latent, f32 on the device."""
    dev = cond_all.device
    mine = _dp_rows(mesh, x_init.shape[0])
    if mine is not None:
        x_init, plan, cond_all, label_all, lmask, cond_steps = _dp_slice(
            mine, x_init.shape[0], x_init, plan, cond_all, label_all,
            lmask, cond_steps)

    def whole(x):
        """The whole batch's latent from this rank's rows."""
        if mine is None:
            return x
        return comm.all_gather(x.contiguous(), mesh.group(DP_AXIS), dim=0)

    use_cfg = cfg.cfg_scale > 1
    cfg_rescale = float(cfg.cfg_rescale) if use_cfg else 0.0
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

    dc = deepcache_check(solver.name, model.P, deepcache, cond_steps,
                         control, extra_ch)
    unet_kw = {}
    if extra_ch is not None:
        unet_kw["extra_ch"] = to_dev(extra_ch)
    if control is not None:
        cnet, hint, strength = control
        unet_kw["control"] = (cnet, cnet.hint_features(hint), strength)
    dc_warm = max(1, plan.n_step // 10)
    slg = slg_plan(cfg, model.P, plan.n_step, dc)
    pag = pag_plan(cfg, model.P, plan.n_step, dc)
    cache = [None]      # DeepCache's deep output, kept across steps

    def den(xb, sigma, ca, la, **kw):
        """One evaluation of the model on ``xb`` at ``sigma``."""
        if flow:
            t = np.float32(sigma) * np.float32(model.P.n_step_train)
            return flow_denoise(model, xb, np.float32(sigma), t, ca, la,
                                **kw)
        return unet_mod.denoise(model, xb, np.float32(sigma),
                                sigma_to_t(log_sigmas, sigma), ca, la,
                                freeu=freeu, **unet_kw, **kw)

    def dxdt_at(i):
        """The derivative of step ``i``: the CFG mix, steered away from the
        cond rows' degraded evaluation inside the skip-layer or PAG window;
        under DeepCache the whole model on refresh steps, the shallow part
        on the others."""
        steer = slg is not None and slg[2] <= i < slg[3]
        perturb = pag is not None and pag[1] <= i < pag[2]
        refresh = i % max(dc, 1) == 0 or i < dc_warm

        def dxdt(x, sigma):
            n = x.shape[0]
            xb = torch.cat([x, x]) if use_cfg else x
            if dc and refresh:
                d, cache[0] = den(xb, sigma, cond_all, label_all,
                                  want_cache=True)
            elif dc:
                d = den(xb, sigma, cond_all, label_all, use_cache=cache[0])
            else:
                d = den(xb, sigma, cond_all, label_all)
            out = _cfg_mix(d, n, cfg.cfg_scale, cfg_rescale) if use_cfg \
                else d
            if steer or perturb:
                la = None if label_all is None else label_all[:n]
                if steer:
                    scale = slg[0]
                    d_skip = den(x, sigma, cond_all[:n], la,
                                 skip_layers=slg[1])
                else:
                    scale = pag[0]
                    d_skip = den(x, sigma, cond_all[:n], la, pag=True)
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
        if solver.name == "lcm":
            # the consistency function's x0 through the boundary scalings,
            # then the re-noise on the ancestral slot (no churn)
            d = x - t * dxdt_at(i)(x, t)
            ts = sigma_to_t(log_sigmas, t) * f32(10.0)
            c_skip = f32(0.25) / (ts * ts + f32(0.25))
            c_out = ts / np.sqrt(ts * ts + f32(0.25))
            c_in = f32(1.0) / np.sqrt(t * t + f32(1.0))
            x = d * c_out + x * (c_skip * c_in)
        else:
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
            step_observer(i + 1, whole(x).cpu().numpy())
        if step_callback is not None:
            step_callback(i + 1, plan.n_step)
        if step_latent is not None:
            step_latent(i + 1, plan.n_step, whole(x))
    return whole(x)
