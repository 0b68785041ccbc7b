"""Session API (port of ``mlimgsynth_tpu/api.py``): SD1.5, SD2.1-768-v,
SDXL, SD3-medium, SD3.5-large and -medium, and Flux.1-schnell and -dev
txt2img, img2img (``image``, ``f_t_ini``) and alpha-mask
inpainting (``image_mask`` or the image's alpha), with LoRAs (``lora`` and
``<lora:NAME:MULT>`` prompt tags) merged into the weights as they load;
encoded and decoded by the VAE or, with the ``tae`` option, the tiny
autoencoder.  Two memory options: ``vae_tile`` (the VAE encodes and
decodes in overlapping tiles) and ``unet_split`` (stage-wise weight
residency: the text encoders and the denoiser are on the card only for
their stage).  The prompt layer: textual-inversion embeddings
(``<emb:NAME>`` tags, files under ``embed_dir``), A1111 prompt editing
(``[from:to:when]``, ``[a|b]``) on the UNet models, and the T5-XXL
context of SD3, SD3.5 and Flux (``t5`` weights, bundled or a file of their
own, read with the ``t5_tokenizer`` ``tokenizer.json``; ``t5_tokens``
rows).  A model that ships as components (Flux: a transformer-only file)
takes its text tower and its autoencoder from the ``clip`` and ``vae``
files.  Every weight type runs on every model type: quantized linears are
quantized where the weights are read to (the card, or the host for a
module staged there).  The DiT families take skip-layer guidance
(``slg_scale``, ``slg_layers``, ``slg_start``, ``slg_end``), the SD UNets
perturbed-attention guidance (``pag_scale``, ``pag_start``, ``pag_end``)
and FreeU (``freeu``); every model takes ``cfg_rescale``, seed variations
(``subseed``, ``subseed_strength``), DeepCache (``deepcache``) and
seamless tiling (``tiling``: the loaded conv modules pad circularly for
the request), and the UNets the ``lcm`` method.  The second-stage and
control paths: inpainting with a blurred mask (``mask_blur``) or at full
resolution around the mask (``inpaint_full_res``,
``inpaint_full_res_padding``), inpaint-variant UNets (9 input channels,
found from the checkpoint), ControlNet (``control_net``,
``control_image``, ``control_strength``), ESRGAN upscaling (``upscaler``,
:meth:`MLImgSynth.upscale`), the hires fix (``hires_fix``,
``hires_denoise``, ``hires_steps``, ``hires_upscaler``), the SDXL refiner
as a model type (``sdxl_refiner``) and as the second stage of an SDXL
request (``refiner``, ``refiner_switch``).

``MLImgSynth`` keeps the JAX session's option names and its
``option_set`` / ``setup`` / ``generate`` / ``tensors`` surface.  The
weights load once, onto the session's device, and stay there across
``generate`` calls (under ``unet_split``, on the host between stages).
Options, model types and weight types this slice does not port raise
``MlisError``; none is silently ignored.

Arrays at this boundary are float32 numpy NCHW, as in the JAX package; the
image is ``[n, 3, h, w]`` in [0, 1], quantized through uint8 (under
``vae_tile`` with the VAE, the decoder's float output, as the JAX
session's ``image_decode`` gives it).  After each
``generate`` the session holds the A1111 "parameters" text of the request
in ``infotext``; a ``callback(session, progress)`` option sees its stages
and steps, as the JAX session's does.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import __version__ as _pkg_version
from . import prompt as prompt_mod
from . import tokenizer as tok_mod
from . import weights as weights_mod
from .errors import MlisError
from .io.tensorstore import TensorStore
from .models import blocks as blocks_mod
from .models import clip as clip_mod
from .models import controlnet as cnet_mod
from .models import esrgan as esr_mod
from .models import flux as flux_mod
from .models import mmdit as mmdit_mod
from .models import t5 as t5_mod
from .models import unet as unet_mod
from .models import vae as vae_mod
from .nameconv import normalize_cnet_name, normalize_name
from .ops.quant_plan import dit_m_hint
from .parallel import comm
from .parallel import mesh as pmesh
from .parallel import pipeline as pipe
from .parallel import tensor_parallel as tpar
from .rng import RngPhilox
from .sampling.sampler import (DC_METHODS, SamplerConfig, make_plan,
                               pag_plan, plan_n_step, run_sampler, slg_plan)
from .sampling.solvers import SOLVERS, get_solver
from .utils import image as image_mod
from .utils.log import g_logger as log


class Aborted(Exception):
    """A progress callback asked to stop."""


def _locked(fn):
    """``fn`` with the session's lock held (re-entrant: a method that holds
    it may call another)."""
    @functools.wraps(fn)
    def run(self, *args, **kw):
        with self._lock:
            return fn(self, *args, **kw)
    return run


@dataclass
class ModelTypeDef:
    """``unet_p`` is the denoiser's parameters: ``UnetParams`` or, for the
    flow models, ``MmditParams`` (the SD3 family) or ``FluxParams``
    (``flux``).  ``clip2_p`` is the second text tower (bigG, SDXL and the
    SD3 family), None for single-tower types."""
    name: str
    clip_p: tok_mod.ClipParams
    unet_p: object
    vae_p: vae_mod.VaeParams
    default_dim: int
    default_clip_skip: int
    clip2_p: Optional[tok_mod.ClipParams] = None


def _model_types() -> Dict[str, ModelTypeDef]:
    """Model types this port runs (tests monkeypatch this table).  sd2 is
    SD2.1-768-v: OpenCLIP ViT-H at clip skip 2, the v-prediction UNet, the
    SD1 VAE (``mlimgsynth_tpu/api.py:122-123``).  sdxl is
    SDXL-base: CLIP-L and bigG at clip skip 2, the labeled UNet, the SD1 VAE
    at SDXL's scale (``mlimgsynth_tpu/api.py:124-126``).  sd3 is SD3-medium
    (Stability AI's sd3_medium.safetensors): CLIP-L and bigG at clip skip 2
    (and T5-XXL where its weights and a tokenizer are given, else zero T5
    rows), the MMDiT, the 16-channel VAE.  sd35_large and sd35_medium
    condition as sd3 does (``mlimgsynth_tpu/api.py:141-148``).
    flux_schnell and flux_dev: CLIP-L alone, at clip skip 1, for the pooled
    row, T5-XXL for the context, the Flux VAE (``:149-158``).  sdxl_refiner
    is the SDXL refiner: the bigG tower alone (with its projection, under
    ``clip.``) at clip skip 2, the refiner UNet, the SDXL VAE
    (``:127-132``)."""
    return {"sd1": ModelTypeDef("sd1", clip_mod.CLIP_VIT_L_14,
                                unet_mod.UNET_SD1, vae_mod.VAE_SD1, 512, 1),
            "sd2": ModelTypeDef("sd2", clip_mod.CLIP_VIT_H_14,
                                unet_mod.UNET_SD2, vae_mod.VAE_SD1, 768, 2),
            "sdxl": ModelTypeDef("sdxl", clip_mod.CLIP_VIT_L_14,
                                 unet_mod.UNET_SDXL, vae_mod.VAE_SDXL, 1024,
                                 2, clip_mod.CLIP_VIT_BIGG_14),
            "sdxl_refiner": ModelTypeDef(
                "sdxl_refiner", clip_mod.CLIP_VIT_BIGG_14,
                unet_mod.UNET_SDXL_REFINER, vae_mod.VAE_SDXL, 1024, 2),
            "sd3": ModelTypeDef("sd3", clip_mod.CLIP_VIT_L_14,
                                mmdit_mod.MMDIT_SD3_MEDIUM, vae_mod.VAE_SD3,
                                1024, 2, clip_mod.CLIP_VIT_BIGG_14),
            "sd35_large": ModelTypeDef(
                "sd35_large", clip_mod.CLIP_VIT_L_14,
                mmdit_mod.MMDIT_SD35_LARGE, vae_mod.VAE_SD3, 1024, 2,
                clip_mod.CLIP_VIT_BIGG_14),
            "sd35_medium": ModelTypeDef(
                "sd35_medium", clip_mod.CLIP_VIT_L_14,
                mmdit_mod.MMDIT_SD35_MEDIUM, vae_mod.VAE_SD3, 1024, 2,
                clip_mod.CLIP_VIT_BIGG_14),
            "flux_schnell": ModelTypeDef(
                "flux_schnell", clip_mod.CLIP_VIT_L_14,
                flux_mod.FLUX_SCHNELL, vae_mod.VAE_FLUX, 1024, 1),
            "flux_dev": ModelTypeDef(
                "flux_dev", clip_mod.CLIP_VIT_L_14, flux_mod.FLUX_DEV,
                vae_mod.VAE_FLUX, 1024, 1)}


def build_models(mt: ModelTypeDef) -> Dict[str, torch.nn.Module]:
    """The modules the session loads for ``mt`` to run txt2img, by
    parameter-name prefix, on the meta device."""
    with torch.device("meta"):
        if not getattr(mt.unet_p, "flow", False):
            # the refiner's single tower gives the projected pooled feature
            towers = {"clip.text.": clip_mod.ClipText(
                mt.clip_p, proj=_single_label(mt))}
            if mt.clip2_p is not None:      # SDXL: bigG with its projection
                towers["clip2.text."] = clip_mod.ClipText(mt.clip2_p,
                                                          proj=True)
            return {**towers, "unet.": unet_mod.UNet(mt.unet_p),
                    "vae.": vae_mod.VaeDecoder(mt.vae_p)}
        if getattr(mt.unet_p, "flux", False):
            # the unprojected pooled row: no text projection
            return {"clip.text.": clip_mod.ClipText(mt.clip_p),
                    "flux.": flux_mod.Flux(mt.unet_p),
                    "vae.": vae_mod.VaeDecoder(mt.vae_p)}
        return {"clip.text.": clip_mod.ClipText(mt.clip_p, proj=True),
                "clip2.text.": clip_mod.ClipText(mt.clip2_p, proj=True),
                "mmdit.": mmdit_mod.MMDiT(mt.unet_p),
                "vae.": vae_mod.VaeDecoder(mt.vae_p)}


def build_encoders(mt: ModelTypeDef) -> Dict[str, torch.nn.Module]:
    """The VAE encoder (its names under ``vae.``, beside the decoder's),
    which the session loads on its first image, on the meta device."""
    with torch.device("meta"):
        return {"vae.": vae_mod.VaeEncoder(mt.vae_p)}


def _single_label(mt: ModelTypeDef) -> bool:
    """A labeled UNet conditioned by one tower (the SDXL refiner)."""
    return bool(mt.unet_p.cond_label) and mt.clip2_p is None


def build_controlnet(mt: ModelTypeDef) -> torch.nn.Module:
    """The ControlNet of ``mt``'s UNet (its inputs as wide as the UNet's),
    on the meta device."""
    with torch.device("meta"):
        return cnet_mod.ControlNet(mt.unet_p)


def _id_norm(s: str) -> str:
    """Case/hyphen-insensitive option and enum names, '+' matches 'p'."""
    return s.lower().replace("-", "_").replace("+", "p")


_OPTIONS = ("model", "model_type", "weight_type", "prompt", "nprompt",
            "image_dim", "steps", "seed", "cfg_scale", "method", "scheduler",
            "batch_size", "no_prompt_parse", "s_noise", "s_ancestral",
            "clip_skip", "tae", "aux_dir", "callback", "image", "image_mask",
            "f_t_ini", "f_t_end", "lora", "lora_dir", "lora_clear",
            "tensor_use_flags", "vae_tile", "unet_split", "embed_dir",
            "t5", "t5_tokenizer", "t5_tokens", "clip", "vae", "slg_scale",
            "slg_layers", "slg_start", "slg_end", "no_decode", "cfg_rescale",
            "subseed", "subseed_strength", "pag_scale", "pag_start",
            "pag_end", "deepcache", "freeu", "tiling", "mask_blur",
            "inpaint_full_res", "inpaint_full_res_padding", "control_net",
            "control_image", "control_strength", "upscaler", "hires_fix",
            "hires_denoise", "hires_steps", "hires_upscaler", "refiner",
            "refiner_switch", "backend", "threads", "dump_flags",
            "error_handler", "log_level", "tp", "dp", "sp", "pp")
# options whose string value is one argument: paths and text
# (``option_set_str``)
_STR_OPTIONS = ("model", "tae", "aux_dir", "lora_dir", "prompt", "nprompt",
                "embed_dir", "t5", "t5_tokenizer", "clip", "vae",
                "control_net", "upscaler", "hires_upscaler", "refiner")
# options that take an object, never a string
_OBJ_OPTIONS = ("callback", "image", "image_mask", "control_image",
                "error_handler")
# ``backend`` values -> the device they name (None: the session's own, a
# card unless the caller asked for the CPU)
_BACKENDS = {"": None, "best": None, "cuda": "cuda", "cpu": "cpu"}
_SCHEDULERS = ("uniform", "karras", "lcm", "exponential", "sgm_uniform",
               "beta")
# the reference's enums (``mlimgsynth_tpu/api.py:69-72``): an integer
# ``method`` or ``scheduler`` value indexes them
METHOD_NAMES = ["none", "euler", "heun", "taylor3", "dpmpp2m",
                "dpmpp2s", "dpmpp2m_sde", "lcm", "unipc"]
SCHED_NAMES = ["none", "uniform", "karras", "lcm",
               "exponential", "sgm_uniform", "beta"]
# weight type -> (compute dtype, quantized bits); None: the device's
# default (bf16 on a card, f32 on the CPU).  As the JAX package
# (``mlimgsynth_tpu/api.py:820-837``): q4* run 4-bit weights, the other q
# types 8-bit.
_WEIGHT_TYPES = {"f32": (torch.float32, 0), "f16": (torch.bfloat16, 0),
                 "bf16": (torch.bfloat16, 0),
                 "q8_0": (None, 8), "q5_k": (None, 8), "q6_k": (None, 8),
                 "q4_0": (None, 4), "q4_1": (None, 4), "q4_k": (None, 4)}
# progress stages, indexes into STAGE_NAMES (the JAX package's ``STAGE_*``)
STAGE_IDLE, STAGE_COND_ENCODE, STAGE_IMAGE_ENCODE = 0, 1, 2
STAGE_IMAGE_DECODE, STAGE_DENOISE = 3, 4
STAGE_NAMES = ["idle", "cond_encode", "image_encode", "image_decode",
               "denoise"]
# which of ``tensors`` a request uses (``tensor_use_flags``; the JAX
# package's ``TUF_*``, ``mlimgsynth_tpu/api.py:77-81``): the image to
# encode, its mask, a latent to start from, a latent mask
TUF_IMAGE, TUF_MASK, TUF_LATENT, TUF_LMASK = 1, 2, 4, 8
# FreeU's (b1, b2, s1, s2) by family, for ``freeu`` 1 / auto
# (``_FREEU_DEFAULTS``, ``mlimgsynth_tpu/api.py:1830-1832``)
_FREEU_DEFAULTS = {"sd1": (1.5, 1.6, 0.9, 0.2), "sd2": (1.4, 1.6, 0.9, 0.2),
                   "sdxl": (1.3, 1.4, 0.9, 0.2)}
# the linear latent -> RGB map of the previews without a TAE
# (``mlimgsynth_tpu/sampling/sampler.py:670-673``)
_PREVIEW_RGB = [[0.298, 0.207, 0.208], [0.187, 0.286, 0.173],
                [-0.158, 0.189, 0.264], [-0.184, -0.271, -0.473]]
_BOOL = {"true": True, "yes": True, "y": True, "1": True,
         "false": False, "no": False, "n": False, "0": False}
# the modules that take tensor parallelism (``tp``, ``mlimgsynth_tpu/
# api.py:1261-1262``: the UNet or DiT, ControlNet, T5; CLIP and the VAE
# stay whole on every rank)
_TP_MODELS = ("unet.", "mmdit.", "flux.", "cnet.", "t5.")
# the modules that ``unet_split`` keeps on the host between their stages:
# the text encoders (on the card for the conditioning) and the denoiser
# (for the sampler loop); the VAE and the TAE stay on the card
_STAGED = ("clip.text.", "clip2.text.", "unet.", "mmdit.", "flux.")
_TOWERS = ("clip.text.", "clip2.text.")
# the prefixes a standalone T5 file's names may carry
# (``mlimgsynth_tpu/api.py:978-996``)
_T5_FILE_PREFIXES = ("text_encoders.t5xxl.", "transformer.")


def _clip_file_name(t: str):
    """A CLIP file's tensor name -> its internal name: the HF
    ``CLIPTextModel`` layout (``text_model.*``) as the CompVis checkpoint
    nests it, any other name as a checkpoint's (``mlimgsynth_tpu/api.py:
    997-1009``)."""
    if t.startswith("text_model."):
        t = "cond_stage_model.transformer." + t
    return normalize_name(t)


def _vae_file_name(t: str):
    """A VAE file's tensor name -> its internal name: bare ``encoder.`` /
    ``decoder.`` names under ``first_stage_model.`` (``:1010-1022``)."""
    if not t.startswith("first_stage_model."):
        t = "first_stage_model." + t
    return normalize_name(t)


# the auxiliary files of a model that ships as components: option ->
# (the prefix their tensors are read under, the name transform)
_AUX_FILES = {"clip": ("clip_ckpt.", _clip_file_name),
              "vae": ("vae_ckpt.", _vae_file_name)}


def _split_args(value: str) -> List[str]:
    """Split a ','-separated option value with double-quote quoting
    (the JAX package's ``_split_args``)."""
    out, cur, in_q = [], [], False
    for c in value:
        if in_q:
            if c == '"':
                in_q = False
            else:
                cur.append(c)
        elif c == '"':
            in_q = True
        elif c == ",":
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    out.append("".join(cur))
    return out


def _int(v, default=0) -> int:
    """An integer option value; the empty string gives ``default``."""
    if isinstance(v, str):
        v = v.strip()
        return default if v == "" else int(v)
    return int(v)


def _float(v, default=0.0) -> float:
    """A float option value; the empty string gives ``default``."""
    if isinstance(v, str):
        v = v.strip()
        return default if v == "" else float(v)
    return float(v)


def _enum_value(v, names):
    """A ``method`` or ``scheduler`` value: None for the empty string (the
    option is left alone), an integer as an index into ``names``, else the
    normalised name."""
    if isinstance(v, str):
        return None if v.strip() == "" else _id_norm(v)
    return names[int(v)]


def _bool(v) -> bool:
    if isinstance(v, str):
        if v.strip().lower() not in _BOOL:
            raise ValueError(f"invalid boolean '{v}'")
        return _BOOL[v.strip().lower()]
    return bool(v)


def _tile_geometry(full0, full1, n0, n1, k):
    """Row-major tile origins + inner write boxes (tile-relative), matching
    the reference's stitch rule: skip the k-margin on non-edge sides
    (src/vae.c:365-385; the JAX package's ``_tile_geometry``,
    ``mlimgsynth_tpu/api.py:3521-3540``)."""
    step0, step1 = n0 - k * 2, n1 - k * 2
    n_t0 = (full0 + step0 - 1) // step0
    n_t1 = (full1 + step1 - 1) // step1
    origins, boxes = [], []
    for t1 in range(n_t1):
        i1 = min(t1 * step1, full1 - n1)
        for t0 in range(n_t0):
            i0 = min(t0 * step0, full0 - n0)
            d0 = k if i0 else 0
            d1 = k if i1 else 0
            ty1 = n1 - k if i1 + n1 < full1 else n1
            tx1 = n0 - k if i0 + n0 < full0 else n0
            origins.append((i1, i0))
            boxes.append((d1, ty1, d0, tx1))
    return np.asarray(origins, np.int32), np.asarray(boxes, np.int32)


def _tiled_decode(vae, lat: torch.Tensor, tile_px: int) -> torch.Tensor:
    """latent [n, ch_z, lh, lw] (scaled) -> image [n, 3, f lh, f lw] in
    [-1, 1], f32, decoded by ``vae`` (a ``VaeDecoder``) in tiles of
    ``tile_px`` (rounded up to a multiple of 64) plus a margin of 8 latent
    pixels on each side (``_tiled_decode``, ``mlimgsynth_tpu/api.py:
    3648-3679``).  Each tile writes its inner box into the canvas, in
    ``_tile_geometry``'s order, so a later tile overwrites an earlier one
    where the clamped last tile overlaps it.  One tile that covers the
    latent is the untiled decode."""
    f = vae.P.f_down
    k = 8
    n, _, lh, lw = lat.shape
    tile_px = (tile_px + 63) // 64 * 64
    n0 = min(tile_px // f + k * 2, lw)
    n1 = min(tile_px // f + k * 2, lh)
    if n0 == lw and n1 == lh:
        return vae(lat).float()
    origins, boxes = _tile_geometry(lw, lh, n0, n1, k)
    log.info(f"VAE tiled decode: {len(origins)} tiles of "
             f"{n0 * f}x{n1 * f}px")
    img = torch.zeros(n, vae.P.ch_x, lh * f, lw * f, device=lat.device)
    for (y, x), (y0, y1, x0, x1) in zip(origins.tolist(), boxes.tolist()):
        dec = vae(lat[:, :, y:y + n1, x:x + n0])
        img[:, :, (y + y0) * f:(y + y1) * f, (x + x0) * f:(x + x1) * f] = \
            dec[:, :, y0 * f:y1 * f, x0 * f:x1 * f]
    return img


def _tiled_encode(enc, img: torch.Tensor, tile_px: int) -> torch.Tensor:
    """image [n, 3, ih, iw] in [-1, 1] -> moments [n, 2 ch_z, ih/f, iw/f],
    f32, encoded by ``enc`` (a ``VaeEncoder``) in tiles of ``tile_px``
    (rounded up to a multiple of 64) plus a margin of 8 f image pixels on
    each side (``_tiled_encode``, ``mlimgsynth_tpu/api.py:3682-3705``),
    stitched as :func:`_tiled_decode` stitches."""
    f = enc.P.f_down
    k = f * 8
    n, _, ih, iw = img.shape
    tile_px = (tile_px + 63) // 64 * 64
    n0 = min(tile_px + k * 2, iw)
    n1 = min(tile_px + k * 2, ih)
    if n0 == iw and n1 == ih:
        return enc(img).float()
    origins, boxes = _tile_geometry(iw, ih, n0, n1, k)
    log.info(f"VAE tiled encode: {len(origins)} tiles of {n0}x{n1}px")
    mom = torch.zeros(n, enc.P.ch_z * 2, ih // f, iw // f,
                      device=img.device)
    for (y, x), (y0, y1, x0, x1) in zip(origins.tolist(), boxes.tolist()):
        e = enc(img[:, :, y:y + n1, x:x + n0])
        oy, ox = y // f, x // f
        mom[:, :, oy + y0 // f:oy + y1 // f, ox + x0 // f:ox + x1 // f] = \
            e[:, :, y0 // f:y1 // f, x0 // f:x1 // f]
    return mom


class MLImgSynth:
    """The session.  ``device`` defaults to the first CUDA card; without
    one the session refuses to start unless the caller asks for the CPU
    (``device="cpu"``).  With ``late_device`` (a C ABI context) the device
    is resolved at the first ``setup`` instead, from the ``backend`` option:
    the CPU where it is ``cpu``, else the card, and ``MlisError`` without
    one; there is no fallback either way.  The compute type is bf16 on a
    card and f32 on the CPU; the ``weight-type`` option overrides it, and a
    quantized weight type stores the linears in 8 or 4 bits (``qbits``).
    ``setup``, ``generate``, ``generate_batch`` and the encoders hold the
    session's lock: one session may serve several threads (the server's
    worker and its handlers)."""

    def __init__(self, device=None, late_device: bool = False):
        self._late_device = bool(late_device) and device is None
        self.device = torch.device("cuda" if device is None else device)
        if (not self._late_device and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise MlisError(MlisError.E_UNKNOWN,
                            "no CUDA device found; pass device=\"cpu\" "
                            "to run on the CPU")
        self.dtype = self._default_dtype()
        self.qbits = 0
        # a ``weight-type`` the caller set; else a model file of quantized
        # tensors sets ``qbits`` (``_load_model``)
        self._wtype_set = False
        self._lock = threading.RLock()
        # the error handler (``error_handler``) sees every error of a
        # ``generate``; ``errstr`` keeps the last one's text
        self.error_handler: Optional[Callable] = None
        self.errstr = ""
        self.c = {"model": "", "model_type": "", "prompt_raw": "",
                  "nprompt_raw": "", "width": 0, "height": 0, "steps": 0,
                  "cfg_scale": 7.0, "method": "euler",
                  "scheduler": "uniform", "n_batch": 1,
                  "no_prompt_parse": False, "clip_skip": 0,
                  "s_noise": 0.0, "s_ancestral": 0.0, "tae": "",
                  "aux_dir": "", "f_t_ini": 1.0, "f_t_end": 0.0,
                  "lora_dir": "", "tuflags": 0, "vae_tile": 0,
                  "unet_split": False, "embed_dir": "", "t5": "",
                  "t5_tokenizer": "", "t5_tokens": 77, "clip": "",
                  "vae": "", "slg_scale": 0.0, "slg_layers": "7,8,9",
                  "slg_start": 0.01, "slg_end": 0.2, "no_decode": False,
                  "cfg_rescale": 0.0, "pag_scale": 0.0, "pag_start": 0.0,
                  "pag_end": 1.0, "subseed": -1, "subseed_strength": 0.0,
                  "deepcache": 0, "tiling": False, "freeu": "",
                  "mask_blur": 0.0, "inpaint_full_res": 0,
                  "inpaint_full_res_padding": 32, "control_net": "",
                  "control_strength": 1.0, "upscaler": "",
                  "hires_fix": 0.0, "hires_denoise": 0.7, "hires_steps": 0,
                  "hires_upscaler": "", "refiner": "",
                  "refiner_switch": 0.8, "backend": "", "be_params": "",
                  "threads": 0, "dump_flags": 0, "weight_type": "",
                  "tp": 1, "dp": 1, "sp": 1, "pp": 1}
        self.prompt = prompt_mod.PromptText()
        self.nprompt = prompt_mod.PromptText()
        self.rng = RngPhilox(seed=int(time.time() * 1000) & 0xFFFFFFFFFFFF)
        # per-step latent observer (i_step, latent_nchw)
        self.step_observer: Optional[Callable] = None
        # progress callback (session, progress dict); a true return aborts
        self.callback: Optional[Callable] = None
        self.progress = {"stage": STAGE_IDLE, "step": 0, "step_end": 0,
                         "nfe": 0, "step_time": 0.0}
        self.infotext = ""
        # the variation seed of the last request (infotext)
        self._subseed_eff = -1
        self._nfe = 0
        self.tensors: Dict[str, Optional[np.ndarray]] = {
            k: None for k in ("image", "mask", "latent", "lmask", "cond",
                              "ncond", "label", "nlabel", "control_image")}
        # (path, multiplier, from a prompt tag); tag LoRAs last one request
        self.loras: List[Tuple[str, float, bool]] = []
        # seconds of the last setup and request: "load_s" (a whole load or
        # a LoRA reload, its merges included), "lora_merge_s",
        # "encoder_load_s", "embed_reload_s" (the text towers reloaded for
        # new embeddings), "t5_load_s", "t5_encode_s", "image_encode_s",
        # "decode_s", "generate_s"; under ``unet_split`` each stage move,
        # "move_in_<module>_s" and "move_out_<module>_s" (module: clip,
        # clip2, unet, mmdit, flux)
        self.times: Dict[str, float] = {}
        self._mt: Optional[ModelTypeDef] = None
        self._models: Dict[str, torch.nn.Module] = {}
        self._encoders: Dict[str, torch.nn.Module] = {}
        self._loaded = ""
        self._tae_loaded = ""
        # the LoRA list the loaded weights hold, and the module prefixes
        # its merges touched
        self._lora_state: Tuple[Tuple[str, float], ...] = ()
        self._lora_prefixes: set = set()
        # the residency record: prefixes of ``_models`` whose weights are
        # on the session's device; under ``unet_split`` the others of
        # ``_STAGED`` hold their host copy (``_host``, pinned on a card),
        # which is also the state that each stage puts on the device
        self.resident: set = set()
        self._host: Dict[str, Dict[str, torch.Tensor]] = {}
        # textual inversion: name -> {"ids": [int], "tables": {"clip" or
        # "clip2": f32 [k, d]}}, appended to the CLIP token tables in
        # registration order (token id n_vocab + row); ``_embed_version``
        # counts changes of the registry, ``_towers_embeds`` the version
        # each loaded tower holds
        self._embeds: Dict[str, dict] = {}
        self._embed_order: List[str] = []
        self._embed_version = 0
        self._towers_embeds: Dict[str, int] = {}
        self._bundled_t5 = False
        # the T5 encoder (on the device once loaded; it stays there under
        # ``unet_split``, as in the JAX session) and the weights it holds
        self._t5: Optional[t5_mod.T5Encoder] = None
        self._t5_key = ""
        # the ControlNet file ``_models["cnet."]`` holds
        self._cnet_loaded = ""
        # the upscaler (module, params) and the file, dtype and device it
        # was read for
        self._upscaler = None
        self._upscaler_key = ""
        # the second-stage dispatch: guards against re-entry (inside a
        # full-resolution inpaint, a hires stage, an ensemble stage), the
        # ensemble's handoff knobs (``SamplerConfig.keep_tail`` /
        # ``noise_add``) and its refiner sub-session
        self._in_fullres = self._in_hires = self._in_refiner = False
        self._keep_tail, self._noise_add = False, True
        self._refiner: Optional["MLImgSynth"] = None
        self._refiner_path = ""
        # the ranks' mesh under tp / dp / sp / pp (``_mesh_resolve``)
        self._mesh: Optional[pmesh.Mesh] = None

    def _default_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.device.type == "cuda"
                else torch.float32)

    # -- options ------------------------------------------------------------

    def option_set(self, name: str, *args) -> None:
        opt = _id_norm(name)
        if opt not in _OPTIONS:
            raise MlisError(MlisError.E_UNK_OPT,
                            f"option '{name}' is not supported by the "
                            "PyTorch port")
        try:
            self._option_set(opt, *args)
        except MlisError:
            raise
        except (ValueError, TypeError, IndexError) as e:
            raise MlisError(MlisError.E_OPT_VALUE,
                            f"invalid argument for option '{name}': {e}")

    def _option_set(self, opt: str, *args) -> None:
        c = self.c
        v = args[0]
        if opt == "model":
            c["model"] = str(v)
        elif opt == "model_type":
            mt = _id_norm(str(v))
            types = _model_types()
            if mt not in types:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"model type '{v}' is not supported by the "
                                f"PyTorch port (have: {', '.join(types)})")
            if self._mt is None or mt != c["model_type"]:
                # the same type keeps the loaded geometry (an
                # inpaint-variant UNet's input width); another reloads
                self._mt = types[mt]
                self._loaded = ""
            c["model_type"] = mt
            c["width"] = c["width"] or self._mt.default_dim
            c["height"] = c["height"] or c["width"]
            c["clip_skip"] = c["clip_skip"] or self._mt.default_clip_skip
        elif opt == "weight_type":
            wt = str(v).lower()
            if wt in ("", "none", "-1"):
                self.dtype, self.qbits = self._default_dtype(), 0
                self._wtype_set = False
                return
            if wt not in _WEIGHT_TYPES:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"unknown weight type '{v}' (have: "
                                f"{', '.join(_WEIGHT_TYPES)})")
            dtype, self.qbits = _WEIGHT_TYPES[wt]
            self.dtype = dtype or self._default_dtype()
            self._wtype_set = True
            c["weight_type"] = wt
        elif opt == "backend":
            # the session's device is fixed when it is made (or, for a
            # ``late_device`` session, at its first setup): a backend
            # names it or fails (``_backend_init``, ``api.py:873-882``)
            want = str(v).strip().lower()
            if want not in _BACKENDS:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"backend '{v}' not available (have: "
                                "cuda, cpu)")
            dev = _BACKENDS[want]
            if (not self._late_device and dev is not None
                    and dev != self.device.type):
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"backend '{v}' is not this session's "
                                f"device ({self.device.type})")
            c["backend"] = str(v)
            c["be_params"] = str(args[1]) if len(args) > 1 else ""
        elif opt in ("threads", "dump_flags"):
            # stored, as the JAX session stores them (``api.py:466-469``)
            c[opt] = _int(v)
        elif opt == "error_handler":
            self.error_handler = v
        elif opt == "log_level":
            from .utils.log import level_from_str
            log.level = level_from_str(str(v))
        elif opt in ("prompt", "nprompt"):
            self._prompt_set(opt, str(v))
        elif opt in ("no_prompt_parse", "no_decode"):
            c[opt] = _bool(v)
        elif opt == "image_dim":
            c["width"] = _int(v)
            c["height"] = (_int(args[1]) if len(args) > 1 and str(args[1])
                           else c["width"])
        elif opt == "steps":
            c["steps"] = _int(v)
        elif opt == "seed":
            if str(v) != "":
                self.rng.seed = int(v)
                self.rng.offset = 0
        elif opt == "cfg_scale":
            c["cfg_scale"] = _float(v, 7.0)
        elif opt == "batch_size":
            c["n_batch"] = max(1, _int(v, 1))
        elif opt == "method":
            m = _enum_value(v, METHOD_NAMES)
            if m is None:
                return
            if isinstance(v, str) and m.endswith("_a"):
                # the ancestral suffix (``api.py:363-375``)
                m = m[:-2]
                c["s_ancestral"] = 1.0
            if m not in SOLVERS:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"method '{v}' is not supported by the "
                                f"PyTorch port (have: {', '.join(SOLVERS)})")
            c["method"] = m
        elif opt == "scheduler":
            sc = _enum_value(v, SCHED_NAMES)
            if sc is None:
                return
            if sc not in _SCHEDULERS:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"invalid scheduler '{v}'")
            c["scheduler"] = sc
        elif opt in ("s_noise", "s_ancestral"):
            c[opt] = _float(v)
        elif opt == "clip_skip":
            c["clip_skip"] = _int(v)
        elif opt in ("tae", "aux_dir", "lora_dir"):
            c[opt] = str(v)
        elif opt == "callback":
            self.callback = v
        elif opt == "image":
            self._image_set(v)
        elif opt == "image_mask":
            t = np.asarray(v, np.float32)
            if t.ndim != 4 or t.shape[1] != 1:
                raise MlisError(MlisError.E_IMAGE,
                                "mask must have one channel")
            self.tensors["mask"] = t
            c["tuflags"] |= TUF_MASK
        elif opt == "f_t_ini":
            c["f_t_ini"] = _float(v, 1.0)
        elif opt == "f_t_end":
            c["f_t_end"] = _float(v)
        elif opt == "lora":
            mult = _float(args[1], 1.0) if len(args) > 1 else 1.0
            self._lora_add(str(v), mult, from_prompt=False)
        elif opt == "lora_clear":
            self.loras.clear()
        elif opt == "tensor_use_flags":
            c["tuflags"] = _int(v)
        elif opt == "vae_tile":
            c["vae_tile"] = _int(v)
        elif opt == "unet_split":
            c["unet_split"] = _bool(v)
        elif opt == "embed_dir":
            if str(v) != c["embed_dir"]:
                c["embed_dir"] = str(v)
                self._embeds_clear()
        elif opt == "t5":
            if str(v) != c["t5"]:
                c["t5"] = str(v)
                self._t5, self._t5_key = None, ""   # free the old encoder
        elif opt == "t5_tokenizer":
            c["t5_tokenizer"] = str(v)
        elif opt in ("clip", "vae"):
            c[opt] = str(v)     # a new file reloads the model (``setup``)
        elif opt == "t5_tokens":
            c["t5_tokens"] = _int(v, 77)
        elif opt == "slg_scale":
            # skip-layer guidance (``mlimgsynth_tpu/api.py:403-432``)
            f = _float(v)
            if f < 0:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "slg-scale must be >= 0")
            c["slg_scale"] = f
        elif opt == "slg_layers":
            # rejoined: ``option_set_str`` splits "7,8,9" into three values
            txt = ",".join(str(a) for a in args)
            try:
                layers = tuple(int(x) for x in txt.split(",") if x.strip())
            except ValueError:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"invalid slg-layers '{txt}'")
            if not layers:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "slg-layers must name at least one block")
            c["slg_layers"] = ",".join(str(x) for x in layers)
        elif opt in ("slg_start", "slg_end", "pag_start", "pag_end"):
            f = _float(v)
            if not 0.0 <= f <= 1.0:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"{opt} must be in [0, 1]")
            c[opt] = f
        elif opt == "cfg_rescale":
            # (``mlimgsynth_tpu/api.py:397-414``, ``:505-522``)
            f = _float(v)
            if not 0.0 <= f <= 1.0:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "cfg-rescale must be in [0, 1]")
            c["cfg_rescale"] = f
        elif opt == "pag_scale":
            f = _float(v)
            if f < 0:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "pag-scale must be >= 0")
            c["pag_scale"] = f
        elif opt == "subseed":
            c["subseed"] = _int(v, -1)
        elif opt == "subseed_strength":
            c["subseed_strength"] = _float(v, 0.0)
        elif opt == "deepcache":
            c["deepcache"] = _int(v, 0)
        elif opt == "freeu":
            # rejoined: ``option_set_str`` splits "B1,B2,S1,S2"
            c["freeu"] = ",".join(str(a) for a in args).strip()
            _freeu_parse(c["freeu"])    # a bad value fails here
        elif opt == "tiling":
            c["tiling"] = bool(_int(v, 0))
        elif opt == "mask_blur":
            c["mask_blur"] = _float(v, 0.0)
        elif opt == "inpaint_full_res":
            c["inpaint_full_res"] = _int(v, 0)
        elif opt == "inpaint_full_res_padding":
            c["inpaint_full_res_padding"] = _int(v, 32)
        elif opt in ("control_net", "upscaler", "hires_upscaler", "refiner"):
            # a new ControlNet or upscaler file loads on its next use
            c[opt] = str(v)
        elif opt == "control_image":
            self._control_image_set(v)
        elif opt == "control_strength":
            c["control_strength"] = _float(v, 1.0)
        elif opt == "hires_fix":
            c["hires_fix"] = _float(v, 0.0)
        elif opt == "hires_denoise":
            c["hires_denoise"] = _float(v, 0.7)
        elif opt == "hires_steps":
            c["hires_steps"] = _int(v, 0)
        elif opt == "refiner_switch":
            c["refiner_switch"] = _float(v, 0.8)
        elif opt in ("tp", "dp", "sp", "pp"):
            # a new mesh shape reloads the models, sharded for it
            # (``mlimgsynth_tpu/api.py:460-465``)
            n = max(1, _int(v, 1))
            if c[opt] != n:
                c[opt] = n
                self._loaded = ""
                self._t5, self._t5_key = None, ""

    def _control_image_set(self, t) -> None:
        """The ControlNet hint: uint8 [h,w,3] or float NCHW [n,3,h,w] in
        [0, 1]; None or "" clears it (``mlimgsynth_tpu/api.py:478-489``)."""
        if t is None or (isinstance(t, str) and t == ""):
            self.tensors["control_image"] = None
            return
        t = np.asarray(t)
        if t.dtype == np.uint8:
            t = image_mod.tensor_from_image_arr(t)
        t = np.asarray(t, np.float32)
        if t.ndim != 4 or t.shape[1] != 3:
            raise MlisError(MlisError.E_IMAGE,
                            "control image must be [n,3,h,w] or u8 hwc")
        self.tensors["control_image"] = t

    def _image_set(self, img) -> None:
        """uint8 [h,w,c] or float NCHW in [0, 1]; a 4th channel (alpha)
        becomes the mask (``_image_set``, ``mlimgsynth_tpu/api.py:771-786``).
        """
        img = np.asarray(img)
        if img.dtype == np.uint8:
            t = image_mod.tensor_from_image_arr(img)
        else:
            t = np.asarray(img, np.float32)
        if t.ndim != 4:
            raise MlisError(MlisError.E_IMAGE,
                            f"invalid image shape {t.shape}")
        if t.shape[1] == 4:
            rgb, mask = image_mod.image_alpha_split(t)
            self.tensors["mask"] = np.ascontiguousarray(mask)
            t = np.ascontiguousarray(rgb)
            self.c["tuflags"] |= TUF_MASK
        elif t.shape[1] != 3:
            raise MlisError(MlisError.E_IMAGE,
                            f"invalid number of channels: {t.shape[1]}")
        self.tensors["image"] = t
        self.c["tuflags"] |= TUF_IMAGE

    def _lora_find(self, name: str) -> str:
        """A LoRA file: ``name`` as a path, else ``NAME.safetensors`` under
        ``lora_dir``, then under ``aux_dir`` (``_lora_find``,
        ``mlimgsynth_tpu/api.py:637-650``)."""
        if os.path.exists(name):
            return name
        base = self.c["lora_dir"]
        path = (os.path.join(base, name + ".safetensors") if base
                else name + ".safetensors")
        if os.path.exists(path):
            return path
        aux = self._aux_find(path)
        if aux != path and os.path.exists(aux):
            return aux
        raise MlisError(MlisError.E_FILE_NOT_FOUND,
                        f"lora model file not found '{path}'")

    def _lora_add(self, name: str, mult: float, from_prompt: bool) -> None:
        self.loras.append((self._lora_find(name), mult, from_prompt))

    def option_set_str(self, name: str, value: Optional[str]) -> None:
        """Set an option from its string form, as the CLI does (the JAX
        package's ``option_set_str``): paths and text whole, other values
        split at commas (``image-dim 768,512``)."""
        opt = _id_norm(name)
        if opt not in _OPTIONS:
            raise MlisError(MlisError.E_UNK_OPT,
                            f"option '{name}' is not supported by the "
                            "PyTorch port")
        value = value if value is not None else ""
        if opt in _STR_OPTIONS:
            self.option_set(opt, value)
        elif opt in _OBJ_OPTIONS:
            raise MlisError(MlisError.E_OPT_VALUE,
                            f"option '{opt}' cannot be set with a string "
                            "value")
        else:
            self.option_set(opt, *_split_args(value))

    def option_get(self, name: str):
        """An option's value (``option_get``, ``mlimgsynth_tpu/api.py:
        580-589``): the model type's name ("none" when unset), the prompts'
        raw text, the seed; any other option its stored value, or None
        where the session keeps it under another name."""
        opt = _id_norm(name)
        if opt not in _OPTIONS:
            raise MlisError(MlisError.E_UNK_OPT, f"unknown option '{name}'")
        if opt == "model_type":
            return self.c["model_type"] or "none"
        if opt in ("prompt", "nprompt"):
            return self.c[opt + "_raw"]
        if opt == "seed":
            return self.rng.seed
        return self.c.get(opt)

    def _err(self, e: MlisError):
        """Record ``e`` and hand it to the error handler, then raise it
        (``_err``, ``mlimgsynth_tpu/api.py:841-849``)."""
        self.errstr = str(e)
        if self.error_handler is not None:
            self.error_handler(self, {"code": e.code, "desc": str(e)})
        raise e

    def _aux_find(self, path: str) -> str:
        """An auxiliary file (the TAE weights, a LoRA) that does not exist
        relative to the working directory is looked up under ``aux_dir``
        (the JAX package's ``_aux_find``)."""
        if path and not os.path.exists(path) and self.c["aux_dir"]:
            cand = os.path.join(self.c["aux_dir"], path)
            if os.path.exists(cand):
                return cand
        return path

    def _cb(self, stage: int, step: int, step_end: int) -> None:
        """Progress to the ``callback`` (the JAX package's ``_cb``)."""
        now = time.time()
        p = self.progress
        p["step_time"] = now - p.get("_t", now)
        p["_t"] = now
        p.update(stage=stage, step=step, step_end=step_end, nfe=self._nfe)
        if self.callback is not None and self.callback(self, dict(p)):
            raise Aborted("generation cancelled by callback")

    def text_tokenize(self, text: str) -> List[int]:
        """Token ids of ``text`` (the model type must be set, or a model
        file to detect it from)."""
        if self._mt is None:
            self.setup()
        return tok_mod.tokenize(text)

    def _parse_prompt_text(self, text: str, allow_loras: bool = True
                           ) -> prompt_mod.PromptText:
        """A prompt parsed without touching the session: prompt editing is
        probed first (the emphasis parser would read its colons as weights)
        and the fields hold the step-0 expansion, ``editing`` telling that
        ``generate`` expands it again per step
        (``mlimgsynth_tpu/api.py:596-610``, ``:2748-2760``).  A batch's
        negative prompts take no ``<lora:...>`` tag (``allow_loras``)."""
        if self.c["no_prompt_parse"]:
            return prompt_mod.prompt_set_raw(text)
        t0, edited = prompt_mod.expand_editing(text, 0, 1000)
        try:
            parsed = prompt_mod.prompt_set_parse(t0 if edited else text)
        except prompt_mod.PromptParseError as e:
            raise MlisError(MlisError.E_PROMPT_PARSE, str(e))
        parsed.editing = bool(edited)
        if parsed.loras and not allow_loras:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "<lora:...> tags are not supported in batched "
                            "negative prompts")
        return parsed

    def _prompt_set(self, key: str, text: str) -> None:
        """Parse a prompt; its ``<lora:NAME:MULT>`` tags join the LoRA list
        for one request, those of an earlier prompt leave it
        (``mlimgsynth_tpu/api.py:593-628``)."""
        self.c[key + "_raw"] = text
        parsed = self._parse_prompt_text(text)
        if not self.c["no_prompt_parse"]:
            if key == "prompt":
                self.loras = [l for l in self.loras if not l[2]]
            for name, mult in parsed.loras:
                self._lora_add(name, mult, from_prompt=True)
        setattr(self, key, parsed)

    # -- textual inversion (``mlimgsynth_tpu/api.py:658-770``) ---------------

    def _embeds_clear(self) -> None:
        if self._embeds:
            self._embeds.clear()
            self._embed_order.clear()
            self._embed_version += 1

    def _embed_find(self, name: str) -> str:
        """An embedding file: ``name`` as a path, else ``NAME.safetensors``
        then ``NAME.pt`` under ``embed_dir``, each also under ``aux_dir``."""
        if os.path.exists(name) and not os.path.isdir(name):
            return name
        base = self.c["embed_dir"]
        for ext in (".safetensors", ".pt"):
            path = os.path.join(base, name + ext) if base else name + ext
            if os.path.exists(path):
                return path
            aux = self._aux_find(path)
            if aux != path and os.path.exists(aux):
                return aux
        raise MlisError(MlisError.E_FILE_NOT_FOUND,
                        f"embedding file not found '{name}'")

    @staticmethod
    def _embed_read_tables(path: str) -> Dict[str, np.ndarray]:
        """An embedding file -> {"clip": f32 [k, d]} and/or {"clip2": f32
        [k, d2]}: safetensors with ``emb_params`` (A1111, one encoder) or
        ``clip_l`` / ``clip_g`` (SDXL), or a torch ``.pt`` with
        ``string_to_param`` (or ``emb_params``), read with
        ``weights_only``."""
        tables: Dict[str, np.ndarray] = {}
        if path.endswith(".pt"):
            try:
                obj = torch.load(path, map_location="cpu", weights_only=True)
            except Exception as e:
                raise MlisError(MlisError.E_UNKNOWN,
                                f"embedding '{path}' unreadable: {e}")
            stp = obj.get("string_to_param") if isinstance(obj, dict) \
                else None
            t = None
            if isinstance(stp, dict) and stp:
                t = next(iter(stp.values()))
            elif isinstance(obj, dict) and "emb_params" in obj:
                t = obj["emb_params"]
            if not isinstance(t, torch.Tensor):
                raise MlisError(MlisError.E_UNKNOWN,
                                f"unrecognized embedding layout '{path}'")
            tables["clip"] = t.detach().float().numpy()
        else:
            st = TensorStore.open(path)
            try:
                names = set(st.names())
                for key, sub in (("emb_params", "clip"), ("clip_l", "clip"),
                                 ("clip_g", "clip2")):
                    if key in names:
                        tables[sub] = np.array(st.read(key, "f32"))
                if not tables:
                    raise MlisError(
                        MlisError.E_UNKNOWN,
                        f"unrecognized embedding layout '{path}' "
                        f"(keys: {sorted(names)[:8]})")
            finally:
                st.close()
        return {k: np.atleast_2d(np.asarray(t, np.float32))
                for k, t in tables.items()}

    def _embed_token_ids(self, name: str) -> List[int]:
        """The token ids of a named embedding, read and registered on its
        first use: one table per text tower of the model, each of the
        tower's width, all of one vector count."""
        reg = self._embeds.get(name)
        if reg is not None:
            return reg["ids"]
        path = self._embed_find(name)
        tables = self._embed_read_tables(path)
        mt = self._mt
        need = ["clip"] + (["clip2"] if mt.clip2_p is not None else [])
        for sub in need:
            P = mt.clip_p if sub == "clip" else mt.clip2_p
            t = tables.get(sub)
            if t is None:
                raise MlisError(
                    MlisError.E_UNKNOWN,
                    f"embedding '{name}' has no table for {sub} "
                    f"(model type {self.c['model_type']})")
            if t.shape[1] != P.d_embed:
                raise MlisError(
                    MlisError.E_UNKNOWN,
                    f"embedding '{name}' {sub} width {t.shape[1]} != "
                    f"model d_embed {P.d_embed}")
        ks = {tables[sub].shape[0] for sub in need}
        if len(ks) != 1:
            raise MlisError(MlisError.E_UNKNOWN,
                            f"embedding '{name}' per-encoder vector counts "
                            f"differ: {sorted(ks)}")
        base = mt.clip_p.n_vocab + sum(len(self._embeds[n]["ids"])
                                       for n in self._embed_order)
        ids = list(range(base, base + ks.pop()))
        self._embeds[name] = {"ids": ids,
                              "tables": {sub: tables[sub] for sub in need}}
        self._embed_order.append(name)
        self._embed_version += 1
        log.info(f"embedding '{name}': {len(ids)} vector(s) from {path}")
        return ids

    def _embed_rows(self, prefix: str) -> Optional[np.ndarray]:
        """The rows appended to the token table of the tower at ``prefix``,
        in id order (None without embeddings)."""
        if not self._embed_order:
            return None
        sub = prefix.split(".")[0]
        return np.concatenate([self._embeds[n]["tables"][sub]
                               for n in self._embed_order])

    def _embeds_sync(self) -> None:
        """Reload the text towers when the embedding registry changed since
        they loaded, so that their token tables hold its rows (the JAX
        session drops its cached tower parameters, ``api.py:757-759``)."""
        stale = {p for p in _TOWERS if p in self._models
                 and self._towers_embeds.get(p) != self._embed_version}
        if stale:
            self._load_model(self.c["model"], self._lora_state, only=stale)

    # -- setup --------------------------------------------------------------

    def _device_resolve(self) -> None:
        """A ``late_device`` session's device, from ``backend``: the CPU
        for ``cpu``, else the card (``MlisError`` without one); the compute
        type follows it."""
        dev = _BACKENDS[self.c["backend"].strip().lower()] or "cuda"
        if dev == "cuda" and not torch.cuda.is_available():
            raise MlisError(MlisError.E_UNKNOWN,
                            "no CUDA device found; set the backend option "
                            "to cpu to run on the CPU")
        self.device = torch.device(dev)
        wt = self.c["weight_type"] if self._wtype_set else ""
        self.dtype = (_WEIGHT_TYPES[wt][0] if wt else None) \
            or self._default_dtype()
        self._late_device = False

    @_locked
    def setup(self) -> None:
        """Load the model onto the session's device (once per model file,
        weight type and device) with the current LoRAs merged, and the TAE
        where the ``tae`` option names one (the VAE encoder loads on the
        first ``image_encode``).  A changed LoRA list reloads the modules
        that the old list or the new one patches, from the file, so no
        merge outlives its list.  Under ``unet_split`` the text encoders
        and the denoiser load to the host and go to the device for their
        stage only (:meth:`_stage_in`); with the option off, every module
        is on the device after ``setup``."""
        if self._late_device:
            self._device_resolve()
        self._mesh_resolve()
        path = self.c["model"]
        if not path:
            raise MlisError(MlisError.E_UNKNOWN, "No model file set")
        key = (f"{path}|{self.c['clip']}|{self.c['vae']}|{self.dtype}|"
               f"{self.qbits if self._wtype_set else 'file'}|{self.device}")
        loras = tuple((p, m) for p, m, _ in self.loras)
        if self._loaded != key:
            self._models, self._encoders = {}, {}
            self._host, self.resident = {}, set()
            self._cnet_loaded = ""
            self._embeds_clear()     # token ids and widths are per model
            self._load_model(path, loras)
            self._loaded = key
            self._tae_loaded = ""
        elif loras != self._lora_state:
            old = self._lora_prefixes
            self._load_model(path, loras, reload=True)
            log.info(f"LoRA list changed: reloaded "
                     f"{', '.join(sorted(old | self._lora_prefixes))} "
                     f"{{{self.times['load_s']:.3f}s}}")
        if not self.c["unet_split"]:
            for prefix in list(self._host):
                self._stage_in(prefix)
            self._host.clear()
        tae = self._aux_find(self.c["tae"])
        if tae and self._tae_loaded != tae:
            self._load_tae(tae)
            self._tae_loaded = tae
        cnet = self._aux_find(self.c["control_net"])
        if cnet != self._cnet_loaded:
            self._models.pop("cnet.", None)
            self.resident.discard("cnet.")
            self._cnet_loaded = ""
            if cnet:
                self._load_cnet(cnet)
                self._cnet_loaded = cnet

    def _mesh_resolve(self) -> None:
        """The ranks' mesh for the options tp, dp, sp and pp
        (``_backend_init``, ``mlimgsynth_tpu/api.py:881-909``): none when
        their product is 1; else the default process group (joined here
        from torchrun's environment where it is not up yet) must hold
        that many ranks, or ``MlisError`` names the torchrun line.  A rank
        on a card takes ``cuda:{local_rank % device_count}``."""
        c = self.c
        tp, dp, sp, pp = c["tp"], c["dp"], c["sp"], c["pp"]
        if pp > 1 and (tp > 1 or dp > 1 or sp > 1):
            raise MlisError(MlisError.E_OPT_VALUE,
                            "--pp does not compose with --tp/--dp/--sp yet; "
                            "use pp alone")
        if tp > 1 and self.qbits and self._wtype_set:
            self._tp_quant_error()
        if tp * dp * sp * pp == 1:
            self._mesh = None
            return
        want = {pmesh.DP_AXIS: dp, pmesh.PP_AXIS: pp, pmesh.SP_AXIS: sp,
                pmesh.TP_AXIS: tp}
        if self._mesh is not None and self._mesh.shape == want:
            return
        comm.init(self.device.type)
        self._mesh = pmesh.Mesh(tp=tp, dp=dp, sp=sp, pp=pp)
        if self.device.type == "cuda":
            self.device = torch.device(
                "cuda", comm.local_rank() % torch.cuda.device_count())
            torch.cuda.set_device(self.device)
        log.info(f"Mesh: dp={dp} pp={pp} sp={sp} tp={tp} over "
                 f"{self._mesh.world} ranks, this one {self._mesh.rank} on "
                 f"{self.device} ({comm.transport()})")

    @staticmethod
    def _tp_quant_error():
        """tp with a quantized weight type: the JAX package leaves its
        ``_q8`` weights whole on every device (no tp rule names them) and
        splits only their biases, which the explicit head split here does
        not reproduce."""
        raise MlisError(MlisError.E_OPT_VALUE,
                        "tp > 1 with a quantized weight type is not ported "
                        "(the quantized linears are not split over tp); "
                        "use a float weight type, or dp, sp or pp")

    def _pp_stage(self) -> pipe.Stage:
        """This rank's stage of the denoiser under pp, after the JAX
        session's checks (``api.py:1286-1301``)."""
        P = self._mt.unet_p
        pp = self.c["pp"]
        if not getattr(P, "flow", False):
            raise MlisError(MlisError.E_OPT_VALUE,
                            "--pp is currently supported for MMDiT "
                            "(SD3-family) and Flux models")
        if getattr(P, "x_self_attn_layers", ()):
            raise MlisError(MlisError.E_OPT_VALUE,
                            "--pp needs a uniform block stack; MMDiT-X "
                            "(SD3.5-medium) dual-attention blocks are not "
                            "stackable")
        if not getattr(P, "flux", False) and P.depth % pp:
            raise MlisError(MlisError.E_OPT_VALUE,
                            f"--pp {pp} must divide the block count "
                            f"({P.depth})")
        mesh = self._mesh
        return pipe.Stage(mesh.index(pmesh.PP_AXIS), pp,
                          mesh.ranks(pmesh.PP_AXIS),
                          mesh.group(pmesh.PP_AXIS))

    def _shard(self, m, prefix: str, params):
        """``params`` of the module ``m`` at ``prefix`` cut to this
        rank's tp share (``m`` made that share too), where the mesh has
        tp > 1 and the module takes it."""
        mesh = self._mesh
        if (mesh is None or mesh.size(pmesh.TP_AXIS) == 1
                or prefix not in _TP_MODELS):
            return params
        return tpar.shard(m, prefix, params, mesh.size(pmesh.TP_AXIS),
                          mesh.index(pmesh.TP_AXIS),
                          mesh.group(pmesh.TP_AXIS))

    def _load_cnet(self, path: str) -> None:
        """The ControlNet of ``control_net`` onto the device, beside the
        UNet (never staged to the host), in the session's dtype and, under
        a quantized weight type, with its linears quantized: its own file,
        its names through ``normalize_cnet_name`` (the CompVis
        ``control_model.*`` or the diffusers layout;
        ``mlimgsynth_tpu/api.py:966-972``, ``:1024-1037``)."""
        if not os.path.exists(path):
            raise MlisError(MlisError.E_FILE_NOT_FOUND,
                            f"control-net file not found "
                            f"'{self.c['control_net']}'")
        if self._flow():
            raise MlisError(MlisError.E_OPT_VALUE,
                            "control-net applies to the SD UNet families "
                            "only")
        t0 = time.time()
        store = TensorStore.open(path)
        err = None
        try:
            name_map: Dict[str, weights_mod.NameRef] = {}
            for raw in store.tensors:
                r = normalize_cnet_name(raw)
                if r is not None:
                    name_map.setdefault(r, weights_mod.NameRef(raw))
            if not name_map:
                raise MlisError(MlisError.E_UNKNOWN,
                                "no ControlNet tensors recognized in "
                                f"'{self.c['control_net']}'")
            m = build_controlnet(self._mt)
            try:
                params = weights_mod.load_params(
                    store, name_map, weights_mod.module_shapes(m, "cnet."),
                    self.device, self.dtype)
            except (KeyError, ValueError) as e:
                # raised once the store is closed
                err = MlisError(MlisError.E_UNKNOWN,
                                f"control-net '{path}': {e}")
            else:
                params = self._shard(m, "cnet.", params)
                if self.qbits:
                    weights_mod.quantize_linear_weights(m, "cnet.", params,
                                                        self.qbits, None)
                self._models["cnet."] = weights_mod.load_module(
                    m, "cnet.", params).eval()
                self.resident.add("cnet.")
        finally:
            store.close()
        if err is not None:
            raise err
        self.times["cnet_load_s"] = time.time() - t0
        log.info(f"ControlNet loaded on {self.device}: {len(name_map)} "
                 f"tensors {{{self.times['cnet_load_s']:.3f}s}}")

    def _stage_in(self, prefix: str) -> None:
        """Put the weights of the staged module at ``prefix`` on the device
        (a copy of its host state; ``times["move_in_<module>_s"]``, the copy
        waited for).  A module already there stays."""
        if prefix in self.resident:
            return
        t0 = time.time()
        weights_mod.load_module(
            self._models[prefix], prefix,
            {k: v.to(self.device, non_blocking=True)
             for k, v in self._host[prefix].items()})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.resident.add(prefix)
        self.times[f"move_in_{prefix.split('.')[0]}_s"] = \
            time.time() - t0

    def _stage_out(self, prefix: str) -> None:
        """Take the staged module at ``prefix`` off the device: it holds
        its host state again (made from the device copy where the module
        loaded before ``unet_split`` was set) and no tensor of it is left
        on the card, whose cached blocks ``empty_cache`` frees
        (``times["move_out_<module>_s"]``)."""
        if prefix not in self.resident:
            return
        t0 = time.time()
        m = self._models[prefix]
        if prefix not in self._host:
            self._host[prefix] = {prefix + k: self._pin(v)
                                  for k, v in m.state_dict().items()}
        weights_mod.load_module(m, prefix, self._host[prefix])
        self.resident.discard(prefix)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.times[f"move_out_{prefix.split('.')[0]}_s"] = \
            time.time() - t0

    def _pin(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t`` (on the host or the device), in page-locked
        memory where the session runs on a card, so that its copy to the
        card is one DMA at the bus's rate."""
        if self.device.type != "cuda":
            return t.to("cpu")
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)

    def _load_tae(self, path: str) -> None:
        """The TAE decoder, and its encoder where the file holds one, from
        its own taesd file (``mlimgsynth_tpu/api.py:942-976``,
        ``:1164-1181``); its latent width must be the model family's."""
        if not os.path.exists(path):
            raise MlisError(MlisError.E_FILE_NOT_FOUND,
                            f"tae file not found '{path}'")
        m = weights_mod.load_tae(path, self.device, self.dtype)
        if m.P.ch_z != self._mt.vae_p.ch_z:
            raise MlisError(
                MlisError.E_IMAGE,
                f"TAE latent channels ({m.P.ch_z}) do not match the model "
                f"family's ({self._mt.vae_p.ch_z}) - e.g. taesd is for SD, "
                "taesd3 for SD3")
        self._models["tae."] = m
        self.resident.add("tae.")
        enc = weights_mod.load_tae(path, self.device, self.dtype,
                                   encoder=True)
        self._encoders.pop("tae.", None)
        if enc is not None:
            self._encoders["tae."] = enc
        log.info(f"TAE loaded: {path} ({m.P})")

    def _load_model(self, path: str, loras, reload: bool = False,
                    encoders: bool = False, only=None) -> None:
        """Load modules from the model file with ``loras`` ((path,
        multiplier) pairs) merged on the host first: every txt2img module,
        or (``reload``) those that the loaded list or ``loras`` patches, or
        (``encoders``) the VAE encoder, or the modules at the prefixes
        ``only``.  A text tower's token table takes the rows of the
        registered embeddings (``mlimgsynth_tpu/api.py:1220-1227``)."""
        if not os.path.exists(path):
            raise MlisError(MlisError.E_FILE_NOT_FOUND,
                            f"model file not found '{path}'")
        t0 = time.time()
        store = TensorStore.open(path)
        try:
            name_map = self._name_map(store)
            if not (reload or encoders or only):
                self._bundled_t5 = "t5.shared.weight" in name_map
                types = _model_types()
                mt = weights_mod.identify_model(
                    store, name_map,
                    {d.unet_p.n_ctx: k for k, d in types.items()})
                if mt is None and self._mt is None:
                    raise MlisError(MlisError.E_UNKNOWN,
                                    "could not detect the model type")
                if self._mt is None:
                    self._option_set("model_type", mt)
                if not self._wtype_set:
                    # the file's weight type, where its tensors are
                    # quantized (a GGUF q8_0 or q4_*: ``api.py:1066-1068``);
                    # float files keep the device's compute type
                    ft = weights_mod.stored_type(store, name_map)
                    self.qbits = _WEIGHT_TYPES.get(ft, (None, 0))[1]
                if self.qbits and self.c["tp"] > 1:
                    self._tp_quant_error()
                # an inpaint-variant UNet (sd-v1-5-inpainting: 9 input
                # channels) takes its input width from the checkpoint
                # (``api.py:1053-1066``)
                ref = name_map.get("unet.in.conv.weight")
                if ref is not None and not self._flow():
                    n_in = int(store.tensors[ref.raw].shape[1])
                    if n_in != self._mt.unet_p.n_ch_in:
                        self._mt = dataclasses.replace(
                            self._mt, unet_p=dataclasses.replace(
                                self._mt.unet_p, n_ch_in=n_in))
                        log.info(f"UNet input channels: {n_in} "
                                 "(inpaint-variant model)")
            models = (build_encoders if encoders else build_models)(self._mt)
            touched = self._lora_touched(name_map, loras, list(models))
            if reload:
                want = self._lora_prefixes | touched
                models = {k: m for k, m in models.items() if k in want}
                if "vae." in want:     # the encoder reloads on demand
                    self._encoders.pop("vae.", None)
            elif only is not None:
                models = {k: m for k, m in models.items() if k in only}
            t1 = time.time()
            self._lora_merge(store, name_map, loras, tuple(models))
            if not (encoders or only):
                self.times["lora_merge_s"] = time.time() - t1
            # the DiT families store some 8-bit weights per column, decided
            # for the session's image size: tokens and 256 context rows,
            # doubled for the CFG batch but on Flux (``api.py:1229-1247``)
            m_hint = (dit_m_hint(self.c["height"] or 1024,
                                 self.c["width"] or 1024,
                                 flux=self._denoiser() == "flux.")
                      if self._flow() else None)
            target = self._encoders if encoders else self._models
            n_q, err = 0, None
            for prefix, m in models.items():
                target.pop(prefix, None)   # free the old copy first
                # read to the device and cast (and quantize) there, or, for
                # a module staged on the host, read to the host and cast
                # (and quantize) there
                staged = (self.c["unet_split"] and prefix in _STAGED
                          and not encoders)
                if (self._mesh is not None and self.c["pp"] > 1
                        and prefix == self._denoiser() and not encoders):
                    # this rank reads its stage's blocks only (the
                    # checks first: a UNet has no stages)
                    stage = self._pp_stage()
                    m.set_stage(stage)
                try:
                    params = weights_mod.load_params(
                        store, name_map, weights_mod.module_shapes(m, prefix),
                        "cpu" if staged else self.device, self.dtype)
                except KeyError as e:
                    # raised once the store is closed; a model that ships
                    # as components takes its text tower and its VAE from
                    # the ``clip`` and ``vae`` files
                    err = MlisError(MlisError.E_UNKNOWN,
                                    f"{prefix[:-1]}: {e.args[0]} (a model "
                                    "file without a text encoder or VAE "
                                    "needs the clip and vae options)")
                    break
                if prefix in _TOWERS:
                    self._grow_token_table(m, prefix, params)
                params = self._shard(m, prefix, params)
                if self.qbits:
                    n_q += weights_mod.quantize_linear_weights(
                        m, prefix, params, self.qbits,
                        m_hint if prefix == self._denoiser() else None)
                if encoders:     # the VAE encoder stays on the device
                    params = {k: v.to(self.device)
                              for k, v in params.items()}
                elif staged:
                    # on the host until its stage
                    params = {k: self._pin(v) for k, v in params.items()}
                    self._host[prefix] = params
                    self.resident.discard(prefix)
                else:
                    params = {k: v.to(self.device)
                              for k, v in params.items()}
                    self._host.pop(prefix, None)
                    self.resident.add(prefix)
                target[prefix] = weights_mod.load_module(
                    m, prefix, params).eval()
        finally:
            store.close()
        if err is not None:
            raise err
        if not (encoders or only):
            self._lora_state = tuple(loras)
            self._lora_prefixes = touched
        secs = time.time() - t0
        self.times["encoder_load_s" if encoders
                   else "embed_reload_s" if only else "load_s"] = secs
        quant = f", {n_q} linears in int{self.qbits}" if n_q else ""
        what = ("VAE encoder" if encoders
                else ", ".join(models) if reload or only
                else f"Model {self.c['model_type']}")
        log.info(f"{what} loaded on {self.device} ({self.dtype}{quant}, "
                 f"{len(loras)} LoRAs) {{{secs:.3f}s}}")

    def _name_map(self, store: TensorStore) -> Dict[str, weights_mod.NameRef]:
        """Internal name -> entry of the model file ``store``, with the
        ``clip`` and ``vae`` files read into the store under their prefixes
        and mapped (``mlimgsynth_tpu/api.py:949-1022``): a name the model
        file maps stays its own.  A file that maps no tensor raises."""
        name_map = weights_mod.build_name_map(store)
        for opt, (prefix, transform) in _AUX_FILES.items():
            if not self.c[opt]:
                continue
            p = self._aux_find(self.c[opt])
            if not os.path.exists(p):
                raise MlisError(MlisError.E_FILE_NOT_FOUND,
                                f"{opt} file not found '{self.c[opt]}'")
            store.read_file(p, prefix=prefix)
            n = weights_mod.merge_prefixed(name_map, store, prefix, transform)
            if not n:
                raise MlisError(MlisError.E_UNKNOWN,
                                f"no {opt.upper()} tensors recognized in "
                                f"'{self.c[opt]}'")
            log.debug(f"{opt} file: {n} tensors mapped")
        return name_map

    def _grow_token_table(self, m, prefix: str,
                          params: Dict[str, torch.Tensor]) -> None:
        """Append the registered embeddings' rows to the token table in
        ``params`` of the tower ``m`` at ``prefix`` (on the meta device,
        its table then made as tall), in the table's dtype; record the
        registry version the tower holds."""
        rows = self._embed_rows(prefix)
        if rows is not None:
            key = prefix + "embed.token.weight"
            tw = params[key]
            params[key] = torch.cat([tw, torch.from_numpy(rows).to(
                tw.device, tw.dtype)])
            with torch.device("meta"):
                m.embed.token = torch.nn.Embedding(*params[key].shape)
        self._towers_embeds[prefix] = self._embed_version

    def _lora_touched(self, name_map, loras, prefixes) -> set:
        """The module prefixes among ``prefixes`` whose weights ``loras``
        patch, from the LoRA files' tensor names."""
        out = set()
        for path, _ in loras:
            lstore = TensorStore.open(path)
            try:
                names = weights_mod.lora_targets(name_map, lstore)
            finally:
                lstore.close()
            out |= {p for p in prefixes for n in names if n.startswith(p)}
        return out

    def _lora_merge(self, store, name_map, loras, prefixes) -> None:
        """Merge ``loras`` into ``store``'s cache, for the weights of the
        modules at ``prefixes`` (``_loras_apply``,
        ``mlimgsynth_tpu/api.py:1071-1093``)."""
        for path, mult in loras:
            lstore = TensorStore.open(path)
            err = None
            try:
                n = weights_mod.lora_apply(
                    store, name_map, lstore, mult,
                    only=lambda name: name.startswith(prefixes))
            except FloatingPointError as e:
                err = MlisError(MlisError.E_NAN, str(e))
            except KeyError as e:
                err = MlisError(MlisError.E_UNKNOWN, f"lora '{path}': {e}")
            # raised once the failed merge's frames, which hold views of
            # the mapped files, are gone, so that the files can close
            lstore.close()
            if err is not None:
                raise err
            log.debug(f"lora '{path}' patched {n} tensors")

    def _flow(self) -> bool:
        return bool(getattr(self._mt.unet_p, "flow", False))

    def _denoiser(self) -> str:
        """The prefix of the denoiser module: ``unet.``, ``mmdit.`` (the
        SD3 family) or ``flux.``."""
        if getattr(self._mt.unet_p, "flux", False):
            return "flux."
        return "mmdit." if self._flow() else "unet."

    # -- generation ---------------------------------------------------------

    def _prompt_tokens(self, pt: prompt_mod.PromptText
                       ) -> Tuple[List[int], List[float]]:
        """The token stream and emphasis weights of a parsed prompt; an
        embedding's marker chunk gives its ids (``_prompt_tokens``,
        ``mlimgsynth_tpu/api.py:1486-1502``)."""
        toks: List[int] = []
        wts: List[float] = []
        for text, w in (pt.chunks or [(pt.text, 1.0)]):
            if text == prompt_mod.BREAK_MARK:
                t = [tok_mod.BREAK_TOKEN]
            elif text.startswith(prompt_mod.EMBED_MARK):
                t = self._embed_token_ids(text[len(prompt_mod.EMBED_MARK):])
            else:
                t = tok_mod.tokenize(text)
            toks.extend(t)
            wts.extend([w] * len(t))
        return toks, wts

    def _n_window(self, P: tok_mod.ClipParams, raw) -> int:
        """The encoder windows shared by a batch of token streams: the
        longest's (``_window_count``); flow models condition on one."""
        if self._flow():
            return 1
        return max(len(tok_mod.split_windows(P, t, w)[0]) for t, w in raw)

    def _encode_tower(self, prefix: str, P: tok_mod.ClipParams, raw,
                      want_feat: bool, n_win: int):
        """One batched encode of token streams ``raw`` by the tower at
        ``prefix``, in ``n_win`` windows each, emphasis weights applied
        (ref: ``_clip_encode_rows``, mlis_clip_tokens_encode).  Returns
        (hidden f32, pooled feature or None)."""
        toks, wmat, fidx = [], [], []
        for t, w in raw:
            wins, wrows, f0 = tok_mod.split_windows(P, t, w, n_window=n_win)
            toks.append(wins[:n_win])
            wmat.append(np.concatenate(wrows[:n_win]))
            fidx.append(f0)
        tokens = torch.as_tensor(np.asarray(toks, np.int64),
                                 device=self.device)
        emb, feat = self._models[prefix].encode_windows(
            tokens, self.c["clip_skip"], self._mt.unet_p.clip_norm,
            torch.as_tensor(fidx, device=self.device) if want_feat else None)
        w = torch.as_tensor(np.asarray(wmat, np.float32), device=self.device)
        return emb.float() * w[:, :, None], feat

    @_locked
    @torch.no_grad()
    def clip_text_encode(self, text: str, submodel: str = "clip",
                         want_feat: bool = False, norm: bool = True):
        """The text tower ``submodel`` ("clip" or "clip2") on ``text`` as
        raw text, no emphasis: (embeddings f32 [1, W*n_token, d], the
        pooled feature f32 [1, d] or None); at the session's clip skip, or
        the whole stack with ``want_feat`` (``clip_text_encode``,
        ``mlimgsynth_tpu/api.py:1546-1553``).  A feature of a tower
        without a projection raises ``KeyError`` as the JAX session's
        missing ``text_proj`` does (but Flux's, which is unprojected)."""
        self.setup()
        prefix = submodel + ".text."
        if prefix not in _TOWERS or prefix not in self._models:
            raise MlisError(MlisError.E_OPT_VALUE,
                            f"no text tower '{submodel}' in model type "
                            f"{self.c['model_type']}")
        tower = self._models[prefix]
        flux = getattr(self._mt.unet_p, "flux", False)
        if want_feat and not flux and not hasattr(tower, "text_proj"):
            raise KeyError(prefix + "text_proj")
        P = self._mt.clip_p if submodel == "clip" else self._mt.clip2_p
        toks, _ = self._prompt_tokens(prompt_mod.prompt_set_raw(text))
        self._embeds_sync()
        self._stage_in(prefix)
        n_win = self._n_window(P, [(toks, None)])
        wins, _, f0 = tok_mod.split_windows(P, toks, None,
                                            n_window=n_win)
        tokens = torch.as_tensor(np.asarray([wins[:n_win]], np.int64),
                                 device=self.device)
        emb, feat = self._models[prefix].encode_windows(
            tokens, 0 if want_feat else self.c["clip_skip"], norm,
            torch.as_tensor([f0], device=self.device) if want_feat
            else None)
        return (emb.float().cpu().numpy(),
                None if feat is None else feat.float().cpu().numpy())

    @torch.no_grad()
    def _text_cond(self, pts: List[prompt_mod.PromptText],
                   chunk: Optional[int] = None, n_uncond: int = 0
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(cond, label) rows for several prompts, encoded in batches of
        ``chunk`` rows (default: all at once; a short last batch filled
        with its last row), every row in the same windows.  The text towers come onto the device first (reloaded if
        the prompts registered an embedding).  SD3
        (``api.py:1705-1721``): both towers' skip hiddens concatenated on
        features, zero-padded to the T5 width, then the T5 context's rows
        (:meth:`_t5_rows`); the label is the two pooled features
        concatenated.  SDXL (``api.py:1722-1736``): the two skip hiddens
        concatenated on features; the label is bigG's pooled projected
        feature (from the same pass as its skip hidden) and the size
        embeddings of ``[h, w, 0, 0, h, w]``, 256 each.  The SDXL refiner
        (``api.py:1738-1752``): its one tower's skip hidden; the label is its
        pooled projected feature and the embeddings of ``[h, w, 0, 0,
        score]``, the score ``AESTHETIC_NSCORE`` on the last ``n_uncond``
        rows (the negative prompts) and ``AESTHETIC_SCORE`` on the
        others."""
        raw = [self._prompt_tokens(pt) for pt in pts]
        self._embeds_sync()
        for prefix in _TOWERS:
            if prefix in self._models:
                self._stage_in(prefix)
        mt = self._mt
        chunk = chunk or len(raw)

        def encode(prefix, P, want_feat):
            # a short last batch repeats its last row, so that every
            # batch has the same rows
            n_win = self._n_window(P, raw)
            parts = []
            for i in range(0, len(raw), chunk):
                rows = raw[i:i + chunk]
                parts.append(self._encode_tower(
                    prefix, P, rows + rows[-1:] * (chunk - len(rows)),
                    want_feat, n_win))
            n = len(raw)
            return (torch.cat([e for e, _ in parts])[:n],
                    torch.cat([f for _, f in parts])[:n] if want_feat
                    else None)

        if not self._flow():
            single = _single_label(mt)
            emb1, feat = encode("clip.text.", mt.clip_p, single)
            if not mt.unet_p.cond_label:
                return emb1, None
            if single:
                h, w, n = self.c["height"], self.c["width"], len(pts)
                sizes = torch.tensor(
                    [[h, w, 0, 0, unet_mod.AESTHETIC_NSCORE
                      if i >= n - n_uncond else unet_mod.AESTHETIC_SCORE]
                     for i in range(n)], dtype=torch.float32,
                    device=self.device)
                se = blocks_mod.timestep_embedding(sizes.reshape(-1), 256)
                return emb1, torch.cat([feat.float(), se.reshape(n, -1)],
                                       dim=-1)
            emb2, feat = encode("clip2.text.", mt.clip2_p, True)
            h, w = self.c["height"], self.c["width"]
            sizes = torch.tensor([h, w, 0, 0, h, w], dtype=torch.float32,
                                 device=self.device)
            se = blocks_mod.timestep_embedding(sizes, 256).reshape(1, -1)
            return (torch.cat([emb1, emb2], dim=-1),
                    torch.cat([feat.float(), se.expand(len(pts), -1)],
                              dim=-1))
        if getattr(mt.unet_p, "flux", False):
            # Flux (``api.py:1699-1704``): the context is T5's rows alone
            # (zero rows of CLIP's length without T5), the label CLIP-L's
            # unprojected pooled row
            feat = encode("clip.text.", mt.clip_p, True)[1]
            return self._t5_rows(pts, mt.unet_p.d_ctx_in), feat
        emb1, feat1 = encode("clip.text.", mt.clip_p, True)
        emb2, feat2 = encode("clip2.text.", mt.clip2_p, True)
        d_ctx = mt.unet_p.d_ctx_in
        clip_part = torch.cat([emb1, emb2], dim=-1)
        clip_part = torch.nn.functional.pad(
            clip_part, (0, d_ctx - clip_part.shape[-1]))
        return (torch.cat([clip_part, self._t5_rows(pts, d_ctx)], dim=1),
                torch.cat([feat1, feat2], dim=-1))

    # -- T5 (``mlimgsynth_tpu/api.py:944-996``, ``:1188-1231``, ``:1759-1791``)

    def _t5_rows(self, pts: List[prompt_mod.PromptText],
                 d_ctx: int) -> torch.Tensor:
        """f32 [len(pts), rows, d_ctx] T5 context rows of the prompts'
        texts: the encoder's output on ``t5_tokens`` tokens, zero-padded to
        ``d_ctx``, where T5 weights (the ``t5`` file, or bundled in the
        model file) and a ``t5_tokenizer`` are given; else zero rows of the
        CLIP token length (the public SD3 pipelines' mode without T5)."""
        c = self.c
        have = bool(c["t5"]) or self._bundled_t5
        if not have or not c["t5_tokenizer"]:
            if have:
                log.warning("T5 weights present but no t5-tokenizer set; "
                            "using zero T5 context rows")
            return torch.zeros(len(pts), self._mt.clip_p.n_token, d_ctx,
                               device=self.device)
        self._t5_load()
        toks = t5_mod.tokenize([pt.text for pt in pts],
                               n_token=int(c["t5_tokens"] or 77),
                               tokenizer_json=self._aux_find(
                                   c["t5_tokenizer"]))
        t0 = time.time()
        emb = self._t5(torch.as_tensor(toks, dtype=torch.long,
                                       device=self.device)).float()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times["t5_encode_s"] = time.time() - t0
        return torch.nn.functional.pad(emb, (0, d_ctx - emb.shape[-1]))

    def _t5_load(self) -> None:
        """Load the T5 encoder onto the device in the compute dtype (never
        quantized, as in the JAX session), from the ``t5`` file (its names
        bare or under ``text_encoders.t5xxl.`` / ``transformer.``) or from
        the model file's ``text_encoders.t5xxl.*``; the geometry from the
        tensor shapes.  Once per source file, dtype and device."""
        c = self.c
        src = self._aux_find(c["t5"]) if c["t5"] else c["model"]
        key = f"{src}|{self.dtype}|{self.device}"
        if self._t5 is not None and self._t5_key == key:
            return
        self._t5 = None
        if not os.path.exists(src):
            raise MlisError(MlisError.E_FILE_NOT_FOUND,
                            f"t5 file not found '{c['t5']}'")
        t0 = time.time()
        store = TensorStore.open(src)
        err = None
        try:
            if c["t5"]:
                name_map = {}
                for raw in store.tensors:
                    t = raw
                    for pre in _T5_FILE_PREFIXES:
                        if t.startswith(pre):
                            t = t[len(pre):]
                    name_map.setdefault("t5." + t, weights_mod.NameRef(raw))
            else:
                name_map = {n: r for n, r in
                            weights_mod.build_name_map(store).items()
                            if n.startswith("t5.")}
            shapes = {n: tuple(store.tensors[r.raw].shape)
                      for n, r in name_map.items() if r.split is None}
            try:
                P = t5_mod.params_from_spec_shapes(shapes)
            except KeyError as e:
                raise MlisError(MlisError.E_UNKNOWN,
                                f"no T5 tensors recognized in '{src}' "
                                f"(missing {e})")
            with torch.device("meta"):
                m = t5_mod.T5Encoder(P)
            try:
                params = weights_mod.load_params(
                    store, name_map, weights_mod.module_shapes(m, "t5."),
                    self.device, self.dtype)
            except (KeyError, ValueError) as e:
                # raised once the failed read's frames, which hold views of
                # the mapped file, are gone, so that the file can close
                err = MlisError(MlisError.E_UNKNOWN, f"T5 '{src}': {e}")
            else:
                params = self._shard(m, "t5.", params)
                self._t5 = weights_mod.load_module(m, "t5.", params).eval()
        finally:
            store.close()
        if err is not None:
            raise err
        self._t5_key = key
        self.times["t5_load_s"] = time.time() - t0
        log.info(f"T5 loaded on {self.device} ({self.dtype}; d_model "
                 f"{P.d_model}, {P.n_layer} layers, {P.n_head} heads) "
                 f"{{{self.times['t5_load_s']:.3f}s}}")

    # -- prompt editing (``mlimgsynth_tpu/api.py:1574-1608``) -----------------

    def _edit_segments(self, use_cfg: bool, scfg: SamplerConfig):
        """(prompt segments, negative segments, loop steps) of a request
        whose prompt or (with CFG) negative prompt edits, each segment list
        ``editing_segments``' (texts, step -> text) or None; None without
        editing (``generate``, ``mlimgsynth_tpu/api.py:2187-2211``).  Flow
        models raise."""
        c = self.c
        if c["no_prompt_parse"] or not (
                self.prompt.editing or use_cfg and self.nprompt.editing):
            return None
        if self._flow():
            raise MlisError(MlisError.E_OPT_VALUE,
                            "prompt editing is not supported for flow models")
        n_plan = plan_n_step(scfg, 2 if use_cfg else 1)
        ep = prompt_mod.editing_segments(c["prompt_raw"], n_plan)
        en = (prompt_mod.editing_segments(c["nprompt_raw"], n_plan)
              if use_cfg else None)
        if ep is None and en is None:
            return None
        return ep, en, n_plan

    def _edit_cond_bank(self, edit_segs, use_cfg: bool, n_batch: int):
        """The conditioning bank of an editing request: every distinct
        segment text encoded (prompt segments first, then negative ones;
        an empty negative segment zero rows on the models that zero an
        empty negative prompt), and the int [steps, rows] matrix of the
        bank rows each step conditions on, [cond x n; uncond x n].  The
        bank encodes in batches of the request's own rows (2 with CFG), so
        that a segment's rows are those the same text gives without
        editing, bit for bit on the card too (a GEMM's kernel, and so its
        sums, depend on the batch's rows)."""
        ep, en, n_plan = edit_segs
        c = self.c
        p_texts, p_idx = (ep if ep is not None
                          else ([c["prompt_raw"]], [0] * n_plan))
        u_texts, u_idx = [], None
        if use_cfg:
            u_texts, u_idx = (en if en is not None
                              else ([c["nprompt_raw"]], [0] * n_plan))
        pts = [self._parse_prompt_text(t) for t in p_texts + u_texts]
        rows, lrows = self._text_cond(pts, chunk=2 if use_cfg else 1,
                                      n_uncond=len(u_texts))
        k = len(p_texts)
        if use_cfg and getattr(self._mt.unet_p, "uncond_empty_zero", False):
            for j, t in enumerate(u_texts):
                if not t:
                    rows[k + j] = 0.0
        idx = np.empty((n_plan, (2 if use_cfg else 1) * n_batch), np.int64)
        for i in range(n_plan):
            idx[i, :n_batch] = p_idx[i]
            if use_cfg:
                idx[i, n_batch:] = k + u_idx[i]
        log.info(f"Prompt editing: {k} prompt"
                 + (f" + {len(u_texts)} negative" if use_cfg else "")
                 + f" segment(s) over {n_plan} steps")
        return rows, lrows, idx

    @_locked
    @torch.no_grad()
    def image_encode(self, img: np.ndarray, sample: bool = True
                     ) -> np.ndarray:
        """img NCHW [n, 3, h, w] in [0, 1] -> the sampler's latent [n, ch_z,
        h/8, w/8] (``image_encode``, ``mlimgsynth_tpu/api.py:1872-1883``):
        with the TAE, its encoder's output; else a sample of the VAE
        encoder's moments (``vae.latent_sample``, in f32), whose noise
        sample i draws from ``RngPhilox(seed + i, offset)``, after which the
        session's offset moves on (``:1969-1991``), so the plan's noise
        follows it; with ``sample`` False the moments' mean, no noise drawn
        (the inpaint-variant conditioning).  The latent subtracts the VAE's
        ``shift_factor`` (SD3), as the decoder adds it back."""
        self.setup()
        if not self.c["tae"] and "vae." not in self._encoders:
            self._load_model(self.c["model"], self._lora_state,
                             encoders=True)
        t0 = time.time()
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
            self.device)
        if self.c["tae"]:
            enc = self._encoders.get("tae.")
            if enc is None:
                raise MlisError(MlisError.E_IMAGE,
                                "the TAE file holds no encoder")
            lat = enc(x).float()
        else:
            lat = self._vae_encode(x, sample)
        if not torch.isfinite(lat).all():
            raise MlisError(MlisError.E_NAN, "NaN found in encoded latent")
        out = lat.cpu().numpy()
        self.times["image_encode_s"] = time.time() - t0
        self._cb(STAGE_IMAGE_ENCODE, 1, 1)
        return out

    def _vae_encode(self, x: torch.Tensor, sample: bool = True
                    ) -> torch.Tensor:
        """img [n, 3, h, w] in [0, 1] on the device -> a sample of the VAE
        encoder's moments (in tiles under ``vae_tile``), or their mean, as
        :meth:`image_encode` describes (``_vae_encode``,
        ``mlimgsynth_tpu/api.py:1969-1991``)."""
        P = self._mt.vae_p
        enc = self._encoders["vae."]
        tile = self.c["vae_tile"]
        # seamless tiling wraps the whole-image encode, not a tile's
        blocks_mod.set_tiling(enc, self.c["tiling"] and tile <= 0)
        x = x * 2.0 - 1.0
        mom = _tiled_encode(enc, x, tile) if tile > 0 else enc(x)
        if not sample:
            return vae_mod.latent_mean(mom, P)
        n, _, h, w = mom.shape
        streams = [RngPhilox(self.rng.seed + i, self.rng.offset)
                   for i in range(n)]
        rand = np.stack([st.randn_shaped((P.ch_z, h, w))
                         for st in streams]).astype(np.float32)
        self.rng.offset = streams[0].offset
        return vae_mod.latent_sample(
            mom, torch.from_numpy(rand).to(self.device), P)

    def _vae_decode(self, x: torch.Tensor) -> torch.Tensor:
        """The sampler's latent on the device -> the VAE's image (x + 1) / 2
        in f32, neither clamped nor quantized, decoded in tiles under
        ``vae_tile`` (``_vae_decode``, ``mlimgsynth_tpu/api.py:
        1993-2006``)."""
        vae = self._models["vae."]
        tile = self.c["vae_tile"]
        blocks_mod.set_tiling(vae, self.c["tiling"] and tile <= 0)
        img = _tiled_decode(vae, x, tile) if tile > 0 else vae(x).float()
        return (img + 1.0) / 2.0

    @_locked
    @torch.no_grad()
    def image_decode(self, latent: np.ndarray) -> np.ndarray:
        """latent NCHW [n, ch_z, h, w] (scaled) -> image [n, 3, 8h, 8w] in
        [0, 1] (``image_decode``, ``mlimgsynth_tpu/api.py:1885-1895``): the
        VAE's float output (tiled under ``vae_tile``) or the TAE's, clamped
        (its ``_tae_decode``)."""
        self.setup()
        x = torch.from_numpy(np.ascontiguousarray(latent, np.float32)).to(
            self.device)
        out = self._image_decode(x).cpu().numpy()
        self._cb(STAGE_IMAGE_DECODE, 1, 1)
        return out

    def _image_decode(self, x: torch.Tensor) -> torch.Tensor:
        if self.c["tae"]:
            # the JAX session's ``_tae_decode`` does not wrap
            blocks_mod.set_tiling(self._models["tae."], False)
            img = self._models["tae."](x).float().clamp(0.0, 1.0)
        else:
            img = self._vae_decode(x)
        if not torch.isfinite(img).all():
            raise MlisError(MlisError.E_NAN, "NaN found in decoded image")
        return img

    def mask_encode(self, mask: np.ndarray) -> np.ndarray:
        """Image mask -> latent mask by block-mean downsize (reference:
        mlis_mask_encode)."""
        f = self._mt.vae_p.f_down if self._mt else 8
        return image_mod.mask_downsize(np.asarray(mask, np.float32), f)

    def generate(self) -> np.ndarray:
        """Run a request with the current options; returns the image (with
        ``no_decode``, the latent, and ``tensors["image"]`` is left as it
        was).  With
        an ``image`` the initial latent is its encoding (img2img, the
        schedule cut at ``f_t_ini``); with a mask (``image_mask``, the
        image's alpha) the masked-in region (1 = KEEP) stays that latent.
        The second-stage paths go first, in the JAX session's order
        (``mlimgsynth_tpu/api.py:2091-2098``): an inpaint at full
        resolution, then the hires fix, then the refiner ensemble; each runs
        its stages through this method with its own path shut.  An
        ``MlisError`` goes to the error handler first."""
        with self._lock:
            try:
                return self._generate_dispatch()
            except MlisError as e:
                self._err(e)

    def _generate_dispatch(self) -> np.ndarray:
        self.setup()
        with pmesh.scope(self._mesh):
            return self._generate_routed()

    def _generate_routed(self) -> np.ndarray:
        c = self.c
        if (c["inpaint_full_res"] and not self._in_fullres
                and c["tuflags"] & TUF_IMAGE and c["tuflags"] & TUF_MASK):
            return self._inpaint_fullres_generate()
        if c["hires_fix"] > 1.0 and not self._in_hires:
            return self._hires_generate()
        if c["refiner"] and not self._in_refiner and not self._in_hires:
            return self._refiner_generate()
        return self._generate()

    def _generate(self) -> np.ndarray:
        """One request of the plain path (:meth:`generate`)."""
        self.setup()
        c = self.c
        t_start = time.time()
        self._nfe = 0
        for k in [k for k in self.times
                  if k == "image_encode_s" or k.startswith("move_")]:
            del self.times[k]
        f = self._mt.vae_p.f_down
        n = c["n_batch"]
        h, w = c["height"] // f, c["width"] // f
        if c["tuflags"] & TUF_IMAGE:
            img = self.tensors["image"]
            if img.shape[0] != n:
                img = np.repeat(img, n // img.shape[0], axis=0)
            self.tensors["latent"] = self.image_encode(img)
            c["tuflags"] |= TUF_LATENT
        if c["tuflags"] & TUF_LATENT:
            latent = np.asarray(self.tensors["latent"], np.float32)
            if latent.shape[0] < n:
                latent = np.repeat(latent, n, axis=0)
            h, w = latent.shape[2], latent.shape[3]
        else:
            latent = np.zeros((n, self._mt.vae_p.ch_z, h, w), np.float32)
        if c["tuflags"] & TUF_MASK:
            mask_in = np.asarray(self.tensors["mask"], np.float32)
            if c["mask_blur"] > 0:
                # A1111's mask blur, before the downsize (``api.py:
                # 2128-2134``)
                mask_in = image_mod.mask_gaussian_blur(mask_in,
                                                       c["mask_blur"])
            self.tensors["lmask"] = self.mask_encode(mask_in)
            c["tuflags"] |= TUF_LMASK
        lmask = (np.asarray(self.tensors["lmask"], np.float32)
                 if c["tuflags"] & TUF_LMASK else None)
        masked = lmask is not None
        extra_ch = self._inpaint_extra(lmask, h, w)
        if extra_ch is not None:
            # the variant's learned conditioning takes the mask's place
            lmask = None
        P = self._mt.unet_p
        flow = self._flow()
        # Flux dev embeds the guidance: cfg_scale is its value, and there
        # is no uncond batch (``api.py:2182-2186``)
        guidance = getattr(P, "guidance_embed", False)
        eff_cfg = 1.0 if guidance else c["cfg_scale"]
        use_cfg = eff_cfg > 1
        flow_shift = 0.0
        if flow:    # dev's grows with the image (``api.py:2354-2357``)
            flow_shift = (flux_mod.dynamic_flow_shift(P, h, w)
                          if getattr(P, "flux", False) else P.flow_shift)
        scfg = SamplerConfig(method=c["method"], sched=c["scheduler"],
                             n_step=c["steps"], cfg_scale=eff_cfg,
                             s_ancestral=c["s_ancestral"],
                             s_noise=c["s_noise"], f_t_ini=c["f_t_ini"],
                             f_t_end=c["f_t_end"], flow_shift=flow_shift,
                             cfg_rescale=c["cfg_rescale"],
                             keep_tail=self._keep_tail,
                             noise_add=self._noise_add, **_slg_kw(c))
        # the guidance options' errors before the noise is drawn, as the
        # JAX session's ``_guidance_checks`` (``api.py:2028-2071``)
        slg_plan(scfg, P, c["steps"])
        if c["slg_scale"] > 0 and c["pp"] > 1:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "slg-scale is not supported with --pp block "
                            "stacking")
        pag_plan(scfg, P, c["steps"], c["deepcache"])
        freeu = self._freeu_resolve()
        edit_segs = self._edit_segments(use_cfg, scfg)
        edit_steps = None
        if edit_segs is not None:
            # the bank and its rows per step; tensors["cond"] holds the
            # bank (``api.py:2301-2305``)
            cond, label, edit_steps = self._edit_cond_bank(edit_segs,
                                                           use_cfg, n)
            cond_all, label_all = cond, label
        else:
            cond, label = self._text_cond([self.prompt, self.nprompt]
                                          if use_cfg else [self.prompt],
                                          n_uncond=int(use_cfg))
            if (use_cfg and not c["nprompt_raw"]
                    and getattr(self._mt.unet_p, "uncond_empty_zero", False)):
                # SDXL: an empty negative prompt conditions on zero context
                # rows and keeps its label, as the JAX session's default
                # (fused) encode zeroes the uncond emphasis weights
                # (``api.py:2220-2224``, ref src/mlimgsynth.c:1702)
                cond[1:] = 0.0
            # [cond xn; uncond xn]
            cond_all = torch.repeat_interleave(cond, n, dim=0)
            label_all = (None if label is None
                         else torch.repeat_interleave(label, n, dim=0))
        if guidance:
            # the guidance value rides as the label's last column
            # (``api.py:2325-2331``)
            label_all = torch.cat([label_all, label_all.new_full(
                (label_all.shape[0], 1), c["cfg_scale"])], dim=-1)
        self._deepcache_check(flow, edit_steps, c["control_net"],
                              extra_ch is not None)
        denoiser = self._denoiser()
        if c["unet_split"]:
            # stage-wise residency (``api.py:2402-2405``): the text
            # encoders leave the card before the loop (T5 stays)
            for prefix in _TOWERS:
                if prefix in self._models:
                    self._stage_out(prefix)
        self._stage_in(denoiser)
        self._cb(STAGE_COND_ENCODE, 1, 1)
        nfe_per_dxdt = 2 if use_cfg else 1
        subseeds = None
        if c["subseed_strength"] > 0:
            # seed variations (``api.py:2366-2376``): by default far from
            # the seed streams (seed + i), so that row i's variation noise
            # is no other row's base noise
            sub0 = (c["subseed"] if c["subseed"] >= 0
                    else self.rng.seed + (1 << 31))
            self._subseed_eff = sub0
            subseeds = [sub0 + i for i in range(n)]
        plan = make_plan(scfg, latent.shape, self.rng, nfe_per_dxdt,
                         subseeds=subseeds,
                         subseed_strength=c["subseed_strength"])
        # seamless tiling: the denoiser's convs wrap for this request
        blocks_mod.set_tiling(self._models[denoiser], c["tiling"])
        control = self._control_spec(h * f, w * f)

        def step_cb(i, n_step):
            self._nfe = i * plan.nfe_per_step
            self._cb(STAGE_DENOISE, i, n_step)

        with torch.no_grad():
            x = run_sampler(self._models[denoiser],
                            latent, plan, cond_all, scfg,
                            step_observer=self.step_observer,
                            label_all=label_all,
                            step_callback=(step_cb if self.callback
                                           else None),
                            lmask=lmask, cond_steps=edit_steps,
                            deepcache=c["deepcache"], freeu=freeu,
                            control=control, extra_ch=extra_ch,
                            mesh=self._mesh)
            # evaluations run: a 2-evaluation solver's last step has one
            n_fe = get_solver(c["method"]).n_fe
            self._nfe = (plan.n_step * n_fe - (n_fe - 1)) * nfe_per_dxdt
            if not torch.isfinite(x).all():
                raise MlisError(MlisError.E_NAN, "NaN found in the "
                                + {"unet.": "UNet", "mmdit.": "MMDiT",
                                   "flux.": "Flux"}[denoiser] + " output")
            if c["unet_split"]:
                # the denoiser leaves the card after the loop (``:2480``)
                self._stage_out(denoiser)
            t_dec = time.time()
            if c["no_decode"]:
                # the latent is the result (``api.py:2484``, ``:2510``)
                image = None
            elif c["vae_tile"] > 0 and not c["tae"]:
                # the JAX session's ``image_decode`` branch (``:2499``):
                # the float image, neither clamped nor quantized
                image = self._image_decode(x).cpu().numpy()
            else:
                # the loop's decode wraps under seamless tiling
                # (``_decode_u8``, ``sampler.py:652-656``)
                dec = self._models["tae." if c["tae"] else "vae."]
                blocks_mod.set_tiling(dec, c["tiling"])
                if c["tae"]:
                    # the TAE takes the sampler's latent and gives [0, 1]
                    # (``_decode_u8``'s "tae" branch); C-cast truncation
                    img = dec(x).float() * 255.0
                else:
                    img = (dec(x).float() + 1.0) * (255.0 / 2.0)
                u8 = img.clamp(0.0, 255.0).to(torch.uint8)
                image = u8.cpu().numpy().astype(np.float32) / 255.0
            self.times["decode_s"] = time.time() - t_dec
        self.tensors["latent"] = x.cpu().numpy()
        if edit_steps is not None:
            self.tensors["cond"] = cond.cpu().numpy()
            self.tensors["ncond"] = self.tensors["nlabel"] = None
            self.tensors["label"] = (None if label is None
                                     else label.cpu().numpy())
        else:
            self.tensors["cond"] = cond[:1].cpu().numpy()
            self.tensors["ncond"] = (cond[1:].cpu().numpy() if use_cfg
                                     else None)
            if label is not None:
                self.tensors["label"] = label[:1].cpu().numpy()
                self.tensors["nlabel"] = (label[1:].cpu().numpy() if use_cfg
                                          else None)
        if image is not None:
            self.tensors["image"] = image
            self._cb(STAGE_IMAGE_DECODE, 1, 1)
        self._infotext_update(w * f, h * f, plan.n_step,
                              "inpaint" if masked else "img2img")
        self._prompt_clear()
        self.times["generate_s"] = time.time() - t_start
        log.info(f"Generation done {{{self.times['generate_s']:.3f}s}}")
        return self.tensors["latent"] if image is None else image

    def _inpaint_extra(self, lmask: Optional[np.ndarray], h: int,
                       w: int) -> Optional[np.ndarray]:
        """An inpaint-variant UNet's extra input channels [1, 2 ch_z + 1, h,
        w] (None for any other model): the repaint mask ``1 - keep`` at
        latent resolution, then the deterministic encode (the moments'
        mean) of ``image * keep + 0.5 (1 - keep)``, the image's repainted
        area grey; without an image, a zero latent
        (``mlimgsynth_tpu/api.py:2139-2170``)."""
        mt, c = self._mt, self.c
        P = mt.unet_p
        if self._flow() or P.n_ch_in <= mt.vae_p.ch_z:
            return None
        if P.n_ch_in != 2 * mt.vae_p.ch_z + 1:
            raise MlisError(MlisError.E_UNKNOWN,
                            f"unsupported UNet input channels {P.n_ch_in} "
                            f"(expected {2 * mt.vae_p.ch_z + 1} for an "
                            "inpaint variant)")
        keep_lat = (np.asarray(lmask[:1], np.float32) if lmask is not None
                    else np.zeros((1, 1, h, w), np.float32))
        mlat = np.zeros((1, mt.vae_p.ch_z, h, w), np.float32)
        if c["tuflags"] & TUF_IMAGE and self.tensors["image"] is not None:
            img_in = np.asarray(self.tensors["image"][:1], np.float32)
            if c["tuflags"] & TUF_MASK and self.tensors["mask"] is not None:
                keep_img = np.asarray(self.tensors["mask"][:1], np.float32)
            else:   # the latent mask, upsampled to the image's size
                fk = img_in.shape[2] // keep_lat.shape[2]
                keep_img = np.repeat(np.repeat(keep_lat, fk, 2), fk, 3)
            masked = img_in * keep_img + 0.5 * (1.0 - keep_img)
            mlat = self.image_encode(masked, sample=False)[:1]
        log.info(f"Inpaint-variant conditioning ({P.n_ch_in} input "
                 "channels)")
        return np.concatenate([1.0 - keep_lat, mlat], axis=1)

    def _control_spec(self, ih: int, iw: int):
        """The sampler's ``control`` of a request of ``ih`` x ``iw`` pixels,
        or None without ``control_net``: ``E_IMAGE`` without a
        ``control_image`` or for one of another size (``mlimgsynth_tpu/
        api.py:2385-2401``); its first row is the hint."""
        c = self.c
        if not c["control_net"]:
            return None
        hint = self.tensors["control_image"]
        if hint is None:
            raise MlisError(MlisError.E_IMAGE,
                            "control-net is set but no control-image was "
                            "given")
        if hint.shape[2:] != (ih, iw):
            raise MlisError(MlisError.E_IMAGE,
                            f"control image size {hint.shape[3]}x"
                            f"{hint.shape[2]} does not match output "
                            f"{iw}x{ih}")
        log.info(f"ControlNet active (strength: "
                 f"{c['control_strength']:g})")
        return (self._models["cnet."],
                torch.from_numpy(np.ascontiguousarray(hint[:1], np.float32))
                .to(self.device), float(c["control_strength"]))

    # -- upscaling (``mlimgsynth_tpu/api.py:1904-1963``) ----------------------

    def _upscaler_get(self):
        """The ``upscaler`` model (module, params) on the session's device
        in its dtype, read once per file, dtype and device."""
        if not self.c["upscaler"]:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "no upscaler model configured (option "
                            "'upscaler')")
        path = self._aux_find(self.c["upscaler"])
        key = f"{path}|{self.dtype}|{self.device}"
        if self._upscaler is None or self._upscaler_key != key:
            if not os.path.exists(path):
                raise MlisError(MlisError.E_FILE_NOT_FOUND,
                                f"upscaler file not found "
                                f"'{self.c['upscaler']}'")
            self._upscaler = None
            t0 = time.time()
            try:
                self._upscaler = esr_mod.load_esrgan(path, self.device,
                                                     self.dtype)
            except ValueError as e:
                raise MlisError(MlisError.E_UNKNOWN,
                                f"upscaler '{path}': {e}")
            self._upscaler_key = key
            self.times["upscaler_load_s"] = time.time() - t0
            P = self._upscaler[1]
            depth = getattr(P, "n_block", None) or getattr(P, "n_conv", 0)
            log.info(f"Upscaler: {os.path.basename(path)} x{P.scale} "
                     f"({type(P).__name__.replace('Params', '')} "
                     f"f{P.n_feat} d{depth}) "
                     f"{{{self.times['upscaler_load_s']:.3f}s}}")
        return self._upscaler

    @_locked
    @torch.no_grad()
    def upscale(self, img: np.ndarray, resize: Optional[float] = None,
                tile: int = 0) -> np.ndarray:
        """Upscale images NCHW [n, 3, h, w] in [0, 1] with the ``upscaler``
        model, to [n, 3, s h, s w] (s its factor) in f32.  A pixel-unshuffle
        model (x2, x1) takes the image edge-padded to its factor and the
        output is trimmed back.  ``resize``: the final factor, where it is
        not s a Lanczos resize of the model's output (A1111's
        ``upscaling_resize``).  ``tile`` > 0 bounds a pass to tiles of that
        edge plus a margin (16 pixels, a multiple of the unshuffle factor),
        each writing its inner box into the canvas in ``_tile_geometry``'s
        order; the tiles run as a Python loop."""
        m, P = self._upscaler_get()
        t0 = time.time()
        img = np.asarray(img, np.float32)
        n, _, h, w = img.shape
        u, s = P.unshuffle, P.scale
        ph, pw = (-h) % u, (-w) % u
        if ph or pw:
            img = np.pad(img, ((0, 0), (0, 0), (0, ph), (0, pw)),
                         mode="edge")
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        hp, wp = img.shape[2], img.shape[3]
        k = max(u, 16 // u * u)
        if tile and (tile + 2 * k < wp or tile + 2 * k < hp):
            t = max(u, (tile + u - 1) // u * u)
            n0 = min(t + 2 * k, wp) // u * u
            n1 = min(t + 2 * k, hp) // u * u
            origins, boxes = _tile_geometry(wp, hp, n0, n1, k)
            log.info(f"ESRGAN tiled upscale: {len(origins)} tiles of "
                     f"{n0}x{n1}px")
            out = torch.zeros(n, 3, hp * s, wp * s, device=self.device)
            for (y, xo), (y0, y1, x0, x1) in zip(origins.tolist(),
                                                 boxes.tolist()):
                up = m(x[:, :, y:y + n1, xo:xo + n0]).float()
                out[:, :, (y + y0) * s:(y + y1) * s,
                    (xo + x0) * s:(xo + x1) * s] = \
                    up[:, :, y0 * s:y1 * s, x0 * s:x1 * s]
        else:
            out = m(x).float()
        out = out[:, :, :h * s, :w * s].cpu().numpy()
        if resize and abs(float(resize) - s) > 1e-6:
            out = image_mod.lanczos_resize(out, int(round(h * float(resize))),
                                           int(round(w * float(resize))))
        self.times["upscale_s"] = time.time() - t0
        return out

    # -- the second stages (``mlimgsynth_tpu/api.py:2512-2727``) --------------

    def _inpaint_fullres_generate(self) -> np.ndarray:
        """Inpainting at full resolution (A1111's "only masked"): the mask's
        padded bounding box, widened toward the request's aspect, is cut
        out, Lanczos-resized to the request's size, inpainted there,
        resized back and blended into the image under the mask.  The mask
        blur applies once, here; an empty mask is plain img2img."""
        c = self.c
        img = np.asarray(self.tensors["image"], np.float32)
        mask = np.asarray(self.tensors["mask"], np.float32)
        saved_blur = c["mask_blur"]
        if saved_blur > 0:
            mask = image_mod.mask_gaussian_blur(mask, saved_blur)
        # the session's masks keep at 1; the crop helpers take white as
        # the area to repaint
        repaint = 1.0 - mask
        w = c["width"] or img.shape[3]
        h = c["height"] or img.shape[2]
        pad = int(c["inpaint_full_res_padding"])
        box = image_mod.inpaint_crop_region(repaint, w, h, pad,
                                            mult=self._mt.vae_p.f_down)
        self._in_fullres = True
        try:
            if box is None:
                return self.generate()
            x0, y0, x1, y1 = box
            crop_img = image_mod.resize_float_nchw(img[:, :, y0:y1, x0:x1],
                                                   h, w)
            crop_mask = np.clip(image_mod.resize_float_nchw(
                mask[:, :, y0:y1, x0:x1], h, w), 0.0, 1.0)
            c["mask_blur"] = 0.0   # applied above
            self.tensors["image"] = crop_img
            self.tensors["mask"] = crop_mask
            out = self.generate()
            final = image_mod.inpaint_paste(img, out, repaint, box)
            self.tensors["image"] = final
            self.infotext += (f", Inpaint area: only masked, "
                              f"Masked padding: {pad}")
            log.info(f"Inpaint full res: box {x1 - x0}x{y1 - y0}+{x0}+{y0} "
                     f"processed at {w}x{h}")
            return final
        finally:
            self._in_fullres = False
            c["mask_blur"] = saved_blur

    def _hires_generate(self) -> np.ndarray:
        """The hires fix (A1111's semantics): a first pass at the request's
        size, its latent upscaled by ``hires_fix`` to a multiple of 64
        pixels (bilinear, as ``jax.image.resize``), then an img2img pass
        there at strength ``hires_denoise`` over ``hires_steps`` steps (0:
        ``steps``).  With ``hires_upscaler`` set (not "" or "latent") the
        upscale is in image space: the first pass decodes, the ``upscaler``
        model upscales, a Lanczos resize gives the final size, and the
        second pass starts from its encode.  The first pass clears the
        one-shot options; the second gets the prompts, the prompt tags'
        LoRAs, the steps and ``no_decode`` back."""
        c = self.c
        factor = float(c["hires_fix"])
        base_w, base_h = c["width"], c["height"]
        f = self._mt.vae_p.f_down
        mult = f * 8    # the VAE's factor and three UNet downsamplings
        fin_w = max(mult, int(round(base_w * factor / mult)) * mult)
        fin_h = max(mult, int(round(base_h * factor / mult)) * mult)
        denoise = float(c["hires_denoise"])
        steps2 = int(c["hires_steps"]) or c["steps"]
        saved_prompt = (c["prompt_raw"], c["nprompt_raw"])
        saved_steps, saved_nodec = c["steps"], c["no_decode"]
        saved_loras = list(self.loras)
        up_name = str(c["hires_upscaler"]).strip()
        use_img_up = up_name.lower() not in ("", "latent")
        self._in_hires = True
        try:
            if use_img_up:
                c["no_decode"] = False
                img1 = np.asarray(self.generate(), np.float32)
                up = self.upscale(img1)
                if up.shape[2] != fin_h or up.shape[3] != fin_w:
                    up = image_mod.lanczos_resize(up, fin_h, fin_w)
                lat2 = self.image_encode(up)
            else:
                c["no_decode"] = True
                lat = np.asarray(self.generate(), np.float32)
                lat2 = image_mod.resize_bilinear_nchw(lat, fin_h // f,
                                                      fin_w // f)
            c["prompt_raw"], c["nprompt_raw"] = saved_prompt
            self.loras = saved_loras
            c["steps"] = steps2
            c["no_decode"] = saved_nodec
            c["width"], c["height"] = fin_w, fin_h
            c["f_t_ini"], c["f_t_end"] = denoise, 0.0
            c["tuflags"] = TUF_LATENT
            self.tensors["latent"] = lat2
            out = self.generate()
            self.infotext += (f", Hires upscale: {factor:g}, "
                              f"Hires steps: {steps2}, "
                              f"Denoising strength: {denoise:g}")
            if use_img_up:
                self.infotext += f", Hires upscaler: {up_name}"
            return out
        finally:
            self._in_hires = False
            c["width"], c["height"] = base_w, base_h
            c["steps"] = saved_steps
            c["no_decode"] = saved_nodec

    def _refiner_get(self) -> "MLImgSynth":
        """The refiner's sub-session on the session's device, made on first
        use and again when ``refiner`` names another file; it takes the
        session's weight type and auxiliary paths when made, and the
        per-request options on every call, and continues the session's
        Philox stream (seed and offset)."""
        c = self.c
        rs = self._refiner
        if rs is None or self._refiner_path != c["refiner"]:
            rs = MLImgSynth(device=self.device)
            rs.dtype, rs.qbits = self.dtype, self.qbits
            rs._wtype_set = self._wtype_set
            for o in ("tae", "lora_dir", "embed_dir", "aux_dir"):
                rs.c[o] = c[o]
            rs.option_set("model", c["refiner"])
            self._refiner = rs
            self._refiner_path = c["refiner"]
        for o in ("width", "height", "cfg_scale", "cfg_rescale", "method",
                  "scheduler", "s_noise", "s_ancestral", "clip_skip",
                  "n_batch", "no_prompt_parse", "vae_tile", "no_decode",
                  "freeu"):
            rs.c[o] = c[o]
        rs.rng.seed = self.rng.seed
        rs.rng.offset = self.rng.offset
        return rs

    def _refiner_generate(self) -> np.ndarray:
        """The base -> refiner ensemble (the SDXL paper's; diffusers'
        ``denoising_end`` / ``denoising_start``): the base model denoises
        from ``f_t_ini`` to ``1 - refiner_switch`` and stops there, its
        latent still at that sigma (``keep_tail``); the refiner continues
        from that sigma without adding noise and decodes.  Where nothing
        is left below the switch for the base (it ends before it, or starts
        below it, or would run fewer than 2 steps) one model runs alone:
        the base if it ends before the switch, else the refiner, with the
        usual noise."""
        c = self.c
        switch = min(max(float(c["refiner_switch"]), 0.0), 1.0)
        f_cut = 1.0 - switch
        saved_prompt = (c["prompt_raw"], c["nprompt_raw"])
        saved_end, saved_nodec = c["f_t_end"], c["no_decode"]
        f_ini = (c["f_t_ini"] if c["tuflags"] & (TUF_LATENT | TUF_IMAGE)
                 else 1.0)
        rs = self._refiner_get()
        base_steps = int(c["steps"] * (f_ini - f_cut) + 0.5)
        self._in_refiner = True
        try:
            if saved_end >= f_cut or f_ini <= f_cut or base_steps < 2:
                if saved_end >= f_cut:
                    return self.generate()
                rs.c["steps"] = c["steps"]
                rs.c["f_t_ini"], rs.c["f_t_end"] = c["f_t_ini"], saved_end
                rs.c["tuflags"] = c["tuflags"]
                for t in ("image", "latent", "mask", "lmask"):
                    rs.tensors[t] = self.tensors[t]
                rs.option_set("prompt", saved_prompt[0])
                rs.option_set("nprompt", saved_prompt[1])
                out = rs.generate()
                self._prompt_clear()
                base_info = rs.infotext
            else:
                c["no_decode"] = True
                c["f_t_end"] = f_cut
                self._keep_tail = True
                lat = np.asarray(self.generate(), np.float32)
                rs.c["steps"] = c["steps"]
                rs.c["f_t_ini"], rs.c["f_t_end"] = f_cut, saved_end
                rs.c["tuflags"] = TUF_LATENT
                rs.tensors["latent"] = lat
                rs.option_set("prompt", saved_prompt[0])
                rs.option_set("nprompt", saved_prompt[1])
                rs.rng.offset = self.rng.offset
                rs._noise_add = False
                base_info = self.infotext
                try:
                    out = rs.generate()
                finally:
                    rs._noise_add = True
            self.tensors["latent"] = rs.tensors["latent"]
            self.tensors["image"] = rs.tensors["image"]
            self.infotext = base_info + (
                f", Refiner: {os.path.basename(c['refiner'])}, "
                f"Refiner switch: {switch:g}")
            return out
        finally:
            self._in_refiner = False
            self._keep_tail = False
            c["no_decode"] = saved_nodec

    # -- the merged-batch serving path (``mlimgsynth_tpu/api.py:2743-3316``)

    def _batch_loras_apply(self, pts: List[prompt_mod.PromptText]) -> None:
        """The ``<lora:...>`` tags of a merged batch: one weight set a
        batch, so every request must carry the same tags (the server's
        merge key makes it so); the merged weights stay for the next batch
        with the same tags (``_batch_loras_apply``, ``:2767-2787``)."""
        tags = list(pts[0].loras) if pts else []
        for p in pts[1:]:
            if list(p.loras) != tags:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "all requests in a device batch must share "
                                "the same <lora:...> tags")
        wanted = [(self._lora_find(name), float(mult))
                  for name, mult in tags]
        if [(p_, m_) for p_, m_, fp in self.loras if fp] != wanted:
            self.loras = ([l for l in self.loras if not l[2]]
                          + [(p_, m_, True) for p_, m_ in wanted])
            self.setup()

    def _batch_edit_cond_bank(self, requests, use_cfg: bool, n_plan: int):
        """Prompt editing in a merged batch: each request's step segments
        (one segment for a request without editing) index one shared
        conditioning bank of every distinct text, prompts first, encoded
        in one batched call; returns (bank rows, bank labels, the int
        [n_plan, rows] matrix of the rows each step conditions on, [cond x
        n; uncond x n]) (``_batch_edit_cond_bank``, ``:1610-1672``)."""
        n = len(requests)

        def maps_for(raws):
            texts, tindex, maps = [], {}, []

            def row_of(t):
                if t not in tindex:
                    tindex[t] = len(texts)
                    texts.append(t)
                return tindex[t]

            for raw in raws:
                segs = prompt_mod.editing_segments(raw, n_plan)
                if segs is None:
                    maps.append([row_of(raw)] * n_plan)
                else:
                    base = [row_of(t) for t in segs[0]]
                    maps.append([base[i] for i in segs[1]])
            return texts, maps

        p_texts, p_maps = maps_for([str(r.get("prompt", ""))
                                    for r in requests])
        u_texts, u_maps = [], []
        if use_cfg:
            u_texts, u_maps = maps_for([str(r.get("nprompt", ""))
                                        for r in requests])
        pts = ([self._parse_prompt_text(t) for t in p_texts]
               + [self._parse_prompt_text(t, allow_loras=False)
                  for t in u_texts])
        rows, lrows = self._text_cond(pts, n_uncond=len(u_texts))
        k = len(p_texts)
        if use_cfg and getattr(self._mt.unet_p, "uncond_empty_zero", False):
            for j, t in enumerate(u_texts):
                if not t:
                    rows[k + j] = 0.0
        idx = np.empty((n_plan, 2 * n if use_cfg else n), np.int64)
        for i in range(n_plan):
            for r in range(n):
                idx[i, r] = p_maps[r][i]
                if use_cfg:
                    idx[i, n + r] = k + u_maps[r][i]
        log.info(f"Prompt editing (batch): {k} prompt"
                 + (f" + {len(u_texts)} negative" if use_cfg else "")
                 + f" segment(s) over {n_plan} steps")
        return rows, lrows, idx

    def _preview_u8(self, x: torch.Tensor) -> np.ndarray:
        """A preview frame of the latents ``x``: uint8 [n, h, w, 3], the TAE
        decode where the session has a TAE, else the linear latent -> RGB
        map at latent resolution (``_decode_u8``'s "latent" kind,
        ``mlimgsynth_tpu/sampling/sampler.py:666-675``; a 16-channel latent
        by its first four channels)."""
        with torch.no_grad():
            if self.c["tae"]:
                img = self._models["tae."](x).float() * 255.0
            else:
                m = torch.tensor(_PREVIEW_RGB, device=x.device)
                img = torch.einsum("nchw,cd->ndhw", x[:, :4].float(), m)
                img = (img + 1.0) * (255.0 / 2.0)
            u8 = img.clamp(0.0, 255.0).to(torch.uint8)
        return u8.permute(0, 2, 3, 1).cpu().numpy()

    @_locked
    @torch.no_grad()
    def generate_batch(self, requests: List[dict], step_callback=None,
                       init_latents: Optional[np.ndarray] = None,
                       init_lmask: Optional[np.ndarray] = None,
                       preview_callback=None, preview_chunk: int = 0,
                       _latent_only: bool = False
                       ) -> Tuple[np.ndarray, List[str]]:
        """Several txt2img (or img2img) requests as one device batch
        (``generate_batch``, ``mlimgsynth_tpu/api.py:2789-3090``).  Each
        request dict brings its own ``prompt``, ``nprompt``, ``seed`` (a
        seedless one gets the session's seed + its index) and ``subseed``;
        every other option is the session's.  Returns (images NCHW [N, 3,
        H, W] in [0, 1], quantized through uint8, and each request's
        infotext); ``_latent_only`` (the first stage of the hires fix and
        of the ensemble) returns the latents instead.

        ``init_latents`` [N, ch_z, h, w] (one row a request) makes it
        img2img at the session's ``f_t_ini``; ``init_lmask`` [N, 1, h, w]
        (1 keeps) inpainting.  The prompts are encoded in one batched call
        with the negative prompts after them.  ``step_callback(i_step,
        n_step)`` returning true aborts the whole batch with ``Aborted``;
        ``preview_callback(i_step, n_step, frames_u8_nhwc)`` gets a frame
        every ``preview_chunk`` steps (0: ``MLIS_PROGRESS_CHUNK``, default
        1), the callback asked after each; the last frame is the decoded
        image.  Frames come from this Python loop between steps."""
        self.setup()
        with pmesh.scope(self._mesh):
            return self._generate_batch_routed(
                requests, step_callback, init_latents, init_lmask,
                preview_callback, preview_chunk, _latent_only)

    def _generate_batch_routed(self, requests, step_callback, init_latents,
                               init_lmask, preview_callback, preview_chunk,
                               _latent_only):
        c = self.c
        if (c["hires_fix"] > 1.0 and not self._in_hires
                and not _latent_only):
            return self._generate_batch_hires(
                requests, step_callback, init_latents, init_lmask,
                preview_callback, preview_chunk)
        if c["refiner"] and not self._in_refiner and not self._in_hires:
            return self._generate_batch_refiner(
                requests, step_callback, init_latents, init_lmask,
                preview_callback, preview_chunk)
        return self._generate_batch(requests, step_callback,
                                    init_latents, init_lmask,
                                    preview_callback, preview_chunk,
                                    _latent_only)

    def _generate_batch(self, requests, step_callback, init_latents,
                        init_lmask, preview_callback, preview_chunk,
                        latent_only) -> Tuple[np.ndarray, List[str]]:
        c, mt = self.c, self._mt
        P = mt.unet_p
        f = mt.vae_p.f_down
        w, h = c["width"] // f, c["height"] // f
        n = len(requests)
        if init_latents is not None:
            if init_latents.shape[0] != n:
                raise MlisError(MlisError.E_OPT_VALUE,
                                f"init_latents batch {init_latents.shape[0]}"
                                f" != {n} requests")
            h, w = init_latents.shape[2], init_latents.shape[3]
        if init_lmask is not None and init_latents is None:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "inpainting masks need init images")
        flow = self._flow()
        guidance = getattr(P, "guidance_embed", False)
        use_cfg = c["cfg_scale"] > 1 and not guidance
        pts = [self._parse_prompt_text(str(r.get("prompt", "")))
               for r in requests]
        self._batch_loras_apply(pts)
        seeds = [int(r["seed"]) if r.get("seed") is not None
                 else self.rng.seed + i for i, r in enumerate(requests)]
        npts = ([self._parse_prompt_text(str(r.get("nprompt", "")),
                                         allow_loras=False)
                 for r in requests] if use_cfg else [])
        flow_shift = 0.0
        if flow:
            flow_shift = (flux_mod.dynamic_flow_shift(P, h, w)
                          if getattr(P, "flux", False) else P.flow_shift)
        scfg = SamplerConfig(
            method=c["method"], sched=c["scheduler"], n_step=c["steps"],
            cfg_scale=1.0 if guidance else c["cfg_scale"],
            s_ancestral=c["s_ancestral"], s_noise=c["s_noise"],
            f_t_ini=c["f_t_ini"] if init_latents is not None else 1.0,
            f_t_end=c["f_t_end"], keep_tail=self._keep_tail,
            noise_add=self._noise_add, flow_shift=flow_shift,
            cfg_rescale=c["cfg_rescale"], **_slg_kw(c))
        edit_steps = None
        if (not c["no_prompt_parse"]
                and (any(p.editing for p in pts)
                     or any(q.editing for q in npts))):
            if flow:
                raise MlisError(MlisError.E_OPT_VALUE, "prompt editing is "
                                "not supported for flow models")
            cond_all, label_all, edit_steps = self._batch_edit_cond_bank(
                requests, use_cfg, plan_n_step(scfg, 2 if use_cfg else 1))
        else:
            # [cond x n; uncond x n]: the prompts, then the negative ones
            cond_all, label_all = self._text_cond(pts + npts,
                                                  n_uncond=len(npts))
            if use_cfg and getattr(P, "uncond_empty_zero", False):
                for i, r in enumerate(requests):
                    if not r.get("nprompt"):
                        cond_all[n + i] = 0.0
        if guidance and label_all is not None:
            label_all = torch.cat([label_all, label_all.new_full(
                (label_all.shape[0], 1), c["cfg_scale"])], dim=-1)
        slg_plan(scfg, P, c["steps"])
        if c["slg_scale"] > 0 and c["pp"] > 1:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "slg-scale is not supported with --pp block "
                            "stacking")
        pag_plan(scfg, P, c["steps"], c["deepcache"])
        freeu = self._freeu_resolve()
        nfe_per_dxdt = 2 if use_cfg else 1
        latent = (np.asarray(init_latents, np.float32)
                  if init_latents is not None
                  else np.zeros((n, mt.vae_p.ch_z, h, w), np.float32))
        subseeds = None
        if c["subseed_strength"] > 0:
            subseeds = [int(r["subseed"]) if r.get("subseed") is not None
                        else seeds[j] + (1 << 31)
                        for j, r in enumerate(requests)]
        plan = make_plan(scfg, latent.shape, RngPhilox(seeds[0], 0),
                         nfe_per_dxdt, seeds=seeds, subseeds=subseeds,
                         subseed_strength=c["subseed_strength"])
        log.info(f"Generating batch of {n} requests (seeds {seeds}, steps "
                 f"{plan.n_step})")
        control = self._control_spec(h * f, w * f)
        extra_ch = None
        if P.n_ch_in > mt.vae_p.ch_z and not flow:
            if init_latents is not None:
                raise MlisError(MlisError.E_OPT_VALUE,
                                "inpaint-variant models do not support "
                                "merged img2img batches (use generate())")
            # txt2img on an inpaint variant repaints everything
            extra_ch = np.concatenate(
                [np.ones((1, 1, h, w), np.float32),
                 np.zeros((1, mt.vae_p.ch_z, h, w), np.float32)], 1)
        self._deepcache_check(flow, edit_steps, c["control_net"],
                              extra_ch is not None)
        denoiser = self._denoiser()
        if c["unet_split"]:
            for prefix in _TOWERS:
                if prefix in self._models:
                    self._stage_out(prefix)
        self._stage_in(denoiser)
        blocks_mod.set_tiling(self._models[denoiser], c["tiling"])
        chunk = max(1, int(preview_chunk
                           or os.environ.get("MLIS_PROGRESS_CHUNK", "1")))

        def on_step(i, n_step, x):
            # after each chunk of steps: a preview frame, then the
            # cancellation check (an abort on the last step is none)
            if i % chunk and i != n_step:
                return
            if preview_callback is not None and (i < n_step
                                                 or latent_only):
                preview_callback(i, n_step, self._preview_u8(x))
            if (step_callback is not None and step_callback(i, n_step)
                    and i < n_step):
                raise Aborted("generation cancelled")

        x = run_sampler(self._models[denoiser], latent, plan, cond_all,
                        scfg, label_all=label_all, lmask=init_lmask,
                        cond_steps=edit_steps, deepcache=c["deepcache"],
                        freeu=freeu, control=control, extra_ch=extra_ch,
                        step_latent=on_step, mesh=self._mesh)
        if not torch.isfinite(x).all():
            raise MlisError(MlisError.E_NAN, "NaN found in UNet output")
        if c["unet_split"]:
            self._stage_out(denoiser)
        if latent_only:
            imgs = x.cpu().numpy()
        else:
            # the loop's fused decode: the whole batch at once, untiled
            # (``_decode_u8``), wrapping under seamless tiling
            dec = self._models["tae." if c["tae"] else "vae."]
            blocks_mod.set_tiling(dec, c["tiling"])
            img = (dec(x).float() * 255.0 if c["tae"]
                   else (dec(x).float() + 1.0) * (255.0 / 2.0))
            u8 = img.clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()
            if preview_callback is not None:
                preview_callback(plan.n_step, plan.n_step,
                                 u8.transpose(0, 2, 3, 1))
            imgs = u8.astype(np.float32) / 255.0
        n_fe = get_solver(c["method"]).n_fe
        self._nfe = (plan.n_step * n_fe - (n_fe - 1)) * nfe_per_dxdt
        infotexts = []
        save = (c["prompt_raw"], c["nprompt_raw"], self.rng.seed,
                self.infotext, self._subseed_eff)
        try:
            for i, r in enumerate(requests):
                c["prompt_raw"] = str(r.get("prompt", ""))
                c["nprompt_raw"] = str(r.get("nprompt", ""))
                self.rng.seed = seeds[i]
                if subseeds is not None:
                    self._subseed_eff = subseeds[i]
                self._infotext_update(w * f, h * f, plan.n_step,
                                      "inpaint" if init_lmask is not None
                                      else "img2img")
                infotexts.append(self.infotext)
        finally:
            (c["prompt_raw"], c["nprompt_raw"], self.rng.seed,
             self.infotext, self._subseed_eff) = save
        return imgs, infotexts

    def _generate_batch_hires(self, requests, step_callback, init_latents,
                              init_lmask, preview_callback, preview_chunk
                              ) -> Tuple[np.ndarray, List[str]]:
        """The hires fix on a merged batch (``_generate_batch_hires``,
        ``:3092-3166``): a latent-only first batch at ``image_dim``, the
        latents resized by ``hires_fix`` (bilinear; or the images decoded,
        upscaled by the ``upscaler`` model, Lanczos-resized and encoded
        again), then an img2img batch at ``hires_denoise``; each stage
        draws its own streams from the requests' seeds.  The first stage's
        infotexts with the hires fields."""
        c = self.c
        factor = float(c["hires_fix"])
        base_w, base_h = c["width"], c["height"]
        f = self._mt.vae_p.f_down
        mult = f * 8
        fin_w = max(mult, int(round(base_w * factor / mult)) * mult)
        fin_h = max(mult, int(round(base_h * factor / mult)) * mult)
        denoise = float(c["hires_denoise"])
        steps2 = int(c["hires_steps"]) or c["steps"]
        saved_steps = c["steps"]
        saved_ini, saved_end = c["f_t_ini"], c["f_t_end"]
        up_name = str(c["hires_upscaler"]).strip()
        use_img_up = up_name.lower() not in ("", "latent")
        self._in_hires = True
        try:
            if use_img_up:
                imgs1, infos = self.generate_batch(
                    requests, step_callback, init_latents, init_lmask,
                    preview_callback, preview_chunk)
                up = self.upscale(np.asarray(imgs1, np.float32))
                if up.shape[2] != fin_h or up.shape[3] != fin_w:
                    up = image_mod.lanczos_resize(up, fin_h, fin_w)
                lat2 = self.image_encode(up)
            else:
                lats, infos = self.generate_batch(
                    requests, step_callback, init_latents, init_lmask,
                    preview_callback, preview_chunk, _latent_only=True)
                lat2 = image_mod.resize_bilinear_nchw(
                    np.asarray(lats, np.float32), fin_h // f, fin_w // f)
            c["width"], c["height"] = fin_w, fin_h
            c["steps"] = steps2
            c["f_t_ini"], c["f_t_end"] = denoise, 0.0
            imgs, _ = self.generate_batch(requests, step_callback, lat2,
                                          None, preview_callback,
                                          preview_chunk)
            extra = f", Hires upscaler: {up_name}" if use_img_up else ""
            infos = [t + f", Hires upscale: {factor:g}, Hires steps: "
                     f"{steps2}, Denoising strength: {denoise:g}" + extra
                     for t in infos]
            return imgs, infos
        finally:
            self._in_hires = False
            c["width"], c["height"] = base_w, base_h
            c["steps"] = saved_steps
            c["f_t_ini"], c["f_t_end"] = saved_ini, saved_end

    def _generate_batch_refiner(self, requests, step_callback, init_latents,
                                init_lmask, preview_callback, preview_chunk
                                ) -> Tuple[np.ndarray, List[str]]:
        """The base -> refiner ensemble on a merged batch
        (``_generate_batch_refiner``, ``:3168-3234``): a latent-only base
        batch stopping at the switch's sigma, then a refiner batch from
        there without new noise; each stage draws its own streams from the
        requests' seeds.  Where nothing is left below the switch for the
        base one model runs alone, as :meth:`_refiner_generate` decides.
        The base stage's infotexts with the refiner fields."""
        c = self.c
        switch = min(max(float(c["refiner_switch"]), 0.0), 1.0)
        f_cut = 1.0 - switch
        saved_end = c["f_t_end"]
        f_ini = c["f_t_ini"] if init_latents is not None else 1.0
        rs = self._refiner_get()
        base_steps = int(c["steps"] * (f_ini - f_cut) + 0.5)
        self._in_refiner = True
        try:
            if saved_end >= f_cut:
                return self.generate_batch(
                    requests, step_callback, init_latents, init_lmask,
                    preview_callback, preview_chunk)
            if f_ini <= f_cut or base_steps < 2:
                rs.c["steps"] = c["steps"]
                rs.c["f_t_ini"], rs.c["f_t_end"] = c["f_t_ini"], saved_end
                imgs, infos = rs.generate_batch(
                    requests, step_callback, init_latents, init_lmask,
                    preview_callback, preview_chunk)
            else:
                c["f_t_end"] = f_cut
                self._keep_tail = True
                try:
                    lats, infos = self.generate_batch(
                        requests, step_callback, init_latents, init_lmask,
                        preview_callback, preview_chunk, _latent_only=True)
                finally:
                    self._keep_tail = False
                    c["f_t_end"] = saved_end
                rs.c["steps"] = c["steps"]
                rs.c["f_t_ini"], rs.c["f_t_end"] = f_cut, saved_end
                rs._noise_add = False
                try:
                    imgs, _ = rs.generate_batch(
                        requests, step_callback, np.asarray(lats), None,
                        preview_callback, preview_chunk)
                finally:
                    rs._noise_add = True
            infos = [t + f", Refiner: {os.path.basename(c['refiner'])}, "
                     f"Refiner switch: {switch:g}" for t in infos]
            return imgs, infos
        finally:
            self._in_refiner = False

    def backend_info(self) -> dict:
        """The session's devices (``backend_info``, ``mlimgsynth_tpu/
        api.py:3301-3316``): every CUDA card, its name and free and total
        memory, for a session on a card; the CPU for one on it."""
        if self.device.type == "cuda" and torch.cuda.is_available():
            devs = []
            for i in range(torch.cuda.device_count()):
                free, total = torch.cuda.mem_get_info(i)
                devs.append({"name": f"cuda:{i}",
                             "desc": torch.cuda.get_device_name(i),
                             "mem_free": int(free), "mem_total": int(total)})
            return {"name": "cuda", "n_dev": len(devs), "devs": devs}
        import platform
        return {"name": "cpu", "n_dev": 1,
                "devs": [{"name": "cpu:0",
                          "desc": platform.processor() or "cpu"}]}

    def _infotext_update(self, w: int, h: int, n_step: int,
                         mode: str = "img2img") -> None:
        """The A1111-compatible 'parameters' text, for the options the port
        has (``_infotext_update``, ``mlimgsynth_tpu/api.py:3236-3300``)."""
        c = self.c
        out = [c["prompt_raw"] + "\n"]
        if c["nprompt_raw"]:
            out.append(f"Negative prompt: {c['nprompt_raw']}\n")
        out.append(f"Seed: {self.rng.seed}")
        if c["subseed_strength"] > 0:
            out.append(f", Variation seed: {self._subseed_eff}, "
                       f"Variation seed strength: "
                       f"{c['subseed_strength']:g}")
        out.append(f", Sampler: {c['method']}")
        if c["s_ancestral"] == 1:
            out.append(" ancestral")
        # the lcm method runs the lcm grid unless a scheduler was chosen
        sched = ("lcm" if c["method"] == "lcm"
                 and c["scheduler"] == "uniform" else c["scheduler"])
        out.append(f", Schedule type: {sched}")
        if c["s_ancestral"] > 0:
            out.append(f", Ancestral: {c['s_ancestral']:g}")
        if c["s_noise"] > 0:
            out.append(f", SNoise: {c['s_noise']:g}")
        if c["cfg_scale"] > 1:
            out.append(f", CFG scale: {c['cfg_scale']:g}")
        if c["cfg_rescale"] > 0 and c["cfg_scale"] > 1:
            out.append(f", CFG Rescale: {c['cfg_rescale']:g}")
        if c["slg_scale"] > 0:
            out.append(f", SLG scale: {c['slg_scale']:g}"
                       f", SLG layers: {c['slg_layers']}"
                       f", SLG start: {c['slg_start']:g}"
                       f", SLG end: {c['slg_end']:g}")
        if c["pag_scale"] > 0:
            out.append(f", PAG scale: {c['pag_scale']:g}")
            if c["pag_start"] > 0 or c["pag_end"] < 1:
                out.append(f", PAG start: {c['pag_start']:g}"
                           f", PAG end: {c['pag_end']:g}")
        if c["deepcache"] > 1:
            out.append(f", DeepCache: {c['deepcache']}")
        if _freeu_parse(c["freeu"]) is not None:
            out.append(", FreeU: " + ",".join(
                f"{v:g}" for v in self._freeu_resolve()))
        if c["f_t_ini"] < 1:
            out.append(f", Mode: {mode}, f_t_ini: {c['f_t_ini']:g}")
        out.append(f", Steps: {n_step}, NFE: {self._nfe}, Size: {w}x{h}"
                   f", Clip skip: {c['clip_skip']}")
        model = os.path.splitext(os.path.basename(c["model"]))[0]
        out.append(f", Model: {model}")
        if c["tae"]:
            out.append(", VAE: tae")
        if c["control_net"]:
            cn = os.path.splitext(os.path.basename(c["control_net"]))[0]
            out.append(f", ControlNet: {cn}, "
                       f"ControlNet strength: {c['control_strength']:g}")
        out.append(f", Version: MLImgSynth-TPU v{_pkg_version}")
        self.infotext = "".join(out)

    def _freeu_resolve(self):
        """The request's FreeU (b1, b2, s1, s2), or None: ``freeu`` "auto"
        (or a true value) picks the family's values; ``MlisError`` on a
        flow model (``_freeu_resolve``, ``mlimgsynth_tpu/api.py:
        1852-1866``)."""
        fu = _freeu_parse(self.c["freeu"])
        if fu is None:
            return None
        P = self._mt.unet_p
        if getattr(P, "flow", False):
            raise MlisError(MlisError.E_OPT_VALUE,
                            "freeu applies to UNet families only")
        if fu != "auto":
            return fu
        fam = ("sdxl" if P.ch_adm_in
               else "sd2" if P.n_ctx >= 1024 else "sd1")
        return _FREEU_DEFAULTS[fam]

    def _deepcache_check(self, flow: bool, edit_steps, control=False,
                         extra=False) -> None:
        """DeepCache runs on the plain SD UNet, MMDiT and Flux loops with
        a solver of one evaluation a step, without ControlNet, an
        inpaint-variant UNet's channels, prompt editing, SLG or a mesh
        (``_deepcache_check``, ``mlimgsynth_tpu/api.py:1555-1572``)."""
        c = self.c
        if c["deepcache"] <= 1:
            return
        if (edit_steps is not None or control or extra
                or self._mesh is not None
                or c["method"] not in DC_METHODS):
            raise MlisError(
                MlisError.E_OPT_VALUE,
                "deepcache supports SD-UNet, SD3/MMDiT and Flux families "
                "(no ControlNet/inpaint-variant/editing/mesh), 1-eval "
                "solvers only: " + ", ".join(DC_METHODS))
        if flow and c["slg_scale"] > 0:
            raise MlisError(MlisError.E_OPT_VALUE,
                            "deepcache is not supported with slg-scale")

    def _prompt_clear(self) -> None:
        """One-shot options cleared after generate (ref: mlis_prompt_clear,
        ``mlimgsynth_tpu/api.py:2731-2741``): the prompts, ``f_t_ini`` and
        ``f_t_end``, the tensor flags and the prompt tags' LoRAs."""
        c = self.c
        c["prompt_raw"] = c["nprompt_raw"] = ""
        c["f_t_ini"], c["f_t_end"], c["tuflags"] = 1.0, 0.0, 0
        self.loras = [l for l in self.loras if not l[2]]


def _slg_kw(c) -> dict:
    """``SamplerConfig`` keywords of skip-layer and perturbed-attention
    guidance from the options (``_slg_kw``, ``mlimgsynth_tpu/api.py:
    3320-3334``)."""
    kw = {}
    if c["slg_scale"]:
        kw.update(slg_scale=float(c["slg_scale"]),
                  slg_layers=tuple(int(v) for v in str(c["slg_layers"])
                                   .split(",") if v.strip()),
                  slg_start=float(c["slg_start"]),
                  slg_end=float(c["slg_end"]))
    if c["pag_scale"]:
        kw.update(pag_scale=float(c["pag_scale"]),
                  pag_start=float(c["pag_start"]),
                  pag_end=float(c["pag_end"]))
    return kw


def _freeu_parse(v: str):
    """A ``freeu`` value: None when off (empty, 0, n, no, false, off),
    "auto" when on (1, y, yes, true, on, auto), else the four floats
    B1,B2,S1,S2; ``MlisError`` otherwise (``_freeu_parse``,
    ``mlimgsynth_tpu/api.py:1834-1850``)."""
    v = str(v).strip()
    if not v or v.lower() in ("0", "n", "no", "false", "off"):
        return None
    if v.lower() in ("1", "y", "yes", "true", "on", "auto"):
        return "auto"
    try:
        parts = tuple(float(x) for x in v.replace(";", ",").split(","))
    except ValueError:
        parts = ()
    if len(parts) != 4:
        raise MlisError(MlisError.E_OPT_VALUE,
                        "freeu: expected y/n or B1,B2,S1,S2")
    return parts
