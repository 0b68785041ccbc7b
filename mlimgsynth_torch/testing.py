"""Test support for the PyTorch port: tiny geometries, seeded random
checkpoints, a numpy safetensors writer (the machine with the GPU has no
``safetensors`` package), and the checks of a flash or quantized-matmul
kernel against its plain twin.

The tiny geometries carry the values of ``mlimgsynth_tpu/testing.py``
(``TINY_CLIP``, ``TINY_UNET``, ``TINY_VAE``, the SD2 set
``TINY_MODEL_TYPE_SD2``, ``:84-93``, the SDXL set ``TINY_MODEL_TYPE_XL``,
``:94-101``, the SD3 set ``TINY_MODEL_TYPE_SD3``, ``:387-409``, its
MMDiT-X ``TINY_MMDIT_X``, ``:396-404``, and the Flux set, ``:547-563``) in
the port's own parameter classes; ``TINY_Q_MODEL_TYPE``,
``TINY_Q_MODEL_TYPE_XL``, ``TINY_Q_MODEL_TYPE_SD3``, ``TINY_Q_MODEL_TYPE_SD35``
and the ``TINY_Q_MODEL_TYPE_FLUX*`` pair widen them so that the linears
quantize.  A Flux model ships as component files
(:func:`write_random_flux_files`); its LoRAs come in kohya or
diffusers-PEFT names (:func:`write_random_flux_lora`).  The second-stage
and control paths: ``TINY_MODEL_TYPE_REFINER`` (``:336-342``) and the
refiner's checkpoint layout (its bigG tower under
``conditioner.embedders.0.model.``), :func:`inpaint_variant` (a model
type's UNet at ``2 ch_z + 1`` input channels), :func:`write_random_controlnet`
(the ``control_model.*`` layout) and :func:`write_random_esrgan` (RRDBNet or
SRVGGNetCompact, in basicsr or the old ESRGAN names, ``.safetensors`` or
``.pth``).
"""
from __future__ import annotations

import base64
import dataclasses
import json
import math
import re
import statistics
import struct
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from . import nameconv
from .api import (ModelTypeDef, _clip_file_name, _single_label,
                  _vae_file_name, build_controlnet, build_encoders,
                  build_models)
from .models import esrgan as esr_mod
from .models import flux as flux_mod
from .models import mmdit as mmdit_mod
from .models import t5 as t5_mod
from .models import tae as tae_mod
from .models import unet as unet_mod
from .models import vae as vae_mod
from .tokenizer import ClipParams
from .weights import module_shapes

TINY_CLIP = ClipParams(n_vocab=49408, n_token=77, d_embed=32, n_interm=64,
                       n_head=4, n_layer=2)
TINY_UNET = unet_mod.UnetParams(
    n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1), attn_res=(1, 2),
    n_head=4, n_te=64, n_ctx=32)
TINY_VAE = vae_mod.VaeParams(ch=32, ch_mult=(1, 1, 2, 2))
TINY_MODEL_TYPE = ModelTypeDef("sd1", TINY_CLIP, TINY_UNET, TINY_VAE, 64, 1)

# Input widths that are multiples of 128, so that a quantized weight type
# stores nearly every linear quantized (the 32/64 widths above quantize
# none).
TINY_Q_CLIP = ClipParams(n_vocab=49408, n_token=77, d_embed=128,
                         n_interm=256, n_head=4, n_layer=2)
TINY_Q_UNET = unet_mod.UnetParams(
    n_ch=128, ch_mult=(1, 2), transf_depth=(1, 1), attn_res=(1, 2),
    n_head=4, n_te=256, n_ctx=128)
TINY_Q_MODEL_TYPE = ModelTypeDef("sd1", TINY_Q_CLIP, TINY_Q_UNET, TINY_VAE,
                                 64, 1)


# SD2: the JAX package's tiny set (``mlimgsynth_tpu/testing.py:84-93``):
# the SD1 tiny with v-prediction, clip skip 2
TINY_UNET_V = unet_mod.UnetParams(
    n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1), attn_res=(1, 2),
    n_head=4, n_te=64, n_ctx=32, vparam=True)
TINY_MODEL_TYPE_SD2 = ModelTypeDef("sd2", TINY_CLIP, TINY_UNET_V, TINY_VAE,
                                   64, 2)


# SDXL: the JAX package's tiny set (``mlimgsynth_tpu/testing.py:94-101``):
# context 32 + 32 wide, label = the 32-wide pooled feature + 6 x 256
TINY_CLIP2 = ClipParams(n_vocab=49408, n_token=77, d_embed=32, n_interm=64,
                        n_head=4, n_layer=2, tok_pad=0)
TINY_UNET_XL = unet_mod.UnetParams(
    n_ch=32, ch_mult=(1, 2), transf_depth=(1, 1), attn_res=(1, 2),
    n_head=4, n_te=64, n_ctx=64, ch_adm_in=32 + 1536, clip_norm=False,
    cond_label=True, uncond_empty_zero=True)
TINY_MODEL_TYPE_XL = ModelTypeDef("sdxl", TINY_CLIP, TINY_UNET_XL, TINY_VAE,
                                  64, 2, TINY_CLIP2)

# The SDXL refiner's tiny set (``mlimgsynth_tpu/testing.py:336-342``): the
# bigG-layout tower alone, no attention at level 0, label = the 32-wide
# pooled feature + 5 x 256
TINY_UNET_REFINER = unet_mod.UnetParams(
    n_ch=32, ch_mult=(1, 2), transf_depth=(2, 2), attn_res=(2,),
    n_head=4, n_te=64, n_ctx=32, ch_adm_in=32 + 5 * 256, clip_norm=False,
    cond_label=True, uncond_empty_zero=True)
TINY_MODEL_TYPE_REFINER = ModelTypeDef("sdxl_refiner", TINY_CLIP2,
                                       TINY_UNET_REFINER, TINY_VAE, 64, 2)


def inpaint_variant(mt: ModelTypeDef) -> ModelTypeDef:
    """``mt`` with an inpaint-variant UNet: ``2 ch_z + 1`` input channels
    (latent, repaint mask, masked-image latent; sd-v1-5-inpainting)."""
    return dataclasses.replace(mt, unet_p=dataclasses.replace(
        mt.unet_p, n_ch_in=2 * mt.vae_p.ch_z + 1))

# The SDXL set at widths that quantize: both towers 128 wide, the UNet as
# TINY_Q_UNET with a 256-wide context and a 128 + 1536 = 13 x 128 label.
TINY_Q_CLIP2 = ClipParams(n_vocab=49408, n_token=77, d_embed=128,
                          n_interm=256, n_head=4, n_layer=2, tok_pad=0)
TINY_Q_UNET_XL = unet_mod.UnetParams(
    n_ch=128, ch_mult=(1, 2), transf_depth=(1, 1), attn_res=(1, 2),
    n_head=4, n_te=256, n_ctx=256, ch_adm_in=128 + 1536, clip_norm=False,
    cond_label=True, uncond_empty_zero=True)
TINY_Q_MODEL_TYPE_XL = ModelTypeDef("sdxl", TINY_Q_CLIP, TINY_Q_UNET_XL,
                                    TINY_VAE, 64, 2, TINY_Q_CLIP2)


# SD3: the JAX package's tiny set (``mlimgsynth_tpu/testing.py:387-409``),
# a 4-channel flow VAE with the SD3 scale and shift
TINY_MMDIT = mmdit_mod.MmditParams(
    depth=2, d_model=32, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
    d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
    n_ctx=80)
TINY_VAE_SD3 = vae_mod.VaeParams(ch=32, ch_mult=(1, 1, 2, 2),
                                 scale_factor=1.5305, shift_factor=0.0609,
                                 quant_conv=False)
TINY_MODEL_TYPE_SD3 = ModelTypeDef("sd3", TINY_CLIP, TINY_MMDIT,
                                   TINY_VAE_SD3, 64, 2, TINY_CLIP2)

# SD3.5: the JAX package's MMDiT-X tiny (``mlimgsynth_tpu/testing.py:
# 396-404``): qk-norm and attn2 in block 0
TINY_MMDIT_X = mmdit_mod.MmditParams(
    depth=2, d_model=32, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
    d_ctx_in=80, d_pooled=64, pos_embed_max=8, d_t_embed=16,
    n_ctx=80, qk_norm=True, x_self_attn_layers=(0,))
TINY_MODEL_TYPE_SD35 = ModelTypeDef("sd35_medium", TINY_CLIP, TINY_MMDIT_X,
                                    TINY_VAE_SD3, 64, 2, TINY_CLIP2)

# Flux: the JAX package's tiny set (``mlimgsynth_tpu/testing.py:547-563``),
# one double and one single block 32 wide, 4-channel latents
TINY_FLUX_SCHNELL = flux_mod.FluxParams(
    depth_double=1, depth_single=1, d_model=32, n_head=2,
    axes_dim=(4, 6, 6), n_ch_in=16, n_ch_out=16, d_ctx_in=48,
    d_pooled=32, n_ctx=48)
TINY_FLUX_DEV = flux_mod.FluxParams(
    depth_double=1, depth_single=1, d_model=32, n_head=2,
    axes_dim=(4, 6, 6), n_ch_in=16, n_ch_out=16, d_ctx_in=48,
    d_pooled=32, n_ctx=48, guidance_embed=True, dynamic_shift=True)
TINY_VAE_FLUX = vae_mod.VaeParams(ch=32, ch_mult=(1, 1, 2, 2),
                                  scale_factor=0.3611, shift_factor=0.1159,
                                  quant_conv=False)
TINY_MODEL_TYPE_FLUX = ModelTypeDef("flux_schnell", TINY_CLIP,
                                    TINY_FLUX_SCHNELL, TINY_VAE_FLUX, 64, 1)
TINY_MODEL_TYPE_FLUX_DEV = ModelTypeDef("flux_dev", TINY_CLIP, TINY_FLUX_DEV,
                                        TINY_VAE_FLUX, 64, 1)

# The SD3 set at widths that quantize: 128 wide with 2 heads of 64, every
# MMDiT linear's input a multiple of 128.  At 512^2 the CFG batch holds
# 2 x 1024 image tokens, so the x-stream products reach the 2048 rows of
# the W8A8 route.
TINY_Q_MMDIT = mmdit_mod.MmditParams(
    depth=2, d_model=128, n_head=2, patch=2, n_ch_in=4, n_ch_out=4,
    d_ctx_in=256, d_pooled=256, pos_embed_max=32, d_t_embed=128,
    n_ctx=256)
TINY_Q_MODEL_TYPE_SD3 = ModelTypeDef("sd3", TINY_Q_CLIP, TINY_Q_MMDIT,
                                     TINY_VAE_SD3, 512, 2, TINY_Q_CLIP2)


# The SD3.5-medium set at widths that quantize: TINY_Q_MMDIT with qk-norm
# and MMDiT-X's attn2 in block 0, conditioned by the 32-wide towers of the
# JAX package's tiny SD3 files (a 64-wide pooled row, which stays in the
# compute dtype; the 64 context columns zero-padded to 256).  At 512^2 the
# CFG batch's x-stream products have 2 x 1024 rows, the W8A8 route's.
TINY_Q_MMDIT_X = dataclasses.replace(TINY_Q_MMDIT, d_pooled=64,
                                     qk_norm=True, x_self_attn_layers=(0,))
TINY_Q_MODEL_TYPE_SD35 = ModelTypeDef("sd35_medium", TINY_CLIP,
                                      TINY_Q_MMDIT_X, TINY_VAE_SD3, 512, 2,
                                      TINY_CLIP2)

# The Flux set at widths that quantize: one double and one single block
# 128 wide with 2 heads of 64 (RoPE axes 16 + 24 + 24), a 128-wide
# context; ``img_in`` (16 packed channels) and ``vector_in`` (the tiny
# CLIP-L's 32-wide pooled row) stay in the compute dtype, as the full
# model's ``img_in`` (64) does.  Flux has no CFG batch, so the per-column
# storage needs 768^2: ``dit_m_hint(768, 768, flux=True)`` = 2,560 tokens
# (512^2 gives 1,280, below the W8A8 route's 2,048 rows).
TINY_Q_FLUX_SCHNELL = flux_mod.FluxParams(
    depth_double=1, depth_single=1, d_model=128, n_head=2,
    axes_dim=(16, 24, 24), n_ch_in=16, n_ch_out=16, d_ctx_in=128,
    d_pooled=32, n_ctx=128)
TINY_Q_FLUX_DEV = dataclasses.replace(TINY_Q_FLUX_SCHNELL,
                                      guidance_embed=True,
                                      dynamic_shift=True)
TINY_Q_MODEL_TYPE_FLUX = ModelTypeDef("flux_schnell", TINY_CLIP,
                                      TINY_Q_FLUX_SCHNELL, TINY_VAE_FLUX,
                                      768, 1)
TINY_Q_MODEL_TYPE_FLUX_DEV = ModelTypeDef("flux_dev", TINY_CLIP,
                                          TINY_Q_FLUX_DEV, TINY_VAE_FLUX,
                                          768, 1)

# T5: the encoder-parity geometry (128 wide, 4 heads of 32) and one narrow
# enough for the tiny SD3's 80-wide context (its rows zero-padded to 80)
TINY_T5 = t5_mod.T5Params(d_model=128, d_kv=32, n_head=4, d_ff=256,
                          n_layer=2, n_vocab=512)
TINY_T5_SD3 = t5_mod.T5Params(d_model=64, d_kv=16, n_head=4, d_ff=96,
                              n_layer=2, n_vocab=512)


def model_shapes(mt: ModelTypeDef, encoders: bool = False
                 ) -> Dict[str, Tuple[int, ...]]:
    """Internal name -> shape of every parameter the port loads for
    ``mt`` to run txt2img (text towers, UNet or MMDiT, VAE decoder), built
    on the meta device; with ``encoders``, then the VAE encoder's."""
    shapes = {}
    models = list(build_models(mt).items())
    if encoders:
        models += list(build_encoders(mt).items())
    for prefix, m in models:
        shapes.update(module_shapes(m, prefix))
    return shapes


def _init_std(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of a random parameter: 1-D weights (norm scales) are 1
    and biases 0; embeddings have std 0.02; matrices 1/sqrt(fan_in), so
    activations stay O(1) through a full-depth random model."""
    if len(shape) == 1:
        return (1.0 if name.endswith(".weight") else 0.0), 0.0
    if name.endswith((".embed.token.weight", ".embed.position.weight",
                      ".pos_embed")):
        return 0.0, 0.02
    return 0.0, 1.0 / math.sqrt(int(np.prod(shape[1:])))


def _hf_clip_name(internal: str) -> str:
    """``clip.text.*`` -> the HF ``CLIPTextModel`` name (``text_model.*``;
    ``mlimgsynth_tpu/testing.py:566-576``)."""
    t = "text_model." + internal.split(".text.", 1)[1]
    for a, b in (("embed.position.", "embeddings.position_embedding."),
                 ("embed.token.", "embeddings.token_embedding."),
                 (".norm1.", ".layer_norm1."), (".norm2.", ".layer_norm2."),
                 (".attn.", ".self_attn."),
                 ("text_model.ln_final.", "text_model.final_layer_norm.")):
        t = t.replace(a, b)
    return t


def _sd3_ckpt_name(internal: str):
    """Internal name -> sd3 single-file checkpoint name (the port's copy of
    ``mlimgsynth_tpu/testing.py:412-432``).  ``text_proj`` gives a marker
    ``("tproj", name)``: the file holds that Linear weight transposed."""
    if internal.startswith("mmdit."):
        return "model.diffusion_model." + internal[len("mmdit."):]
    if internal.startswith(("clip.text.", "clip2.text.")):
        tower = "clip_l" if internal.startswith("clip.") else "clip_g"
        t = _hf_clip_name(internal)
        pre = f"text_encoders.{tower}.transformer."
        if t == "text_model.text_proj":
            return ("tproj", pre + "text_model.text_projection.weight")
        return pre + t
    return nameconv.internal_to_compvis(internal)   # vae.*


# OpenCLIP names of a layer's tails (``transformer.resblocks.N.``)
_OPENCLIP_TAILS = (("norm1.", "ln_1."), ("norm2.", "ln_2."),
                   ("mlp.fc1.", "mlp.c_fc."), ("mlp.fc2.", "mlp.c_proj."))


def _openclip_name(t: str, pre: str):
    """A text tower's name below ``.text.`` -> its OpenCLIP checkpoint name
    under ``pre`` (SD2's tower, SDXL's bigG).  A q/k/v tensor gives
    ``("qkv", i, fused name)``: the file holds q, k and v stacked in one
    ``in_proj`` tensor."""
    if t == "embed.token.weight":
        return pre + "token_embedding.weight"
    if t == "embed.position.weight":
        return pre + "positional_embedding"
    if t == "text_proj":
        return pre + "text_projection"
    if t.startswith("ln_final."):
        return pre + t
    m = re.match(r"encoder\.layers\.(\d+)\.(.*)", t)
    if m is None:
        return None
    stem, tail = f"{pre}transformer.resblocks.{m.group(1)}.", m.group(2)
    qkv = re.match(r"attn\.(q|k|v)_proj\.(weight|bias)$", tail)
    if qkv:
        return ("qkv", "qkv".index(qkv.group(1)),
                f"{stem}attn.in_proj_{qkv.group(2)}")
    for a, b in _OPENCLIP_TAILS:
        tail = tail.replace(a, b)
    return stem + tail


def _sd2_ckpt_name(internal: str):
    """Internal name -> SD2.1 single-file checkpoint name (the v2-1_768
    layout of ``mlimgsynth_tpu/testing.py:write_checkpoint_sd2``): the
    OpenCLIP ViT-H tower under ``cond_stage_model.model.``, the UNet and
    VAE as CompVis."""
    if internal.startswith("clip.text."):
        return _openclip_name(internal[len("clip.text."):],
                              "cond_stage_model.model.")
    return nameconv.internal_to_compvis(internal)


def _sdxl_ckpt_name(internal: str):
    """Internal name -> sd_xl_base single-file checkpoint name (CLIP-L under
    ``conditioner.embedders.0.transformer.``, bigG in the OpenCLIP layout
    under ``conditioner.embedders.1.model.``, the UNet and VAE as CompVis),
    the layout of ``mlimgsynth_tpu/testing.py:write_checkpoint_sdxl``."""
    if internal.startswith("clip2.text."):
        return _openclip_name(internal[len("clip2.text."):],
                              "conditioner.embedders.1.model.")
    ck = nameconv.internal_to_compvis(internal)
    if ck is not None and internal.startswith("clip.text."):
        ck = ck.replace("cond_stage_model.", "conditioner.embedders.0.", 1)
    return ck


def _refiner_ckpt_name(internal: str):
    """Internal name -> sd_xl_refiner single-file checkpoint name (the bigG
    tower in the OpenCLIP layout under ``conditioner.embedders.0.model.``,
    the UNet and VAE as CompVis; ``mlimgsynth_tpu/testing.py:345-370``)."""
    if internal.startswith("clip.text."):
        return _openclip_name(internal[len("clip.text."):],
                              "conditioner.embedders.0.model.")
    return nameconv.internal_to_compvis(internal)


def _checkpoint_layout(mt: ModelTypeDef) -> Dict[str, tuple]:
    """Checkpoint name -> (shape in the file, how it is stored, [(internal
    name, shape)]) for every parameter of ``mt``, in parameter order, each
    checked to map back onto its internal names: the CompVis layout for
    SD1, the v2-1_768 layout for SD2, the sd_xl_base layout for SDXL, the
    sd3 single-file layout for the flow types.  How: ``"as_is"``; ``"T"``, a
    Linear-stored text projection (transposed); ``"qkv"``, OpenCLIP's fused
    q/k/v (stacked on rows); ``"linear"``, SD2.1's and SDXL's 1x1
    ``proj_in`` / ``proj_out`` stored as linears."""
    flow = getattr(mt.unet_p, "flow", False)
    refiner = not flow and _single_label(mt)
    sdxl = mt.clip2_p is not None and not flow
    sd2 = mt.name == "sd2"
    out: Dict[str, tuple] = {}
    for name, shape in model_shapes(mt, encoders=True).items():
        ck = (_sd3_ckpt_name(name) if flow else _sdxl_ckpt_name(name) if sdxl
              else _refiner_ckpt_name(name) if refiner
              else _sd2_ckpt_name(name) if sd2
              else nameconv.internal_to_compvis(name))
        how, file_shape = "as_is", shape
        if isinstance(ck, tuple) and ck[0] == "tproj":
            how, ck, file_shape = "T", ck[1], tuple(reversed(shape))
            back = nameconv.normalize_name(ck)
            ok = isinstance(back, nameconv.TProj) and back.name == name
        elif isinstance(ck, tuple):
            _, i, ck = ck
            how = "qkv"
            back = nameconv.normalize_name(ck)
            which = ("q_proj", "k_proj", "v_proj")[i]
            ok = (isinstance(back, nameconv.QKV) and name == back.name
                  .replace("in_proj_weight", which + ".weight")
                  .replace("in_proj_bias", which + ".bias"))
            if ck in out:
                prev = out[ck][0]
                file_shape = (prev[0] + shape[0],) + tuple(shape[1:])
        else:
            if ((sdxl or sd2 or refiner)
                    and re.search(r"\.proj_(in|out)\.weight$", name)):
                how, file_shape = "linear", shape[:2]
            ok = ck is not None and nameconv.normalize_name(ck) == name
        if not ok:
            raise ValueError(f"no checkpoint round trip for {name}")
        members = out[ck][2] if ck in out else []
        out[ck] = (file_shape, how, members + [(name, shape)])
    return out


def _draw(shape, std: float, dtype, rng=None, gen=None, device="cpu"):
    """N(0, std^2) values of ``shape`` in ``dtype`` (numpy), from the numpy
    stream ``rng`` or, where it is None, the torch generator ``gen`` on
    ``device`` (a card draws billions of values in seconds)."""
    if rng is not None:
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std)).astype(dtype)
    tdtype = {np.dtype(np.float16): torch.float16,
              np.dtype(np.float32): torch.float32}[np.dtype(dtype)]
    return (torch.randn(shape, generator=gen, device=device).mul_(std)
            .to(tdtype).cpu().numpy())


def random_checkpoint_tensors(mt: ModelTypeDef, seed: int = 0,
                              dtype=np.float16, device=None
                              ) -> Iterator[Tuple[str, np.ndarray]]:
    """(checkpoint name, array) for every tensor of ``mt``'s checkpoint,
    drawn in order from one seeded stream, one at a time (a fused q/k/v
    tensor draws its three parts together): numpy's, or with ``device`` a
    torch generator's on that device."""
    rng = np.random.default_rng(seed) if device is None else None
    gen = (None if device is None else
           torch.Generator(device=device).manual_seed(seed))
    for ck, (file_shape, how, members) in _checkpoint_layout(mt).items():
        parts = []
        for name, shape in members:
            mean, std = _init_std(name, shape)
            if std == 0.0:
                arr = np.full(shape, mean, dtype)
            else:
                arr = _draw(shape, std, dtype, rng, gen, device)
            parts.append(arr)
        arr = np.concatenate(parts) if how == "qkv" else parts[0]
        if how == "T":
            arr = np.ascontiguousarray(arr.T)
        yield ck, arr.reshape(file_shape)


_ST_DTYPES = {np.dtype(np.float16): "F16", np.dtype(np.float32): "F32"}


def write_safetensors(path, shapes: Dict[str, Tuple[int, ...]], dtype,
                      arrays: Iterable[Tuple[str, np.ndarray]]) -> None:
    """Write a safetensors file whose header lists ``shapes`` (in order, all
    ``dtype``), streaming the ``(name, array)`` pairs in the same order."""
    dtype = np.dtype(dtype)
    header, offset = {}, 0
    for name, shape in shapes.items():
        size = int(np.prod(shape)) * dtype.itemsize
        header[name] = {"dtype": _ST_DTYPES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * (-(len(hjson) + 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for (name, arr), want in zip(arrays, shapes.items()):
            if (name, tuple(arr.shape), arr.dtype) != (want[0], want[1],
                                                       dtype):
                raise ValueError(f"{name} {arr.dtype} {arr.shape} does not "
                                 f"match the header entry {want}")
            f.write(np.ascontiguousarray(arr).data)


def write_random_checkpoint(path, mt: ModelTypeDef, seed: int = 0,
                            dtype=np.float16, device=None) -> None:
    """Seeded random checkpoint of ``mt`` at ``path``: CompVis names for
    SD1, the v2-1_768 layout for SD2, the sd_xl_base layout for SDXL, the
    sd3 single-file layout for SD3 and SD3.5; drawn by numpy, or with
    ``device`` by a torch generator on that device."""
    shapes = {ck: v[0] for ck, v in _checkpoint_layout(mt).items()}
    write_safetensors(path, shapes, dtype,
                      random_checkpoint_tensors(mt, seed, dtype, device))


def flux_file_layout(mt: ModelTypeDef, encoders: bool = True
                     ) -> Dict[str, Dict[str, Tuple[str, tuple]]]:
    """The component files of a Flux model type, as BFL and Hugging Face
    ship them: {"model": bare transformer names (``double_blocks.0.img_attn.
    qkv.weight``), "clip": CLIP-L in the HF layout (``text_model.*``, no
    text projection), "vae": bare ``encoder.`` / ``decoder.`` names (the
    encoder with ``encoders``)}, each {name in the file: (internal name,
    shape)}, checked to map back through the session's transforms."""
    out = {"model": {}, "clip": {}, "vae": {}}
    for name, shape in model_shapes(mt, encoders).items():
        if name.startswith("flux."):
            key, fname = "model", name[len("flux."):]
            back = nameconv.normalize_name(fname)
        elif name.startswith("clip.text."):
            key, fname = "clip", _hf_clip_name(name)
            back = _clip_file_name(fname)
        else:
            key = "vae"
            fname = nameconv.internal_to_compvis(name)[
                len("first_stage_model."):]
            back = _vae_file_name(fname)
        if back != name:
            raise ValueError(f"no {key} file round trip for {name}")
        out[key][fname] = (name, shape)
    return out


# The scale of a random full-width Flux: N(0, 1/fan_in) for every matrix
# but the modulation products (``*_mod.lin``, ``modulation.lin``,
# ``final_layer.adaLN_modulation.1``), drawn at half that std.  Their
# outputs are each block's shift, scale and gates: at half width a
# block's gated branches add about a quarter as much variance to the
# residual stream, which 57 blocks accumulate, and (1 + scale) stays
# positive for most channels, as in a trained adaLN; RMSNorm scales are 1
# and biases 0, so the attention logits of the normed q and k stay within
# +-sqrt(128) in bf16.
FLUX_MOD_STD = 0.5


def _flux_std(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    mean, std = _init_std(name, shape)
    if std and name.endswith(("_mod.lin.weight", "modulation.lin.weight",
                              "adaLN_modulation.1.weight")):
        std *= FLUX_MOD_STD
    return mean, std


def write_random_flux_files(dirpath, mt: ModelTypeDef, seed: int = 0,
                            dtype=np.float16, device="cpu"
                            ) -> Dict[str, str]:
    """Seeded random component files of the Flux type ``mt`` under
    ``dirpath`` (:func:`flux_file_layout`; the scale :data:`FLUX_MOD_STD`
    states), drawn one tensor at a time by a torch generator on ``device``
    (a card draws the 12 B values of Flux.1 in seconds, numpy in minutes):
    model, then CLIP-L, then the VAE.  Returns {"model", "clip", "vae":
    path}."""
    import os
    gen = torch.Generator(device=device).manual_seed(seed)
    paths = {}
    for key, entries in flux_file_layout(mt).items():
        def tensors(entries=entries):
            for fname, (name, shape) in entries.items():
                mean, std = _flux_std(name, shape)
                yield fname, (np.full(shape, mean, dtype) if std == 0.0 else
                              _draw(shape, std, dtype, gen=gen,
                                    device=device))

        paths[key] = os.path.join(str(dirpath),
                                  f"flux-random-{key}.safetensors")
        write_safetensors(paths[key], {f: v[1] for f, v in entries.items()},
                          dtype, tensors())
    return paths


def write_random_tae(path, P: tae_mod.TaeParams = tae_mod.TAE_SD1,
                     seed: int = 0, dtype=np.float16) -> None:
    """Seeded random taesd-format file of the decoder and the encoder ``P``
    at ``path`` (names without prefix, as madebyollin/taesd ships them;
    full width by default: ``ch_inner`` 64, ``n_blk`` 3), drawn as the
    checkpoints above are, the decoder's first."""
    with torch.device("meta"):
        shapes = module_shapes(tae_mod.TaeDecoder(P), "")
        shapes.update(module_shapes(tae_mod.TaeEncoder(P), ""))
    rng = np.random.default_rng(seed)

    def tensors():
        for name, shape in shapes.items():
            mean, std = _init_std(name, shape)
            arr = (np.full(shape, mean, dtype) if std == 0.0 else
                   (rng.standard_normal(shape, dtype=np.float32)
                    * np.float32(std)).astype(dtype))
            yield name, arr

    write_safetensors(path, shapes, dtype, tensors())


def t5_file_shapes(P: t5_mod.T5Params, prefix: str = ""
                   ) -> Dict[str, Tuple[int, ...]]:
    """HF ``T5EncoderModel`` name (under ``prefix``: "" for a bare T5 file,
    ``text_encoders.t5xxl.transformer.`` as the sd3 single file bundles it)
    -> shape of every tensor the port's T5 loads."""
    with torch.device("meta"):
        shapes = module_shapes(t5_mod.T5Encoder(P), "")
    return {prefix + k: v for k, v in shapes.items()}


def write_random_t5(path, P: t5_mod.T5Params = TINY_T5, seed: int = 0,
                    dtype=np.float16, prefix: str = "",
                    device: str = "cpu") -> None:
    """Seeded random T5 encoder file of ``P`` at ``path`` in HF names
    (:func:`t5_file_shapes`), drawn as Hugging Face initializes a T5: the
    norm scales 1, the token table N(0, 1), the query projection N(0,
    1/(d_model d_kv)) (T5's attention is unscaled: the query carries
    1/sqrt(d_kv)), every other tensor N(0, 1/fan_in) (the position-bias
    table 1/n_head); one tensor at a time by a torch generator on
    ``device`` (a card draws the 4.8 B values of T5-XXL in seconds)."""
    shapes = t5_file_shapes(P, prefix)
    gen = torch.Generator(device=device).manual_seed(seed)

    def tensors():
        for name, shape in shapes.items():
            if len(shape) == 1:
                arr = np.ones(shape, dtype)
            else:
                std = (1.0 if name.endswith("shared.weight") else
                       1.0 / math.sqrt(shape[1] * (
                           P.d_kv if name.endswith(".q.weight") else 1)))
                arr = _draw(shape, std, dtype, gen=gen, device=device)
            yield name, arr

    write_safetensors(path, shapes, dtype, tensors())


def write_embedding(path, tables: Dict[str, np.ndarray]) -> None:
    """A textual-inversion file at ``path`` (f32): ``{"emb_params": rows}``
    in the A1111 layout, or ``{"clip_l": rows, "clip_g": rows}`` for SDXL,
    each [vectors, width]."""
    tables = {k: np.ascontiguousarray(v, np.float32)
              for k, v in tables.items()}
    write_safetensors(path, {k: v.shape for k, v in tables.items()},
                      np.float32, iter(tables.items()))


# kohya LoRA prefixes of the text towers: SD1/SD2 name their one tower
# ``lora_te_``, SDXL its two ``lora_te1_`` / ``lora_te2_``
_LORA_TE = {"clip.text.": "lora_te_", "clip2.text.": "lora_te2_"}
_LORA_TE_XL = {"clip.text.": "lora_te1_", "clip2.text.": "lora_te2_"}


def lora_name(internal: str, sdxl: bool = False) -> str:
    """The kohya name stem of a LoRA for the weight ``internal``
    (``<stem>.weight``, an internal name): ``lora_unet_...`` for the UNet
    (its CompVis path with dots as underscores), ``lora_te_...`` /
    ``lora_te1_`` / ``lora_te2_...`` for the text towers (their HF
    transformers path), ``lora_unet_joint_blocks_...`` for the MMDiT's
    joint blocks, ``lora_`` plus the CompVis path otherwise.  Checked to map
    back onto ``internal``."""
    stem = internal[:-len(".weight")]
    te = _LORA_TE_XL if sdxl else _LORA_TE
    pre = next((p for p in te if stem.startswith(p)), None)
    if pre is not None:
        t = "text_model." + stem[len(pre):]
        for a, b in ((".embed.", ".embeddings."), (".norm1", ".layer_norm1"),
                     (".norm2", ".layer_norm2"), (".attn.", ".self_attn.")):
            t = t.replace(a, b)
        name = te[pre] + t.replace(".", "_")
    elif stem.startswith("mmdit.joint_blocks."):
        name = "lora_unet_" + stem[len("mmdit."):].replace(".", "_")
    else:
        cv = nameconv.internal_to_compvis(internal)
        if cv is None:
            raise ValueError(f"no LoRA name for {internal}")
        cv = cv[:-len(".weight")]
        if cv.startswith("model.diffusion_model."):
            cv = "unet_" + cv[len("model.diffusion_model."):].replace(
                ".", "_")
        name = "lora_" + cv
    back = nameconv.normalize_lora_name(
        name + ".lora_down.weight",
        "mmdit" if internal.startswith("mmdit.") else "sd")
    if back != stem + ".lora_down.weight":
        raise ValueError(f"LoRA name {name} maps to {back}, not {internal}")
    return name


def lora_attention_targets(mt: ModelTypeDef,
                           towers: Tuple[str, ...] = ("clip.text.",)):
    """Every UNet attention projection (self and cross: q, k, v, out) and
    the MLP weights (fc1, fc2) of the text towers at ``towers``: the
    targets of a typical style LoRA."""
    proj = re.compile(r"\.attn[12]\.(q|k|v|out)_proj\.weight$")
    mlp = re.compile(r"\.mlp\.fc[12]\.weight$")
    return [n for n in model_shapes(mt)
            if (n.startswith("unet.") and proj.search(n))
            or (n.startswith(towers) and mlp.search(n))]


def write_random_lora(path, mt: ModelTypeDef, targets, rank: int = 4,
                      seed: int = 0, alpha=None, dtype=np.float16) -> Dict:
    """Seeded random LoRA file of ``mt`` at ``path``, in kohya names
    (:func:`lora_name`), of rank ``rank`` for each internal ``<stem>.weight``
    in ``targets`` (a linear's [out, in] or a conv's [out, in, kh, kw]
    weight: down is [rank, in * kh * kw], up [out, rank]); ``alpha`` (the
    ``.alpha`` scalar) defaults to the rank.  down ~ N(0, 1/in) and up ~
    N(0, 1/rank) / 4, so a full-width delta moves each weight by about a
    quarter of its own spread.  Returns {stem name: (down, up, alpha)} in
    f32 as the file holds them."""
    shapes = model_shapes(mt, encoders=True)
    sdxl = mt.clip2_p is not None and not getattr(mt.unet_p, "flow", False)
    rng = np.random.default_rng(seed)
    header, arrays, out = {}, [], {}
    a = float(rank if alpha is None else alpha)
    for name in targets:
        shape = shapes[name]
        n_out, n_in = shape[0], int(np.prod(shape[1:]))
        stem = lora_name(name, sdxl)
        down = (rng.standard_normal((rank, n_in), dtype=np.float32)
                / np.float32(math.sqrt(n_in))).astype(dtype)
        up = (rng.standard_normal((n_out, rank), dtype=np.float32)
              / np.float32(4.0 * math.sqrt(rank))).astype(dtype)
        alpha_arr = np.array([a], dtype)
        for k, v in ((".lora_down.weight", down), (".lora_up.weight", up),
                     (".alpha", alpha_arr)):
            header[stem + k] = v.shape
            arrays.append((stem + k, v))
        out[stem] = (down.astype(np.float32), up.astype(np.float32),
                     float(alpha_arr[0]))
    write_safetensors(path, header, dtype, iter(arrays))
    return out


# A Flux LoRA's targets in every block: the image stream's fused qkv, its
# attention output and its MLP input in the double blocks, ``linear1`` (the
# fused qkv and MLP input) and ``linear2`` in the single blocks.  In
# diffusers-PEFT names a fused target is one slice: the q third of the qkv
# (``attn.to_q``), the MLP's four sevenths of ``linear1`` (``proj_mlp``).
# (weight tail, kohya module, PEFT module, PEFT row slice (num, span, den)
# or None)
_FLUX_LORA_DOUBLE = (("img_attn.qkv", "img_attn_qkv", "attn.to_q", (0, 1, 3)),
                     ("img_attn.proj", "img_attn_proj", "attn.to_out.0",
                      None),
                     ("img_mlp.0", "img_mlp_0", "ff.net.0.proj", None))
_FLUX_LORA_SINGLE = (("linear1", "linear1", "proj_mlp", (3, 4, 7)),
                     ("linear2", "linear2", "proj_out", None))


def write_random_flux_lora(path, mt: ModelTypeDef, rank: int = 4,
                           seed: int = 0, peft: bool = False,
                           dtype=np.float16, blocks=None) -> Dict:
    """Seeded random LoRA of the Flux type ``mt`` at ``path`` on the
    targets above in every block (``blocks``: in the first (double,
    single) blocks only): kohya names
    (``lora_unet_double_blocks_0_img_attn_qkv``, ``.alpha`` = rank), or
    with ``peft`` diffusers-PEFT ones (``transformer.transformer_blocks.0.
    attn.to_q``, no alpha: scale 1), a fused target's pair on its slice.
    Both draw the same values for a seed, and the kohya file holds a
    sliced target's up rows zero-padded into the fused weight, so the two
    files merge into the same weights bit for bit.  down ~ N(0, 1/in), up ~
    N(0, 1/rank) / 4, as :func:`write_random_lora`.  Returns {internal
    weight name: (down, up over the whole weight, alpha)} in f32 as the
    kohya file holds them."""
    shapes = model_shapes(mt)
    rng = np.random.default_rng(seed)
    header, arrays, out = {}, [], {}
    P = mt.unet_p
    depths = blocks or (P.depth_double, P.depth_single)
    for blocks, table, pblocks, depth in (
            ("double_blocks", _FLUX_LORA_DOUBLE, "transformer_blocks",
             depths[0]),
            ("single_blocks", _FLUX_LORA_SINGLE,
             "single_transformer_blocks", depths[1])):
        for i in range(depth):
            for tail, kmod, pmod, frac in table:
                name = f"flux.{blocks}.{i}.{tail}.weight"
                n_out, n_in = shapes[name]
                rows = n_out if frac is None else n_out // frac[2] * frac[1]
                r0 = 0 if frac is None else n_out // frac[2] * frac[0]
                down = (rng.standard_normal((rank, n_in), dtype=np.float32)
                        / np.float32(math.sqrt(n_in))).astype(dtype)
                up = (rng.standard_normal((rows, rank), dtype=np.float32)
                      / np.float32(4.0 * math.sqrt(rank))).astype(dtype)
                full = np.zeros((n_out, rank), dtype)
                full[r0:r0 + rows] = up
                if peft:
                    stem = f"transformer.{pblocks}.{i}.{pmod}"
                    pairs = ((".lora_A.weight", down), (".lora_B.weight", up))
                    at = "" if frac is None else "@%d/%d/%d" % frac
                    want = f"flux.{blocks}.{i}.{tail}{at}"
                else:
                    stem = f"lora_unet_{blocks}_{i}_{kmod}"
                    pairs = ((".lora_down.weight", down),
                             (".lora_up.weight", full),
                             (".alpha", np.array([rank], dtype)))
                    want = f"flux.{blocks}.{i}.{tail}"
                back = nameconv.normalize_lora_name(stem + pairs[0][0],
                                                    "flux")
                if back != want + ".lora_down.weight":
                    raise ValueError(f"LoRA name {stem} maps to {back}")
                for k, v in pairs:
                    header[stem + k] = v.shape
                    arrays.append((stem + k, v))
                out[name] = (down.astype(np.float32),
                             full.astype(np.float32), float(rank))
    write_safetensors(path, header, dtype, iter(arrays))
    return out

def write_random_controlnet(path, mt: ModelTypeDef, seed: int = 0,
                            dtype=np.float16, zero_scale: float = 0.1,
                            device=None) -> Dict[str, Tuple[int, ...]]:
    """A seeded random ControlNet of ``mt``'s UNet in the CompVis
    ``control_model.*`` layout (each name checked to map back through
    ``normalize_cnet_name``), drawn as :func:`write_random_checkpoint`
    draws; the zero convs (``zc.*``, ``mid.out``), zero when a ControlNet
    is made and small once trained, at ``zero_scale`` times the usual std.
    Returns the file's shapes."""
    shapes, names = {}, {}
    for name, shape in module_shapes(build_controlnet(mt), "cnet.").items():
        ck = nameconv.internal_to_cnet_ckpt(name)
        if ck is None or nameconv.normalize_cnet_name(ck) != name:
            raise ValueError(f"no control_model round trip for {name}")
        shapes[ck], names[ck] = shape, name
    rng = np.random.default_rng(seed) if device is None else None
    gen = (None if device is None else
           torch.Generator(device=device).manual_seed(seed))

    def tensors():
        for ck, shape in shapes.items():
            mean, std = _init_std(names[ck], shape)
            if ".zc." in names[ck] or ".mid.out." in names[ck]:
                std *= zero_scale
            yield ck, (np.full(shape, mean, dtype) if std == 0.0
                       else _draw(shape, std, dtype, rng, gen, device))

    write_safetensors(path, shapes, dtype, tensors())
    return shapes


# the old ESRGAN names of the basicsr ones (``esrgan._OLD_FIXED``)
_OLD_ESRGAN = {v: k for k, v in esr_mod._OLD_FIXED.items()}


def _old_esrgan_name(name: str, n_block: int) -> str:
    """A basicsr RRDBNet name -> the old ESRGAN layout's (``model.N``,
    the trunk under ``model.1.sub.``), which ``esrgan._canon_name`` maps
    back."""
    stem, _, tail = name.partition(".")
    if stem in _OLD_ESRGAN:
        return _OLD_ESRGAN[stem] + "." + tail
    if stem == "conv_body":
        return f"model.1.sub.{n_block}.{tail}"
    m = re.match(r"body\.(\d+)\.rdb(\d)\.(conv\d)\.(.*)", name)
    return f"model.1.sub.{m.group(1)}.RDB{m.group(2)}.{m.group(3)}.0." \
        + m.group(4)


def write_random_esrgan(path, P, seed: int = 0, dtype=np.float32,
                        old_names: bool = False) -> Dict[str, np.ndarray]:
    """A seeded random upscaler of ``P`` (``esrgan.EsrganParams``: RRDBNet;
    ``SrvggParams``: SRVGGNetCompact) at ``path``: ``.pth`` a torch
    ``state_dict`` (under ``params_ema``, as Real-ESRGAN ships), else
    safetensors; RRDBNet with ``old_names`` in the old ESRGAN layout.
    Convs at 1/sqrt(fan_in), biases 0, PReLU slopes 0.25.  Returns the
    basicsr-named arrays."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, t in esr_mod.build_upscaler(P).state_dict().items():
        shape = tuple(t.shape)
        if len(shape) == 4:
            a = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                1.0 / math.sqrt(int(np.prod(shape[1:]))))
        elif name.endswith(".bias"):
            a = np.zeros(shape, np.float32)
        else:
            a = np.full(shape, 0.25, np.float32)
        arrays[name] = a.astype(dtype)
    out = ({_old_esrgan_name(k, P.n_block): v for k, v in arrays.items()}
           if old_names else dict(arrays))
    if str(path).endswith(".pth"):
        torch.save({"params_ema": {k: torch.from_numpy(v)
                                   for k, v in out.items()}}, str(path))
    else:
        write_safetensors(path, {k: v.shape for k, v in out.items()}, dtype,
                          iter(out.items()))
    return arrays


# Each flash kernel against its plain twin on the card: the shapes the SD1.5
# 512^2, SDXL 1024^2, SD3-medium 1024^2 (with 77 or 256 T5 tokens), SD2.1
# 768^2, SD3.5 1024^2 and Flux 1024^2 main paths give the kernels
# (perturbed-attention guidance's cond-only evaluation at batch 1), the
# SD1.5 hires fix's 1024^2 second pass, the SDXL refiner's 1024^2 levels,
# the serving path's merged batches (four SD1.5 requests, an SDXL pair),
# a rank's shapes under tp, dp and pp, and ragged ones.  (kernel, q shape
# [B, H, Sq, D], Sk, where the main path runs it)
ATTN_CASES = [
    ("flash_attn_fwd", (2, 8, 4096, 40), 4096, "UNet level 0"),
    ("flash_attn_fwd", (2, 8, 1024, 80), 1024, "UNet level 1"),
    ("flash_attn_fwd", (2, 10, 4096, 64), 4096, "SDXL UNet level 1"),
    ("flash_attn_fwd", (2, 20, 1024, 64), 1024, "SDXL UNet level 2"),
    ("flash_attn_fwd", (2, 5, 9216, 64), 9216, "SD2 UNet level 0"),
    ("flash_attn_fwd", (2, 10, 2304, 64), 2304, "SD2 UNet level 1"),
    ("flash_attn_fwd", (2, 20, 576, 64), 576,
     "SD2 UNet level 2 (a 64-row last q block, a 64-column kv tile)"),
    ("flash_attn_fwd", (1, 8, 4096, 40), 4096,
     "SD1.5 PAG evaluation (batch 1), level 0"),
    ("flash_attn_fwd", (1, 8, 1024, 80), 1024,
     "SD1.5 PAG evaluation (batch 1), level 1"),
    ("flash_attn_fwd", (1, 10, 4096, 64), 4096,
     "SDXL PAG evaluation (batch 1), level 1"),
    ("flash_attn_fwd", (1, 20, 1024, 64), 1024,
     "SDXL PAG evaluation (batch 1), level 2"),
    ("flash_attn_fwd", (2, 8, 16384, 40), 16384,
     "SD1.5 1024^2 (hires fix second pass), UNet level 0"),
    ("flash_attn_fwd", (2, 8, 4096, 80), 4096,
     "SD1.5 1024^2 (hires fix second pass), UNet level 1"),
    ("flash_attn_fwd", (2, 12, 4096, 64), 4096,
     "SDXL refiner 1024^2, UNet level 1 (12 heads)"),
    ("flash_attn_fwd", (2, 24, 1024, 64), 1024,
     "SDXL refiner 1024^2, UNet level 2 (24 heads)"),
    ("flash_attn_fwd", (8, 8, 4096, 40), 4096,
     "SD1.5 merged batch of 4 (serve), UNet level 0"),
    ("flash_attn_fwd", (8, 8, 1024, 80), 1024,
     "SD1.5 merged batch of 4 (serve), UNet level 1"),
    ("flash_attn_fwd", (4, 10, 4096, 64), 4096,
     "SDXL merged pair, UNet level 1"),
    ("flash_attn_fwd", (4, 20, 1024, 64), 1024,
     "SDXL merged pair, UNet level 2"),
    ("flash_attn_fwd", (2, 4, 4096, 40), 4096,
     "SD1.5 under tp = 2 (a rank's 4 of 8 heads), UNet level 0"),
    ("flash_attn_fwd", (2, 4, 1024, 80), 1024,
     "SD1.5 under tp = 2 (a rank's 4 of 8 heads), UNet level 1"),
    ("flash_attn_fwd", (8, 4, 4096, 40), 4096,
     "SD1.5 merged batch of 4 served under tp = 2, UNet level 0"),
    ("flash_attn_fwd", (8, 4, 1024, 80), 1024,
     "SD1.5 merged batch of 4 served under tp = 2, UNet level 1"),
    ("flash_attn_fwd", (2, 8, 1024, 160), 1024,
     "SD1.5 1024^2 (hires fix second pass), UNet level 2: head dim 160, "
     "8 heads"),
    ("flash_attn_fwd", (2, 8, 4096, 40), 4095, "ragged Sk"),
    ("flash_attn_fwd", (2, 4, 1000, 40), 700, "ragged Sq and Sk"),
    ("flash_attn_fwd", (2, 3, 1000, 136), 700,
     "head dim 136 (three boxes, 24 columns of the last), ragged Sq and Sk"),
    ("flash_attn_fwd", (1, 2, 600, 160), 520,
     "head dim 160, ragged Sq and Sk (an 8-row last kv tile)"),
    ("flash_attn_fwd_wide", (1, 1, 4096, 512), 4096, "VAE mid-block"),
    ("flash_attn_fwd_wide", (1, 1, 4096, 512), 4095, "ragged Sk"),
    ("flash_attn_fwd_wide", (1, 1, 16384, 512), 16384,
     "SD3 and SDXL VAE mid-block"),
    ("flash_attn_fwd_wide", (1, 1, 9216, 512), 9216,
     "SD2 VAE mid-block (144 blocks on 132 SMs)"),
    ("flash_attn_fwd_wide", (1, 1, 6400, 512), 6400,
     "SDXL VAE tile of 640^2 (--vae-tile 512; 100 blocks, one wave)"),
    ("flash_attn_fwd_wide", (1, 1, 2304, 512), 2304,
     "SD1.5 VAE tile of 384^2 (--vae-tile 256)"),
    ("flash_attn_fwd_wide", (4, 1, 4096, 512), 4096,
     "SD1.5 merged batch of 4 (serve), VAE mid-block (B H 4)"),
    ("flash_attn_fwd_wide", (2, 1, 16384, 512), 16384,
     "SDXL merged pair, VAE mid-block (B H 2, two waves)"),
    ("flash_attn_fwd_wide", (2, 1, 4096, 512), 4096,
     "SD1.5 under dp = 2 with batch 2: a rank decodes the gathered batch"),
    ("flash_attn_fwd_wide", (2, 2, 600, 512), 520,
     "ragged Sq and Sk (an 8-row last kv tile)"),
    ("flash_attn_joint", (2, 24, 4250, 64), 4250,
     "MMDiT joint attention, SD3-medium"),
    ("flash_attn_joint", (2, 12, 4250, 64), 4250,
     "SD3-medium under tp = 2 (a rank's 12 of 24 heads)"),
    ("flash_attn_joint", (2, 24, 4429, 64), 4429,
     "SD3-medium with 256 T5 tokens (a ragged tail of 13 past 69 x 64)"),
    ("flash_attn_joint", (2, 38, 4250, 64), 4250,
     "MMDiT joint attention, SD3.5-large (38 heads)"),
    ("flash_attn_joint", (2, 24, 4096, 64), 4096,
     "MMDiT-X attn2 over the latent tokens, SD3.5-medium"),
    ("flash_attn_joint", (1, 24, 4608, 128), 4608,
     "Flux-dev joint attention, 512 T5 tokens (head dim 128)"),
    ("flash_attn_joint", (1, 24, 4352, 128), 4352,
     "Flux-schnell joint attention, 256 T5 tokens (head dim 128)"),
    ("flash_attn_joint", (1, 24, 4250, 64), 4250,
     "SD3.5-medium skip-layer pass, joint attention (batch 1); SD3-medium "
     "under pp = 2 (a microbatch of one row)"),
    ("flash_attn_joint", (1, 24, 4096, 64), 4096,
     "SD3.5-medium skip-layer pass, MMDiT-X attn2 (batch 1)"),
    ("flash_attn_joint", (1, 4, 2049, 64), 2049, "ragged S"),
    ("flash_attn_joint", (1, 2, 2100, 128), 2100, "head dim 128"),
]

# Limits of a kernel's output against its twin's, on q, k, v drawn from
# N(0, 1) in bf16 (each output then has a std of about 0.03).  Both round
# the output to bf16 (2^-9 relative) and the probabilities to bf16, the
# twin after normalising and the kernels before, so on the H100 they differ
# by 3.1e-3 in relative L2 and by at most 4e-3 elementwise at every case
# below.  A wrong kernel differs by far more: on the H100, the scale taken
# from the padded depth (1/sqrt(48) for d = 40) reads 0.12 in relative L2,
# the ragged kv tail dropped 0.16-0.31, the QK^T depth short by 16 columns
# 0.47, the output not rescaled by a new running max 0.85-0.92, and the
# tail's columns past Sk left unmasked 0.036-0.055, which only the ragged
# cases show (tools/torch_kernel_mutants.py plants each and shows it
# caught).
ATTN_REL_L2 = 1e-2
ATTN_ATOL, ATTN_RTOL = 4e-3, 2.0 ** -6


def attention_inputs(shape, sk: int, seed: int = 0):
    """q [B, H, Sq, D] and k, v [B, H, Sk, D], N(0, 1) in bf16 on the card."""
    b, h, sq, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, h, s, d, device="cuda", generator=gen)
            .bfloat16() for s in (sq, sk, sk)]


def _kernel_error(out, ref, rel_l2: float, atol: float, rtol: float) -> dict:
    """A kernel's output against its plain twin's: the largest elementwise
    error, the relative L2 error, and whether both are within the limits
    (and every output finite)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    rel = ((o - r).norm() / r.norm()).item()
    ok = bool(torch.isfinite(o).all() and rel <= rel_l2
              and (err <= atol + rtol * r.abs()).all())
    return {"max_abs_err": err.max().item(), "rel_l2": rel, "ok": ok}


def attention_error(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """A flash kernel against its twin, held to the ``ATTN_*`` limits."""
    return _kernel_error(out, ref, ATTN_REL_L2, ATTN_ATOL, ATTN_RTOL)


# Each quantized-matmul kernel against its plain twin on the card, at the
# products of the SD1.5 512^2 main path (CFG batch 2), the weight-stationary
# and the most frequent tiled products of the SDXL and SD3-medium 1024^2
# ones (CFG batch 2), SD2.1-768-v's (CFG batch 2 of 96^2, 48^2 and 24^2
# tokens), the weight-only products of Flux.1 at 1024^2 (no CFG batch: 4096
# image tokens, 512 T5 tokens on dev, 256 on schnell, 4608 and 4352 in the
# single blocks), a product whose x exceeds the L2 (banded walk) and two
# ragged ones.
# (kernel kind, M, K, N, where the main path runs it); every case runs for
# q8 and q4.
QUANT_CASES = [
    ("ws", 8192, 1280, 320, "ff.net.2, 64x64 level"),
    ("ws", 2048, 640, 5120, "ff.net.0.proj, 32x32 level"),
    ("ws", 2048, 2560, 640, "ff.net.2, 32x32 level"),
    ("ws", 2048, 640, 640, "attention q/k/v/out, 32x32 level"),
    ("ws", 2048, 1280, 1280, "SDXL attention q/k/v/out, 32x32 level"),
    ("ws", 2048, 1280, 10240, "SDXL ff.net.0.proj, 32x32 level"),
    ("ws", 8192, 640, 640, "SDXL attention q/k/v/out, 64x64 level"),
    ("ws", 8192, 640, 5120, "SDXL ff.net.0.proj, 64x64 level"),
    ("ws", 8192, 2560, 640, "SDXL ff.net.2, 64x64 level"),
    ("ws", 2048, 5120, 1280, "SDXL ff.net.2, 32x32 level"),
    ("ws", 4097, 1280, 200, "ragged M and N"),
    ("ws", 2048, 640, 100, "N not a multiple of 8: stores from registers"),
    ("tile", 512, 1280, 1280, "attention q/k/v/out, 16x16 level"),
    ("tile", 154, 768, 1280, "cross-attention k/v, 16x16 level"),
    ("tile", 154, 3072, 768, "CLIP mlp.fc2"),
    ("tile", 2, 1280, 320, "resnet emb_proj, 64x64 level"),
    ("tile", 154, 2048, 640, "SDXL cross-attention k/v, 64x64 level"),
    ("tile", 154, 2048, 1280, "SDXL cross-attention k/v, 32x32 level"),
    ("tile", 2, 2816, 1280, "SDXL label embedding"),
    ("tile", 308, 1536, 6144, "SD3 context mlp.fc1"),
    ("tile", 308, 6144, 1536, "SD3 context mlp.fc2"),
    ("tile", 2, 1536, 9216, "SD3 adaLN"),
    ("ws", 18432, 1280, 320, "SD2 ff.net.2, 96x96 level"),
    ("ws", 4608, 640, 640, "SD2 attention q/k/v/out, 48x48 level"),
    ("tile", 1152, 1280, 1280, "SD2 attention q/k/v/out, 24x24 level"),
    ("tile", 154, 1024, 640, "SD2 cross-attention k/v, 48x48 level"),
    ("ws", 4096, 12288, 3072, "Flux img_mlp.2"),
    ("ws", 4608, 15360, 3072, "Flux single-block linear2"),
    ("ws", 4352, 3072, 21504, "Flux-schnell single-block linear1 (q4_0)"),
    ("ws", 4096, 3072, 64, "Flux final linear (N 64)"),
    ("ws", 4100, 12288, 3000, "x past the L2 (bands of 7 M tiles, the "
     "last 5), ragged M and N"),
    ("tile", 512, 3072, 9216, "Flux txt_attn.qkv, 512 T5 tokens"),
    ("tile", 512, 12288, 3072, "Flux txt_mlp.2, 512 T5 tokens"),
    ("tile", 512, 4096, 3072, "Flux txt_in"),
    ("tile", 256, 3072, 12288, "Flux-schnell txt_mlp.0, 256 T5 tokens"),
    ("tile", 1, 3072, 18432, "Flux double-block modulation"),
    ("tile", 77, 768, 200, "ragged M and N"),
    ("ws", 8192, 640, 320, "SD1.5 tp 2: ff.net.2 share (K 1280 / 2), "
     "64x64 level"),
    ("ws", 2048, 640, 320, "SD1.5 tp 2: attention q/k/v share, 32x32"),
    ("ws", 2048, 640, 2560, "SD1.5 tp 2: ff.net.0.proj share, 32x32"),
    ("ws", 2048, 1280, 640, "SD1.5 tp 2: ff.net.2 share (K 2560 / 2), "
     "32x32"),
    ("tile", 512, 1280, 640, "SD1.5 tp 2: attention q/k/v share, 16x16"),
    ("tile", 512, 640, 1280, "SD1.5 tp 2: attention out_proj share "
     "(K 1280 / 2), 16x16"),
    ("tile", 512, 1280, 5120, "SD1.5 tp 2: ff.net.0.proj share, 16x16"),
    ("tile", 512, 2560, 1280, "SD1.5 tp 2: ff.net.2 share (K 5120 / 2), "
     "16x16"),
    ("tile", 154, 768, 320, "SD1.5 tp 2: cross-attention k/v share, "
     "32x32"),
    ("tile", 308, 1536, 2304, "SD3 tp 2: context attn.qkv share (N 2304, "
     "no multiple of 80 or 160)"),
    ("tile", 308, 1536, 3072, "SD3 tp 2: context mlp.fc1 share"),
]

# Limits of a kernel's output against its twin's, on x ~ N(0, 1) and a
# weight ~ N(0, 1/K) (each output then has a std of about 1).  Both
# dequantize to the same bf16 weight and accumulate in f32 (the twin's
# cuBLAS product may not reduce in bf16, so it rounds an f32 sum once, as
# the JAX package's XLA twin does), so their f32
# sums differ only in summation order (about 1e-6 relative); each rounds its
# sum to bf16, and two such roundings differ by at most one bf16 step,
# 2^-7 of the value, or 2^-8 absolute near zero.  A wrong kernel differs by
# far more: a scale group shifted, the q4 nibble order swapped or one
# 128-deep group dropped reads 0.3 or more in relative L2.
QUANT_REL_L2 = 4e-3
QUANT_ATOL, QUANT_RTOL = 2.0 ** -8, 2.0 ** -7


def quant_inputs(m: int, k: int, n: int, bits: int, seed: int = 0):
    """x [m, k] bf16 on the card, and a weight [n, k] ~ N(0, 1/k) quantized
    by ``ops.quant`` to ``bits`` (weight and scales on the card)."""
    from .ops import quant
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k), dtype=np.float32) / np.float32(
        math.sqrt(k))
    q, s = (quant.quantize_weight_q4 if bits == 4
            else quant.quantize_weight)(w)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    return (x.to("cuda", torch.bfloat16), torch.from_numpy(q).cuda(),
            torch.from_numpy(s).cuda())


def quant_error(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """A quantized-matmul kernel against its twin, held to the ``QUANT_*``
    limits."""
    return _kernel_error(out, ref, QUANT_REL_L2, QUANT_ATOL, QUANT_RTOL)


# The W8A8 kernel on per-column weights against its plain twin: the four
# x-stream products of SD3-medium at 1024^2 (CFG batch 2 x 4096 image
# tokens; slab 512 at K 1536, 1024 at K 6144), those of SD3.5-large (K 2432
# = 19 x 128 has no slab of 1024, 512 or 256: the slab is K itself, where a
# slab's integer dot no longer fits an f32 exactly), SD3.5-medium's
# batch-1 skip-layer pass, Flux.1's per-column products (4096 image
# tokens, 4608 in the single blocks), a ragged M, and ragged N with slabs
# 256 and 640 (K itself).  (M, K, N, where the main path runs it)
INT8_CASES = [
    (8192, 1536, 4608, "x_block attn.qkv"),
    (8192, 1536, 1536, "x_block attn.proj"),
    (8192, 1536, 6144, "x_block mlp.fc1"),
    (8192, 6144, 1536, "x_block mlp.fc2"),
    (8192, 2432, 7296, "SD3.5-large x_block attn.qkv (slab 2432)"),
    (8192, 2432, 2432, "SD3.5-large x_block attn.proj (slab 2432)"),
    (8192, 2432, 9728, "SD3.5-large x_block mlp.fc1 (slab 2432)"),
    (4096, 1536, 4608, "SD3.5-medium skip-layer pass x_block attn.qkv"),
    (4096, 3072, 9216, "Flux img_attn.qkv"),
    (4096, 3072, 12288, "Flux img_mlp.0"),
    (4608, 3072, 21504, "Flux single-block linear1"),
    (4097, 1536, 1536, "ragged M"),
    (2048, 1536, 640, "tile width 80"),
    (300, 768, 200, "ragged M and N, slab 256"),
    (77, 640, 72, "ragged M and N, slab 640"),
    (8192, 1536, 2304, "SD3 tp 2: x_block attn.qkv share (N 2304)"),
    (8192, 1536, 3072, "SD3 tp 2: x_block mlp.fc1 share"),
]

# Limits of the W8A8 kernel against its twin, on x ~ N(0, 1) in bf16 and a
# weight ~ N(0, 1/K) stored per column.  Both quantize x with the same f32
# operations (amax, 127 / amax, round half to even), both products are exact
# integer sums (the twin's f32 matmul of int8-valued operands is exact below
# 2^24 per slab), and both fold the slabs in order without a fused
# multiply-add, so the two agree bit for bit.  The limits are those of the
# other quantized kernels: one activation moved across a rounding boundary
# stays within them, while a slab dropped, a scale taken from the wrong row
# or column, or an unrounded activation does not.
INT8_REL_L2, INT8_ATOL, INT8_RTOL = QUANT_REL_L2, QUANT_ATOL, QUANT_RTOL


def int8_inputs(m: int, k: int, n: int, seed: int = 0):
    """x [m, k] bf16, and a weight [n, k] ~ N(0, 1/k) quantized per block
    and then stored per column by ``ops.quant`` (int8 [n, k], f32 [n]), all
    on the card."""
    from .ops import quant
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k), dtype=np.float32) / np.float32(
        math.sqrt(k))
    q, s, _ = quant.percol_from_blocks(*quant.quantize_weight(w))
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    return (x.to("cuda", torch.bfloat16), torch.from_numpy(q).cuda(),
            torch.from_numpy(s).cuda())


def int8_error(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The W8A8 kernel against its twin, held to the ``INT8_*`` limits."""
    return _kernel_error(out, ref, INT8_REL_L2, INT8_ATOL, INT8_RTOL)


# The W8A8 kernel on per-block weights (K8, the ``MLIS_Q8_MODE=int8`` route)
# against its plain twin: products of an SDXL q8_0 UNet at 1024^2 (CFG
# batch 2: 8,192 tokens at the 64 x 64 level, 2,048 at 32 x 32, 2 x 77
# context rows, 2 label rows), the per-block ones of Flux.1-dev at 1024^2
# (the single blocks' linear2 at 4608 rows, the text stream at 512, the
# modulation at 1) and ragged M and N.  (M, K, N, where the main
# path runs it); the inputs are ``quant_inputs(m, k, n, 8)``.
Q8_INT8_CASES = [
    (8192, 640, 5120, "ff.net.0.proj, 64x64 level"),
    (8192, 2560, 640, "ff.net.2, 64x64 level"),
    (8192, 640, 640, "attention q/k/v/out, 64x64 level"),
    (2048, 1280, 1280, "attention q/k/v/out, 32x32 level"),
    (2048, 1280, 10240, "ff.net.0.proj, 32x32 level"),
    (2048, 5120, 1280, "ff.net.2, 32x32 level"),
    (154, 2048, 1280, "cross-attention k/v, 32x32 level"),
    (2, 2816, 1280, "label_embed.0"),
    (4608, 15360, 3072, "Flux single-block linear2"),
    (512, 3072, 9216, "Flux txt_attn.qkv"),
    (1, 3072, 18432, "Flux double-block modulation"),
    (4097, 640, 200, "ragged M and N"),
    (77, 1280, 72, "ragged M and N"),
    (8192, 640, 320, "SD1.5 tp 2: ff.net.2 share, 64x64 level"),
    (2048, 640, 2560, "SD1.5 tp 2: ff.net.0.proj share, 32x32 level"),
    (2048, 1280, 640, "SD1.5 tp 2: ff.net.2 share, 32x32 level"),
    (512, 1280, 640, "SD1.5 tp 2: attention q/k/v share, 16x16 level"),
    (512, 640, 1280, "SD1.5 tp 2: attention out_proj share, 16x16 level"),
]

# Its limits are those of the per-column kernel, for the same reasons: both
# quantize x with the same f32 operations, both block products are exact
# integer sums, and both fold the blocks in order as (dot * (amax * (1/127)))
# * scale without a fused multiply-add, so the two agree bit for bit; a block
# folded with its neighbour's weight scale or an unrounded activation reads
# far beyond them.
Q8_INT8_REL_L2, Q8_INT8_ATOL, Q8_INT8_RTOL = INT8_REL_L2, INT8_ATOL, INT8_RTOL


def q8_int8_error(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """K8 against its twin, held to the ``Q8_INT8_*`` limits."""
    return _kernel_error(out, ref, Q8_INT8_REL_L2, Q8_INT8_ATOL,
                         Q8_INT8_RTOL)


def median_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn`` on the card: the median over ``n``
    samples of ``reps`` calls timed by CUDA events.  Each sample is queued
    behind a spin of a few milliseconds on the card, so the calls run back
    to back and the host's launch time (tens of microseconds per call, more
    than a small kernel takes) stays out of the number."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)   # cycles: ~2.5 ms at 1.98 GHz
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


# -- tokenizer.json files (the T5 tokenizer's format) ------------------------

def build_charsmap(rules: Dict[str, str]) -> bytes:
    """sentencepiece's ``precompiled_charsmap`` for ``rules`` (key ->
    replacement, non-empty keys without NUL): a little-endian u32 trie size
    in bytes, the Darts double array over each key's UTF-8 bytes (a unit's
    low 8 bits its label, bit 8 "has a leaf", bits 10-31 the XOR offset to
    its children, a leaf unit bit 31 and its value; padded to whole blocks
    of 256 units), then the NUL-terminated
    replacements, a leaf's value the byte offset of its own."""
    trie: dict = {}
    strings = bytearray()
    for key, rep in rules.items():
        if not key or "\0" in key:
            raise ValueError(f"charsmap key {key!r}")
        node = trie
        for c in key.encode("utf-8"):
            node = node.setdefault(c, {})
        node[None] = len(strings)
        strings += rep.encode("utf-8") + b"\0"
    units = {0: 0}
    used_bases = set()

    def place(node, pos):
        labels = sorted(0 if c is None else c for c in node)
        base = 1
        while base in used_bases or any((base ^ c) in units or base ^ c == 0
                                        for c in labels):
            base += 1
        used_bases.add(base)
        off = pos ^ base
        if off >= 1 << 21:
            raise ValueError("charsmap too large for the units' offset field")
        units[pos] = (units[pos] & 0x1FF) | (off << 10)
        for c in labels:
            units[base ^ c] = 0
        for c, child in node.items():
            if c is None:
                units[base] = (1 << 31) | child
                units[pos] |= 1 << 8
        for c, child in sorted((c, n) for c, n in node.items()
                               if c is not None):
            units[base ^ c] = c
            place(child, base ^ c)

    place(trie, 0)
    # every base ^ label (label < 256) inside the array, as Darts blocks of
    # 256 units leave it
    arr = [0] * ((max(max(units), max(used_bases)) | 0xFF) + 1)
    for p, u in units.items():
        arr[p] = u
    blob = struct.pack(f"<{len(arr)}I", *arr)
    return struct.pack("<I", len(blob)) + blob + bytes(strings)


def unigram_tokenizer_spec(pieces, unk_id: int = 2, charsmap: bytes = None,
                           eos: bool = False) -> dict:
    """A ``tokenizer.json`` dict in the layout ``tokenizers`` saves: a
    Unigram model over ``pieces`` ((piece, score) in id order), a Metaspace
    pre-tokenizer, a normalizer of the T5 files' form (the charsmap's
    ``Precompiled`` where one is given, then runs of spaces replaced by
    one), and, with ``eos``, a ``TemplateProcessing`` that appends
    ``</s>`` (id 1), as the T5 tokenizer that Hugging Face distributes
    does."""
    norms = [{"type": "Replace", "pattern": {"Regex": " {2,}"},
              "content": " "}]
    if charsmap is not None:
        norms.insert(0, {"type": "Precompiled", "precompiled_charsmap":
                         base64.b64encode(charsmap).decode()})
    post = None
    if eos:
        seq = {"Sequence": {"id": "A", "type_id": 0}}
        post = {"type": "TemplateProcessing",
                "single": [seq, {"SpecialToken": {"id": "</s>",
                                                  "type_id": 0}}],
                "pair": [seq, {"Sequence": {"id": "B", "type_id": 1}}],
                "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                            "tokens": ["</s>"]}}}
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [],
            "normalizer": {"type": "Sequence", "normalizers": norms},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                              "prepend_scheme": "always", "split": True},
            "post_processor": post, "decoder": None,
            "model": {"type": "Unigram", "unk_id": unk_id,
                      "vocab": [[p, float(s)] for p, s in pieces],
                      "byte_fallback": False}}


def random_unigram_pieces(n_vocab: int, seed: int = 0):
    """``n_vocab`` (piece, score) pairs: ``<pad>``, ``</s>``, ``<unk>``,
    then ``▁`` and the printable ASCII characters alone and after
    ``▁``, then made-up pieces of 2-8 lowercase letters (half after
    ``▁``), all distinct, with seeded log-probability scores."""
    rng = np.random.default_rng(seed)
    pieces = ["<pad>", "</s>", "<unk>", "▁"]
    chars = [chr(c) for c in range(33, 127)]
    pieces += chars + ["▁" + c for c in chars]
    seen = set(pieces)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(pieces) < n_vocab:
        w = "".join(rng.choice(letters, rng.integers(2, 9)))
        if rng.random() < 0.5:
            w = "▁" + w
        if w not in seen:
            seen.add(w)
            pieces.append(w)
    pieces = pieces[:n_vocab]
    scores = -rng.uniform(2.0, 14.0, len(pieces))
    scores[:3] = 0.0
    return list(zip(pieces, scores.tolist()))


def write_tokenizer_json(path, spec: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False, indent=1)
