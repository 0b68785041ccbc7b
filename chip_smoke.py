#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (mlimgsynth_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, one result line each (any failure exits non-zero):
  1. device    - requires CUDA; prints the card's name and power limit;
  2. build     - compiles csrc/flash_attention.cu and csrc/quant_matmul.cu
                 for sm_90a, one nvcc each, started together; per kernel its
                 registers and spills (ptxas -v) and its wgmma instructions
                 (HGMMA and IGMMA in cuobjdump's SASS, where the toolkit has
                 it): the attention kernels (K1, K3/K4; K2) and the
                 weight-only kernels (tiled and weight-stationary) must
                 hold HGMMA, the W8A8 GEMM kernels IGMMA, and none may
                 spill or have its wgmma serialized by ptxas;
  3. kernels   - each kernel against its plain PyTorch version, bf16: the
                 flash kernels at the SD1.5 512^2, SDXL 1024^2,
                 SD3-medium, SD3.5 and Flux 1024^2 main-path shapes (K3
                 at head dim 128 for Flux, at batch 1 for SD3.5-medium's
                 skip-layer pass) and ragged ones, the quantized matmuls
                 (q8 and q4, tiled and weight-stationary) at the SD1.5
                 products, the most frequent SDXL, SD3, SD2 and Flux ones
                 and ragged M and N, the per-column W8A8 kernel at the
                 SD3, SD3.5 (slab 2432) and Flux products and ragged ones,
                 the per-block W8A8 kernel (MLIS_Q8_MODE=int8) at the SDXL
                 and Flux products and ragged ones; each with its time,
                 its plain version's, one
                 PyTorch call's for the same function (for the W8A8 kernels
                 also torch._int_mm's, the int8 library product; for the
                 attention the SDPA backend that PyTorch picks, named) and
                 the card's bound (the attention also with its floor of
                 exponentials on the MUFU, exp_ms);
  4. main      - three paths on one seeded random full-width SD1.5
                 checkpoint, one session at a time (512^2, 20 Euler steps,
                 CFG 7, bf16 activations): bf16 weights, 3 requests; q8_0
                 and q4_0 weights, 2 requests each, and one more q8_0
                 request under MLIS_Q8_MODE=int8.  Then two paths on one
                 seeded random full-width SD3-medium checkpoint (f16 on
                 disk; 1024^2, 20 Euler steps, CFG 7): bf16, 2 requests;
                 q8_0, 1 request and 1 under MLIS_Q8_MODE=int8.  Then two
                 paths on one seeded random full-width SDXL-base checkpoint
                 (f16 on disk; 1024^2, 20 Euler steps, CFG 7): bf16, 2
                 requests; q8_0, 1 request and 1 under MLIS_Q8_MODE=int8 in
                 the same session.  Then SD2.1-768-v through the port's CLI
                 (``cli.main``) on one seeded random full-width checkpoint
                 (f16 on disk; 768^2, 20 DPM++2M steps, CFG 7): 3 requests,
                 each PNG read back with the port's decoder and held to the
                 session's image and infotext, one with --tae on a random
                 full-width taesd file, and a 4-step request per other
                 method (euler_a, heun, taylor3, dpmpp2s, dpmpp2m_sde,
                 unipc; dpmpp2m with --s-noise 1) through the session.
                 img2img, inpainting and LoRA (``img2img`` lines): on the
                 SD1.5 checkpoint through the CLI, with a random full-width
                 LoRA (rank 16 on every UNet attention projection and
                 CLIP-L's MLP), an RGB PNG at --f-t-ini 0.6, an RGBA PNG
                 (top half opaque) at 0.8 and a <lora:NAME:0.8> tag on
                 txt2img; the LoRA on the q8_0 session; one img2img request
                 at f_t_ini 0.6 on SDXL, SD3, SD2 and SD2 with --tae.
                 SD3 with T5-XXL context (``t5`` lines): on the SD3
                 checkpoint with a seeded random full-width T5-XXL file
                 (f16, drawn on the card) by --t5 and a made-up Unigram
                 tokenizer.json of 32,128 pieces, a bf16 session runs one
                 request at t5_tokens 77 and one at 256 (joint attention
                 over 4,250 and 4,429 rows), each with its T5 encode time
                 and peak memory; the T5 rows in bf16 against f32 on the
                 card; the 256 request's latent with the kernels against
                 the same with the plain attention.  Embeddings and prompt
                 editing (``embed_edit`` lines): on the SD1.5 checkpoint
                 through the CLI, an <emb:NAME> whose table is CLIP-L's
                 rows of "cat" gives the latent of the word, bit for bit;
                 on that session "[a cat:a dog:10]" at 20 Euler steps gives
                 the latents of "a cat" through step 10, bit for bit, and
                 other ones after; on SDXL the same with an embedding of
                 both towers' rows in an edited prompt.
                 SD3.5 and Flux.1 (``sd35`` and ``flux`` lines), 1024^2
                 at full width on seeded random files drawn on the card
                 (SD3.5-large at 12 of its 38 blocks and Flux at 6 + 12 of
                 its 19 + 38, SD35_LARGE_DEPTH and FLUX_DEPTH), with the
                 T5-XXL file of the ``t5`` lines:
                 SD3.5-medium (MMDiT-X) and SD3.5-large, 20 Euler steps,
                 CFG 7, 77 T5 tokens, 2 requests each; Flux.1-dev from
                 component files (transformer, CLIP-L, VAE), 20 Euler
                 steps at guidance 3.5 and 512 T5 tokens, 2 requests
                 through the session and one CLI call (--clip, --vae,
                 --t5); Flux.1-schnell, 4 steps, cfg 1, 256 T5 tokens, one
                 request.  Each with its setup and request seconds, peak
                 memory and exact K3 and K2 launches; one denoiser
                 evaluation with the kernels against the plain attention
                 (held to 3e-2) and the whole last request's latent the
                 same two ways (reported).  Then each of those sessions
                 switched to a quantized weight type (the weights read to
                 the card and quantized there; T5 stays loaded):
                 Flux.1-dev q8_0, 2 requests and 1 under
                 MLIS_Q8_MODE=int8, its peak below the bf16 session's,
                 then a seeded random rank-16 LoRA of the first 4 double
                 blocks' image qkv, attention output and MLP input and
                 the first 8 single blocks' linear1 and linear2 (of 19
                 and 38; FLUX_LORA_BLOCKS), in kohya names
                 and in PEFT names (4-step requests; the merged weights
                 checked against the host, the two latents equal);
                 Flux.1-schnell q4_0, 1 request; SD3.5-large q8_0, 1
                 request (K7 at the activation slab 2432 on every
                 x-stream qkv, proj and fc1); SD3.5-medium q8_0 with
                 skip-layer guidance (2.5 on layers 7-9, steps 0-3: four
                 batch-1 evaluations), 1 request.  Each with exact
                 launches by kernel and shape (the quantized products
                 from the module tree) and one denoiser evaluation with
                 the kernels against the quantized matmuls' plain
                 versions (3e-2).  SD2.1 under q8_0 closes the SD2
                 lines: 2 requests, exact launches by product, one UNet
                 evaluation against the plain versions (1e-2).
                 One img2img request at f_t_ini 0.6 on SD3.5-medium and on
                 Flux-dev (K2 in the encoder and the decoder), and SD3
                 q8_0 with the T5-XXL file at 77 tokens, each with exact
                 launches and an in-situ evaluation; on Flux-dev q8_0 and
                 schnell q4_0 the ``drift_groups`` lines: one evaluation
                 with the weight-only kernels on for one product group at
                 a time (the one-row modulations and embedders, the text
                 stream, the long-K products, the rest), the plain
                 versions as they are (every group 0.0) and without their
                 few-row padding.  The sampler and guidance options
                 (``features`` lines), one request each: SD1.5 with
                 cfg_rescale 0.7, a subseed at 0.3 (the initial noise bit
                 for bit the numpy slerp), lcm (4 steps), FreeU, PAG 3 (K1
                 at batch 1) and tiling (the VAE decode wrap-equivariant);
                 SDXL with PAG, DeepCache 3 and FreeU; Flux-dev and SD3
                 with DeepCache 2; each with exact launches by shape and an
                 in-situ evaluation of the option's own path.
                 The second-stage and control paths, one request each on
                 bf16 sessions: ``inpaint`` (SD1.5: a 768^2 RGBA image
                 with an off-centre hole at full resolution, mask blur 4,
                 the image outside the box kept exactly; a random
                 full-width 9-channel inpaint variant drawn on the card),
                 ``controlnet`` (a random full-width SD1.5 ControlNet
                 drawn on the card, a 512^2 hint, strength 0.8), ``hires``
                 (SD1.5 512^2 -> 1024^2 by the latent, then by a random
                 RRDBNet x4plus: K1 at the 1024^2 levels, the wide kernel
                 at head dim 160), ``upscale`` (the CLI's upscale of a
                 512^2 PNG by that model, whole and in 256-pixel tiles:
                 no kernel, time and memory) and ``refiner`` (SDXL-base
                 with a random full-width refiner drawn on the card at
                 switch 0.8, then the refiner alone), each with its
                 seconds, peak memory, exact launches by shape and, but
                 ``upscale``, one denoiser evaluation of its path with the
                 kernels against the plain attention in situ.
                 The serving front ends (``serve``, ``capi``, ``vae_test``
                 and ``sdxl_pair`` lines): an in-process port server over
                 a bf16 SD1.5 512^2 session (its warm-up request first):
                 four concurrent A1111 txt2img requests, queued before its
                 worker starts, merge into one device batch (K1 at batch 8,
                 K2 over 4 latents; mlis_merged_requests_total 3 on
                 /metrics; launches exact), then the same four each alone
                 (each merged row held to the SD1.5 VAE image limit of
                 REF_LIMITS), seconds of both; one OpenAI generation; one
                 preview request polled until it has a frame; one queued
                 request and one running batch cancelled.  One generate
                 through the port's C ABI shim (built with cc) from a C
                 program, on the card, held to the request served alone;
                 the CLI's vae-test; a merged SDXL pair through
                 generate_batch on the bf16 SDXL session (K1 at batch 4).
                 The multi-rank modes (``ranks`` lines): two processes
                 sharing the card over gloo (``parallel/comm.spawn``),
                 each rank a session of its own: SD1.5 512^2 at tp 2, dp 2
                 (batch 2; two requests) and sp 2, 20 Euler steps;
                 SD3-medium 1024^2 at tp 2, sp 2, pp 2 and pp 2 with
                 q8_0, one request at RANK_SD3_STEPS steps; one torchrun
                 CLI generate at SD1.5 tp 2, 20 steps (this script's
                 --cli-rank mode in each rank); after the SD2 lines, once
                 the background checkpoint writes are done.  Each rank's line: transport, setup
                 and request seconds, peak memory, the denoiser's bytes on
                 the rank, launches (flash launches exact by shape), and
                 the relative L2 of its u8 image against the same request
                 on one rank (RANK_LIMIT); the ranks' images equal.
                 The memory paths (``lowmem`` lines, BASELINE config 5):
                 on the SDXL checkpoint, the bf16 session and a q4_0
                 session each run one request with neither option, then
                 two with --unet-split 1 --vae-tile 512 (the first takes
                 the weights to the host, the second is the low-memory
                 request, held under q4_0 to 4 GiB of
                 max_memory_allocated); their latents equal bit for bit;
                 the tiled decode of the q4_0 latent with the kernels
                 against the plain attention, and its device time beside
                 the whole decode's; one SD1.5 img2img CLI call with
                 --vae-tile 256 --unet-split 1.  Each prints its peak
                 allocated and reserved memory, its stage moves and decode
                 seconds.  Checks the images and the exact kernel launch
                 counts of every request (for SD2, img2img and lowmem per
                 shape: K2 runs in the VAE encoder and decoder, or once a
                 tile; K9/K10 per product), the inpainting's kept latent
                 rows (bit for bit the encoded latent), the merged LoRA
                 weights (bit for bit bf16(W + delta), or its quantization,
                 computed on the host) and, under --unet-split, that no
                 tensor of the text encoders or the UNet is left on the
                 card after a request;
  5. reference - per path, one full-width UNet or MMDiT evaluation with the
                 kernels against the same with the plain versions (bf16: the
                 attention, plus one VAE decode, and SDXL's tiled decode
                 under --vae-tile 512; q8_0 / q4_0: the quantized
                 matmuls; SDXL q8_0 under MLIS_Q8_MODE=int8: the per-block
                 W8A8 kernel); SD2 also one whole request's latent and
                 image; the VAE encoder's moments at 512^2 and 1024^2;
  6. shapes    - the quantized products of one SD1.5, one SD3-medium and
                 one SDXL q8_0 request (SD3: but the per-column W8A8
                 kernel's), each timed for the q8 and q4 kernel the dispatch
                 picks in the default mode beside its bound and cuBLAS, and
                 those of the SDXL request under MLIS_Q8_MODE=int8, each
                 timed for the per-block W8A8 kernel; each with a per-request
                 sum (in the kernels line, the tiled and weight-stationary
                 kernels' per-request time on each path);
  7. small     - tiny random SD1 (192^2), SDXL (192^2) and SD3 (512^2)
                 models, and the quantizing tiny SDXL (256^2) under q4_0
                 with both memory options, through the session on the card
                 (bf16, kernels) against the same on the CPU (f32, the path
                 the CPU tests hold against the JAX package);
  8. imports   - nothing of jax or of the JAX package was loaded, and the
                 CLI, T5 and Flux modules were.
Then one JSON line on the kernels and, last, the device JSON line.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import gc
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mlimgsynth_torch import api, cli, testing
from mlimgsynth_torch import tokenizer as tok_mod
from mlimgsynth_torch import weights as weights_mod
from mlimgsynth_torch.io.tensorstore import TensorStore
from mlimgsynth_torch.models import blocks as blocks_mod
from mlimgsynth_torch.models import clip as clip_mod
from mlimgsynth_torch.models import esrgan as esr_mod
from mlimgsynth_torch.models import flux as flux_mod
from mlimgsynth_torch.models import mmdit as mmdit_mod
from mlimgsynth_torch.models import t5 as t5_mod
from mlimgsynth_torch.models import unet as unet_mod
from mlimgsynth_torch.ops import _build, quant
from mlimgsynth_torch.ops import flash_attention as fa
from mlimgsynth_torch.ops import quant_matmul as qmm
from mlimgsynth_torch.ops.quant_plan import pick_large_m_plan
from mlimgsynth_torch.parallel import comm
from mlimgsynth_torch.rng import RngPhilox
from mlimgsynth_torch.sampling import sampler as sampler_mod
from mlimgsynth_torch.sampling import schedule as sch
from mlimgsynth_torch.sampling.solvers import get_solver
from mlimgsynth_torch.utils import image as image_mod

SOURCES = {"flash_attention": "mlimgsynth_torch/csrc/flash_attention.cu",
           "quant_matmul": "mlimgsynth_torch/csrc/quant_matmul.cu"}
REPLACES = {
    "flash_attn_fwd": "mlimgsynth_tpu/ops/flash_attention.py:452",
    "flash_attn_fwd_wide": "mlimgsynth_tpu/ops/flash_attention.py:48",
    "flash_attn_joint": "mlimgsynth_tpu/ops/stock_flash.py:177",
    "q8_matmul_tile": "mlimgsynth_tpu/ops/q8_matmul.py:40",
    "q8_matmul_ws": "mlimgsynth_tpu/ops/q8_matmul.py:267",
    "q4_matmul_tile": "mlimgsynth_tpu/ops/q4_matmul.py:75",
    "q4_matmul_ws": "mlimgsynth_tpu/ops/q4_matmul.py:156",
    "q8_matmul_ws_int8": "mlimgsynth_tpu/ops/q8_matmul.py:432",
    "q8_matmul_int8": "mlimgsynth_tpu/ops/q8_matmul.py:528",
}
REQUESTS = [(42, "a photograph of an astronaut riding a horse"),
            (43, "a watercolor painting of a lighthouse at dawn"),
            (44, "a (red:1.2) fox in the snow, highly detailed")]
# launches per request: flash kernels on every path; per quantized path
# 45 weight-stationary products per UNet evaluation x 20, and 103 tiled ones
# x 20 plus CLIP's 72 (derivation in PERF.md)
FLASH_PER_REQUEST = {"flash_attn_fwd": 200, "flash_attn_fwd_wide": 1}
QUANT_PER_REQUEST = {"ws": 900, "tile": 2132}
PATHS = [("bf16", None, 3), ("q8_0", 8, 2), ("q4_0", 4, 2)]
# under MLIS_Q8_MODE=int8 every quantized product runs the per-block W8A8
# kernel (K8) instead
SD1_INT8_PER_REQUEST = QUANT_PER_REQUEST["ws"] + QUANT_PER_REQUEST["tile"]
# SD3-medium at 1024^2: one joint attention per block and evaluation (24 x
# 20) and the VAE mid-block's; on q8_0 the four x-stream products of every
# block and evaluation run the W8A8 kernel (4 x 24 x 20), the other
# quantized products are counted from the module tree (sd3_want)
SD3_DIM, SD3_STEPS = 1024, 20
SD3_FLASH_PER_REQUEST = {"flash_attn_fwd": 0, "flash_attn_fwd_wide": 1,
                         "flash_attn_joint": 480}
SD3_INT8_PER_REQUEST = 1920
SD3_PATHS = [("bf16", None, 2), ("q8_0", 8, 1)]
# SDXL-base at 1024^2: per UNet evaluation 10 self-attentions at the 64 x 64
# level ([2, 10, 4096, 64]) and 60 at 32 x 32 ([2, 20, 1024, 64]), x 20; the
# VAE mid-block's at [1, 1, 16384, 512]; the quantized products counted
# from the module tree (sdxl_want)
SDXL_DIM, SDXL_STEPS = 1024, 20
SDXL_FLASH_PER_REQUEST = {"flash_attn_fwd": 1400, "flash_attn_fwd_wide": 1,
                          "flash_attn_joint": 0}
SDXL_PATHS = [("bf16", None, 2), ("q8_0", 8, 1)]
# SD2.1-768-v at 768^2, through the CLI: per UNet evaluation 5
# self-attentions at each level with attention ([2, 5, 9216, 64] at 96 x 96,
# [2, 10, 2304, 64] at 48 x 48, [2, 20, 576, 64] at 24 x 24; the 144-token
# mid level and the 77-token cross-attention run the plain softmax) x 20;
# the VAE mid-block's [1, 1, 9216, 512] (none with --tae)
SD2_DIM, SD2_STEPS = 768, 20
SD2_SHAPES = {(2, 5, 9216, 64): 5, (2, 10, 2304, 64): 5,
              (2, 20, 576, 64): 5}   # K1 calls per UNet evaluation
SD2_ARGS = ["-d", str(SD2_DIM), "-s", str(SD2_STEPS), "--method", "dpmpp2m",
            "--cfg-scale", "7", "-n", "blurry, low quality", "-q"]
# the other methods, 4 steps each (s_noise needs sigma * sqrt(2) * s_noise
# above sigma: below 1/sqrt(2) the churn has no real square root, in the
# JAX package's plan as in the reference's)
SD2_SWEEP = [("euler_a", 0.0), ("heun", 0.0), ("taylor3", 0.0),
             ("dpmpp2s", 0.0), ("dpmpp2m_sde", 0.0), ("unipc", 0.0),
             ("dpmpp2m", 1.0)]

# img2img, inpainting and LoRA (BASELINE config 4) on SD1.5 512^2 through
# the CLI, 20 Euler steps cut by f_t_ini (12 and 16 run): (kind, f_t_ini);
# a random LoRA of rank 16 on every UNet attention projection and CLIP-L's
# MLP at multiplier 0.8, by --lora on the image requests, by a tag on the
# txt2img one.  The other models' img2img request runs at I2I_F_T_INI.
I2I_REQUESTS = [("img2img", 0.6), ("inpaint", 0.8), ("lora_tag", 1.0)]
I2I_ARGS = ["-d", "512", "-s", "20", "--method", "euler", "--cfg-scale", "7",
            "-S", "42", "-n", "blurry, low quality", "-q"]
LORA_RANK, LORA_MULT, I2I_F_T_INI = 16, 0.8, 0.6

# The memory paths (BASELINE config 5): SDXL-base 1024^2 with --unet-split
# and --vae-tile 512 (4 decode tiles of 640^2: K2 at [1, 1, 6400, 512]),
# under q4_0 held to the reference's 4 GiB of device memory; SD1.5 512^2
# img2img through the CLI with --vae-tile 256 (4 encode and 4 decode tiles
# of 384^2: K2 at [1, 1, 2304, 512])
LOWMEM = {"vae-tile": 512, "unet-split": 1}
LOWMEM_BYTES = 4 * 2 ** 30
SD1_LOWMEM_ARGS = ["--vae-tile", "256", "--unet-split", "1"]

# SD3-medium with T5-XXL context: one bf16 request at each t5_tokens (the
# joint attention over 4096 image + 77 CLIP + t5_tokens rows); a prompt of
# more than 77 T5 tokens, so that 77 cuts it and 256 pads it; the made-up
# tokenizer's charsmap maps full-width Latin letters, digits and the
# ellipsis.  T5_REL_L2 holds the T5 rows in bf16 against f32 on the card:
# a 24-layer random T5 at width 1024 on the CPU read 2.2e-2 (77 tokens) and
# 2.4e-2 (256), bf16 against f32, and the limit leaves 2.5 times that; the
# full-width T5-XXL on the H100 reads 1.7e-2 and 1.5e-2.
T5_TOKENS = (77, 256)
T5_PROMPT = ("a photograph of an astronaut riding a white horse across the "
             "surface of the moon, the earth rising over the horizon behind "
             "him, dramatic rim light, highly detailed, ３５ｍｍ film grain, "
             "wide angle lens, cinematic composition, and a small red flag "
             "planted in the grey dust in the foreground…")
T5_RULES = {**{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
            **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
            **{chr(0xFF10 + i): chr(0x30 + i) for i in range(10)},
            "…": "..."}
T5_REL_L2 = 6e-2
# the T5-XXL file and tokenizer the ``t5`` lines write, which the SD3.5 and
# Flux lines use too
T5_FILE, T5_TOKENIZER = "t5xxl-random-f16.safetensors", "t5-tokenizer.json"

# The other DiT families (``sd35`` and ``flux`` lines), 1024^2 at full
# width, SD3.5-medium at full depth, SD3.5-large and Flux at a cut depth
# (below): SD3.5-medium and -large, 20 Euler steps, CFG 7, 77 T5
# tokens, two requests each; Flux.1-dev, 20 Euler steps at guidance 3.5
# and 512 T5 tokens (BFL's default for dev), two requests and a CLI call;
# Flux.1-schnell, 4 steps, cfg 1, 256 T5 tokens, one request.  K3 a
# request: one joint attention per block and evaluation (SD3.5-medium also
# one attn2 in each of blocks 0-12), K2 once in the VAE decode.
DIT_DIM, SD35_STEPS = 1024, 20
# the depths cut to keep the whole run inside its time once the rank lines
# came (widths and heads kept): SD3.5-large's joint blocks of 38, Flux's
# double and single blocks of 19 and 38
SD35_LARGE_DEPTH = 12
FLUX_DEPTH = (6, 12)
FLUX_RUNS = {"flux_dev": {"steps": 20, "cfg": 3.5, "t5_tokens": 512,
                          "requests": 2},
             "flux_schnell": {"steps": 4, "cfg": 1.0, "t5_tokens": 256,
                              "requests": 1}}
REQUEST_EVALS = {"flux_schnell": 4}
DIT_K3_PER_REQUEST = {"sd35_medium": 24 * 20 + 13 * 20,
                      "sd35_large": SD35_LARGE_DEPTH * 20,
                      "flux_dev": sum(FLUX_DEPTH) * 20,
                      "flux_schnell": sum(FLUX_DEPTH) * 4}
_FULL_TYPES = api._model_types


def _cut_types() -> dict:
    """The session's model types with SD35_LARGE_DEPTH and FLUX_DEPTH
    (``api._model_types`` in this process while the run lasts)."""
    types = _FULL_TYPES()
    mt = types["sd35_large"]
    P = mt.unet_p
    types["sd35_large"] = dataclasses.replace(mt, unet_p=dataclasses.replace(
        P, depth=SD35_LARGE_DEPTH, d_model=P.width, n_head=P.heads))
    for name in ("flux_dev", "flux_schnell"):
        mt = types[name]
        types[name] = dataclasses.replace(mt, unet_p=dataclasses.replace(
            mt.unet_p, depth_double=FLUX_DEPTH[0],
            depth_single=FLUX_DEPTH[1]))
    return types

# Quantized weight types on SD3.5 and Flux (the ``sd35`` and ``flux`` lines
# with a ``path``), each on the session of its bf16 lines, switched to the
# weight type (the T5 encoder stays loaded): Flux-dev q8_0, two requests and
# one under MLIS_Q8_MODE=int8, then its LoRA requests; Flux-schnell q4_0,
# one request; SD3.5-large q8_0, one request (K7 at the activation slab
# 2432 = K); SD3.5-medium q8_0 with skip-layer guidance (scale 2.5 on
# layers 7-9 over the default window, 0.01-0.2 of the steps: steps 0-3 of
# 20 make one more evaluation of the cond rows, batch 1).  The LoRA: rank
# 16 on the image qkv, attention output and MLP input of the first
# FLUX_LORA_BLOCKS[0] double blocks and the linear1 and linear2 of the first
# FLUX_LORA_BLOCKS[1] single blocks (every kind of target; the host merge
# of all 57 blocks' took 41-65 s a reload), in kohya names and in PEFT
# names (the fused targets' slices), each a request of LORA_STEPS steps.
DIT_Q = {"flux_dev": ("q8_0", 8), "flux_schnell": ("q4_0", 4),
         "sd35_large": ("q8_0", 8), "sd35_medium": ("q8_0", 8)}
SD35_SLG = [("slg-scale", 2.5), ("slg-layers", "7,8,9")]
LORA_STEPS = 4
FLUX_LORA_BLOCKS = (4, 8)
# SD2.1-768-v under q8_0: two requests through the session on the SD2
# checkpoint, 20 DPM++2M steps, CFG 7 (K5 and K6 at SD2's products)
SD2_Q8 = "q8_0"

# Embeddings and prompt editing: a prompt with a word, an embedding of that
# word's token rows in its place, and an edit that switches at EDIT_STEP
# of 20 Euler steps
EMBED_PROMPT = "a photograph of a {} sitting on a red sofa"
EDIT_PROMPTS = {"sd1": ("a photograph of [a cat:a dog:10] sitting on a red "
                        "sofa", "a photograph of a cat sitting on a red sofa"),
                "sdxl": ("a photograph of a <emb:xcat> [in the snow:in the "
                         "rain:10]", "a photograph of a cat in the snow")}
EDIT_STEP = 10

# The sampler and guidance options (``features`` lines), each one request
# at the main path's settings (20 Euler steps, CFG 7) on a bf16 session:
# SD1.5 512^2 with cfg_rescale 0.7, a subseed at strength 0.3, the lcm
# method (4 steps, CFG 1.5), FreeU (the family's values), PAG 3.0 (one
# batch-1 evaluation of the cond rows a step, K1 at batch 1) and seamless
# tiling; SDXL 1024^2 with PAG, DeepCache 3 and FreeU; Flux-dev and SD3
# with DeepCache 2.  (feature, options); the options go back to
# FEATURE_RESET after each.  TILING_WRAP_REL_L2 holds the tiled VAE
# decode of a latent rolled by k against the decode rolled by 8k: both
# sum the same products in other orders (cuDNN's tiles, K2's kv order),
# a bf16 rounding apart.
FEATURES = {
    "sd1": [("cfg_rescale", [("cfg-rescale", 0.7)]),
            ("subseed", [("subseed", 4242), ("subseed-strength", 0.3)]),
            ("lcm", [("method", "lcm"), ("steps", 4), ("cfg-scale", 1.5)]),
            ("freeu", [("freeu", "1")]),
            ("pag", [("pag-scale", 3.0)]),
            ("tiling", [("tiling", 1)])],
    "sdxl": [("pag", [("pag-scale", 3.0)]),
             ("deepcache", [("deepcache", 3)]),
             ("freeu", [("freeu", "1")])],
    "flux_dev": [("deepcache", [("deepcache", 2)])],
    "sd3": [("deepcache", [("deepcache", 2)])],
}
FEATURE_RESET = [("cfg-rescale", 0.0), ("subseed", -1),
                 ("subseed-strength", 0.0), ("method", "euler"),
                 ("steps", 20), ("freeu", ""), ("pag-scale", 0.0),
                 ("tiling", 0), ("deepcache", 0)]
TILING_WRAP_REL_L2, TILING_ROLL = 1e-2, (3, 5)

# The card's peaks (NVIDIA H100 SXM data sheet, dense): bf16 and int8
# tensor cores, and device memory.
PEAK_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12


ms = testing.median_ms   # a call's device time
# a plain version takes 2-100 times its kernel's time, so 5 samples of 2
# calls give its median well enough (the kernels keep 20 samples of 10)
PLAIN = {"n": 5, "reps": 2}


# the card's name and power limit (``nvidia-smi``), and the seconds since
# the start, on every line
CARD = ""
T_START = time.time()


def phase(name: str, **kv) -> None:
    print(json.dumps({"phase": name, **kv, "card": CARD,
                      "t": time.time() - T_START}), flush=True)


def _clocks() -> dict:
    """The card's SM clock, its maximum, power draw and temperature
    (``nvidia-smi``): a run whose clock sits well below the maximum under
    load is throttled, and its times read slow."""
    keys = ("clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu")
    vals = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(keys)}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(", ")
    return {"clocks": dict(zip(keys, vals))}


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> dict:
    t_ops, t_mem = flops / peak, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    global CARD
    t_start = time.time()
    api._model_types = _cut_types
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    CARD = smi
    kind = torch.cuda.get_device_name(0)
    phase("device", kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda, **_clocks())

    t0 = time.time()
    _build.load_all(SOURCES)
    libs = {n: {"nvcc_seconds": i["seconds"], "cached": i["cached"],
                "kernels": kernel_report(n)}
            for n, i in _build.BUILD_INFO.items()}
    phase("build", seconds=time.time() - t0, libs=libs)
    check_wgmma_kernels({**libs["flash_attention"]["kernels"],
                         **libs["quant_matmul"]["kernels"]})

    launches = collections.Counter()
    # the numpy draws of the four checkpoints run in one process of their
    # own (no share of this one's interpreter lock, which the host-bound
    # requests need), in the order the paths take them, while the kernels
    # phase and the paths run
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for model_type in ("sd1", "sd3", "sdxl", "sd2"):
                _WRITES[model_type] = pool.submit(_write_checkpoint, tmp,
                                                  model_type)
            kernels = (check_flash() + check_quant() + check_int8()
                       + check_q8_int8())
            sd1_dq, sd3_dq, sdxl_dq, sdxl_int8 = _paths(tmp, launches)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    dq = {"sd1": sd1_dq, "sdxl": sdxl_dq, "sd3": sd3_dq}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] in ("q8_matmul_tile", "q8_matmul_ws"):
            # the kernel's device time in one q8_0 request of each path
            k["per_request_ms"] = {path: t[k["name"] + "_ms"]
                                   for path, t in dq.items()}
        if k["name"] in ("q4_matmul_tile", "q4_matmul_ws"):
            # q4_0 runs on SD1.5 and, in the lowmem lines, on SDXL
            k["per_request_ms"] = {path: dq[path][k["name"] + "_ms"]
                                   for path in ("sd1", "sdxl")}
        if k["name"] == "q8_matmul_int8":
            k["sdxl_per_request_ms"] = sdxl_int8["ms"]
    small_check()
    check_imports()
    phase("done", seconds=time.time() - t_start, **_clocks())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _paths(tmp: str, launches: collections.Counter):
    """The full-width paths in ``tmp``, their launches added to
    ``launches``: SD1.5, SD3, SDXL, SD2, SD3.5 and Flux.  Returns the timed
    quantized products of the SD1.5, SD3 and SDXL q8_0 requests and of the
    SDXL one under MLIS_Q8_MODE=int8."""
    ckpt = _checkpoint(tmp, "sd1")
    lora = _lora(tmp)
    for wt, bits, n_req in PATHS:
        s = api.MLImgSynth(device="cuda")
        launches.update(main_path(s, ckpt, "sd1", 512, wt,
                                  REQUESTS[:n_req],
                                  lambda s, bits=bits: sd1_want(bits)))
        if bits == 8:
            launches.update(main_path(
                s, ckpt, "sd1", 512, wt, REQUESTS[n_req:n_req + 1],
                lambda s: sd1_want(8, int8=True), mode="int8"))
        reference_check(s, wt, bits)
        if not bits:
            rank_references(s, "sd1", ckpt, wt, (1, 2))
        if bits == 8:
            sd1_dq = time_shapes(s)
            launches.update(lora_q8_request(s, ckpt, lora))
        _drop(s)
    launches.update(sd1_img2img_path(tmp, ckpt, lora))
    launches.update(sd1_lowmem_cli(tmp, ckpt))
    launches.update(embed_edit_sd1(tmp, ckpt))
    launches.update(features_sd1(ckpt))
    launches.update(second_stage_sd1(tmp, ckpt))
    launches.update(serve_sd1(tmp, ckpt))
    sd1_ckpt = ckpt         # kept for the rank phases
    ckpt = _checkpoint(tmp, "sd3")
    for wt, bits, n_req in SD3_PATHS:
        s = api.MLImgSynth(device="cuda")
        launches.update(main_path(s, ckpt, "sd3", SD3_DIM, wt,
                                  REQUESTS[:n_req], sd3_want))
        if not bits:
            launches.update(img2img_request(s, "sd3", SD3_DIM))
        if bits == 8:
            launches.update(main_path(
                s, ckpt, "sd3", SD3_DIM, wt, REQUESTS[n_req:n_req + 1],
                lambda s: sd3_want(s, int8=True), mode="int8"))
        sd3_reference_check(s, wt, bits)
        rank_references(s, "sd3", ckpt, wt, (1,))
        if not bits:
            launches.update(features(s, "sd3"))
            launches.update(t5_path(s, tmp))
        if bits == 8:
            sd3_dq = time_products(sd3_dq_products(s), "sd3")
            launches.update(sd3_q8_t5_request(s, tmp))
            s._t5 = None
        _drop(s)
    sd3_ckpt = ckpt
    ckpt = _checkpoint(tmp, "sdxl")
    for wt, bits, n_req in SDXL_PATHS:
        s = api.MLImgSynth(device="cuda")
        launches.update(main_path(s, ckpt, "sdxl", SDXL_DIM, wt,
                                  REQUESTS[:n_req], sdxl_want))
        if not bits:
            launches.update(sdxl_pair(s))
            launches.update(img2img_request(s, "sdxl", SDXL_DIM))
        if bits == 8:
            launches.update(main_path(
                s, ckpt, "sdxl", SDXL_DIM, wt, REQUESTS[n_req:n_req + 1],
                lambda s: sdxl_want(s, int8=True), mode="int8"))
        sdxl_reference_check(s, wt, bits)
        if not bits:
            launches.update(features(s, "sdxl"))
            launches.update(refiner_path(s, tmp))
            launches.update(embed_edit_sdxl(s, ckpt, tmp))
            launches.update(sdxl_lowmem_requests(s, wt))
        if bits == 8:
            sdxl_dq = time_products(
                unet_products(s, SDXL_DIM, SDXL_STEPS), "sdxl")
            sdxl_int8 = time_sdxl_int8_shapes(s)
        _drop(s)
    launches.update(sdxl_lowmem_path(ckpt))
    os.remove(ckpt)
    launches.update(sd2_path(tmp))
    # the rank phases once the background writes are done (the ranks talk
    # through the host, which the numpy draws share)
    launches.update(ranks_path({"sd1": sd1_ckpt, "sd3": sd3_ckpt}))
    launches.update(ranks_cli(tmp, sd1_ckpt))
    os.remove(sd1_ckpt)
    os.remove(sd3_ckpt)
    t5 = {"t5": os.path.join(tmp, T5_FILE),
          "t5_tokenizer": os.path.join(tmp, T5_TOKENIZER)}
    launches.update(sd35_path(tmp, t5))
    launches.update(flux_path(tmp, t5))
    os.remove(t5["t5"])
    return sd1_dq, sd3_dq, sdxl_dq, sdxl_int8


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = (re.findall(r"L[ib](\d+)E", mangled[i:].split("EEv")[0])
            if mangled[i:i + 1] == "I" else [])
    return f"{name}<{','.join(args)}>" if args else name


def kernel_report(lib: str) -> dict:
    """Per kernel of a built library: registers and spilled bytes from the
    ptxas -v log (and ``wgmma_serialized`` where ptxas reports that it
    serialized the kernel's wgmma), and its wgmma instructions in its SASS
    where the toolkit has cuobjdump: HGMMA (floating point) and IGMMA
    (integer)."""
    out, cur = {}, None
    for ln in _build.BUILD_INFO[lib]["log"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Performance Loss: wgmma.* in the function '(\w+)'", ln)
        if m:
            out.setdefault(_kernel_name(m.group(1)), {})[
                "wgmma_serialized"] = True
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            cur = None
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                              capture_output=True, text=True).stdout
        fn = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\w+)", ln)
            if m:
                fn = out.setdefault(_kernel_name(m.group(1)), {})
                fn["hgmma"] = fn["igmma"] = 0
            elif fn is not None:
                fn["hgmma"] += "HGMMA" in ln
                fn["igmma"] += "IGMMA" in ln
    return out


# the kernels written for wgmma: name prefix -> its SASS opcode
WGMMA_KERNELS = {"attn_hopper_kernel": "hgmma", "attn_wide_kernel": "hgmma",
                 "qmm_ws_kernel": "hgmma", "qmm_tile_kernel": "hgmma",
                 "qmm_i8_kernel": "igmma"}


def check_wgmma_kernels(report: dict) -> None:
    """The attention (K1, K3/K4, K2), weight-only (K5, K6, K9, K10) and
    W8A8 (K7, K8) kernels hold their wgmma instructions (where cuobjdump shows
    the SASS), spill nothing and keep their wgmma asynchronous."""
    for prefix, op in WGMMA_KERNELS.items():
        got = {k: v for k, v in report.items() if k.startswith(prefix)}
        if not got or any(v.get("spill_bytes", 0) or v.get(op) == 0
                          or v.get("wgmma_serialized") for v in got.values()):
            raise AssertionError(f"{prefix} kernels: {got}")


def _entry(name: str, source: str, **kv) -> dict:
    extra = ({"also_replaces": "mlimgsynth_tpu/ops/splash_flash.py:114"}
             if name == "flash_attn_joint" else {})
    return {"name": name, "route": "cuda", "source": SOURCES[source],
            "replaces": REPLACES[name], **extra, "launches": 0, **kv}


# One request's calls of each flash kernel at its main-path shapes, (q
# shape, Sk) -> {model: calls}; they add up to the launch counts above
FLASH_SHAPE_CALLS = {
    ((2, 8, 4096, 40), 4096): {"sd1": 100, "sd1_cnet": 40},
    ((2, 8, 1024, 80), 1024): {"sd1": 100, "sd1_cnet": 40},
    # the hires fix's second pass at 1024^2 (level 2: head dim 160 on the
    # wide kernel) and the SDXL refiner's levels 1 and 2 at 1024^2
    ((2, 8, 16384, 40), 16384): {"sd1_1024": 100},
    ((2, 8, 4096, 80), 4096): {"sd1_1024": 100},
    ((2, 8, 1024, 160), 1024): {"sd1_1024": 100},
    ((2, 12, 4096, 64), 4096): {"sdxl_refiner": 400},
    ((2, 24, 1024, 64), 1024): {"sdxl_refiner": 400},
    ((2, 10, 4096, 64), 4096): {"sdxl": 200},
    ((2, 20, 1024, 64), 1024): {"sdxl": 1200},
    ((1, 1, 4096, 512), 4096): {"sd1": 1, "sd1_img2img": 2},
    ((1, 1, 16384, 512), 16384): {"sd3": 1, "sdxl": 1, "sd3_img2img": 2,
                                  "sdxl_img2img": 2, "sd3_t5_77": 1,
                                  "sd3_t5_256": 1, "sd35_medium": 1,
                                  "sd35_large": 1, "flux_dev": 1,
                                  "flux_schnell": 1, "sd1_1024": 1,
                                  "sdxl_refiner": 1},
    ((2, 24, 4250, 64), 4250): {"sd3": 480, "sd3_t5_77": 480,
                                "sd35_medium": 480},
    ((2, 24, 4096, 64), 4096): {"sd35_medium": 260},
    ((2, 38, 4250, 64), 4250): {"sd35_large": SD35_LARGE_DEPTH * 20},
    ((1, 24, 4608, 128), 4608): {"flux_dev": sum(FLUX_DEPTH) * 20},
    ((1, 24, 4352, 128), 4352): {"flux_schnell": sum(FLUX_DEPTH) * 4},
    ((2, 24, 4429, 64), 4429): {"sd3_t5_256": 480},
    # SD3.5-medium's skip-layer pass (batch 1, layers 7-9 left out) on 4
    # steps of 20: 21 joint attentions and 10 attn2 a pass
    ((1, 24, 4250, 64), 4250): {"sd35_medium_slg": 84, "sd3_pp2": 96},
    ((1, 24, 4096, 64), 4096): {"sd35_medium_slg": 40},
    # PAG's batch-1 evaluation of the cond rows on each of 20 steps (the
    # SDXL mid transformer's self-attention, identity there, runs none)
    ((1, 8, 4096, 40), 4096): {"sd1_pag": 100},
    ((1, 8, 1024, 80), 1024): {"sd1_pag": 100},
    ((1, 10, 4096, 64), 4096): {"sdxl_pag": 200},
    ((1, 20, 1024, 64), 1024): {"sdxl_pag": 1000},
    ((2, 5, 9216, 64), 9216): {"sd2": 100},
    ((2, 10, 2304, 64), 2304): {"sd2": 100},
    ((2, 20, 576, 64), 576): {"sd2": 100},
    ((1, 1, 9216, 512), 9216): {"sd2": 1, "sd2_img2img": 2},
    ((1, 1, 6400, 512), 6400): {"sdxl_lowmem": 4},
    ((1, 1, 2304, 512), 2304): {"sd1_lowmem_img2img": 8},
    # the serving path: four SD1.5 requests merged into one device batch,
    # and a merged SDXL pair (one batch's calls)
    # a rank's request under tp 2, dp 2 (batch 2) and pp 2 (SD3 at
    # RANK_SD3_STEPS steps)
    ((2, 4, 4096, 40), 4096): {"sd1_tp2": 100},
    ((2, 4, 1024, 80), 1024): {"sd1_tp2": 100},
    ((2, 1, 4096, 512), 4096): {"sd1_dp2": 1},
    ((2, 12, 4250, 64), 4250): {"sd3_tp2": 96},
    ((8, 8, 4096, 40), 4096): {"sd1_serve4": 100},
    ((8, 8, 1024, 80), 1024): {"sd1_serve4": 100},
    ((4, 1, 4096, 512), 4096): {"sd1_serve4": 1},
    ((4, 10, 4096, 64), 4096): {"sdxl_pair": 200},
    ((4, 20, 1024, 64), 1024): {"sdxl_pair": 1200},
    ((2, 1, 16384, 512), 16384): {"sdxl_pair": 1},
}


@functools.lru_cache(maxsize=None)
def _exp_rate() -> float:
    """Exponentials a second on the card: 16 a clock on each SM (its MUFU
    lanes) at the SM's maximum clock (``nvidia-smi clocks.max.sm``)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16 * sms * mhz * 1e6


def check_flash():
    """Each flash kernel against its plain version at the main-path shapes,
    held to the limits in ``testing`` (relative L2 and elementwise); the
    library call is PyTorch's scaled_dot_product_attention, timed on the
    backend its dispatcher picks (its own choice function; named in
    ``library``); ``exp_ms``: the least time the card's MUFU units take for
    the B H Sq Sk exponentials.  Each kernel's entry gives its first
    main-path shape's numbers and, under ``shapes``, those of all of them
    (K2: the SD1.5 and the SDXL / SD3 VAE mid-block)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    summary, per_request = {}, collections.defaultdict(
        lambda: collections.defaultdict(float))
    for name, shape, sk, where in testing.ATTN_CASES:
        fn = getattr(fa, name)
        q, k, v = testing.attention_inputs(shape, sk)
        out = fn(q, k, v)
        ref = fa.attention_plain(q, k, v)
        torch.cuda.synchronize()
        res = testing.attention_error(out, ref)
        b, h, sq, d = shape
        backend = SDPBackend(torch._fused_sdp_choice(q, k, v))
        with sdpa_kernel(backend):
            library_ms = ms(lambda: sdpa(q, k, v))
        t = {"ms": ms(lambda: fn(q, k, v)),
             "plain_ms": ms(lambda: fa.attention_plain(q, k, v), **PLAIN),
             "library_ms": library_ms,
             "library": f"scaled_dot_product_attention {backend.name}",
             **bound(4.0 * b * h * sq * sk * d,
                     2.0 * b * h * d * (2 * sq + 2 * sk)),
             "exp_ms": b * h * sq * sk / _exp_rate() * 1e3}
        phase("kernels", kernel=name, where=where, q=list(shape), sk=sk,
              **res, **t,
              limits={"rel_l2": testing.ATTN_REL_L2,
                      "atol": testing.ATTN_ATOL, "rtol": testing.ATTN_RTOL})
        if not res["ok"]:
            raise AssertionError(f"{name} {where}: kernel disagrees with "
                                 "its plain version")
        for model, calls in FLASH_SHAPE_CALLS.get((shape, sk), {}).items():
            for key in ("ms", "library_ms", "bound_ms", "exp_ms"):
                per_request[(name, model)][key] += calls * t[key]
            per_request[(name, model)]["calls"] += calls
        if (shape, sk) in FLASH_SHAPE_CALLS:   # a main-path shape
            if name not in summary:
                summary[name] = {"shape": [list(shape), sk],
                                 "max_abs_err": res["max_abs_err"], **t}
            summary[name].setdefault("shapes", []).append(
                {"shape": [list(shape), sk],
                 "max_abs_err": res["max_abs_err"], **t})
    want = {("flash_attn_fwd", "sd1"): FLASH_PER_REQUEST["flash_attn_fwd"],
            ("flash_attn_fwd", "sdxl"): SDXL_FLASH_PER_REQUEST[
                "flash_attn_fwd"],
            ("flash_attn_fwd", "sd2"): SD2_STEPS * sum(SD2_SHAPES.values()),
            ("flash_attn_fwd_wide", "sd2"): 1,
            ("flash_attn_joint", "sd3"): SD3_FLASH_PER_REQUEST[
                "flash_attn_joint"],
            **{("flash_attn_joint", m): c for m, c in
               DIT_K3_PER_REQUEST.items()}}
    for key, calls in want.items():
        if per_request[key]["calls"] != calls:
            raise AssertionError(f"FLASH_SHAPE_CALLS gives {key} "
                                 f"{per_request[key]['calls']} calls")
    for (name, model), sums in per_request.items():
        summary[name].setdefault("per_request_ms", {})[model] = sums["ms"]
        summary[name].setdefault("per_request_sums_ms", {})[model] = dict(
            sums)
    return [_entry(n, "flash_attention", **summary[n])
            for n in ("flash_attn_fwd", "flash_attn_fwd_wide",
                      "flash_attn_joint")]


def _quant_bound(m: int, k: int, n: int, bits: int) -> dict:
    """x read, the packed weight and scales read, y written once."""
    return bound(2.0 * m * n * k,
                 2.0 * m * k + n * k * bits / 8 + 4.0 * n * k / 128
                 + 2.0 * m * n)


def _time_quant(name: str, x, q, s, bits: int) -> dict:
    """The kernel, its plain version, and the library call: one torch.matmul
    on the weight dequantized beforehand (the same product without the
    dequantization)."""
    plain = quant.q4_matmul_plain if bits == 4 else quant.q8_matmul_plain
    w = (quant.unpack_q4(q) if bits == 4 else q).float()
    w = (w.view(w.shape[0], -1, quant.KBLOCK) * s[:, :, None]
         ).view(w.shape[0], -1).bfloat16()
    fn = getattr(qmm, name)
    return {"ms": ms(lambda: fn(x, q, s)),
            "plain_ms": ms(lambda: plain(x, q, s), **PLAIN),
            "library_ms": ms(lambda: torch.matmul(x, w.t()))}


# the main-path product whose numbers stand in the kernels line
QUANT_SUMMARY_SHAPE = {"ws": (2048, 640, 5120), "tile": (512, 1280, 1280)}


def check_quant():
    """Each quantized-matmul kernel against its plain version at the
    main-path products and ragged ones, held to the limits in ``testing``."""
    summary = {}
    for bits in (8, 4):
        for kind_, m, k, n, where in testing.QUANT_CASES:
            name = f"q{bits}_matmul_{kind_}"
            x, q, s = testing.quant_inputs(m, k, n, bits)
            plain = quant.q4_matmul_plain if bits == 4 \
                else quant.q8_matmul_plain
            out = getattr(qmm, name)(x, q, s)
            ref = plain(x, q, s)
            torch.cuda.synchronize()
            res = testing.quant_error(out, ref)
            t = {**_time_quant(name, x, q, s, bits),
                 **_quant_bound(m, k, n, bits)}
            phase("kernels", kernel=name, where=where, mkn=[m, k, n], **res,
                  **t, limits={"rel_l2": testing.QUANT_REL_L2,
                               "atol": testing.QUANT_ATOL,
                               "rtol": testing.QUANT_RTOL})
            if not res["ok"]:
                raise AssertionError(f"{name} {where}: kernel disagrees "
                                     "with its plain version")
            if (m, k, n) == QUANT_SUMMARY_SHAPE[kind_]:
                summary[name] = {"shape": [m, k, n],
                                 "max_abs_err": res["max_abs_err"], **t}
    return [_entry(n, "quant_matmul", **summary[n])
            for n in ("q8_matmul_tile", "q8_matmul_ws", "q4_matmul_tile",
                      "q4_matmul_ws")]


def _int_mm_ms(x, q, slab: int):
    """The int8 library yardstick: one cuBLASLt int8 x int8 -> int32 product
    (``torch._int_mm``) on the activations quantized at ``slab`` and the int8
    weight, with no quantization pass and no fold; None where it does not
    take the shape (it needs M > 16)."""
    m = x.numel() // x.shape[-1]
    if m <= 16:
        return None
    xq = quant.quantize_slabs(x, slab)[0].reshape(m, -1).to(torch.int8)
    return ms(lambda: torch._int_mm(xq, q.t()))


def check_int8():
    """The W8A8 kernel against its plain version at the SD3 x-stream
    products and ragged ones, held to the limits in ``testing``; the
    library call is one torch.matmul on the weight dequantized to bf16
    beforehand (the product without the activation quantization)."""
    summary = {}
    per_request = collections.defaultdict(float)
    for m, k, n, where in testing.INT8_CASES:
        x, q, s = testing.int8_inputs(m, k, n)
        out = qmm.q8_matmul_ws_int8(x, q, s)
        ref = quant.q8_ws_int8_plain(x, q, s)
        torch.cuda.synchronize()
        res = testing.int8_error(out, ref)
        w = (q.float() * s[:, None]).bfloat16()
        t = {"ms": ms(lambda: qmm.q8_matmul_ws_int8(x, q, s)),
             "plain_ms": ms(lambda: quant.q8_ws_int8_plain(x, q, s),
                            **PLAIN),
             "library_ms": ms(lambda: torch.matmul(x, w.t())),
             "int8_library_ms": _int_mm_ms(x, q, quant._ws_slab(k)),
             **bound(2.0 * m * n * k, 2.0 * m * k + n * k + 4.0 * n
                     + 2.0 * m * n, PEAK_INT8_OPS)}
        phase("kernels", kernel="q8_matmul_ws_int8", where=where,
              mkn=[m, k, n], slab=quant._ws_slab(k), **res, **t,
              limits={"rel_l2": testing.INT8_REL_L2,
                      "atol": testing.INT8_ATOL, "rtol": testing.INT8_RTOL})
        if not res["ok"]:
            raise AssertionError(f"q8_matmul_ws_int8 {where}: kernel "
                                 "disagrees with its plain version")
        if m == 8192 and k in (1536, 6144):
            # an SD3 x-stream product: 24 blocks x 20 evaluations
            for key in ("ms", "library_ms", "int8_library_ms", "bound_ms"):
                per_request[key] += 24 * SD3_STEPS * t[key]
        if (m, k, n) == (8192, 1536, 6144):
            summary = {"shape": [m, k, n],
                       "max_abs_err": res["max_abs_err"], **t}
    return [_entry("q8_matmul_ws_int8", "quant_matmul",
                   per_request_ms=per_request["ms"],
                   per_request_sums_ms=dict(per_request), **summary)]


def _time_q8_int8(x, q, s) -> dict:
    """K8, its plain version, and the library calls: one torch.matmul on the
    weight dequantized to bf16 beforehand (the product without the
    activation quantization) and the int8 one (:func:`_int_mm_ms`)."""
    w = (q.float().view(q.shape[0], -1, quant.KBLOCK) * s[:, :, None]
         ).view(q.shape[0], -1).bfloat16()
    return {"ms": ms(lambda: qmm.q8_matmul_int8(x, q, s)),
            "plain_ms": ms(lambda: quant.q8_matmul_int8_plain(x, q, s),
                           **PLAIN),
            "library_ms": ms(lambda: torch.matmul(x, w.t())),
            "int8_library_ms": _int_mm_ms(x, q, quant.KBLOCK)}


def _q8_int8_bound(m: int, k: int, n: int) -> dict:
    """x read, the int8 weight and its block scales read, y written once;
    2*M*N*K operations at the int8 rate."""
    return bound(2.0 * m * n * k, 2.0 * m * k + n * k + 4.0 * n * k / 128
                 + 2.0 * m * n, PEAK_INT8_OPS)


def check_q8_int8():
    """The per-block W8A8 kernel (K8, MLIS_Q8_MODE=int8) against its plain
    version at the SDXL products and ragged ones, held to the limits in
    ``testing``."""
    summary = {}
    for m, k, n, where in testing.Q8_INT8_CASES:
        x, q, s = testing.quant_inputs(m, k, n, 8)
        out = qmm.q8_matmul_int8(x, q, s)
        ref = quant.q8_matmul_int8_plain(x, q, s)
        torch.cuda.synchronize()
        res = testing.q8_int8_error(out, ref)
        t = {**_time_q8_int8(x, q, s), **_q8_int8_bound(m, k, n)}
        phase("kernels", kernel="q8_matmul_int8", where=where,
              mkn=[m, k, n], **res, **t,
              limits={"rel_l2": testing.Q8_INT8_REL_L2,
                      "atol": testing.Q8_INT8_ATOL,
                      "rtol": testing.Q8_INT8_RTOL})
        if not res["ok"]:
            raise AssertionError(f"q8_matmul_int8 {where}: kernel "
                                 "disagrees with its plain version")
        if (m, k, n) == (8192, 640, 5120):
            summary = {"shape": [m, k, n],
                       "max_abs_err": res["max_abs_err"], **t}
    return [_entry("q8_matmul_int8", "quant_matmul", **summary)]


def _counts():
    return {**fa.LAUNCHES, **qmm.LAUNCHES}


# model type -> the future of its checkpoint's write in the background
_WRITES = {}


def _write_checkpoint(tmp: str, model_type: str):
    """A seeded random full-width f16 checkpoint of ``model_type``, drawn
    by numpy: (its path, the seconds it took)."""
    path = os.path.join(tmp, f"{model_type}-random-f16.safetensors")
    t0 = time.time()
    testing.write_random_checkpoint(path, api._model_types()[model_type],
                                    seed=0)
    return path, time.time() - t0


def _checkpoint(tmp: str, model_type: str) -> str:
    """The checkpoint of ``model_type``: written in the background
    (``_WRITES``; ``wait_s``, the seconds the run waited for it) or
    here."""
    fut = _WRITES.pop(model_type, None)
    t0 = time.time()
    path, write_s = (fut.result() if fut is not None
                     else _write_checkpoint(tmp, model_type))
    phase("main", model=model_type, step="checkpoint", write_s=write_s,
          wait_s=time.time() - t0, bytes=os.path.getsize(path))
    return path


def _drop(s) -> None:
    del s._models
    s._host.clear()
    gc.collect()
    torch.cuda.empty_cache()


def sd1_want(bits, int8: bool = False) -> dict:
    """The launches of one SD1.5 512^2 request (``int8``: under
    MLIS_Q8_MODE=int8)."""
    want = dict(FLASH_PER_REQUEST)
    if int8:
        want["q8_matmul_int8"] = SD1_INT8_PER_REQUEST
    elif bits:
        for kind_, n in QUANT_PER_REQUEST.items():
            want[f"q{bits}_matmul_{kind_}"] = n
    return want


def _q8_kernel(rows: int, k: int, n: int, percol: bool, int8: bool) -> str:
    """The kernel ``qmm.q8_dot`` gives a product, in the reference's order:
    a per-column weight whose plan is int8ws runs the per-column W8A8
    kernel; then MLIS_Q8_MODE=int8 runs the per-block one; else the ws /
    tile rule."""
    plan = pick_large_m_plan(rows, k, n, 2, percol=True) if percol else None
    kind_ = ("ws_int8" if plan and plan[0] == "int8ws" else "int8" if int8
             else "ws" if qmm.use_ws(rows, k) else "tile")
    return f"q8_matmul_{kind_}"


def sd3_want(s, int8: bool = False) -> dict:
    """The launches of one SD3-medium request: those of ``dit_products``,
    each to the kernel the dispatch gives it (``int8``: under
    MLIS_Q8_MODE=int8)."""
    want = dict(SD3_FLASH_PER_REQUEST)
    if not s.qbits:
        return want
    for (rows, k, n, percol), c in dit_products(s, SD3_STEPS).items():
        key = _q8_kernel(rows, k, n, percol, int8)
        want[key] = want.get(key, 0) + c
    if want.get("q8_matmul_ws_int8") != SD3_INT8_PER_REQUEST:
        raise AssertionError(f"the module tree gives {want}")
    return want


def sd3_dq_products(s) -> collections.Counter:
    """(rows, K, N) -> calls of the products of one SD3-medium q8_0 request
    that run a weight-only kernel in the default mode (every one but the
    per-column W8A8 kernel's)."""
    calls = collections.Counter()
    for (rows, k, n, percol), c in dit_products(s, SD3_STEPS).items():
        if _q8_kernel(rows, k, n, percol, False) != "q8_matmul_ws_int8":
            calls[(rows, k, n)] += c
    return calls


def sdxl_want(s, int8: bool = False) -> dict:
    """The launches of one SDXL-base 1024^2 request (``int8``: under
    MLIS_Q8_MODE=int8); the UNet stores nothing per column."""
    want = dict(SDXL_FLASH_PER_REQUEST)
    if not s.qbits:
        return want
    for (rows, k, n), c in unet_products(s, SDXL_DIM, SDXL_STEPS).items():
        key = _q8_kernel(rows, k, n, False, int8)
        want[key] = want.get(key, 0) + c
    return want


def main_path(s, ckpt, model_type, dim, wt, requests, want_fn,
              mode: str = "dq"):
    """The txt2img ``requests`` (seed, prompt) through one full-width
    session of ``model_type`` at ``dim``^2 and weight type ``wt``, with
    ``MLIS_Q8_MODE`` set to ``mode`` for them; each request must launch
    exactly ``want_fn(s)`` (and no other kernel).  Returns the launches of
    the run."""
    for k, v in [("model", ckpt), ("model-type", model_type),
                 ("weight-type", wt), ("image-dim", dim), ("steps", 20),
                 ("cfg-scale", 7.0), ("method", "euler"),
                 ("scheduler", "uniform")]:
        s.option_set(k, v)
    t0 = time.time()
    s.setup()
    n_q = sum(isinstance(m, blocks_mod.QLinear)
              for mod in s._models.values() for m in mod.modules())
    n_percol = sum(isinstance(m, blocks_mod.QLinear)
                   and m.weight_scale.dim() == 1
                   for mod in s._models.values() for m in mod.modules())
    phase("main", model=model_type, path=wt, step="setup",
          load_s=time.time() - t0, quantized_linears=n_q,
          per_column=n_percol)
    want = dict.fromkeys(_counts(), 0)
    want.update(want_fn(s))
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    qmm.reset_counts()
    os.environ["MLIS_Q8_MODE"] = mode
    try:
        for i, (seed, prompt) in enumerate(requests):
            before = _counts()
            s.option_set("seed", seed)
            s.option_set("prompt", prompt)
            s.option_set("nprompt", "blurry, low quality")
            t0 = time.time()
            img = s.generate()
            secs = time.time() - t0
            got = {k: v - before[k] for k, v in _counts().items()}
            plain_calls = fa.PLAIN_CUDA_CALLS + quant.PLAIN_CUDA_CALLS
            phase("main", model=model_type, path=wt, mode=mode, request=i,
                  seed=seed, cold=(i == 0 and mode == "dq"), seconds=secs,
                  launches=got, plain_cuda_calls=plain_calls,
                  image_mean=float(img.mean()), image_std=float(img.std()))
            if (img.shape != (1, 3, dim, dim) or not np.isfinite(img).all()
                    or float(img.std()) == 0.0):
                raise AssertionError(f"{model_type} {wt} request {i}: bad "
                                     f"image {img.shape}")
            if got != want:
                raise AssertionError(f"{model_type} {wt} {mode} request {i}:"
                                     f" launches {got}, want {want}")
            if plain_calls:
                raise AssertionError(f"{model_type} {wt}: a plain version ran"
                                     " on CUDA tensors on the main path")
    finally:
        del os.environ["MLIS_Q8_MODE"]
    phase("main", model=model_type, path=wt, mode=mode,
          max_memory_allocated=torch.cuda.max_memory_allocated())
    return _counts()


def _check_launches(what, got_shapes, want_shapes) -> dict:
    """The launches of one request, by kernel, after checking them by
    shape against ``want_shapes`` and that no plain version ran on CUDA
    tensors."""
    plain = fa.PLAIN_CUDA_CALLS + quant.PLAIN_CUDA_CALLS
    if dict(got_shapes) != want_shapes or plain:
        raise AssertionError(f"{what}: launches {dict(got_shapes)}, want "
                             f"{want_shapes}; plain calls on CUDA {plain}")
    by_kernel = collections.Counter()
    for (name, _), n in got_shapes.items():
        by_kernel[name] += n
    return dict(by_kernel)


def _cli_request(argv):
    """``cli.main(argv)`` with the session it builds kept: (seconds of the
    call, the session, the flash launches by kernel and q shape, as
    ``fa.LAUNCH_SHAPES`` counts them); the session holds the seconds of its
    ``setup`` (the checkpoint load) and of its ``generate`` after it, and
    the latent it encoded from an input image (``encoded``).  Counts are
    set to 0 just before."""
    built = []
    base = api.MLImgSynth

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

        def generate(self):
            t0 = time.time()
            self.setup()
            self.setup_s = time.time() - t0
            t0 = time.time()
            out = super().generate()
            self.generate_s = time.time() - t0
            return out

        def image_encode(self, img):
            self.encoded = super().image_encode(img)
            return self.encoded

    api.MLImgSynth = Kept
    fa.reset_counts()
    qmm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        rc = cli.main(argv)
    finally:
        api.MLImgSynth = base
    secs = time.time() - t0
    if rc != 0 or len(built) != 1:
        raise AssertionError(f"cli {argv}: exit code {rc}")
    return secs, built[0], collections.Counter(fa.LAUNCH_SHAPES)


def _check_png(path, s) -> None:
    """The PNG the CLI wrote, read by the port's own decoder, against the
    session's image quantized to u8 and its infotext."""
    pix, text = image_mod.png_read(path)
    want = image_mod.tensor_to_image_arr(s.tensors["image"], 0)
    if (not np.array_equal(pix, want)
            or text.get("parameters") != s.infotext):
        raise AssertionError(f"{path}: PNG differs from the session's image "
                             "or infotext")


def _image_ok(img, dim) -> bool:
    return (img.shape == (1, 3, dim, dim) and bool(np.isfinite(img).all())
            and float(img.std()) > 0.0)


def sd2_path(tmp: str) -> collections.Counter:
    """SD2.1-768-v through the CLI: three DPM++2M requests (cold, warm,
    warm), each a ``cli.main`` call that builds its session, loads the
    checkpoint and writes a PNG; the kernels-against-plain check on the
    last one's session; one request with --tae; then the solver sweep.
    Returns the launches of the requests."""
    ckpt = _checkpoint(tmp, "sd2")
    tae = os.path.join(tmp, "taesd-random-f16.safetensors")
    testing.write_random_tae(tae, seed=0)
    launches = collections.Counter()
    for i, (seed, prompt) in enumerate(REQUESTS):
        png = os.path.join(tmp, f"sd2-{i}.png")
        secs, s, shapes = _cli_request(
            ["generate", "-m", ckpt, *SD2_ARGS, "-S", str(seed), "-p",
             prompt, "-o", png])
        got = _check_launches(f"sd2 request {i}", shapes,
                              _flash_want("sd2", SD2_STEPS, 1))
        launches.update(got)
        img = s.tensors["image"]
        phase("main", model="sd2", path="bf16", via="cli", request=i,
              seed=seed, cold=(i == 0), seconds=secs, setup_s=s.setup_s,
              generate_s=s.generate_s,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              launches=got, launches_by_shape={
                  f"{k[0]} {list(k[1])}": n for k, n in shapes.items()},
              image_mean=float(img.mean()), image_std=float(img.std()),
              infotext=s.infotext)
        if not _image_ok(img, SD2_DIM) or s.c["model_type"] != "sd2":
            raise AssertionError(f"sd2 request {i}: bad image {img.shape}")
        _check_png(png, s)
        if i < len(REQUESTS) - 1:
            _drop(s)
    sd2_reference_check(s)
    _drop(s)
    png_in = os.path.join(tmp, "sd2-in.png")
    image_mod.image_save(png_in, _test_image(SD2_DIM, 2)[:, :, :3])
    n_step = _n_step(SD2_STEPS, "dpmpp2m", I2I_F_T_INI)
    for tae_args in ([], ["--tae", tae]):
        secs, s, shapes = _cli_request(
            ["generate", "-m", ckpt, *SD2_ARGS, "-S", "42", "-p",
             REQUESTS[0][1], "-i", png_in, "--f-t-ini", str(I2I_F_T_INI),
             *tae_args, "-o", os.path.join(tmp, "sd2-i2i.png")])
        # K2 in the VAE encoder's mid-block and the decoder's; the TAE has
        # no attention
        got = _check_launches(f"sd2 img2img {tae_args}", shapes,
                              _flash_want("sd2", n_step,
                                          0 if tae_args else 2))
        launches.update(got)
        _img2img_phase("sd2", s, secs, got, tae=bool(tae_args),
                       steps=n_step)
        _check_img2img(s, os.path.join(tmp, "sd2-i2i.png"), SD2_DIM,
                       "img2img")
        _drop(s)
    secs, s, shapes = _cli_request(
        ["generate", "-m", ckpt, *SD2_ARGS, "-S", "42", "-p", REQUESTS[0][1],
         "--tae", tae, "-o", os.path.join(tmp, "sd2-tae.png")])
    got = _check_launches("sd2 --tae", shapes,
                          _flash_want("sd2", SD2_STEPS, 0))
    launches.update(got)
    img = s.tensors["image"]
    phase("main", model="sd2", path="bf16", via="cli", tae=True,
          seconds=secs, setup_s=s.setup_s, generate_s=s.generate_s,
          launches=got,
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          image_mean=float(img.mean()), image_std=float(img.std()))
    if not _image_ok(img, SD2_DIM) or "VAE: tae" not in s.infotext:
        raise AssertionError("sd2 --tae: bad image or infotext")
    s.option_set("tae", "")
    for method, s_noise in SD2_SWEEP:
        for k, v in [("s-ancestral", 0), ("method", method),
                     ("s-noise", s_noise), ("steps", 4), ("seed", 7),
                     ("prompt", "a red fox"), ("nprompt", "blurry")]:
            s.option_set(k, v)
        sol = get_solver(s.c["method"])
        n_step = sch.make_schedule(4, "uniform", sol.n_fe).n_step
        n_eval = n_step * sol.n_fe - (sol.n_fe - 1)
        fa.reset_counts()
        qmm.reset_counts()
        t0 = time.time()
        img = s.generate()
        shapes = collections.Counter(fa.LAUNCH_SHAPES)
        got = _check_launches(f"sd2 {method}", shapes,
                              _flash_want("sd2", n_eval, 1))
        launches.update(got)
        phase("main", model="sd2", path="bf16", method=method,
              s_noise=s_noise, s_ancestral=s.c["s_ancestral"], steps=n_step,
              unet_evaluations=n_eval, seconds=time.time() - t0,
              launches=got, image_mean=float(img.mean()),
              image_std=float(img.std()))
        if not _image_ok(img, SD2_DIM):
            raise AssertionError(f"sd2 {method}: bad image")
    launches.update(sd2_q8_request(s))
    _drop(s)
    os.remove(ckpt)
    return launches


def unet_products(s, dim: int, n_eval: int) -> collections.Counter:
    """(rows, K, N) -> calls of one SD2 or SDXL request's quantized
    products at ``dim``^2, from the module tree: the text towers once on
    the 2 x 77 tokens of prompt and negative prompt (CLIP-L or ViT-H its
    first layers, to the clip skip; bigG all of them, for its pooled
    feature); per UNet evaluation (``n_eval``), the time, label and resnet
    embeddings at 2 rows, the cross-attention k/v at 2 x 77 rows and every
    other transformer linear at the CFG batch's tokens of its level (in.i
    at level (i - 1) / (n_res + 1), out.j at the last level less j / (n_res
    + 1), mid at the last)."""
    P = s._mt.unet_p
    ctx = 2 * s._mt.clip_p.n_token
    last, per = len(P.ch_mult) - 1, P.n_res_blk + 1
    calls = collections.Counter()
    for prefix, mod in s._models.items():
        n_run = (clip_mod.clip_skip_layers(s._mt.clip_p, s.c["clip_skip"])
                 if prefix == "clip.text." else None)
        for name, m in mod.named_modules():
            if not isinstance(m, blocks_mod.QLinear):
                continue
            n, k = m.weight_scale.shape[0], m.weight_scale.shape[1] * 128
            if prefix != "unet.":
                if n_run is None or int(name.split(".")[2]) < n_run:
                    calls[(ctx, k, n)] += 1
                continue
            part, idx = name.split(".")[:2]
            if "embed" in name or "emb_proj" in name:
                rows = 2
            elif ".attn2.k_proj" in name or ".attn2.v_proj" in name:
                rows = ctx
            else:
                level = (last if part == "mid" else (int(idx) - 1) // per
                         if part == "in" else last - int(idx) // per)
                rows = 2 * (dim // 8 >> level) ** 2
            calls[(rows, k, n)] += n_eval
    return calls


def sd2_q8_request(s) -> collections.Counter:
    """SD2.1-768-v under q8_0 (``main`` lines with ``path`` q8_0), the one
    path of the port that had not run on the card: the SD2 session switched
    to q8_0 (the checkpoint read to the card and quantized there), two
    requests at 768^2, 20 DPM++2M steps, CFG 7, each with its exact
    launches by kernel and shape (K1 per attention shape, K2, K5 and K6 per
    product, ``unet_products``) and peak memory; then one UNet evaluation
    (the raw v output) with the quantized matmuls against their plain
    versions.  Returns the launches."""
    for k, v in [("weight-type", SD2_Q8), ("tae", ""), ("method", "dpmpp2m"),
                 ("s-noise", 0), ("s-ancestral", 0), ("steps", SD2_STEPS),
                 ("cfg-scale", 7.0), ("image-dim", SD2_DIM)]:
        s.option_set(k, v)
    t0 = time.time()
    s.setup()
    torch.cuda.synchronize()
    phase("main", model="sd2", path=SD2_Q8, step="setup",
          load_s=time.time() - t0, quantized_linears=sum(
              isinstance(m, blocks_mod.QLinear)
              for mod in s._models.values() for m in mod.modules()))
    want = {**_flash_want("sd2", SD2_STEPS, 1),
            **_quant_want({key + (False,): c for key, c in unet_products(
                s, SD2_DIM, SD2_STEPS).items()}, 8)}
    launches = collections.Counter()
    for i, (seed, prompt) in enumerate(REQUESTS[:2]):
        s.option_set("seed", seed)
        s.option_set("prompt", prompt)
        s.option_set("nprompt", "blurry, low quality")
        fa.reset_counts()
        qmm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        img = s.generate()
        secs = time.time() - t0
        shapes = (collections.Counter(fa.LAUNCH_SHAPES)
                  + collections.Counter(qmm.LAUNCH_SHAPES))
        got = _check_launches(f"sd2 q8_0 request {i}", shapes, want)
        launches.update(got)
        phase("main", model="sd2", path=SD2_Q8, request=i, seed=seed,
              cold=(i == 0), seconds=secs,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              launches=got, launches_by_shape={
                  f"{k[0]} {list(k[1])}": n for k, n in shapes.items()},
              image_mean=float(img.mean()), image_std=float(img.std()))
        if not _image_ok(img, SD2_DIM):
            raise AssertionError(f"sd2 q8_0: bad image {img.shape}")
    unet = s._models["unet."]
    gen = torch.Generator(device="cuda").manual_seed(1)
    hw, sigma = SD2_DIM // 8, 14.6
    x = torch.randn(2, 4, hw, hw, device="cuda", generator=gen) * sigma
    t = torch.full((2,), 999.0, device="cuda")
    cond = torch.from_numpy(np.concatenate(
        [s.tensors["cond"], s.tensors["ncond"]])).cuda()

    def run():
        with torch.no_grad():
            return [("sd2_unet_v_q8_0", unet(
                x / (sigma * sigma + 1.0) ** 0.5, t,
                cond).float())]

    _kernels_vs_plain(SD2_Q8, 8, run)
    return launches


def _release(s) -> None:
    """Free a session's weights on the card, its T5 encoder's too."""
    s._t5 = None
    _drop(s)


def _first_eval(model):
    """A forward pre-hook on ``model`` that keeps the inputs of its next
    call, cloned: (the list it fills, the hook's handle)."""
    got = []

    def hook(mod, args):
        if not got:
            got.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args))

    return got, model.register_forward_pre_hook(hook)


def dit_requests(s, model: str, requests, steps: int, line: str
                 ) -> collections.Counter:
    """The txt2img ``requests`` (seed, prompt) on the SD3.5 or Flux session
    ``s`` (options set), each with its exact flash launches by shape (K3
    at the model's shapes, K2 once) and its peak memory; then the in-situ
    check: the denoiser's first evaluation of the last request, with the
    kernels against the same with the plain attention (``REF_LIMITS``),
    and that whole request's latent, the same two ways (reported).
    Returns the launches of the requests."""
    launches = collections.Counter()
    den = s._models[s._denoiser()]
    for i, (seed, prompt) in enumerate(requests):
        s.option_set("seed", seed)
        s.option_set("prompt", prompt)
        s.option_set("nprompt", "blurry, low quality")
        first, hook = _first_eval(den)
        fa.reset_counts()
        qmm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            img = s.generate()
        finally:
            hook.remove()
        secs = time.time() - t0
        shapes = collections.Counter(fa.LAUNCH_SHAPES)
        got = _check_launches(f"{model} request {i}", shapes,
                              _flash_want(model, steps, 1))
        if any(qmm.LAUNCHES.values()):
            raise AssertionError(f"{model}: quantized kernels "
                                 f"{qmm.LAUNCHES}")
        launches.update(got)
        s.peak_bytes = max(getattr(s, "peak_bytes", 0),
                           torch.cuda.max_memory_allocated())
        phase(line, model=model, request=i, seed=seed,
              cold=(i == 0), seconds=secs, steps=steps,
              cfg_scale=s.c["cfg_scale"], t5_tokens=s.c["t5_tokens"],
              t5_encode_s=s.times.get("t5_encode_s"),
              cond_rows=s.tensors["cond"].shape[1],
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              launches=got, launches_by_shape={
                  f"{k[0]} {list(k[1])}": n for k, n in shapes.items()},
              image_mean=float(img.mean()), image_std=float(img.std()))
        if not _image_ok(img, DIT_DIM) or s.c["model_type"] != model:
            raise AssertionError(f"{model} request {i}: bad image "
                                 f"{img.shape}")
    x_kern = torch.from_numpy(s.tensors["latent"])
    first = first[0]

    def run():
        with torch.no_grad():
            return [(f"{model}_v", den(*first).float())]

    _kernels_vs_plain("bf16", None, run)

    def request():
        s.option_set("seed", requests[-1][0])
        s.option_set("prompt", requests[-1][1])
        s.option_set("nprompt", "blurry, low quality")
        s.generate()
        return torch.from_numpy(s.tensors["latent"])

    x_plain = _plain_run(request)
    phase("reference", path="bf16", output=f"{model}_request_latent",
          rel_l2=((x_kern - x_plain).norm() / x_plain.norm()).item(),
          limit=None, plain_calls=fa.PLAIN_CUDA_CALLS)
    return launches


def _dit_session(model: str, files: dict, t5_tokens: int, steps: int,
                 cfg: float, line: str):
    """A bf16 session of ``model`` on ``files`` ("model", and "clip" and
    "vae" where the model ships as components), with the T5-XXL file and
    tokenizer of the ``t5`` lines, set up (weights and T5 loaded) and its
    setup seconds reported."""
    s = api.MLImgSynth(device="cuda")
    opts = [("model", files["model"]), ("model-type", model),
            ("clip", files.get("clip", "")), ("vae", files.get("vae", "")),
            ("t5", files["t5"]), ("t5-tokenizer", files["t5_tokenizer"]),
            ("t5-tokens", t5_tokens), ("image-dim", DIT_DIM),
            ("steps", steps), ("cfg-scale", cfg), ("method", "euler"),
            ("scheduler", "uniform")]
    for k, v in opts:
        s.option_set(k, v)
    t0 = time.time()
    s.setup()
    load_s = time.time() - t0
    s._t5_load()
    phase(line, model=model, step="setup", load_s=load_s,
          t5_load_s=s.times["t5_load_s"],
          params=sum(p.numel() for p in s._models[s._denoiser()]
                     .parameters()),
          memory_allocated=torch.cuda.memory_allocated())
    return s


def _t5_rows(s) -> int:
    """The T5 context rows of a request of ``s``: ``t5_tokens`` with T5
    weights and a tokenizer, else CLIP's 77 zero rows."""
    t5 = (s.c["t5"] or s._bundled_t5) and s.c["t5_tokenizer"]
    return s.c["t5_tokens"] if t5 else s._mt.clip_p.n_token


def dit_products(s, n_eval: int, slg_evals: int = 0) -> collections.Counter:
    """(rows, K, N, per column) -> calls of one SD3, SD3.5 or Flux
    request's quantized products at DIT_DIM^2, from the module tree: the
    text towers once, every layer (the pooled row is read at the top), on
    the 77 rows of each prompt (the prompt, and the negative prompt under
    CFG); per denoiser evaluation (``n_eval``), the batch's image tokens in
    the image-stream products and the final linear, its context rows (CLIP
    and T5 on the SD3 family, T5 on Flux) in the context-stream products and
    ``context_embedder`` / ``txt_in``, both in Flux's single blocks, and a
    row a sample in the modulations and embedders; under skip-layer
    guidance ``slg_evals`` more evaluations of the cond rows alone (batch
    1) without the blocks of ``slg-layers``."""
    P = s._mt.unet_p
    flux = getattr(P, "flux", False)
    cfg = 1.0 if getattr(P, "guidance_embed", False) else s.c["cfg_scale"]
    b = 2 if cfg > 1 else 1
    img, txt = (DIT_DIM // 16) ** 2, _t5_rows(s) + (0 if flux else 77)
    skip = ({int(v) for v in s.c["slg_layers"].split(",")} if slg_evals
            else set())
    calls = collections.Counter()
    for prefix, mod in s._models.items():
        for name, m in mod.named_modules():
            if not isinstance(m, blocks_mod.QLinear):
                continue
            n = m.weight_scale.shape[0]
            k = (m.weight_q4.shape[1] * 2 if m.bits == 4
                 else m.weight_q8.shape[1])
            key = (k, n, m.weight_scale.dim() == 1)
            if prefix in ("clip.text.", "clip2.text."):
                calls[(b * s._mt.clip_p.n_token,) + key] += 1
                continue
            parts = name.split(".")
            block = (int(parts[1]) + (P.depth_double if parts[0]
                                      == "single_blocks" else 0)
                     if parts[0] in ("joint_blocks", "double_blocks",
                                     "single_blocks") else None)
            if ("adaLN" in name or "_mod." in name or "modulation" in name
                    or parts[0] in ("t_embedder", "y_embedder", "time_in",
                                    "guidance_in", "vector_in")):
                rows = 1
            elif (".x_block." in name or ".img_" in name
                  or name == "final_layer.linear"):
                rows = img
            elif parts[0] == "single_blocks":
                rows = img + txt
            else:       # the context stream, context_embedder, txt_in
                rows = txt
            calls[(b * rows,) + key] += n_eval
            if slg_evals and block not in skip:
                calls[(rows,) + key] += slg_evals
    return calls


def _quant_want(calls, bits: int, int8: bool = False) -> dict:
    """(kernel, (rows, K, N)) -> launches of ``calls``, each product to the
    kernel ``qmm.q8_dot`` / ``q4_dot`` gives it (``int8``: under
    MLIS_Q8_MODE=int8)."""
    want = collections.Counter()
    for (rows, k, n, percol), c in calls.items():
        name = (_q8_kernel(rows, k, n, percol, int8) if bits == 8 else
                "q4_matmul_" + ("ws" if qmm.use_ws(rows, k) else "tile"))
        want[(name, (rows, k, n))] += c
    return dict(want)


def _slg_flash_want(s, slg_evals: int) -> dict:
    """The flash launches of ``slg_evals`` skip-layer passes of an SD3.5
    session (batch 1): a joint attention in each block the pass runs, an
    attn2 in each of those with MMDiT-X's second attention."""
    P = s._mt.unet_p
    skip = {int(v) for v in s.c["slg_layers"].split(",")}
    run = [i for i in range(P.depth) if i not in skip]
    s_joint = (DIT_DIM // 16) ** 2 + 77 + _t5_rows(s)
    want = {("flash_attn_joint", (1, P.heads, s_joint, 64)):
            slg_evals * len(run)}
    n2 = sum(i in P.x_self_attn_layers for i in run)
    if n2:
        want[("flash_attn_joint", (1, P.heads, (DIT_DIM // 16) ** 2, 64))] \
            = slg_evals * n2
    return want


def _slg_evals(s, steps: int) -> int:
    """The evaluations a request of ``s`` steers by skip-layer guidance:
    those of the steps in its window (one each under euler)."""
    if not s.c["slg_scale"]:
        return 0
    i0 = int(round(s.c["slg_start"] * steps))
    i1 = max(int(round(s.c["slg_end"] * steps)), i0 + 1)
    return min(i1, steps) - i0


def dit_switch(s, model: str, line: str, opts) -> None:
    """Set ``opts`` (a weight type among them) on the SD3.5 or Flux session
    ``s`` and set it up again (the denoiser, the text tower and the VAE
    reload, their weights read to the card and quantized there; the T5
    encoder stays), with its setup seconds, quantized and per-column
    linears and device memory reported."""
    for k, v in opts:
        s.option_set(k, v)
    torch.cuda.synchronize()
    t0 = time.time()
    s.setup()
    torch.cuda.synchronize()
    qlin = [m for mod in s._models.values() for m in mod.modules()
            if isinstance(m, blocks_mod.QLinear)]
    phase(line, model=model, path=DIT_Q[model][0], step="setup",
          load_s=time.time() - t0, lora_merge_s=s.times.get("lora_merge_s"),
          quantized_linears=len(qlin),
          per_column=sum(m.weight_scale.dim() == 1 for m in qlin),
          memory_allocated=torch.cuda.memory_allocated(),
          options=dict(opts))


def dit_q_requests(s, model: str, requests, steps: int, line: str,
                   mode: str = "dq", check: bool = True
                   ) -> collections.Counter:
    """The txt2img ``requests`` (seed, prompt) on the quantized SD3.5 or
    Flux session ``s`` under MLIS_Q8_MODE ``mode``, each with its exact
    launches by kernel and shape (the flash kernels' and each quantized
    product's, ``dit_products``; the skip-layer passes' too) and its peak
    memory; then (``check``) the in-situ check: the denoiser's first
    evaluation of the last request with the kernels against the same with
    the quantized matmuls' plain versions (``REF_LIMITS``).  Returns the
    launches of the requests."""
    wt, bits = DIT_Q[model]
    launches = collections.Counter()
    den = s._models[s._denoiser()]
    slg = _slg_evals(s, steps)
    want = {**_flash_want(model, steps, 1), **_quant_want(
        dit_products(s, steps, slg), bits, mode == "int8")}
    if slg:
        want.update(_slg_flash_want(s, slg))
    os.environ["MLIS_Q8_MODE"] = mode
    s.peak_bytes = 0
    try:
        for i, (seed, prompt) in enumerate(requests):
            s.option_set("seed", seed)
            s.option_set("prompt", prompt)
            s.option_set("nprompt", "blurry, low quality")
            first, hook = _first_eval(den)
            fa.reset_counts()
            qmm.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            try:
                img = s.generate()
            finally:
                hook.remove()
            secs = time.time() - t0
            shapes = (collections.Counter(fa.LAUNCH_SHAPES)
                      + collections.Counter(qmm.LAUNCH_SHAPES))
            got = _check_launches(f"{model} {wt} {mode} request {i}",
                                  shapes, want)
            launches.update(got)
            s.last_shapes = shapes
            s.peak_bytes = max(s.peak_bytes,
                               torch.cuda.max_memory_allocated())
            phase(line, model=model, path=wt, mode=mode, request=i,
                  **_clocks(), seed=seed, steps=steps, slg_evaluations=slg,
                  cold=(i == 0 and mode == "dq"), seconds=secs,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launches=got, launches_by_shape={
                      f"{k[0]} {list(k[1])}": n for k, n in shapes.items()},
                  image_mean=float(img.mean()), image_std=float(img.std()))
            if not _image_ok(img, DIT_DIM) or s.c["model_type"] != model:
                raise AssertionError(f"{model} {wt} request {i}: bad "
                                     f"image {img.shape}")
        if check:
            first = s.first_eval = first[0]

            def run():
                with torch.no_grad():
                    return [(f"{model}_v_{wt}" + (
                        "_int8" if mode == "int8" else ""),
                             den(*first).float())]

            _kernels_vs_plain(wt, bits, run)
    finally:
        del os.environ["MLIS_Q8_MODE"]
    return launches


def _check_flux_lora_weights(s, path: str, deltas: dict, mult: float,
                             n_numpy: int = 5) -> None:
    """Every weight the Flux LoRA patches, on the card, against the
    quantization of bf16(W + mult * alpha / rank * up @ down) computed on
    the host in f32 from the file's W (per column where the session stores
    the weight so): bit for bit, quantized on the card by the session's
    torch quantizers; the first ``n_numpy`` also by the numpy ones, which
    the CPU tests hold against the JAX package's."""
    store = TensorStore.open(path)
    n_eq = n_np = 0

    def host(item):
        # numpy and torch release the interpreter lock: threads share out
        # the host work of the weights
        name, (down, up, alpha) = item
        w = weights_mod.read_entry(store, name_map[name]).astype(np.float32)
        scale = np.float32(alpha / down.shape[0] * mult)
        return name, torch.from_numpy(w + (up @ down) * scale).to(s.dtype)

    try:
        name_map = weights_mod.build_name_map(store)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            refs = list(pool.map(host, deltas.items()))
        for j, (name, want) in enumerate(refs):
            mod = s._models["flux."].get_submodule(
                name[len("flux."):-len(".weight")])
            percol = mod.weight_scale.dim() == 1
            q, sc = quant.quantize_weight_torch(want.cuda())
            if percol:
                q, sc, _ = quant.percol_from_blocks_torch(q, sc)
            ok = torch.equal(mod.weight_q8, q) and torch.equal(
                mod.weight_scale, sc)
            if j < n_numpy:
                qn, sn = quant.quantize_weight(want.float().numpy())
                if percol:
                    qn, sn, _ = quant.percol_from_blocks(qn, sn)
                ok = ok and (np.array_equal(q.cpu().numpy(), qn)
                             and np.array_equal(sc.cpu().numpy(), sn))
                n_np += 1
            n_eq += ok
    finally:
        store.close()
    n = len(deltas)
    phase("flux", step="lora_weights", weights=n, equal=n_eq,
          numpy_checked=n_np, mult=mult)
    if n_eq != n:
        raise AssertionError(f"{n - n_eq} of {n} merged Flux LoRA weights "
                             "differ from their host reference")


def flux_lora_requests(s, tmp: str, files: dict) -> collections.Counter:
    """The Flux-dev q8_0 session ``s`` with a seeded random full-width LoRA
    (rank 16 on the first FLUX_LORA_BLOCKS blocks,
    ``testing.write_random_flux_lora``), in kohya names, then in
    PEFT names: each a LoRA list change that reloads the transformer
    alone (merged on the host, then quantized on the card) and a request
    of LORA_STEPS steps with its exact launches; the kohya weights checked
    against the host (``_check_flux_lora_weights``), the PEFT ones equal to
    them, and the two latents equal, bit for bit.  Returns the
    launches."""
    launches = collections.Counter()
    saved, latents = {}, {}
    for kind in ("kohya", "peft"):
        path = os.path.join(tmp, f"flux-lora-{kind}-f16.safetensors")
        t0 = time.time()
        deltas = testing.write_random_flux_lora(
            path, s._mt, rank=LORA_RANK, seed=0, peft=kind == "peft",
            blocks=FLUX_LORA_BLOCKS)
        phase("flux", step="lora", kind=kind, write_s=time.time() - t0,
              targets=len(deltas), rank=LORA_RANK,
              bytes=os.path.getsize(path))
        s.option_set("lora-clear", 1)
        s.option_set("lora", path, LORA_MULT)
        s.option_set("steps", LORA_STEPS)
        t0 = time.time()
        s.setup()
        torch.cuda.synchronize()
        phase("flux", model="flux_dev", path="q8_0", step="lora_reload",
              kind=kind, seconds=time.time() - t0,
              load_s=s.times["load_s"], lora_merge_s=s.times["lora_merge_s"],
              reloaded=sorted(s._lora_prefixes))
        if s._lora_prefixes != {"flux."}:
            raise AssertionError(f"flux LoRA reloaded {s._lora_prefixes}")
        launches.update(dit_q_requests(s, "flux_dev", REQUESTS[:1],
                                       LORA_STEPS, "flux", check=False))
        latents[kind] = s.tensors["latent"]
        mods = {n: s._models["flux."].get_submodule(
            n[len("flux."):-len(".weight")]) for n in deltas}
        if kind == "kohya":
            _check_flux_lora_weights(s, files["model"], deltas, LORA_MULT)
            saved = {n: (m.weight_q8.clone(), m.weight_scale.clone())
                     for n, m in mods.items()}
        else:
            same = sum(torch.equal(m.weight_q8, saved[n][0])
                       and torch.equal(m.weight_scale, saved[n][1])
                       for n, m in mods.items())
            phase("flux", step="lora_peft_weights", weights=len(mods),
                  equal_to_kohya=same)
            if same != len(mods):
                raise AssertionError("PEFT and kohya LoRA weights differ")
        os.remove(path)
    saved.clear()
    equal = bool(np.array_equal(latents["kohya"], latents["peft"]))
    phase("flux", step="lora_latents", kohya_equals_peft=equal)
    if not equal:
        raise AssertionError("the kohya and PEFT LoRAs' latents differ")
    return launches


def sd35_path(tmp: str, t5: dict) -> collections.Counter:
    """SD3.5-medium and SD3.5-large at 1024^2 (``sd35`` lines): a seeded
    random full-width checkpoint of each drawn on the card, with the
    T5-XXL file of the ``t5`` lines at 77 tokens, 20 Euler steps, CFG 7,
    two requests (``dit_requests``).  Returns the launches."""
    launches = collections.Counter()
    for model in ("sd35_medium", "sd35_large"):
        path = os.path.join(tmp, f"{model}-random-f16.safetensors")
        t0 = time.time()
        testing.write_random_checkpoint(path, api._model_types()[model],
                                        seed=0, device="cuda")
        phase("sd35", model=model, step="checkpoint",
              write_s=time.time() - t0, bytes=os.path.getsize(path))
        s = _dit_session(model, {"model": path, **t5}, 77, SD35_STEPS,
                         7.0, "sd35")
        launches.update(dit_requests(s, model, REQUESTS[:2], SD35_STEPS,
                                     "sd35"))
        if model == "sd35_medium":
            launches.update(dit_img2img_request(s, model))
        # the same session quantized (SD3.5-medium with skip-layer
        # guidance)
        dit_switch(s, model, "sd35", [("weight-type", DIT_Q[model][0])]
                   + (SD35_SLG if model == "sd35_medium" else []))
        launches.update(dit_q_requests(s, model, REQUESTS[:1], SD35_STEPS,
                                       "sd35"))
        if model == "sd35_large":
            k7 = sum(n for (name, shape), n in s.last_shapes.items()
                     if name == "q8_matmul_ws_int8" and shape[1] == 2432)
            phase("sd35", model=model, path="q8_0", k7_slab_2432=k7)
            if k7 != 3 * SD35_LARGE_DEPTH * SD35_STEPS:
                raise AssertionError(f"K7 at slab 2432: {k7} launches")
        _release(s)
        del s
        os.remove(path)
    return launches


def flux_path(tmp: str, t5: dict) -> collections.Counter:
    """Flux.1-dev and -schnell at 1024^2 (``flux`` lines): seeded random
    full-width component files drawn on the card (the transformer in bare
    BFL names, CLIP-L in the HF layout, the VAE bare), with the T5-XXL
    file of the ``t5`` lines.  Dev: 20 Euler steps at guidance 3.5 and 512
    T5 tokens, two requests through the session (``dit_requests``) and
    one call of the CLI (-m, --clip, --vae, --t5, --t5-tokenizer,
    --t5-tokens 512) with its PNG read back.  Schnell: 4 steps, cfg 1,
    256 T5 tokens, one request, on the same transformer file (schnell is
    dev without ``guidance_in``, whose tensors it leaves unread).  Returns
    the launches."""
    mt = api._model_types()["flux_dev"]
    t0 = time.time()
    files = testing.write_random_flux_files(tmp, mt, seed=0, device="cuda")
    phase("flux", step="files", write_s=time.time() - t0,
          bytes={k: os.path.getsize(p) for k, p in files.items()},
          mod_std=testing.FLUX_MOD_STD)
    files.update(t5)
    launches = collections.Counter()
    dev, fast = FLUX_RUNS["flux_dev"], FLUX_RUNS["flux_schnell"]
    s = _dit_session("flux_dev", files, dev["t5_tokens"], dev["steps"],
                     dev["cfg"], "flux")
    shift = flux_mod.dynamic_flow_shift(s._mt.unet_p, DIT_DIM // 8,
                                        DIT_DIM // 8)
    phase("flux", model="flux_dev", flow_shift=shift)
    if abs(shift - math.exp(1.15)) > 1e-9:
        raise AssertionError(f"flux_dev: the schedule's shift {shift}")
    launches.update(dit_requests(s, "flux_dev", REQUESTS[:dev["requests"]],
                                 dev["steps"], "flux"))
    bf16_peak = s.peak_bytes
    launches.update(dit_img2img_request(s, "flux_dev"))
    launches.update(features(s, "flux_dev"))
    # the same session in q8_0: two requests, one under MLIS_Q8_MODE=int8
    # (K8), then the LoRA requests
    dit_switch(s, "flux_dev", "flux", [("weight-type", "q8_0")])
    launches.update(dit_q_requests(s, "flux_dev", REQUESTS[:2],
                                   dev["steps"], "flux"))
    q8_peak = s.peak_bytes
    flux_drift_groups(s, "flux_dev")
    phase("flux", model="flux_dev", path="q8_0", peak_bytes=q8_peak,
          bf16_peak_bytes=bf16_peak)
    if not q8_peak < bf16_peak:
        raise AssertionError(f"flux_dev q8_0 peaks at {q8_peak} B, bf16 at "
                             f"{bf16_peak}")
    launches.update(dit_q_requests(s, "flux_dev", REQUESTS[2:3],
                                   dev["steps"], "flux", mode="int8"))
    launches.update(flux_lora_requests(s, tmp, files))
    _release(s)
    del s
    png = os.path.join(tmp, "flux-dev.png")
    seed, prompt = REQUESTS[2]
    secs, s, shapes = _cli_request(
        ["generate", "-m", files["model"], "--clip", files["clip"],
         "--vae", files["vae"], "--t5", files["t5"], "--t5-tokenizer",
         files["t5_tokenizer"], "--t5-tokens", str(dev["t5_tokens"]),
         "-d", str(DIT_DIM), "-s", str(dev["steps"]), "--cfg-scale",
         str(dev["cfg"]), "-S", str(seed), "-p", prompt, "-o", png, "-q"])
    got = _check_launches("flux_dev cli", shapes,
                          _flash_want("flux_dev", dev["steps"], 1))
    launches.update(got)
    img = s.tensors["image"]
    phase("flux", model="flux_dev", via="cli", seconds=secs,
          setup_s=s.setup_s, generate_s=s.generate_s,
          t5_load_s=s.times.get("t5_load_s"),
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          launches=got, image_mean=float(img.mean()),
          image_std=float(img.std()), infotext=s.infotext)
    if not _image_ok(img, DIT_DIM) or s.c["model_type"] != "flux_dev":
        raise AssertionError(f"flux_dev cli: bad image {img.shape}")
    _check_png(png, s)
    _release(s)
    del s
    s = _dit_session("flux_schnell", files, fast["t5_tokens"],
                     fast["steps"], fast["cfg"], "flux")
    launches.update(dit_requests(s, "flux_schnell",
                                 REQUESTS[:fast["requests"]],
                                 fast["steps"], "flux"))
    dit_switch(s, "flux_schnell", "flux", [("weight-type", "q4_0")])
    launches.update(dit_q_requests(s, "flux_schnell", REQUESTS[:1],
                                   fast["steps"], "flux"))
    flux_drift_groups(s, "flux_schnell")
    _release(s)
    del s
    for key in ("model", "clip", "vae"):
        os.remove(files[key])
    return launches


def _test_image(dim: int, seed: int = 0) -> np.ndarray:
    """A seeded uint8 RGBA image [dim, dim, 4]: colour ramps with noise,
    its top half opaque and its bottom half transparent."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:dim, 0:dim]
    rgb = np.stack([x, y, (x + y) // 2], axis=-1) * 256 // dim
    rgb = (rgb + rng.integers(0, 48, rgb.shape)) % 256
    alpha = np.where(y < dim // 2, 255, 0)[:, :, None]
    return np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)


def _n_step(n: int, method: str, f_t_ini: float, flow_shift: float = 0.0
            ) -> int:
    """The steps a request of ``n`` evaluations runs, cut at ``f_t_ini``
    (the session's own schedule)."""
    ls = sch.log_sigmas_flow(flow_shift) if flow_shift else None
    return sch.make_schedule(n, "uniform", get_solver(method).n_fe, 2,
                             f_t_ini, log_sigmas=ls).n_step


def _lora(tmp: str) -> tuple:
    """A seeded random full-width LoRA of SD1.5 (rank 16 on every UNet
    attention projection and CLIP-L's MLP, f16): (path, its tensors)."""
    path = os.path.join(tmp, "style-random-f16.safetensors")
    t0 = time.time()
    mt = api._model_types()["sd1"]
    deltas = testing.write_random_lora(
        path, mt, testing.lora_attention_targets(mt), rank=LORA_RANK, seed=0)
    phase("img2img", step="lora", write_s=time.time() - t0,
          targets=len(deltas), rank=LORA_RANK, bytes=os.path.getsize(path))
    return path, deltas


def _check_lora_weights(s, ckpt: str, deltas: dict, mult: float) -> None:
    """Every weight the LoRA patches, on the card, against bf16(W + mult *
    alpha / rank * up @ down) computed on the host in f32 from the
    checkpoint's W (the session's compute type: bf16 on the card; for a
    quantized linear, that weight's quantization): bit for bit."""
    store = TensorStore.open(ckpt)
    n_eq = n_q = 0
    worst = 0.0
    try:
        name_map = weights_mod.build_name_map(store)
        for name in testing.lora_attention_targets(s._mt):
            down, up, alpha = deltas[testing.lora_name(name)]
            w = weights_mod.read_entry(store, name_map[name]).astype(
                np.float32)
            scale = np.float32(alpha / down.shape[0] * mult)
            want = torch.from_numpy(w + (up @ down) * scale).to(s.dtype)
            prefix = next(p for p in s._models if name.startswith(p))
            mod = s._models[prefix].get_submodule(
                name[len(prefix):-len(".weight")])
            if isinstance(mod, blocks_mod.QLinear):
                q, sc = quant.quantize_weight(want.float().numpy())
                ok = (np.array_equal(mod.weight_q8.cpu().numpy(), q)
                      and np.array_equal(mod.weight_scale.cpu().numpy(), sc))
                n_q += 1
            else:
                got = mod.weight.detach().cpu()
                ok = torch.equal(got, want)
                worst = max(worst, (got.float() - want.float()).abs()
                            .max().item())
            n_eq += ok
    finally:
        store.close()
    n = len(deltas)
    phase("img2img", step="lora_weights", weights=n, equal=n_eq,
          quantized=n_q, max_abs_err=worst, mult=mult)
    if n_eq != n:
        raise AssertionError(f"{n - n_eq} of {n} merged LoRA weights differ "
                             "from bf16(W + delta) computed on the host")


def lora_q8_request(s, ckpt: str, lora: tuple) -> dict:
    """One request on the q8_0 session with the LoRA: the session reloads
    the UNet and CLIP-L with the merge made before quantization; the same
    launches as without it, and its quantized weights those of the merged
    weight."""
    s.option_set("lora", lora[0], LORA_MULT)
    out = main_path(s, ckpt, "sd1", 512, "q8_0", REQUESTS[:1],
                    lambda s: sd1_want(8))
    phase("img2img", model="sd1", path="q8_0", step="lora_reload",
          load_s=s.times["load_s"], lora_merge_s=s.times["lora_merge_s"],
          reloaded=sorted(s._lora_prefixes))
    _check_lora_weights(s, ckpt, lora[1], LORA_MULT)
    return out


def _img2img_phase(model, s, secs, got, **kv) -> None:
    img = s.tensors["image"]
    phase("img2img", model=model, seconds=secs,
          setup_s=getattr(s, "setup_s", None),
          generate_s=getattr(s, "generate_s", None),
          load_s=s.times.get("load_s"),
          lora_merge_s=s.times.get("lora_merge_s"),
          encoder_load_s=s.times.get("encoder_load_s"),
          image_encode_s=s.times.get("image_encode_s"), launches=got,
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          image_mean=float(img.mean()), image_std=float(img.std()),
          infotext=s.infotext, **kv)


def _check_img2img(s, png, dim: int, mode: str) -> None:
    """The image, the PNG read back and the infotext's ``Mode:``."""
    if not _image_ok(s.tensors["image"], dim):
        raise AssertionError(f"{mode}: bad image")
    if png is not None:
        _check_png(png, s)
    if mode and f"Mode: {mode}, f_t_ini: " not in s.infotext:
        raise AssertionError(f"{mode}: infotext {s.infotext!r}")


def _flash_want(model: str, n_eval: int, n_k2: int) -> dict:
    """The flash launches of a request of ``model`` with ``n_eval`` UNet,
    MMDiT or Flux evaluations and ``n_k2`` VAE mid-block attentions, by
    kernel and q shape (``FLASH_SHAPE_CALLS`` holds a request of 20
    evaluations, of ``REQUEST_EVALS`` where it names the model)."""
    want = {}
    per = REQUEST_EVALS.get(model, 20)
    for (shape, _), calls in FLASH_SHAPE_CALLS.items():
        n = (n_k2 if shape[-1] == 512
             else calls.get(model, 0) // per * n_eval)
        if model in calls and n:
            name = ("flash_attn_fwd_wide" if shape[-1] > 128 else
                    "flash_attn_joint" if model.startswith(("sd3", "flux"))
                    else "flash_attn_fwd")
            want[(name, shape)] = n
    return want


def _want_sum(*wants) -> dict:
    """The launches by kernel and shape of several parts of a request."""
    out = collections.Counter()
    for w in wants:
        out.update(w)
    return dict(out)


def sd1_img2img_path(tmp: str, ckpt: str, lora: tuple) -> collections.Counter:
    """SD1.5 512^2 img2img, inpainting and a LoRA tag through the CLI
    (``I2I_REQUESTS``), each call a session that loads the checkpoint with
    the LoRA merged; the VAE encoder against its plain attention on the
    inpainting session; the merged weights after the tag request.  Returns
    the launches."""
    rgba = _test_image(512, 1)
    pngs = {"img2img": os.path.join(tmp, "sd1-in-rgb.png"),
            "inpaint": os.path.join(tmp, "sd1-in-rgba.png")}
    image_mod.image_save(pngs["img2img"], rgba[:, :, :3])
    image_mod.image_save(pngs["inpaint"], rgba)
    name = os.path.splitext(os.path.basename(lora[0]))[0]
    launches = collections.Counter()
    for kind, f_t_ini in I2I_REQUESTS:
        out = os.path.join(tmp, f"sd1-{kind}.png")
        argv = ["generate", "-m", ckpt, *I2I_ARGS, "-o", out]
        if kind == "lora_tag":
            argv += ["--lora-dir", tmp, "-p",
                     f"{REQUESTS[0][1]} <lora:{name}:{LORA_MULT}>"]
        else:
            argv += ["-p", REQUESTS[0][1], "-i", pngs[kind], "--f-t-ini",
                     str(f_t_ini), "--lora", f"{lora[0]},{LORA_MULT}"]
        secs, s, shapes = _cli_request(argv)
        n_step = _n_step(20, "euler", f_t_ini)
        n_k2 = 1 if kind == "lora_tag" else 2
        got = _check_launches(f"sd1 {kind}", shapes,
                              _flash_want("sd1", n_step, n_k2))
        if any(qmm.LAUNCHES.values()):
            raise AssertionError(f"sd1 {kind}: quantized kernels launched")
        launches.update(got)
        _img2img_phase("sd1", s, secs, got, request=kind, steps=n_step,
                       f_t_ini=f_t_ini, loras=s._lora_state)
        _check_img2img(s, out, 512, "" if kind == "lora_tag" else kind)
        if kind == "img2img" and n_step != 12:
            raise AssertionError(f"img2img ran {n_step} steps, not 12")
        if kind == "inpaint":
            # the kept (opaque) half of the latent is the encoded latent
            lat, enc = s.tensors["latent"], s.encoded
            kept = np.array_equal(lat[:, :, :32], enc[:, :, :32])
            moved = float(np.abs(lat[:, :, 32:] - enc[:, :, 32:]).max())
            phase("img2img", model="sd1", request=kind, kept_rows_equal=kept,
                  repainted_max_abs_change=moved)
            if not kept or moved == 0.0:
                raise AssertionError("inpaint: the kept latent rows are not "
                                     "the encoded latent")
            encoder_reference_check(s, rgba)
        if kind == "lora_tag":
            _check_lora_weights(s, ckpt, lora[1], LORA_MULT)
        _drop(s)
    return launches


def encoder_reference_check(s, rgba) -> None:
    """The VAE encoder's moments at 512^2 (its mid-block K2 at [1, 1, 4096,
    512]) and at 1024^2 (the SDXL / SD3 encoder's [1, 1, 16384, 512]) with
    the kernels against the same with the plain attention; then its device
    time at each size."""
    enc = s._encoders["vae."]
    x512 = torch.from_numpy(rgba[:, :, :3].transpose(2, 0, 1)[None].astype(
        np.float32) / 127.5 - 1.0).cuda()
    x1024 = torch.nn.functional.interpolate(x512, scale_factor=2.0,
                                            mode="bilinear")

    def run():
        with torch.no_grad():
            return [("vae_enc_moments_512", enc(x512).float()),
                    ("vae_enc_moments_1024", enc(x1024).float())]

    _kernels_vs_plain("bf16", None, run)
    with torch.no_grad():
        phase("img2img", step="vae_encoder_ms",
              ms_512=ms(lambda: enc(x512), n=5, reps=1),
              ms_1024=ms(lambda: enc(x1024), n=5, reps=1))


def img2img_request(s, model: str, dim: int) -> dict:
    """One img2img request at ``I2I_F_T_INI`` on the session (bf16, 20 Euler
    steps cut), from an RGB image of the session's size: the launches by
    shape (K2 in the encoder and the decoder) and the image."""
    s.option_set("image", _test_image(dim, 3)[:, :, :3])
    s.option_set("f-t-ini", I2I_F_T_INI)
    s.option_set("seed", REQUESTS[0][0])
    s.option_set("prompt", REQUESTS[0][1])
    s.option_set("nprompt", "blurry, low quality")
    n_step = _n_step(20, "euler", I2I_F_T_INI,
                     getattr(s._mt.unet_p, "flow_shift", 0.0)
                     if s._flow() else 0.0)
    fa.reset_counts()
    qmm.reset_counts()
    t0 = time.time()
    s.generate()
    secs = time.time() - t0
    got = _check_launches(f"{model} img2img",
                          collections.Counter(fa.LAUNCH_SHAPES),
                          _flash_want(model, n_step, 2))
    _img2img_phase(model, s, secs, got, steps=n_step, f_t_ini=I2I_F_T_INI)
    _check_img2img(s, None, dim, "img2img")
    return got


def _staged_on_card(s) -> list:
    """The staged modules of which some tensor lies on the card."""
    return [p for p in api._STAGED if p in s._models
            and any(t.is_cuda for t in s._models[p].state_dict().values())]


def _lowmem_phase(s, secs, shapes, got, **kv) -> None:
    img = s.tensors["image"]
    phase("main", step="lowmem", seconds=secs,
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          max_memory_reserved=torch.cuda.max_memory_reserved(),
          moves_s={k: v for k, v in s.times.items() if k.startswith("move_")},
          decode_s=s.times.get("decode_s"),
          image_encode_s=s.times.get("image_encode_s"),
          resident=sorted(s.resident),
          host_bytes=sum(t.numel() * t.element_size()
                         for d in s._host.values() for t in d.values()),
          launches=got,
          launches_by_shape={f"{k[0]} {list(k[1])}": n
                             for k, n in sorted(shapes.items())},
          image_mean=float(img.mean()), image_std=float(img.std()), **kv)


def sdxl_lowmem_requests(s, wt: str) -> collections.Counter:
    """On an SDXL-base 1024^2 session of weight type ``wt``: one request
    with neither memory option, then two with ``LOWMEM`` (the first takes
    the session's weights to the host, the second is the low-memory
    request), the same seed and prompts.  Each must launch exactly its K1,
    K2 and (q4_0) K9/K10 counts per shape, with no plain version on CUDA
    tensors, and the latents must be equal bit for bit; the last request
    (q4_0) must peak at or under ``LOWMEM_BYTES``.  Returns the launches."""
    quant = collections.Counter()
    if s.qbits:
        for (rows, k, n), c in unet_products(s, SDXL_DIM,
                                             SDXL_STEPS).items():
            kind_ = "ws" if qmm.use_ws(rows, k) else "tile"
            quant[(f"q{s.qbits}_matmul_{kind_}", (rows, k, n))] += c
    k1 = _flash_want("sdxl", SDXL_STEPS, 0)
    launches, latents = collections.Counter(), []
    for i, opts in enumerate([{"vae-tile": 0, "unet-split": 0}, LOWMEM,
                              LOWMEM]):
        for k, v in [*opts.items(), ("seed", REQUESTS[0][0]),
                     ("prompt", REQUESTS[0][1]),
                     ("nprompt", "blurry, low quality")]:
            s.option_set(k, v)
        k2 = ({("flash_attn_fwd_wide", (1, 1, 6400, 512)): 4}
              if opts["vae-tile"] else
              {("flash_attn_fwd_wide", (1, 1, 16384, 512)): 1})
        want = {**k1, **quant, **k2}
        fa.reset_counts()
        qmm.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        img = s.generate()
        secs = time.time() - t0
        shapes = collections.Counter(fa.LAUNCH_SHAPES) + collections.Counter(
            qmm.LAUNCH_SHAPES)
        got = _check_launches(f"sdxl {wt} lowmem {opts}", shapes, want)
        launches.update(got)
        latents.append(s.tensors["latent"])
        peak = torch.cuda.max_memory_allocated()
        _lowmem_phase(s, secs, shapes, got, model="sdxl", path=wt,
                      request=i, options=opts,
                      latent_equal_to_request_0=bool(np.array_equal(
                          latents[0], latents[-1])),
                      limit_bytes=LOWMEM_BYTES if s.qbits else None)
        if not _image_ok(img, SDXL_DIM):
            raise AssertionError(f"sdxl {wt} lowmem {i}: bad image")
        if opts["unet-split"] and (_staged_on_card(s)
                                   or s.resident != {"vae."}):
            raise AssertionError(f"sdxl {wt} lowmem {i}: staged modules on "
                                 f"the card after the request: "
                                 f"{_staged_on_card(s)} {s.resident}")
        if not np.array_equal(latents[0], latents[-1]):
            raise AssertionError(f"sdxl {wt} lowmem {i}: the latent differs "
                                 "from the one without the options")
        if s.qbits and i == 2 and peak > LOWMEM_BYTES:
            raise AssertionError(f"sdxl {wt} lowmem: peak {peak} B over "
                                 f"{LOWMEM_BYTES}")
    return launches


def sdxl_lowmem_path(ckpt: str) -> collections.Counter:
    """SDXL-base 1024^2 under q4_0: a session (K9/K10 take every quantized
    product), :func:`sdxl_lowmem_requests`, then the tiled decode of its
    latent with the kernels against the same with the plain attention, and
    the device time of the tiled and the whole decode.  Returns the
    launches."""
    s = api.MLImgSynth(device="cuda")
    for k, v in [("model", ckpt), ("model-type", "sdxl"),
                 ("weight-type", "q4_0"), ("image-dim", SDXL_DIM),
                 ("steps", SDXL_STEPS), ("cfg-scale", 7.0),
                 ("method", "euler"), ("scheduler", "uniform")]:
        s.option_set(k, v)
    t0 = time.time()
    s.setup()
    phase("main", step="lowmem", model="sdxl", path="q4_0",
          load_s=time.time() - t0, quantized_linears=sum(
              isinstance(m, blocks_mod.QLinear)
              for mod in s._models.values() for m in mod.modules()))
    launches = sdxl_lowmem_requests(s, "q4_0")
    vae = s._models["vae."]
    lat = torch.from_numpy(s.tensors["latent"]).cuda()

    def run():
        with torch.no_grad():
            return [("sdxl_vae_tiled_image",
                     api._tiled_decode(vae, lat, LOWMEM["vae-tile"]))]

    _kernels_vs_plain("bf16", None, run)
    with torch.no_grad():
        phase("main", step="lowmem", model="sdxl", what="decode_ms",
              tiled_ms=ms(lambda: api._tiled_decode(
                  vae, lat, LOWMEM["vae-tile"]), n=5, reps=1),
              whole_ms=ms(lambda: vae(lat), n=5, reps=1))
    _drop(s)
    return launches


def sd1_lowmem_cli(tmp: str, ckpt: str) -> collections.Counter:
    """SD1.5 512^2 img2img at ``I2I_F_T_INI`` through the CLI with
    ``SD1_LOWMEM_ARGS``: K2 once in each of the 4 encode and 4 decode
    tiles; the PNG is the session's float image as the writer truncates
    it.  Returns the launches."""
    png_in = os.path.join(tmp, "sd1-in-rgb.png")
    out = os.path.join(tmp, "sd1-lowmem.png")
    secs, s, shapes = _cli_request(
        ["generate", "-m", ckpt, *I2I_ARGS, "-p", REQUESTS[0][1], "-i",
         png_in, "--f-t-ini", str(I2I_F_T_INI), *SD1_LOWMEM_ARGS, "-o",
         out])
    n_step = _n_step(20, "euler", I2I_F_T_INI)
    want = {**_flash_want("sd1", n_step, 0),
            ("flash_attn_fwd_wide", (1, 1, 2304, 512)): 8}
    got = _check_launches("sd1 lowmem img2img", shapes, want)
    _lowmem_phase(s, secs, shapes, got, model="sd1", path="bf16", via="cli",
                  args=SD1_LOWMEM_ARGS, steps=n_step, setup_s=s.setup_s,
                  generate_s=s.generate_s)
    _check_img2img(s, out, 512, "img2img")
    if _staged_on_card(s) or s.resident != {"vae."}:
        raise AssertionError(f"sd1 lowmem: staged modules on the card "
                             f"after the request: {s.resident}")
    _drop(s)
    return collections.Counter(got)


def _t5_tokens(s, texts, n_tok: int) -> torch.Tensor:
    """The session's T5 token ids of ``texts`` at ``n_tok``, on its
    device."""
    return torch.as_tensor(t5_mod.tokenize(texts, n_tok, s.c["t5_tokenizer"]),
                           dtype=torch.long, device=s.device)


def t5_path(s, tmp: str) -> collections.Counter:
    """SD3-medium 1024^2 bf16 with T5-XXL context (``t5`` lines) on the
    bf16 SD3 session ``s``: a seeded random full-width T5-XXL file given by
    --t5 and a made-up Unigram tokenizer.json; one request at each
    ``T5_TOKENS`` with exact launches
    by shape (K3 at [2, 24, 4096 + 77 + t5_tokens, 64]), its T5 encode
    time (host, in the request; device, the two rows alone) and peak
    memory; the T5 rows in bf16 against f32 on the card; the last
    request's latent with the kernels against the plain attention.
    Returns the launches of the requests."""
    t5 = os.path.join(tmp, T5_FILE)
    t0 = time.time()
    testing.write_random_t5(t5, t5_mod.T5_XXL, seed=0, device="cuda")
    write_s = time.time() - t0
    tok = os.path.join(tmp, T5_TOKENIZER)
    testing.write_tokenizer_json(tok, testing.unigram_tokenizer_spec(
        testing.random_unigram_pieces(t5_mod.T5_XXL.n_vocab, seed=0),
        charsmap=testing.build_charsmap(T5_RULES), eos=True))
    phase("t5", step="files", t5_write_s=write_s,
          t5_bytes=os.path.getsize(t5))
    s.option_set("t5", t5)
    s.option_set("t5-tokenizer", tok)
    t0 = time.time()
    s._t5_load()
    phase("t5", step="setup", t5_load_s=time.time() - t0,
          t5_params=sum(p.numel() for p in s._t5.parameters()),
          t5_geometry=s._t5.P.__dict__,
          memory_allocated=torch.cuda.memory_allocated())
    launches = collections.Counter()
    toks = {}
    for n_tok in T5_TOKENS:
        s.option_set("t5-tokens", n_tok)
        s.option_set("seed", REQUESTS[0][0])
        s.option_set("prompt", T5_PROMPT)
        s.option_set("nprompt", "blurry, low quality")
        fa.reset_counts()
        qmm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        img = s.generate()
        secs = time.time() - t0
        got = _check_launches(f"sd3 t5_tokens {n_tok}",
                              collections.Counter(fa.LAUNCH_SHAPES),
                              _flash_want(f"sd3_t5_{n_tok}", SD3_STEPS, 1))
        if any(qmm.LAUNCHES.values()):
            raise AssertionError(f"sd3 t5: quantized kernels {qmm.LAUNCHES}")
        launches.update(got)
        cond = s.tensors["cond"]
        toks[n_tok] = _t5_tokens(s, [T5_PROMPT, "blurry, low quality"],
                                 n_tok)
        with torch.no_grad():
            enc_ms = ms(lambda: s._t5(toks[n_tok]), n=5, reps=2)
        phase("t5", t5_tokens=n_tok, seconds=secs,
              t5_encode_s=s.times["t5_encode_s"], t5_encode_ms=enc_ms,
              prompt_t5_tokens=int((toks[n_tok][0] != 0).sum()),
              cond_rows=cond.shape[1], launches=got,
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              image_mean=float(img.mean()), image_std=float(img.std()))
        want = (1, 77 + n_tok, s._mt.unet_p.d_ctx_in)
        if (not _image_ok(img, SD3_DIM) or cond.shape != want
                or not np.abs(cond[:, 77:]).max() > 0):
            raise AssertionError(f"sd3 t5_tokens {n_tok}: image "
                                 f"{img.shape} or cond {cond.shape}")
    # the T5 rows in bf16 (the session's) against an f32 encoder loaded
    # from the same file, both on the card
    s32 = api.MLImgSynth(device="cuda")
    s32.option_set("t5", t5)
    s32.dtype = torch.float32
    s32._t5_load()
    for n_tok, t in toks.items():
        with torch.no_grad():
            a, b = s._t5(t).float(), s32._t5(t)
        rel = ((a - b).norm() / b.norm()).item()
        phase("t5", step="bf16_vs_f32", t5_tokens=n_tok, rel_l2=rel,
              limit=T5_REL_L2)
        if not rel < T5_REL_L2:
            raise AssertionError(f"T5 bf16 against f32: rel L2 {rel}")
    del s32
    gc.collect()
    torch.cuda.empty_cache()

    def run():
        s.option_set("seed", REQUESTS[0][0])
        s.option_set("prompt", T5_PROMPT)
        s.option_set("nprompt", "blurry, low quality")
        s.generate()
        return [("sd3_t5_request_latent",
                 torch.from_numpy(s.tensors["latent"]))]

    _kernels_vs_plain("bf16", None, run)
    return launches


def _token_rows(ckpt: str, prefix: str, word: str) -> np.ndarray:
    """The token-table rows of ``word`` in the text tower at ``prefix`` of
    a checkpoint, f32 (the file's f16 values)."""
    st = TensorStore.open(ckpt)
    ref = weights_mod.build_name_map(st)[prefix + "embed.token.weight"]
    table = weights_mod.read_entry(st, ref)
    rows = np.array(table[tok_mod.tokenize(word)], np.float32)
    del table      # a view of the mapped file, which then can close
    st.close()
    return rows


def _edit_check(s, model: str) -> collections.Counter:
    """``EDIT_PROMPTS[model]`` on session ``s`` (20 Euler steps, CFG 7): the
    edited request's latents equal the plain one's bit for bit through step
    ``EDIT_STEP`` and differ at every step after it; each request launches
    exactly what a request of ``model`` does.  Returns the launches."""
    launches, traj = collections.Counter(), {}
    for kind, prompt in zip(("edit", "plain"), EDIT_PROMPTS[model]):
        steps = []
        s.step_observer = lambda i, lat, steps=steps: steps.append(lat)
        s.option_set("seed", REQUESTS[0][0])
        s.option_set("prompt", prompt)
        s.option_set("nprompt", "blurry, low quality")
        fa.reset_counts()
        qmm.reset_counts()
        t0 = time.time()
        img = s.generate()
        secs = time.time() - t0
        got = _check_launches(f"{model} {kind}",
                              collections.Counter(fa.LAUNCH_SHAPES),
                              _flash_want(model, 20, 1))
        launches.update(got)
        traj[kind] = steps
        phase("embed_edit", model=model, request=kind, seconds=secs,
              cond_rows=s.tensors["cond"].shape[0], launches=got,
              image_ok=_image_ok(img, s.c["width"]))
        if not _image_ok(img, s.c["width"]):
            raise AssertionError(f"{model} {kind}: bad image")
    s.step_observer = None
    equal = [bool(np.array_equal(a, b))
             for a, b in zip(traj["edit"], traj["plain"])]
    phase("embed_edit", model=model, request="edit_vs_plain",
          switch_step=EDIT_STEP, steps_equal=equal)
    if (len(equal) != 20 or not all(equal[:EDIT_STEP])
            or any(equal[EDIT_STEP:])):
        raise AssertionError(f"{model} prompt editing: steps equal {equal}")
    return launches


def embed_edit_sd1(tmp: str, ckpt: str) -> collections.Counter:
    """SD1.5 512^2 through the CLI with --embed-dir: ``<emb:likecat>``, a
    table of CLIP-L's rows of "cat"; then, on the CLI's session, the word
    (latents bit for bit) and prompt editing (:func:`_edit_check`).
    Returns the launches."""
    testing.write_embedding(os.path.join(tmp, "likecat.safetensors"), {
        "emb_params": _token_rows(ckpt, "clip.text.", "cat")})
    out = os.path.join(tmp, "sd1-embedding.png")
    secs, s, shapes = _cli_request(
        ["generate", "-m", ckpt, *I2I_ARGS, "--embed-dir", tmp, "-p",
         EMBED_PROMPT.format("<emb:likecat>"), "-o", out])
    got = _check_launches("sd1 embedding", shapes, _flash_want("sd1", 20, 1))
    _check_png(out, s)
    rows = s._models["clip.text."].embed.token.weight.shape[0]
    phase("embed_edit", model="sd1", via="cli", request="embedding",
          seconds=secs, setup_s=s.setup_s, generate_s=s.generate_s,
          token_table_rows=rows, launches=got)
    if rows != 49409:
        raise AssertionError(f"sd1 embedding: token table of {rows} rows")
    launches = collections.Counter(got)
    lat = {"embedding": s.tensors["latent"]}
    s.option_set("seed", REQUESTS[0][0])
    s.option_set("prompt", EMBED_PROMPT.format("cat"))
    s.option_set("nprompt", "blurry, low quality")
    fa.reset_counts()
    qmm.reset_counts()
    t0 = time.time()
    s.generate()
    got = _check_launches("sd1 word", collections.Counter(fa.LAUNCH_SHAPES),
                          _flash_want("sd1", 20, 1))
    launches.update(got)
    lat["word"] = s.tensors["latent"]
    phase("embed_edit", model="sd1", request="word",
          seconds=time.time() - t0, launches=got)
    equal = bool(np.array_equal(lat["embedding"], lat["word"]))
    phase("embed_edit", model="sd1", request="embedding_vs_word",
          latent_equal=equal)
    if not equal:
        raise AssertionError("sd1: the embedding's latent is not the word's")
    launches.update(_edit_check(s, "sd1"))
    _drop(s)
    return launches


def embed_edit_sdxl(s, ckpt: str, tmp: str) -> collections.Counter:
    """SDXL-base 1024^2 on the bf16 session: an embedding of both towers'
    rows of "cat" (``clip_l``, ``clip_g``) in an edited prompt, against
    the word in the plain prompt (:func:`_edit_check`).  Returns the
    launches."""
    testing.write_embedding(os.path.join(tmp, "xcat.safetensors"), {
        "clip_l": _token_rows(ckpt, "clip.text.", "cat"),
        "clip_g": _token_rows(ckpt, "clip2.text.", "cat")})
    s.option_set("embed-dir", tmp)
    return _edit_check(s, "sdxl")


# Relative L2 limits of the reference phase.  Every layer computes in bf16
# and only the kernels differ between the two runs.  bf16 path: the
# attention; on the H100 the seeded inputs give 1.6e-2 (UNet) and 6.2e-3
# (VAE), and these limits leave about twice that.  Quantized paths: the
# matmuls alone (the flash kernels run in both).  On the H100 the kernels
# give the twin's cuBLAS product bit for bit at every product of the path
# (both sum K in order on the tensor cores in f32; the twin disallows
# cuBLAS's reduction in bf16), so the UNet output reads 0; a sum in another
# order flips bf16 roundings that the UNet amplifies (an f32 twin on the
# CUDA cores read 1.6e-2), and a per-product difference
# at the kernel limit (4e-3, ``testing.QUANT_REL_L2``) would compound
# through the UNet about as the attention's 3e-3 did (1.6e-2): 1e-2 holds
# the first and fails a fault that shows in every product.  SD3: one
# full-width MMDiT evaluation held to 3e-2 on both paths, the SD3 VAE
# decode at 1024^2 to the SD1 VAE's limit.  SDXL: one full-width UNet
# evaluation, bf16 (the attention, 70 flash calls against SD1.5's 16) reads
# 2.3e-2 on the H100, held to the SD1 UNet's limit; q8_0 under
# MLIS_Q8_MODE=int8 (the per-block W8A8 kernel, bit for bit its twin at
# every case of the kernels phase) reads 0, held to the quantized paths'
# 1e-2; its VAE decode (5.1e-3) to the SD1 VAE's limit.  SD2 (bf16): the
# raw v output of one UNet evaluation reads 9.5e-3 on the H100, its VAE
# decode 7.9e-3, a whole 20-step DPM++2M request's latent 2.34e-2 and
# image 1.42e-2, each held to the other paths' UNet or VAE limit
# (``CONTROLS`` reads planted faults beside them).  SD3 with 256 T5 tokens:
# a whole 20-step Euler request's latent, held to the SD2 request latent's
# limit.
REF_LIMITS = {"unet_eps": 3e-2, "vae_image": 1.5e-2,
              "unet_eps_q8_0": 1e-2, "unet_eps_q4_0": 1e-2,
              "mmdit_v": 3e-2, "mmdit_v_q8_0": 3e-2, "sd3_vae_image": 1.5e-2,
              "sdxl_unet_eps": 3e-2, "sdxl_unet_eps_q8_0_int8": 1e-2,
              "sdxl_vae_image": 1.5e-2, "sd2_unet_v": 3e-2,
              "sd2_vae_image": 1.5e-2, "sd2_request_latent": 3e-2,
              "sd2_request_image": 1.5e-2, "vae_enc_moments_512": 1.5e-2,
              "vae_enc_moments_1024": 1.5e-2,
              "sdxl_vae_tiled_image": 1.5e-2, "sd3_t5_request_latent": 3e-2,
              "sd35_medium_v": 3e-2, "sd35_large_v": 3e-2,
              "flux_dev_v": 3e-2, "flux_schnell_v": 3e-2,
              "flux_dev_v_q8_0": 3e-2, "flux_dev_v_q8_0_int8": 3e-2,
              "flux_schnell_v_q4_0": 3e-2, "sd35_large_v_q8_0": 3e-2,
              "sd35_medium_v_q8_0": 3e-2, "sd2_unet_v_q8_0": 1e-2}

# the kernel wrappers and their plain versions: the plain run of the
# reference phase swaps them, so both runs take the same dispatch
PLAIN_ROUTES = {
    None: {(fa, "flash_attention"): fa.attention_plain,
           (fa, "flash_attn_fwd_wide"): fa.attention_plain,
           (fa, "flash_attn_joint"): fa.attention_plain},
    8: {(qmm, "q8_matmul_tile"): quant.q8_matmul_plain,
        (qmm, "q8_matmul_ws"): quant.q8_matmul_plain,
        (qmm, "q8_matmul_ws_int8"): quant.q8_ws_int8_plain,
        (qmm, "q8_matmul_int8"): quant.q8_matmul_int8_plain},
    4: {(qmm, "q4_matmul_tile"): quant.q4_matmul_plain,
        (qmm, "q4_matmul_ws"): quant.q4_matmul_plain},
}


def _plain_run(run, bits=None):
    """``run()`` with the wrappers of ``PLAIN_ROUTES[bits]`` swapped for
    their plain versions (the attention, or the quantized matmuls), checked
    to go through the plain versions and to launch no kernel of them."""
    routes = PLAIN_ROUTES[bits]
    saved = {key: getattr(*key) for key in routes}
    for (mod, attr), fn in routes.items():
        setattr(mod, attr, fn)
    fa.reset_counts()
    qmm.reset_counts()
    try:
        out = run()
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    routed = qmm.LAUNCHES if bits else fa.LAUNCHES
    if (not fa.PLAIN_CUDA_CALLS + quant.PLAIN_CUDA_CALLS
            or any(routed.values())):
        raise AssertionError(f"the plain run launched {routed}")
    return out


def _kernels_vs_plain(wt, bits, run, **kv) -> None:
    """``run()`` -> [(output name, tensor)] with the kernels, then again
    with the wrappers of ``PLAIN_ROUTES[bits]`` swapped for their plain
    versions (the attention on the bf16 path, the quantized matmuls on the
    others); each output held to its ``REF_LIMITS``.  Returns the plain
    run's outputs."""
    kern = run()
    plain = _plain_run(run, bits)
    plain_calls = fa.PLAIN_CUDA_CALLS + quant.PLAIN_CUDA_CALLS
    for (name, a), (_, b) in zip(kern, plain):
        rel = ((a - b).norm() / b.norm()).item()
        phase("reference", path=wt, output=name, rel_l2=rel,
              limit=REF_LIMITS[name], plain_calls=plain_calls,
              kernel_launches_in_plain_run=_counts(), **kv)
        if not rel < REF_LIMITS[name]:
            raise AssertionError(f"{name}: kernels vs plain rel L2 {rel}")
    return plain


def reference_check(s, wt, bits):
    """One UNet evaluation (CFG batch, first sigma) and, on the bf16 path,
    one VAE decode of the last request's latent."""
    unet, vae = s._models["unet."], s._models["vae."]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 4, 64, 64, device="cuda", generator=gen) * 14.6
    cond = torch.from_numpy(s.tensors["cond"]).cuda().repeat(2, 1, 1)
    lat = torch.from_numpy(s.tensors["latent"]).cuda()

    def run():
        with torch.no_grad():
            eps = unet_mod.denoise(unet, x, 14.6, 999.0, cond)
            return [("unet_eps" + (f"_{wt}" if bits else ""), eps)] + (
                [] if bits else [("vae_image", vae(lat).float())])

    _kernels_vs_plain(wt, bits, run)


def sd3_reference_check(s, wt, bits):
    """One MMDiT evaluation at the first sigma (1.0) on the CFG batch of
    the last request's conditioning and, on the bf16 path, one VAE decode
    of its latent."""
    mm, vae = s._models["mmdit."], s._models["vae."]
    gen = torch.Generator(device="cuda").manual_seed(1)
    hw = SD3_DIM // 8
    x = torch.randn(2, 16, hw, hw, device="cuda", generator=gen)
    cond, label = (torch.from_numpy(np.concatenate(
        [s.tensors[k], s.tensors["n" + k]])).cuda() for k in ("cond", "label"))
    lat = torch.from_numpy(s.tensors["latent"]).cuda()

    def run():
        with torch.no_grad():
            v = mmdit_mod.denoise(mm, x, 1.0, 1000.0, cond, label)
            return [("mmdit_v" + (f"_{wt}" if bits else ""), v)] + (
                [] if bits else [("sd3_vae_image", vae(lat).float())])

    _kernels_vs_plain(wt, bits, run)


def sdxl_reference_check(s, wt, bits):
    """One SDXL UNet evaluation (CFG batch of the last request's
    conditioning and labels, first sigma) and, on the bf16 path, one VAE
    decode of its latent; the q8_0 path under MLIS_Q8_MODE=int8."""
    unet, vae = s._models["unet."], s._models["vae."]
    gen = torch.Generator(device="cuda").manual_seed(1)
    hw = SDXL_DIM // 8
    x = torch.randn(2, 4, hw, hw, device="cuda", generator=gen) * 14.6
    cond, label = (torch.from_numpy(np.concatenate(
        [s.tensors[k], s.tensors["n" + k]])).cuda() for k in ("cond", "label"))
    lat = torch.from_numpy(s.tensors["latent"]).cuda()

    def run():
        with torch.no_grad():
            eps = unet_mod.denoise(unet, x, 14.6, 999.0, cond, label)
            return [("sdxl_unet_eps" + ("_q8_0_int8" if bits else ""), eps)
                    ] + ([] if bits else
                         [("sdxl_vae_image", vae(lat).float())])

    os.environ["MLIS_Q8_MODE"] = "int8" if bits else "dq"
    try:
        _kernels_vs_plain(wt, bits, run)
    finally:
        del os.environ["MLIS_Q8_MODE"]


# Planted faults in the flash kernels, each made on one launch's inputs or
# output (through ``fa._launch``, which every wrapper calls): three of the
# size of a rounding or range slip (the last 64 kv rows never loaded, the
# output rounded to fp8 e4m3, a kv loop that ends half way) and two gross
# ones (each head's output in the next head's place, the rows of a last
# partial 128-row q block left unwritten).  The SD2 reference check reads
# each against the plain run beside the limits; each gross fault must read
# above the limit on one of its outputs.  (On the H100 the first three read
# inside the limits on one UNet evaluation: random weights give the
# attention near-uniform weights over similar values.  The kernels phase
# holds those slips, at the operation.)
def _rows_unwritten(o):
    o[:, :, o.shape[2] // 128 * 128:] = 0
    return o


CONTROLS = {
    "drop_last_kv64": (False, lambda f, n, q, k, v, *a: f(
        n, q, k[:, :, :-64], v[:, :, :-64], *a)),
    "fp8_output": (False, lambda f, n, q, k, v, *a: f(n, q, k, v, *a).to(
        torch.float8_e4m3fn).to(q.dtype)),
    "kv_loop_half": (False, lambda f, n, q, k, v, *a: f(
        n, q, k[:, :, :k.shape[2] // 2], v[:, :, :k.shape[2] // 2], *a)),
    "heads_rolled": (True, lambda f, n, q, k, v, *a: f(
        n, q, k, v, *a).roll(1, dims=1)),
    "ragged_q_rows_unwritten": (True, lambda f, n, q, k, v, *a:
                                _rows_unwritten(f(n, q, k, v, *a))),
}


def _controls(run, plain) -> set:
    """``run()`` once for each of ``CONTROLS``, its outputs against the
    plain run's: the readings a faulty kernel gives the gate.  Returns the
    faults that read above the limit on an output."""
    real = fa._launch
    caught = set()
    for fault, (_, fn) in CONTROLS.items():
        fa._launch = functools.partial(fn, real)
        try:
            outs = run()
        finally:
            fa._launch = real
        for (name, a), (_, b) in zip(outs, plain):
            rel = ((a - b).norm() / b.norm()).item()
            if rel > REF_LIMITS[name]:
                caught.add(fault)
            phase("control", fault=fault, output=name, rel_l2=rel,
                  limit=REF_LIMITS[name])
    return caught


def sd2_reference_check(s):
    """One SD2 UNet evaluation (CFG batch of the last request's
    conditioning, first sigma; the raw v output, before ``denoise``'s
    c_skip and c_out, which at sigma 14.6 make ``c_skip * x`` 93% of the
    result) and one VAE decode of its latent, then one whole request
    (seed 42, the CLI's options) and its image, each with the attention
    kernels, with their plain versions and with each planted fault of
    ``CONTROLS``."""
    unet, vae = s._models["unet."], s._models["vae."]
    gen = torch.Generator(device="cuda").manual_seed(1)
    hw = SD2_DIM // 8
    sigma = 14.6
    x = torch.randn(2, 4, hw, hw, device="cuda", generator=gen) * sigma
    t = torch.full((2,), 999.0, device="cuda")
    cond = torch.from_numpy(np.concatenate(
        [s.tensors["cond"], s.tensors["ncond"]])).cuda()
    lat = torch.from_numpy(s.tensors["latent"]).cuda()

    def run():
        with torch.no_grad():
            return [("sd2_unet_v", unet(x / (sigma * sigma + 1.0) ** 0.5, t,
                                        cond).float()),
                    ("sd2_vae_image", vae(lat).float())]

    caught = _controls(run, _kernels_vs_plain("bf16", None, run))

    def request():
        s.option_set("seed", REQUESTS[0][0])
        s.option_set("prompt", REQUESTS[0][1])
        s.option_set("nprompt", "blurry, low quality")
        s.generate()
        return [("sd2_request_latent", torch.from_numpy(
                    s.tensors["latent"]).cuda()),
                ("sd2_request_image", torch.from_numpy(
                    s.tensors["image"]).cuda())]

    caught |= _controls(request, _kernels_vs_plain("bf16", None, request))
    missed = [f for f, (gross, _) in CONTROLS.items()
              if gross and f not in caught]
    if missed:
        raise AssertionError(f"gross faults {missed} read inside the limits")


def time_sdxl_int8_shapes(s) -> dict:
    """The quantized products of one SDXL q8_0 request under
    MLIS_Q8_MODE=int8 (``unet_products``), each timed for the per-block
    W8A8 kernel beside its bound and the library calls; returns the
    per-request sums (``int8_library_ms`` over the products it takes,
    ``int8_library_calls`` of them)."""
    totals = collections.defaultdict(float)
    calls = unet_products(s, SDXL_DIM, SDXL_STEPS)
    for (m, k, n), c in sorted(calls.items()):
        x, q, sc = testing.quant_inputs(m, k, n, 8)
        w = (q.float().view(n, -1, quant.KBLOCK) * sc[:, :, None]
             ).view(n, -1).bfloat16()
        t = {"ms": ms(lambda: qmm.q8_matmul_int8(x, q, sc)),
             "library_ms": ms(lambda: torch.matmul(x, w.t())),
             "int8_library_ms": _int_mm_ms(x, q, quant.KBLOCK),
             **_q8_int8_bound(m, k, n)}
        for key in ("ms", "library_ms", "bound_ms"):
            totals[key] += c * t[key]
        if t["int8_library_ms"] is not None:
            totals["int8_library_ms"] += c * t["int8_library_ms"]
            totals["int8_library_calls"] += c
        phase("shapes", model="sdxl", kernel="q8_matmul_int8",
              mkn=[m, k, n], calls_per_request=c,
              tile_n=qmm.i8_tile_n(m, n), **t)
    phase("shapes", model="sdxl", kernel="q8_matmul_int8",
          per_request_ms=dict(totals), calls=sum(calls.values()))
    return totals


def time_products(calls, model: str) -> dict:
    """Each product (rows, K, N) -> calls of one request timed for the q8
    and q4 kernel the dispatch picks in the default mode: per product the
    calls per request, the kernel, the ws tile width, its time, its plain
    version's, its bound and the library call's time; then the per-request
    sums, by kernel too (``q8_matmul_ws_ms``: K6's device time a
    request)."""
    totals = collections.defaultdict(float)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (m, k, n), c in sorted(calls.items()):
        kind_ = "ws" if qmm.use_ws(m, k) else "tile"
        row = {"mkn": [m, k, n], "calls_per_request": c, "kernel": kind_}
        if kind_ == "ws":
            row["tile_n"] = qmm.ws_tile_n(m, n, sms)
        for bits in (8, 4):
            name = f"q{bits}_matmul_{kind_}"
            x, q, sc = testing.quant_inputs(m, k, n, bits)
            t = {**_time_quant(name, x, q, sc, bits),
                 **_quant_bound(m, k, n, bits)}
            row[f"q{bits}"] = t
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                totals[f"q{bits}_{key}"] += c * t[key]
            totals[f"{name}_ms"] += c * t["ms"]
        phase("shapes", model=model, **row)
    phase("shapes", model=model, per_request_ms=dict(totals),
          calls=sum(calls.values()))
    return totals


def time_shapes(s) -> dict:
    """The quantized products of one SD1.5 q8_0 request (the same for
    q4_0), counted by hooks on a request, through :func:`time_products`."""
    calls = collections.Counter()

    def hook(mod, inp, out):
        x = inp[0]
        k = x.shape[-1]
        calls[(x.numel() // k, k, out.shape[-1])] += 1

    hooks = [m.register_forward_hook(hook) for mod in s._models.values()
             for m in mod.modules() if isinstance(m, blocks_mod.QLinear)]
    try:
        s.option_set("seed", 45)
        s.option_set("prompt", "a lighthouse")
        s.generate()
    finally:
        for h in hooks:
            h.remove()
    return time_products(calls, "sd1")


# -- the sampler and guidance options (``features`` lines) -------------------

# the in-situ output each model's feature requests are held to
FEATURE_OUTPUT = {"sd1": "unet_eps", "sdxl": "sdxl_unet_eps",
                  "sd3": "mmdit_v", "flux_dev": "flux_dev_v"}
# the infotext each feature's request gives
FEATURE_TEXT = {"cfg_rescale": "CFG Rescale: 0.7",
                "subseed": "Variation seed: 4242, Variation seed strength: "
                           "0.3",
                "lcm": "Sampler: lcm, Schedule type: lcm",
                "freeu": ", FreeU: ", "pag": ", PAG scale: 3",
                "deepcache": ", DeepCache: ", "tiling": ""}


def _capture(model, pred):
    """A forward pre-hook on ``model`` that keeps the inputs (positional
    and keyword, tensors cloned) of its first call for which ``pred(args,
    kwargs)`` holds: (the list it fills, the hook's handle)."""
    got = []

    def clone(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def hook(mod, args, kwargs):
        if not got and pred(args, kwargs):
            got.append((tuple(clone(a) for a in args),
                        {k: clone(v) for k, v in kwargs.items()}))

    return got, model.register_forward_pre_hook(hook, with_kwargs=True)


def _dc_refreshes(n_step: int, k: int) -> int:
    """The steps of ``n_step`` on which DeepCache at ``k`` runs the whole
    model: i % k == 0 or i < max(1, n_step // 10)."""
    warm = max(1, n_step // 10)
    return sum(i % k == 0 or i < warm for i in range(n_step))


def _feature_want(s, model: str, feature: str, n_step: int) -> dict:
    """The flash launches of one feature request by kernel and shape: a
    request's (K1 or K3, and K2 once); PAG adds its batch-1 evaluation's
    K1 shapes; DeepCache runs the UNet's attention on refresh steps only
    (SDXL's level 0 has none) and a DiT's first ``dc_split`` blocks on the
    others."""
    want = _flash_want(model, n_step, 1)
    if feature == "pag":
        want.update(_flash_want(model + "_pag", n_step, 0))
    elif feature == "deepcache":
        full = _dc_refreshes(n_step, s.c["deepcache"])
        if not s._flow():
            return _flash_want(model, full, 1)
        P = s._mt.unet_p
        split = (flux_mod.dc_split(P.depth_double)
                 if getattr(P, "flux", False) else mmdit_mod.dc_split(P.depth))
        for key in want:
            if key[0] == "flash_attn_joint":
                per = want[key] // n_step
                want[key] = full * per + (n_step - full) * split
    return want


def _feature_pred(s, feature: str):
    """Which denoiser call a feature request's in-situ check takes: PAG's
    perturbed evaluation; under DeepCache a DiT's first shallow one (the
    cache its last positional input) and a UNet's first whole one, which
    keeps the cache (SDXL's shallow path, level 0, holds no attention);
    else the first."""
    if feature == "pag":
        return lambda a, kw: bool(kw.get("pag"))
    if feature == "deepcache":
        if s._flow():
            return lambda a, kw: a[-1] is not None
        return lambda a, kw: bool(kw.get("want_cache"))
    return lambda a, kw: True


def feature_request(s, model: str, feature: str, opts) -> dict:
    """One request of the bf16 session ``s`` with ``opts`` set (put back
    after it): its seconds, its exact flash launches by shape
    (``_feature_want``), its image and infotext, and the in-situ check of
    one of its denoiser evaluations (``_feature_pred``) with the kernels
    against the plain attention (``REF_LIMITS``); the subseed request's
    initial noise bit for bit the numpy slerp of its two streams; the
    tiling request's VAE decode wrap-equivariant (``tiling_check``).
    Returns the launches."""
    den = s._models[s._denoiser()]
    saved = [(k, s.c[api._id_norm(k)]) for k, _ in opts]
    for k, v in opts:
        s.option_set(k, v)
    n_step = sampler_mod.plan_n_step(sampler_mod.SamplerConfig(
        method=s.c["method"], n_step=s.c["steps"]))
    seed, prompt = REQUESTS[0]
    s.option_set("seed", seed)
    s.option_set("prompt", prompt)
    s.option_set("nprompt", "blurry, low quality")
    want = _feature_want(s, model, feature, n_step)
    got_in, hook = _capture(den, _feature_pred(s, feature))
    plans, make_plan = [], api.make_plan

    def keep_plan(*a, **kw):
        plans.append(make_plan(*a, **kw))
        return plans[-1]

    api.make_plan = keep_plan
    fa.reset_counts()
    qmm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        img = s.generate()
    finally:
        hook.remove()
        api.make_plan = make_plan
    secs = time.time() - t0
    shapes = collections.Counter(fa.LAUNCH_SHAPES) + collections.Counter(
        qmm.LAUNCH_SHAPES)
    got = _check_launches(f"{model} {feature}", shapes, want)
    dim = img.shape[-1]
    phase("features", model=model, feature=feature, options=dict(opts),
          seconds=secs, steps=n_step, nfe=s._nfe, **_clocks(),
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          launches=got, launches_by_shape={
              f"{k[0]} {list(k[1])}": n for k, n in shapes.items()},
          image_mean=float(img.mean()), image_std=float(img.std()),
          infotext=s.infotext)
    if not _image_ok(img, dim) or FEATURE_TEXT[feature] not in s.infotext:
        raise AssertionError(f"{model} {feature}: bad image {img.shape} or "
                             f"infotext {s.infotext!r}")
    args, kw = got_in[0]

    def run():
        with torch.no_grad():
            out = den(*args, **kw)
            out = out[0] if isinstance(out, tuple) else out
            return [(FEATURE_OUTPUT[model], out.float())]

    _kernels_vs_plain("bf16", None, run, model=model, feature=feature)
    if feature == "subseed":
        subseed_check(plans[0], seed, dict(opts))
    if feature == "tiling":
        tiling_check(s)
    for k, v in saved:
        s.option_set(k, v)
    return got


def subseed_check(plan, seed: int, opts: dict) -> None:
    """The subseed request's initial noise (the plan the session drew)
    against the numpy slerp of the seed's and the subseed's streams, drawn
    here: bit for bit."""
    shape = plan.noise0.shape[1:]
    base = RngPhilox(seed, 0).randn_shaped(shape)[None].astype(np.float32)
    sub = RngPhilox(opts["subseed"], 0).randn_shaped(shape)[None].astype(
        np.float32)
    want = sampler_mod._noise_slerp(base, sub, opts["subseed-strength"])
    equal = bool(np.array_equal(plan.noise0, want))
    phase("features", model="sd1", feature="subseed", step="noise",
          noise0_bit_equal=equal,
          differs_from_seed_noise=bool(not np.array_equal(plan.noise0,
                                                          base)))
    if not equal or np.array_equal(plan.noise0, base):
        raise AssertionError("subseed: the initial noise is not the slerp")


def tiling_check(s) -> None:
    """Wrap-equivariance on the card: the VAE decode (bf16, tiling on) of
    the tiling request's latent rolled by ``TILING_ROLL`` equals its
    decode rolled by 8 times that, within ``TILING_WRAP_REL_L2``; the
    untiled decode, for contrast, does not wrap."""
    vae = s._models["vae."]
    f = vae.P.f_down
    lat = torch.from_numpy(s.tensors["latent"]).cuda()
    k = TILING_ROLL
    rel = {}
    with torch.no_grad():
        for on in (True, False):
            blocks_mod.set_tiling(vae, on)
            a = torch.roll(vae(lat).float(), (k[0] * f, k[1] * f), (2, 3))
            b = vae(torch.roll(lat, k, (2, 3))).float()
            rel[on] = ((a - b).norm() / b.norm()).item()
    phase("features", model="sd1", feature="tiling", step="wrap",
          roll=list(k), rel_l2=rel[True], untiled_rel_l2=rel[False],
          limit=TILING_WRAP_REL_L2)
    if not rel[True] < TILING_WRAP_REL_L2 or not rel[False] > rel[True]:
        raise AssertionError(f"tiling: the decode does not wrap {rel}")


def features(s, model: str) -> collections.Counter:
    """The ``FEATURES`` requests of ``model`` on its bf16 session ``s``."""
    launches = collections.Counter()
    for feature, opts in FEATURES[model]:
        launches.update(feature_request(s, model, feature, opts))
    return launches


def features_sd1(ckpt: str) -> collections.Counter:
    """The SD1.5 512^2 ``features`` requests on a bf16 session of
    ``ckpt``."""
    s = api.MLImgSynth(device="cuda")
    for k, v in [("model", ckpt), ("model-type", "sd1"),
                 ("weight-type", "bf16"), ("image-dim", 512), ("steps", 20),
                 ("cfg-scale", 7.0), ("method", "euler"),
                 ("scheduler", "uniform")]:
        s.option_set(k, v)
    s.setup()
    launches = features(s, "sd1")
    _drop(s)
    return launches


def dit_img2img_request(s, model: str) -> dict:
    """One img2img request at ``I2I_F_T_INI`` on the bf16 SD3.5 or Flux
    session (``img2img_request``: K2 in the encoder and the decoder, K3 at
    the model's shape for the cut step count, ``image_encode_s``), and its
    first denoiser evaluation with the kernels against the plain
    attention (``REF_LIMITS``)."""
    den = s._models[s._denoiser()]
    first, hook = _first_eval(den)
    try:
        got = img2img_request(s, model, DIT_DIM)
    finally:
        hook.remove()
    args = first[0]

    def run():
        with torch.no_grad():
            return [(f"{model}_v", den(*args).float())]

    _kernels_vs_plain("bf16", None, run, model=model, request="img2img")
    return got


def sd3_q8_t5_request(s, tmp: str) -> collections.Counter:
    """SD3-medium q8_0 with the T5-XXL file of the ``t5`` lines at 77
    tokens (the T5 encoder in bf16, never quantized): one request with its
    exact launches by kernel and shape (the quantized products for 77 CLIP
    and 77 T5 context rows, ``dit_products``) and the in-situ check of its
    first MMDiT evaluation against the quantized matmuls' plain versions
    (``mmdit_v_q8_0``)."""
    for k, v in [("t5", os.path.join(tmp, T5_FILE)),
                 ("t5-tokenizer", os.path.join(tmp, T5_TOKENIZER)),
                 ("t5-tokens", 77)]:
        s.option_set(k, v)
    t0 = time.time()
    s._t5_load()
    t5_load_s = time.time() - t0
    want = {**_flash_want("sd3", SD3_STEPS, 1),
            **_quant_want(dit_products(s, SD3_STEPS), 8)}
    den = s._models["mmdit."]
    seed, prompt = REQUESTS[0]
    s.option_set("seed", seed)
    s.option_set("prompt", prompt)
    s.option_set("nprompt", "blurry, low quality")
    first, hook = _first_eval(den)
    fa.reset_counts()
    qmm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        img = s.generate()
    finally:
        hook.remove()
    secs = time.time() - t0
    shapes = collections.Counter(fa.LAUNCH_SHAPES) + collections.Counter(
        qmm.LAUNCH_SHAPES)
    got = _check_launches("sd3 q8_0 t5", shapes, want)
    cond = s.tensors["cond"]
    phase("t5", model="sd3", path="q8_0", seconds=secs, t5_load_s=t5_load_s,
          t5_encode_s=s.times.get("t5_encode_s"), t5_tokens=77,
          cond_rows=cond.shape[1], t5_rows_nonzero=bool(
              np.abs(cond[:, 77:]).max() > 0), **_clocks(),
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          launches=got, launches_by_shape={
              f"{k[0]} {list(k[1])}": n for k, n in shapes.items()},
          image_mean=float(img.mean()), image_std=float(img.std()))
    if not _image_ok(img, SD3_DIM) or not np.abs(cond[:, 77:]).max() > 0:
        raise AssertionError("sd3 q8_0 t5: bad image or zero T5 rows")
    args = first[0]

    def run():
        with torch.no_grad():
            return [("mmdit_v_q8_0", den(*args).float())]

    _kernels_vs_plain("q8_0", 8, run, model="sd3", t5_tokens=77)
    return collections.Counter(got)


# Flux's weight-only products by group (the in-situ drift search): the
# modulations at one row (N 18432, 9216, 6144), the embedders at one row
# (time_in, guidance_in, vector_in: N 3072), the text stream at its T5
# rows, the long-K products (mlp.2 and linear2, K 12288 and 15360) and the
# rest (single-block linear1 on q4_0, the final linear)
DRIFT_GROUPS = ("modulations", "embedders", "text_stream", "long_k",
                "other")


def _drift_group(s, m: int, k: int, n: int) -> str:
    if m == 1:
        return "embedders" if n == s._mt.unet_p.d_model else "modulations"
    if m == _t5_rows(s):
        return "text_stream"
    return "long_k" if k >= 12288 else "other"


def flux_drift_groups(s, model: str) -> None:
    """The first Flux evaluation of the last quantized request (on the
    inputs ``dit_q_requests`` kept) with the weight-only kernels on for one
    product group at a time and the plain versions elsewhere, against the
    plain versions everywhere; once with the plain versions as they are
    (products of fewer than ``quant.PAD_ROWS`` rows padded with zero rows)
    and once with that padding off, as it was when Flux-dev q8_0 read
    1.8e-2 in situ.  Each group's difference is reported; with the padded
    versions every group must read 0.0."""
    wt, bits = DIT_Q[model]
    den = s._models["flux."]
    args = s.first_eval
    names = [f"q{bits}_matmul_tile", f"q{bits}_matmul_ws"]
    kernels = {n: getattr(qmm, n) for n in names}
    plain = quant.q4_matmul_plain if bits == 4 else quant.q8_matmul_plain
    pad_rows = quant.PAD_ROWS

    def evaluate(group, padded):
        def route(kern):
            def fn(x, w, sc):
                m, k = x.numel() // x.shape[-1], x.shape[-1]
                if group == "all" or _drift_group(s, m, k,
                                                   w.shape[0]) == group:
                    return kern(x, w, sc)
                return plain(x, w, sc)
            return fn
        for n in names:
            setattr(qmm, n, route(kernels[n]))
        quant.PAD_ROWS = pad_rows if padded else 0
        qmm.reset_counts()
        try:
            with torch.no_grad():
                return den(*args).float(), dict(qmm.LAUNCHES)
        finally:
            for n in names:
                setattr(qmm, n, kernels[n])
            quant.PAD_ROWS = pad_rows

    for padded in (True, False):
        ref, _ = evaluate(None, padded)
        for group in DRIFT_GROUPS + ("all",):
            out, launched = evaluate(group, padded)
            rel = ((out - ref).norm() / ref.norm()).item()
            phase("flux", model=model, path=wt, step="drift_groups",
                  padded=padded, group=group, rel_l2=rel,
                  max_abs_err=(out - ref).abs().max().item(),
                  launches=launched)
            if padded and rel != 0.0:
                raise AssertionError(f"{model} {wt}: group {group} reads "
                                     f"{rel} against the plain versions")


# (model type, tiny geometry, image side, seed): the SD3 one at 512^2 (its
# largest, a 32 x 32 patch grid) runs the joint kernel in the VAE's
# mid-block (64 x 64 latent tokens)
# The second-stage and control paths (``inpaint``, ``controlnet``,
# ``hires``, ``upscale`` and ``refiner`` lines), on the SD1.5 checkpoint at
# 512^2 (20 Euler steps, CFG 7) and the SDXL-base one at 1024^2:
# inpainting at full resolution (a 768^2 RGBA image with an off-centre
# hole, the mask blurred by INPAINT_BLUR, its box padded by INPAINT_PAD and
# processed at 512^2, f_t_ini INPAINT_F_T_INI) and on a random full-width
# 9-channel inpaint-variant SD1.5 (drawn on the card; 20 steps from the
# RGBA image, K2 in the sampled and the deterministic encode and the
# decode); a random full-width SD1.5 ControlNet (control_model.* layout,
# drawn on the card; its encoder copy adds 2 self-attentions at each of
# SD1.5's two flash levels per evaluation) at CNET_STRENGTH on a 512^2
# hint; the hires fix 512^2 -> 1024^2 (HIRES: 14 second-pass steps, the
# UNet's level 2 at head dim 160 on the wide kernel), by the latent and by
# a random RRDBNet x4plus (ESRGAN_X4: 23 blocks, 64 wide); the CLI's
# upscale of the 512^2 image by that model, whole and in UPSCALE_TILE tiles;
# SDXL-base with a random full-width SDXL refiner (drawn on the card) at
# REFINER_SWITCH, then one request of the refiner alone.
INPAINT_BLUR, INPAINT_PAD, INPAINT_F_T_INI = 4.0, 32, 0.8
INPAINT_IMAGE, INPAINT_HOLE = 768, (96, 288, 448, 704)   # y0, y1, x0, x1
CNET_STRENGTH = 0.8
HIRES = [("hires-fix", 2.0), ("hires-denoise", 0.7)]
HIRES_DIM, HIRES_UPSCALER = 1024, "RealESRGAN_x4plus"
ESRGAN_X4 = esr_mod.EsrganParams(n_feat=64, n_block=23, growth=32)
UPSCALE_TILE = 256
REFINER_SWITCH = 0.8


def _sd1_session(ckpt: str):
    """A bf16 SD1.5 512^2 session of ``ckpt``, loaded: (it, load s)."""
    s = api.MLImgSynth(device="cuda")
    for k, v in [("model", ckpt), ("model-type", "sd1"),
                 ("weight-type", "bf16"), ("image-dim", 512), ("steps", 20),
                 ("cfg-scale", 7.0), ("method", "euler"),
                 ("scheduler", "uniform")]:
        s.option_set(k, v)
    t0 = time.time()
    s.setup()
    return s, time.time() - t0


def _request(s, line: str, what: str, want: dict, **opts):
    """One request of ``s`` with ``opts`` (prompt and seed of REQUESTS[0])
    and its flash launches by shape, checked exactly against ``want``:
    (the image or latent, its seconds, the launches by kernel)."""
    for k, v in [("seed", REQUESTS[0][0]), ("prompt", REQUESTS[0][1]),
                 ("nprompt", "blurry, low quality"), *opts.items()]:
        s.option_set(k.replace("_", "-"), v)
    fa.reset_counts()
    qmm.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = s.generate()
    secs = time.time() - t0
    shapes = collections.Counter(fa.LAUNCH_SHAPES)
    got = _check_launches(f"{line} {what}", shapes, want)
    if any(qmm.LAUNCHES.values()):
        raise AssertionError(f"{line} {what}: quantized kernels launched")
    phase(line, request=what, seconds=secs, **_clocks(),
          max_memory_allocated=torch.cuda.max_memory_allocated(),
          launches=got, launches_by_shape={
              f"{k[0]} {list(k[1])}": n for k, n in sorted(shapes.items())},
          times={k: v for k, v in s.times.items()
                 if k.endswith("_s") and not k.startswith("move_")},
          image_mean=float(out.mean()), image_std=float(out.std()),
          infotext=s.infotext)
    return out, secs, got


def _in_situ(line: str, what: str, model=None, got_in=None, run=None,
             **kv) -> None:
    """The in-situ check of a line: the call of ``model`` that
    ``_capture`` recorded in ``got_in``, or ``run``, with the kernels
    against the same with the plain attention, held to
    ``REF_LIMITS[what]``."""
    if run is None:
        args, kw = got_in[0]

        def run():
            with torch.no_grad():
                out = model(*args, **kw)
                out = out[0] if isinstance(out, tuple) else out
                return [(what, out.float())]

    _kernels_vs_plain("bf16", None, run, line=line, **kv)


def inpaint_requests(s, tmp: str) -> collections.Counter:
    """The ``inpaint`` lines: full-resolution inpainting with a blurred
    mask on the SD1.5 session ``s``, then a request of a random 9-channel
    inpaint-variant SD1.5 with one of its UNet evaluations in situ.
    Returns the launches."""
    launches = collections.Counter()
    rgba = _test_image(INPAINT_IMAGE, 5)
    y0, y1, x0, x1 = INPAINT_HOLE
    rgba[:, :, 3] = 255
    rgba[y0:y1, x0:x1, 3] = 0
    n_step = _n_step(20, "euler", INPAINT_F_T_INI)
    img, _, got = _request(
        s, "inpaint", "full_res", _flash_want("sd1", n_step, 2),
        image=rgba, f_t_ini=INPAINT_F_T_INI, mask_blur=INPAINT_BLUR,
        inpaint_full_res=1, inpaint_full_res_padding=INPAINT_PAD)
    launches.update(got)
    mask = rgba[None, None, :, :, 3].astype(np.float32) / 255.0
    box = image_mod.inpaint_crop_region(
        1.0 - image_mod.mask_gaussian_blur(mask, INPAINT_BLUR), 512, 512,
        INPAINT_PAD)
    bx0, by0, bx1, by1 = box
    outside = np.ones((INPAINT_IMAGE, INPAINT_IMAGE), bool)
    outside[by0:by1, bx0:bx1] = False
    kept = bool(np.array_equal(
        img[0].transpose(1, 2, 0)[outside],
        rgba[:, :, :3][outside].astype(np.float32) / 255.0))
    lm = s.tensors["lmask"]
    blurred = int(((lm > 0) & (lm < 1)).sum())
    phase("inpaint", request="full_res", box=list(box),
          outside_box_equal_input=kept, blurred_lmask_values=blurred)
    if (img.shape != (1, 3, INPAINT_IMAGE, INPAINT_IMAGE) or not kept
            or not blurred or "Inpaint area: only masked" not in s.infotext
            or not np.isfinite(img).all()):
        raise AssertionError(f"inpaint full_res: image {img.shape}, kept "
                             f"{kept}, blurred {blurred}, {s.infotext!r}")
    s.option_set("inpaint-full-res", 0)
    s.option_set("mask-blur", 0.0)
    # the 9-channel inpaint variant, drawn on the card
    mt9 = testing.inpaint_variant(api._model_types()["sd1"])
    path = os.path.join(tmp, "sd1-inpainting-random-f16.safetensors")
    t0 = time.time()
    testing.write_random_checkpoint(path, mt9, seed=1, device="cuda")
    write_s = time.time() - t0
    v, load_s = _sd1_session(path)
    phase("inpaint", request="variant", step="checkpoint", write_s=write_s,
          load_s=load_s, bytes=os.path.getsize(path),
          n_ch_in=v._mt.unet_p.n_ch_in)
    unet = v._models["unet."]
    got_in, hook = _capture(unet, lambda a, kw: True)
    try:
        _, _, got = _request(v, "inpaint", "variant",
                             _flash_want("sd1", 20, 3),
                             image=_test_image(512, 6))
    finally:
        hook.remove()
    launches.update(got)
    if v._mt.unet_p.n_ch_in != 9 or got_in[0][0][0].shape[1] != 9:
        raise AssertionError("inpaint variant: the UNet does not take 9 "
                             "input channels")
    _in_situ("inpaint", "unet_eps", unet, got_in, request="variant")
    _drop(v)
    os.remove(path)
    return launches


def controlnet_request(s, tmp: str) -> collections.Counter:
    """The ``controlnet`` line: a random full-width SD1.5 ControlNet,
    drawn on the card, on the SD1.5 session ``s``; one request, exact
    launches (the UNet's and the encoder copy's), and the ControlNet and
    UNet evaluation of its first step in situ.  Returns the launches."""
    path = os.path.join(tmp, "sd1-controlnet-random-f16.safetensors")
    t0 = time.time()
    shapes = testing.write_random_controlnet(
        path, api._model_types()["sd1"], seed=2, device="cuda")
    write_s = time.time() - t0
    hint = np.zeros((512, 512, 3), np.uint8)
    hint[::32] = 255
    hint[:, 100:104] = 255
    s.option_set("control-net", path)
    s.option_set("control-image", hint)
    t0 = time.time()
    s.setup()
    phase("controlnet", step="load", write_s=write_s,
          load_s=time.time() - t0, tensors=len(shapes),
          bytes=os.path.getsize(path))
    cnet, unet = s._models["cnet."], s._models["unet."]
    got_in, hook = _capture(cnet, lambda a, kw: True)
    try:
        _, _, got = _request(
            s, "controlnet", "request",
            _want_sum(_flash_want("sd1", 20, 1),
                      _flash_want("sd1_cnet", 20, 0)),
            control_strength=CNET_STRENGTH)
    finally:
        hook.remove()
    if f"ControlNet strength: {CNET_STRENGTH:g}" not in s.infotext:
        raise AssertionError(f"controlnet: infotext {s.infotext!r}")
    (x, t, cond, label, feat), _ = got_in[0]

    def run():
        with torch.no_grad():
            res = [r * CNET_STRENGTH for r in cnet(x, t, cond, label, feat)]
            return [("unet_eps", unet(x, t, cond, label,
                                      control=res).float())]

    _in_situ("controlnet", "unet_eps", run=run)
    s.option_set("control-net", "")
    s.option_set("control-image", "")
    s.setup()
    os.remove(path)
    return collections.Counter(got)


def hires_requests(s, tmp: str) -> collections.Counter:
    """The ``hires`` lines on the SD1.5 session ``s``: 512^2 -> 1024^2 by
    the latent (its 1024^2 UNet evaluation in situ, the 17 GB plain
    softmax of level 0 included), then by the random RRDBNet x4plus (the
    first pass decoded, upscaled to 2048^2, Lanczos-resized to 1024^2,
    encoded).  Returns the launches and the upscaler's path."""
    launches = collections.Counter()
    n2 = _n_step(20, "euler", dict(HIRES)["hires-denoise"])
    for k, v in HIRES:
        s.option_set(k, v)
    unet = s._models["unet."]
    got_in, hook = _capture(unet, lambda a, kw: a[0].shape[-1] == 128)
    try:
        lat_img, _, got = _request(
            s, "hires", "latent",
            _want_sum(_flash_want("sd1", 20, 0),
                      _flash_want("sd1_1024", n2, 1)))
    finally:
        hook.remove()
    launches.update(got)
    if not _image_ok(lat_img, HIRES_DIM) or "Hires upscale: 2" not in \
            s.infotext:
        raise AssertionError(f"hires latent: image {lat_img.shape}")
    _in_situ("hires", "unet_eps", unet, got_in, request="latent")
    path = os.path.join(tmp, "RealESRGAN_x4plus-random.pth")
    t0 = time.time()
    testing.write_random_esrgan(path, ESRGAN_X4, seed=3)
    phase("hires", step="upscaler", write_s=time.time() - t0,
          bytes=os.path.getsize(path))
    s.option_set("upscaler", path)
    s.option_set("hires-upscaler", HIRES_UPSCALER)
    img, _, got = _request(
        s, "hires", "image",
        _want_sum(_flash_want("sd1", 20, 1), _flash_want("sd1_1024", n2, 2)))
    launches.update(got)
    if not _image_ok(img, HIRES_DIM) or f"Hires upscaler: " \
            f"{HIRES_UPSCALER}" not in s.infotext:
        raise AssertionError(f"hires image: image {img.shape}")
    for k, v in [("hires-fix", 0.0), ("hires-upscaler", "")]:
        s.option_set(k, v)
    return launches, path


def upscale_cli(tmp: str, up: str) -> None:
    """The ``upscale`` lines: the CLI's ``upscale`` of a 512^2 PNG by the
    random RRDBNet x4plus, whole and in tiles of ``UPSCALE_TILE``: no flash
    kernel, the 2048^2 PNGs read back, the tiles' seams measured against
    the whole pass."""
    src = os.path.join(tmp, "up-in.png")
    image_mod.image_save(src, _test_image(512, 7)[:, :, :3])
    outs = {}
    for what, extra in (("whole", []),
                        ("tiled", ["--upscale-tile", str(UPSCALE_TILE)])):
        out = os.path.join(tmp, f"up-{what}.png")
        secs, s, shapes = _cli_request(["upscale", "--upscaler", up, "-i",
                                        src, "-o", out, "-q", *extra])
        if shapes or any(qmm.LAUNCHES.values()):
            raise AssertionError(f"upscale {what}: kernels launched")
        outs[what] = image_mod.png_read(out)[0].astype(np.float32)
        phase("upscale", request=what, seconds=secs,
              upscale_s=s.times.get("upscale_s"),
              upscaler_load_s=s.times.get("upscaler_load_s"),
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              shape=list(outs[what].shape), tile=UPSCALE_TILE if extra
              else 0, **_clocks())
        if outs[what].shape != (2048, 2048, 3):
            raise AssertionError(f"upscale {what}: {outs[what].shape}")
        del s
    diff = np.abs(outs["tiled"] - outs["whole"])
    phase("upscale", step="tiled_vs_whole", max_abs_u8=float(diff.max()),
          mean_abs_u8=float(diff.mean()))


def second_stage_sd1(tmp: str, ckpt: str) -> collections.Counter:
    """The SD1.5 lines of the second-stage and control paths on a bf16
    session of ``ckpt``: ``inpaint``, ``controlnet``, ``hires``, then the
    ``upscale`` CLI calls.  Returns the launches."""
    s, load_s = _sd1_session(ckpt)
    phase("inpaint", step="setup", load_s=load_s)
    launches = inpaint_requests(s, tmp)
    launches.update(controlnet_request(s, tmp))
    got, up = hires_requests(s, tmp)
    launches.update(got)
    _drop(s)
    upscale_cli(tmp, up)
    os.remove(up)
    return launches


def refiner_path(s, tmp: str) -> collections.Counter:
    """The ``refiner`` lines on the SDXL-base bf16 session ``s``: a random
    full-width SDXL refiner drawn on the card, one ensemble request at
    ``REFINER_SWITCH`` (the base's steps to the switch, the refiner's after
    it; exact launches of both models) with a refiner UNet evaluation in
    situ, then one request of the refiner alone.  Returns the launches."""
    mt = api._model_types()["sdxl_refiner"]
    path = os.path.join(tmp, "sdxl_refiner-random-f16.safetensors")
    t0 = time.time()
    testing.write_random_checkpoint(path, mt, seed=4, device="cuda")
    phase("refiner", step="checkpoint", write_s=time.time() - t0,
          bytes=os.path.getsize(path))
    s.option_set("refiner", path)
    s.option_set("refiner-switch", REFINER_SWITCH)
    cut = 1.0 - REFINER_SWITCH
    n_base = sampler_mod.plan_n_step(sampler_mod.SamplerConfig(
        n_step=SDXL_STEPS, f_t_end=cut, keep_tail=True), 2)
    n_ref = sampler_mod.plan_n_step(sampler_mod.SamplerConfig(
        n_step=SDXL_STEPS, f_t_ini=cut), 2)
    rs = s._refiner_get()
    t0 = time.time()
    rs.setup()
    phase("refiner", step="setup", load_s=time.time() - t0,
          base_steps=n_base, refiner_steps=n_ref)
    got_in, hook = _capture(rs._models["unet."], lambda a, kw: True)
    try:
        img, _, got = _request(
            s, "refiner", "ensemble",
            _want_sum(_flash_want("sdxl", n_base, 0),
                      _flash_want("sdxl_refiner", n_ref, 1)))
    finally:
        hook.remove()
    launches = collections.Counter(got)
    if not _image_ok(img, SDXL_DIM) or "Refiner switch: 0.8" not in \
            s.infotext:
        raise AssertionError(f"refiner: image {img.shape}, {s.infotext!r}")
    _in_situ("refiner", "sdxl_unet_eps", rs._models["unet."], got_in)
    img, _, got = _request(rs, "refiner", "alone",
                           _flash_want("sdxl_refiner", SDXL_STEPS, 1))
    launches.update(got)
    if not _image_ok(img, SDXL_DIM):
        raise AssertionError(f"refiner alone: image {img.shape}")
    s.option_set("refiner", "")
    _drop(rs)
    s._refiner = None
    os.remove(path)
    return launches


SMALL_CASES = [("sd1", testing.TINY_MODEL_TYPE, 192, 1),
               ("sdxl", testing.TINY_MODEL_TYPE_XL, 192, 3),
               ("sd3", testing.TINY_Q_MODEL_TYPE_SD3, 512, 2)]
# (model type, tiny geometry, image side, seed, options): the tiny SDXL at
# widths that quantize, under q4_0 with both memory options (64-px tiles:
# 16 decode tiles of 24 x 24 latent pixels at 256^2)
SMALL_OPTION_CASES = [("sdxl", testing.TINY_Q_MODEL_TYPE_XL, 256, 4,
                       [("weight-type", "q4_0"), ("vae-tile", 64),
                        ("unet-split", 1)])]


def small_check():
    """Limits: final image PSNR > 30 dB and final latent relative L2 <
    0.1.  The card computes in bf16 (2^-8 relative rounding per op) over
    10 steps; on the CPU the same comparison, bf16 against f32, gives
    about 39 dB and 0.035 for SD1."""
    types = api._model_types
    try:
        for name, mt, dim, seed, opts in (
                [c + ([],) for c in SMALL_CASES] + SMALL_OPTION_CASES):
            api._model_types = lambda name=name, mt=mt: {name: mt}
            out, launches = {}, 0
            with tempfile.TemporaryDirectory() as tmp:
                ckpt = os.path.join(tmp, "tiny-random-f16.safetensors")
                testing.write_random_checkpoint(ckpt, mt, seed=seed)
                for dev in ("cuda", "cpu"):   # bf16 card, f32 CPU
                    s = api.MLImgSynth(device=dev)
                    for k, v in [("model", ckpt), ("image-dim", dim),
                                 ("steps", 10), ("seed", 5),
                                 ("cfg-scale", 7.0), ("prompt", "a red fox"),
                                 ("nprompt", "blurry"), *opts]:
                        s.option_set(k, v)
                    fa.reset_counts()
                    qmm.reset_counts()
                    out[dev] = (s.generate(), s.tensors["latent"])
                    launches += sum(_counts().values())
                    if opts and dev == "cuda" and not all(
                            qmm.LAUNCHES[k] for k in ("q4_matmul_tile",
                                                      "q4_matmul_ws")):
                        raise AssertionError(f"tiny {name} {opts}: "
                                             f"{qmm.LAUNCHES}")
            (img_g, lat_g), (img_c, lat_c) = out["cuda"], out["cpu"]
            mse = float(np.mean((np.round(img_g * 255)
                                 - np.round(img_c * 255)) ** 2))
            psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
            rel = float(np.linalg.norm(lat_g - lat_c) / np.linalg.norm(lat_c))
            phase("small", model=name, image_dim=dim, options=opts,
                  psnr_db=psnr, latent_rel_l2=rel, kernel_launches=launches,
                  limits={"psnr_db": 30.0, "latent_rel_l2": 0.1})
            if not (psnr > 30.0 and rel < 0.1 and launches > 0):
                raise AssertionError(f"tiny {name} model: card and CPU "
                                     "disagree")
    finally:
        api._model_types = types


# The serving front ends (``serve`` lines): an in-process port server on
# 127.0.0.1 over a bf16 SD1.5 512^2 session (20 Euler steps, CFG 7): four
# concurrent A1111 txt2img requests queued before the worker starts merge
# into one device batch (K1 at batch 8, K2 over 4 latents, the launches of
# one batch exactly), then the same four each alone (their rows held to the
# SD1.5 VAE image limit of REF_LIMITS), one OpenAI generation, one preview
# request polled until it has a frame, and one cancellation of a queued
# request and one of a running batch.  Then the C ABI (one generate of the
# first request through the port's shim from a C program, on the card) and
# the CLI's vae-test.  SERVE_WANT: the merged batch's launches by shape.
SERVE_REQUESTS = [(142, "a photograph of an astronaut riding a horse"),
                  (143, "a watercolor painting of a lighthouse at dawn"),
                  (144, "a (red:1.2) fox in the snow, highly detailed"),
                  (145, "a bowl of fruit on a wooden table, oil painting")]
SERVE_DIM, SERVE_STEPS = 512, 20
SERVE_BODY = {"steps": SERVE_STEPS, "cfg_scale": 7, "width": SERVE_DIM,
              "height": SERVE_DIM, "sampler_name": "Euler",
              "negative_prompt": "blurry, low quality"}
SERVE_WANT = {("flash_attn_fwd", (8, 8, 4096, 40)): 100,
              ("flash_attn_fwd", (8, 8, 1024, 80)): 100,
              ("flash_attn_fwd_wide", (4, 1, 4096, 512)): 1}
# the merged SDXL pair through generate_batch on the bf16 session
SDXL_PAIR_WANT = {("flash_attn_fwd", (4, 10, 4096, 64)): 200,
                  ("flash_attn_fwd", (4, 20, 1024, 64)): 1200,
                  ("flash_attn_fwd_wide", (2, 1, 16384, 512)): 1}
HTTP_TIMEOUT = 300
# the preview request: its steps and a frame every this many
SERVE_PREVIEW = {"steps": SERVE_STEPS, "preview_every": 5}
# the C program's backend: "" leaves the context's default, the card
CAPI_BACKEND = ""

CAPI_PROGRAM = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "mlimgsynth.h"

static int g_steps = 0;

static int progress_cb(void *user, MLIS_Ctx *ctx, const MLIS_Progress *prg)
{
	(void)user; (void)ctx;
	if (prg->stage == MLIS_STAGE_DENOISE) g_steps++;
	return 0;
}

/* drive MODEL OUT_RAW PROMPT DIM STEPS BACKEND ("" for the card) */
int main(int argc, char **argv)
{
	if (argc != 7) return 2;
	int dim = atoi(argv[4]), steps = atoi(argv[5]);
	MLIS_Ctx *ctx = mlis_ctx_create();
	if (!ctx) return 2;
	if (argv[6][0]) mlis_option_set(ctx, MLIS_OPT_BACKEND, argv[6], "");
	mlis_option_set(ctx, MLIS_OPT_MODEL, argv[1]);
	mlis_option_set(ctx, MLIS_OPT_SEED, (uint64_t)142);
	mlis_option_set(ctx, MLIS_OPT_STEPS, steps);
	mlis_option_set(ctx, MLIS_OPT_CFG_SCALE, 7.0);
	mlis_option_set(ctx, MLIS_OPT_IMAGE_DIM, dim, dim);
	mlis_option_set(ctx, MLIS_OPT_PROMPT, argv[3]);
	mlis_option_set(ctx, MLIS_OPT_NPROMPT, "blurry, low quality");
	mlis_option_set(ctx, MLIS_OPT_CALLBACK, progress_cb, (void*)0);
	if (mlis_setup(ctx) < 0 || mlis_generate(ctx) < 0) {
		printf("FAIL %s\n", mlis_errstr_get(ctx));
		return 1;
	}
	MLIS_Image *img = mlis_image_get(ctx, 0);
	FILE *f = fopen(argv[2], "wb");
	if (!img || (int)img->w != dim || (int)img->h != dim || !f) return 1;
	fwrite(img->d, 1, (size_t)img->w * img->h * img->c, f);
	fclose(f);
	printf("steps %d\n", g_steps);
	mlis_ctx_destroy(&ctx);
	printf("CAPI OK\n");
	return 0;
}
"""
# in the C program's interpreter: its launches and whether jax was loaded,
# said as the context goes
CAPI_SITE = """
import json, sys
from mlimgsynth_torch import capi
from mlimgsynth_torch.ops import flash_attention as fa
_destroy = capi.ctx_destroy


def ctx_destroy(addr):
    print("LAUNCHES " + json.dumps({
        "launches": {f"{k}:{list(q)}": n
                     for (k, q), n in fa.LAUNCH_SHAPES.items()},
        "plain": fa.PLAIN_CUDA_CALLS,
        "jax": any(m == "jax" or m.startswith(("jax.", "mlimgsynth_tpu"))
                   for m in sys.modules)}), flush=True)
    return _destroy(addr)


capi.ctx_destroy = ctx_destroy
"""


def _http(url, obj=None):
    """(status, JSON body) of a GET, or a POST of ``obj``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=None if obj is None else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            body = r.read()
            code = r.status
    except urllib.error.HTTPError as e:
        body, code = e.read(), e.code
    try:
        return code, json.loads(body)
    except ValueError:
        return code, body.decode()


def _png_u8(b64: str) -> np.ndarray:
    import base64
    return image_mod.image_load_bytes(base64.b64decode(b64), "response")


def _poll(what, fn, limit: float = HTTP_TIMEOUT):
    """Call ``fn`` until it returns a true value (or fail after ``limit``
    seconds)."""
    t0 = time.time()
    while time.time() - t0 < limit:
        v = fn()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"serve: timed out waiting for {what}")


def serve_sd1(tmp: str, ckpt: str) -> collections.Counter:
    """The ``serve`` lines (see SERVE_REQUESTS), the C ABI line and the
    CLI ``vae-test`` line on the SD1.5 checkpoint.  Returns the
    launches."""
    import threading
    from http.server import ThreadingHTTPServer
    from mlimgsynth_torch import server as srv_mod
    launches = collections.Counter()
    s, load_s = _sd1_session(ckpt)
    os.environ.setdefault("MLIS_PROGRESS_CHUNK", "4")
    warm_s = srv_mod.warmup_generate(s)
    phase("serve", step="setup", load_s=load_s, warmup_s=warm_s)
    srv = srv_mod.Server(s, merge_window_s=0.0, start_worker=False)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv_mod.make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    results, threads = {}, []

    def post_async(key, path, obj):
        t = threading.Thread(target=lambda: results.__setitem__(
            key, _http(url + path, obj)), daemon=True)
        t.start()
        threads.append(t)

    def join():
        for t in threads:
            t.join(HTTP_TIMEOUT)
            if t.is_alive():
                raise AssertionError("serve: a request did not return")
        threads.clear()

    def queued(n):
        with srv.cond:
            if not srv.cond.wait_for(lambda: len(srv.queue) >= n,
                                     timeout=HTTP_TIMEOUT):
                raise AssertionError("serve: requests did not queue")

    try:
        # four concurrent requests, queued before the worker starts
        for i, (seed, prompt) in enumerate(SERVE_REQUESTS):
            post_async(("merged", i), "/sdapi/v1/txt2img",
                       {**SERVE_BODY, "prompt": prompt, "seed": seed})
            queued(i + 1)
        fa.reset_counts()
        qmm.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        srv.worker = threading.Thread(target=srv._worker, daemon=True)
        srv.worker.start()
        join()
        merged_s = time.time() - t0
        got = collections.Counter(fa.LAUNCH_SHAPES)
        got_kernels = _check_launches("serve merged batch", got, SERVE_WANT)
        launches.update(got_kernels)
        metrics = {ln.split(" ")[0]: ln.split(" ")[1] for ln in
                   _http(url + "/metrics")[1].splitlines()
                   if ln.startswith("mlis_")}
        phase("serve", step="merged", requests=len(SERVE_REQUESTS),
              seconds=merged_s,
              images_per_s=len(SERVE_REQUESTS) / merged_s,
              launches=got_kernels, merged_requests_total=int(
                  metrics["mlis_merged_requests_total"]),
              max_memory_allocated=torch.cuda.max_memory_allocated())
        if metrics["mlis_merged_requests_total"] != "3":
            raise AssertionError(f"serve: requests did not merge: {metrics}")
        merged = []
        for i in range(len(SERVE_REQUESTS)):
            code, body = results[("merged", i)]
            if code != 200 or len(body["images"]) != 1:
                raise AssertionError(f"serve: merged request {i}: {code}")
            merged.append(_png_u8(body["images"][0]))
        # the same requests, each alone
        alone, secs = [], []
        for seed, prompt in SERVE_REQUESTS:
            fa.reset_counts()
            t0 = time.time()
            code, body = _http(url + "/sdapi/v1/txt2img",
                               {**SERVE_BODY, "prompt": prompt,
                                "seed": seed})
            secs.append(time.time() - t0)
            if code != 200:
                raise AssertionError(f"serve: request alone: {code}")
            alone.append(_png_u8(body["images"][0]))
            launches.update(_check_launches(
                "serve request alone", collections.Counter(
                    fa.LAUNCH_SHAPES), _flash_want("sd1", 20, 1)))
        rels = []
        for i, (a, b) in enumerate(zip(merged, alone)):
            a, b = a.astype(np.float64), b.astype(np.float64)
            rels.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
        phase("serve", step="alone", seconds=secs,
              sequential_s=sum(secs), images_per_s=len(secs) / sum(secs),
              merged_speedup=sum(secs) / merged_s,
              merged_vs_alone_rel_l2=rels, limit=REF_LIMITS["vae_image"],
              max_abs_u8=[int(np.abs(a.astype(int) - b.astype(int)).max())
                          for a, b in zip(merged, alone)])
        if not max(rels) < REF_LIMITS["vae_image"]:
            raise AssertionError(f"serve: merged rows vs alone {rels}")
        # one OpenAI Images request
        t0 = time.time()
        code, body = _http(url + "/v1/images/generations",
                           {"prompt": SERVE_REQUESTS[1][1], "n": 1,
                            "size": f"{SERVE_DIM}x{SERVE_DIM}",
                            "seed": 143})
        img = _png_u8(body["data"][0]["b64_json"]) if code == 200 else None
        phase("serve", step="openai", code=code, seconds=time.time() - t0)
        if img is None or img.shape != (SERVE_DIM, SERVE_DIM, 3):
            raise AssertionError(f"serve: OpenAI request: {code}")
        # a preview request, polled until it has a frame
        post_async("preview", "/generate",
                   {"prompt": SERVE_REQUESTS[2][1], "seed": 7,
                    "request_id": "pv", "preview": True, "format": "json",
                    **SERVE_PREVIEW})
        frame = _poll("a preview frame", lambda: (lambda r: r[1] if r[0]
                      == 200 and r[1].get("images") else None)(
                          _http(url + "/preview?request_id=pv")))
        join()
        code, body = results["preview"]
        phase("serve", step="preview", code=code, frame_step=frame["step"],
              n_step=frame["n_step"],
              frame_shape=list(_png_u8(frame["images"][0]).shape))
        if code != 200 or frame["step"] % SERVE_PREVIEW["preview_every"]:
            raise AssertionError(f"serve: preview request: {code} {frame}")
        # a running batch and a queued request cancelled
        post_async("run", "/generate", {"prompt": "a cat", "seed": 8,
                                        "request_id": "run",
                                        "preview": True, "preview_every": 1,
                                        "steps": SERVE_PREVIEW["steps"],
                                        "format": "json"})
        _poll("the request to run", lambda: srv.preview_of("run")[1])
        post_async("queued", "/generate", {"prompt": "a dog", "seed": 9,
                                           "request_id": "queued"})
        _poll("the request to queue",
              lambda: srv.preview_of("queued")[0] == "queued")
        states = [_http(url + "/cancel", {"request_id": rid})[1]["status"]
                  for rid in ("queued", "run")]
        join()
        codes = [results[k][0] for k in ("queued", "run")]
        phase("serve", step="cancel", states=states, codes=codes,
              errors_total=srv.n_errors)
        if states != ["dequeued", "cancelling"] or codes != [499, 499]:
            raise AssertionError(f"serve: cancellation {states} {codes}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    _drop(s)
    launches.update(capi_sd1(tmp, ckpt, alone[0]))
    launches.update(vae_test_cli(tmp, ckpt))
    return launches


def capi_sd1(tmp: str, ckpt: str, alone: np.ndarray) -> collections.Counter:
    """One SD1.5 512^2 generate (the first serve request's seed and prompt)
    through the port's C ABI shim, built with cc, from a C program in a
    process of its own, on the card; its image against the same request
    served alone.  Returns its launches."""
    from mlimgsynth_torch import capi
    t0 = time.time()
    lib = capi.build_shim()
    exe, src = os.path.join(tmp, "capi_drive"), os.path.join(tmp, "drive.c")
    with open(src, "w") as f:
        f.write(CAPI_PROGRAM)
    subprocess.run(["cc", "-O1", f"-I{capi.REPO / 'include'}", "-o", exe,
                    src, f"-L{os.path.dirname(lib)}", "-lmlimgsynth_torch",
                    f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True,
                   capture_output=True, text=True)
    build_s = time.time() - t0
    site = os.path.join(tmp, "capi_site")
    os.makedirs(site, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(CAPI_SITE)
    out_raw = os.path.join(tmp, "capi.u8")
    env = dict(os.environ, MLIS_PY_PATH=str(capi.REPO),
               PYTHONPATH=os.pathsep.join([site, str(capi.REPO)]))
    t0 = time.time()
    r = subprocess.run([exe, ckpt, out_raw, SERVE_REQUESTS[0][1],
                        str(SERVE_DIM), str(SERVE_STEPS), CAPI_BACKEND],
                       capture_output=True, text=True, env=env,
                       timeout=600)
    secs = time.time() - t0
    rep = json.loads(r.stdout.split("LAUNCHES ", 1)[1].splitlines()[0]) \
        if "LAUNCHES " in r.stdout else {}
    img = (np.fromfile(out_raw, np.uint8).reshape(SERVE_DIM, SERVE_DIM, 3)
           if r.returncode == 0 else None)
    rel = (float(np.linalg.norm(img.astype(np.float64) - alone)
                 / np.linalg.norm(alone.astype(np.float64)))
           if img is not None else None)
    got = collections.Counter()
    for key, n in rep.get("launches", {}).items():
        name, q = key.split(":")
        got[(name, tuple(json.loads(q)))] = n
    phase("capi", shim=os.path.relpath(lib, str(capi.REPO)),
          build_s=build_s, seconds=secs, rc=r.returncode,
          denoise_callbacks=r.stdout.count(f"steps {SERVE_STEPS}"),
          launches={f"{k}:{list(q)}": n for (k, q), n in got.items()},
          jax=rep.get("jax"), vs_alone_rel_l2=rel,
          equals_alone=bool(img is not None and np.array_equal(img, alone)))
    if (r.returncode != 0 or "CAPI OK" not in r.stdout or rep.get("jax")
            or rep.get("plain") or not rel < REF_LIMITS["vae_image"]):
        raise AssertionError(f"capi: {r.stdout[-2000:]} {r.stderr[-2000:]}")
    by_kernel = _check_launches("capi", got, _flash_want("sd1", 20, 1))
    if not r.stdout.count(f"steps {SERVE_STEPS}"):
        raise AssertionError("capi: the progress callback missed steps")
    return collections.Counter(by_kernel)


def vae_test_cli(tmp: str, ckpt: str) -> collections.Counter:
    """The CLI's ``vae-test`` of a 512^2 PNG on the SD1.5 checkpoint: the
    VAE encoder and decoder (K2 in each mid-block), the round trip's error
    line.  Returns the launches."""
    import contextlib
    import io
    png = os.path.join(tmp, "vae_in.png")
    image_mod.image_save(png, _test_image(SERVE_DIM, seed=5)[:, :, :3])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        secs, s, got = _cli_request(["vae-test", "-m", ckpt, "-i", png,
                                     "-S", "1", "-q"])
    line = [ln for ln in err.getvalue().splitlines()
            if ln.startswith("Image encode/decode")]
    by_kernel = _check_launches("vae-test", got, {
        ("flash_attn_fwd_wide", (1, 1, 4096, 512)): 2})
    phase("vae_test", seconds=secs, line=line[0] if line else None,
          launches=by_kernel)
    if not line:
        raise AssertionError("vae-test printed no error line")
    _drop(s)
    return collections.Counter(by_kernel)


def sdxl_pair(s) -> collections.Counter:
    """A merged SDXL pair through ``generate_batch`` on the bf16 SDXL
    session at 1024^2 (20 Euler steps, CFG 7): exact launches (K1 at batch
    4, K2 over 2 latents), seconds, images.  Returns the launches."""
    reqs = [{"prompt": p, "nprompt": "blurry, low quality", "seed": sd}
            for sd, p in REQUESTS[:2]]
    fa.reset_counts()
    qmm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    imgs, infos = s.generate_batch(reqs)
    secs = time.time() - t0
    got = _check_launches("sdxl pair", collections.Counter(
        fa.LAUNCH_SHAPES), SDXL_PAIR_WANT)
    phase("sdxl_pair", seconds=secs, images_per_s=2 / secs, launches=got,
          shape=list(imgs.shape), seeds=[r["seed"] for r in reqs],
          max_memory_allocated=torch.cuda.max_memory_allocated())
    if (imgs.shape != (2, 3, SDXL_DIM, SDXL_DIM)
            or not np.isfinite(imgs).all() or float(imgs.std()) == 0.0
            or f"Seed: {reqs[1]['seed']}" not in infos[1]):
        raise AssertionError(f"sdxl pair: bad images {imgs.shape}")
    return collections.Counter(got)


# -- the multi-rank modes -----------------------------------------------------
#
# Two processes share the one H100 and talk over gloo (NCCL does not put two
# ranks on one card; ``comm.backend_for``), each on cuda:0, the kernels built
# by this process before they start (each rank loads the cached libraries).
# SD1.5 512^2 at tp 2, dp 2 (batch 2) and sp 2, 20 Euler steps at CFG 7;
# SD3-medium 1024^2 at tp 2, sp 2, pp 2 and pp 2 with q8_0, RANK_SD3_STEPS
# Euler steps at CFG 7; one request a mode (RANK_REQUESTS); one torchrun CLI
# generate, SD1.5 tp 2 at 20 steps (at 4 steps its image read 1.74e-2 from
# one rank's, the perturbation larger against a less settled image).  Each rank's image is held to the same request on one
# rank (``_RANK_REFS``, made on the main path's sessions) by the relative L2
# of the u8 image, RANK_LIMIT (the limit the merged serving rows meet).  The
# two processes share one card, so their seconds are no two-card speed.
RANK_LIMIT = 1.5e-2
RANK_SD3_STEPS = 4
# requests a mode (else one): dp's second is a warm request
RANK_REQUESTS = {("sd1", "dp2"): 2}
RANK_NPROMPT = "blurry, low quality"
# model -> (mode, mesh options, weight type, batch)
RANK_MODES = {"sd1": [("tp2", {"tp": 2}, "bf16", 1),
                      ("dp2", {"dp": 2}, "bf16", 2),
                      ("sp2", {"sp": 2}, "bf16", 1)],
              "sd3": [("tp2", {"tp": 2}, "bf16", 1),
                      ("sp2", {"sp": 2}, "bf16", 1),
                      ("pp2", {"pp": 2}, "bf16", 1),
                      ("pp2", {"pp": 2}, "q8_0", 1)]}
# (model, mode) -> a rank's flash launches in one request, by (kernel, q
# shape): tp runs n_head / 2 heads, dp a CFG pair of one image and decodes
# the gathered pair, pp a microbatch of one row through 12 of the 24 blocks
# (2 microbatches a step); under sp every attention takes the ring
_K1, _K2, _K3 = "flash_attn_fwd", "flash_attn_fwd_wide", "flash_attn_joint"
RANK_FLASH = {
    ("sd1", "tp2"): {(_K1, (2, 4, 4096, 40)): 100,
                     (_K1, (2, 4, 1024, 80)): 100,
                     (_K2, (1, 1, 4096, 512)): 1},
    ("sd1", "dp2"): {(_K1, (2, 8, 4096, 40)): 100,
                     (_K1, (2, 8, 1024, 80)): 100,
                     (_K2, (2, 1, 4096, 512)): 1},
    ("sd1", "sp2"): {},
    ("sd3", "tp2"): {(_K3, (2, 12, 4250, 64)): 24 * RANK_SD3_STEPS,
                     (_K2, (1, 1, 16384, 512)): 1},
    ("sd3", "sp2"): {},
    ("sd3", "pp2"): {(_K3, (1, 24, 4250, 64)): 12 * 2 * RANK_SD3_STEPS,
                     (_K2, (1, 1, 16384, 512)): 1},
}
# model -> {wt: (batch -> the u8 image of the request on one rank)}
_RANK_REFS = collections.defaultdict(dict)


def _rank_opts(model: str, ckpt: str, wt: str, batch: int) -> list:
    seed, prompt = REQUESTS[0]
    return [("model", ckpt), ("model-type", model), ("weight-type", wt),
            ("image-dim", 512 if model == "sd1" else SD3_DIM),
            ("steps", 20 if model == "sd1" else RANK_SD3_STEPS),
            ("cfg-scale", 7.0), ("method", "euler"),
            ("scheduler", "uniform"), ("batch-size", batch), ("seed", seed),
            ("prompt", prompt), ("nprompt", RANK_NPROMPT)]


def _u8(img) -> np.ndarray:
    return np.rint(np.asarray(img) * 255.0).astype(np.uint8)


def rank_references(s, model: str, ckpt: str, wt: str, batches) -> None:
    """The rank modes' requests on the single-rank session ``s`` (of
    ``model`` and ``wt``), their u8 images kept, the first one made twice
    (``repeat_rel_l2``: one rank's own spread, beside which the ranks'
    differences read); the session's batch size and steps are put
    back."""
    for b in batches:
        for k, v in _rank_opts(model, ckpt, wt, b):
            s.option_set(k, v)
        t0 = time.time()
        img = _u8(s.generate())
        secs = time.time() - t0
        _RANK_REFS[(model, wt)][b] = img
        again = {}
        if b == batches[0]:
            s.option_set("seed", REQUESTS[0][0])
            rel, du8 = _rank_rel(_u8(s.generate()), img)
            again = {"repeat_rel_l2": rel, "repeat_max_u8_diff": du8}
        phase("ranks", model=model, path=wt, step="one_rank_reference",
              batch=b, seconds=secs, image_mean=float(img.mean()),
              image_std=float(img.std()), **again)
    s.option_set("batch-size", 1)
    s.option_set("steps", 20)


def _rank_rel(img, ref) -> tuple:
    """(relative L2, largest u8 difference) of ``img`` against ``ref``."""
    a, b = img.astype(np.float64), ref.astype(np.float64)
    return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            int(np.abs(a - b).max()))


def _module_bytes(m) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(m.parameters()) + list(m.buffers()))


def _rank_requests(rank: int, world: int, jobs):
    """A rank's side of ``ranks_path``: for each (model, checkpoint) of
    ``jobs``, each of its modes in a session of its own, its requests
    timed, their launches and the image kept."""
    if "jax" in sys.modules or any(m.startswith("mlimgsynth_tpu")
                                   for m in sys.modules):
        raise AssertionError("a rank loaded jax or the JAX package")
    _build.load_all(SOURCES)
    out = []
    for model, ckpt in jobs:
        out += [_rank_mode(model, ckpt, *m) for m in RANK_MODES[model]]
    return out


def _rank_mode(model: str, ckpt: str, name: str, mesh: dict, wt: str,
               batch: int) -> dict:
    """One mode of ``model`` on this rank (``_rank_requests``)."""
    s = api.MLImgSynth(device="cuda")
    for k, v in _rank_opts(model, ckpt, wt, batch) + list(mesh.items()):
        s.option_set(k, v)
    t0 = time.time()
    s.setup()
    setup_s = time.time() - t0
    denoiser = s._models[s._denoiser()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(RANK_REQUESTS.get((model, name), 1)):
        s.option_set("seed", REQUESTS[0][0])     # the same request
        fa.reset_counts()
        qmm.reset_counts()
        quant.PLAIN_CUDA_CALLS = 0
        t0 = time.time()
        img = s.generate()
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    line = {
        "model": model, "mode": name, "path": wt, "batch": batch,
        "transport": comm.transport(), "device": str(s.device),
        "setup_s": setup_s, "seconds": secs,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "denoiser_bytes": _module_bytes(denoiser),
        "launches": {k: v for k, v in _counts().items() if v},
        "shapes": collections.Counter(fa.LAUNCH_SHAPES),
        "plain_cuda_calls": fa.PLAIN_CUDA_CALLS + quant.PLAIN_CUDA_CALLS,
        "image": _u8(img)}
    _drop(s)
    return line


def _check_rank_line(line: dict, ref, what: str) -> dict:
    """One rank's mode against the one-rank image and the launches it
    must make; returns the checked line (without the image)."""
    img = line.pop("image")
    shapes = line.pop("shapes")
    rel, du8 = _rank_rel(img, ref)
    line.update(rel_l2=rel, max_u8_diff=du8, limit=RANK_LIMIT,
                image_mean=float(img.mean()), image_std=float(img.std()))
    want = RANK_FLASH[(line["model"], line["mode"])]
    if img.shape != ref.shape or rel > RANK_LIMIT or img.std() == 0:
        raise AssertionError(f"{what}: image {img.shape} at relative L2 "
                             f"{rel} of one rank's (limit {RANK_LIMIT})")
    if dict(shapes) != want or line["plain_cuda_calls"]:
        raise AssertionError(f"{what}: flash launches {dict(shapes)}, want "
                             f"{want}; plain calls on CUDA "
                             f"{line['plain_cuda_calls']}")
    if line["path"] == "q8_0" and not (
            line["launches"].get("q8_matmul_ws_int8")
            and line["launches"].get("q8_matmul_tile")):
        raise AssertionError(f"{what}: q8_0 kernels not launched: "
                             f"{line['launches']}")
    return line


def ranks_path(ckpts: dict) -> collections.Counter:
    """The rank modes of each model of ``ckpts`` (model -> checkpoint) on
    two ranks sharing the card: one spawn, each mode's line per rank; the
    images of the ranks equal."""
    jobs = list(ckpts.items())
    t0 = time.time()
    out = comm.spawn(_rank_requests, 2, (jobs,), device_type="cuda",
                     threads=0, timeout=900)
    modes = [(model, m) for model, _ in jobs for m in RANK_MODES[model]]
    launches = collections.Counter()
    for i, (model, (name, mesh, wt, batch)) in enumerate(modes):
        ref = _RANK_REFS[(model, wt)][batch]
        if not np.array_equal(out[0][i]["image"], out[1][i]["image"]):
            raise AssertionError(f"{model} {name} {wt}: the ranks' images "
                                 "differ")
        for r in range(2):
            line = _check_rank_line(out[r][i], ref,
                                    f"{model} {name} {wt} rank {r}")
            phase("ranks", rank=r, mesh=mesh, **line)
            launches.update(line["launches"])
    phase("ranks", step="spawn", models=list(ckpts),
          seconds=time.time() - t0)
    return launches


def ranks_cli(tmp: str, ckpt: str) -> collections.Counter:
    """``torchrun --standalone --nproc-per-node 2`` of the CLI's generate
    at SD1.5 tp 2 (this script's ``--cli-rank`` mode calls ``cli.main``
    in each rank and writes its report): rank 0's PNG against the
    one-rank image."""
    seed, prompt = REQUESTS[0]
    png = os.path.join(tmp, "ranks-cli.png")
    report = os.path.join(tmp, "ranks-cli")
    argv = ["generate", "-m", ckpt, "--tp", "2", "-d", "512", "-s", "20",
            "--method", "euler", "--cfg-scale", "7", "-S", str(seed),
            "-p", prompt, "-n", RANK_NPROMPT, "-o", png, "-q"]
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", os.path.abspath(__file__), "--cli-rank",
         report, *argv], capture_output=True, text=True, timeout=600)
    secs = time.time() - t0
    if r.returncode != 0:
        raise AssertionError(f"torchrun cli: exit {r.returncode}\n"
                             f"{r.stderr[-4000:]}")
    pix, _ = image_mod.png_read(png)
    ref = _RANK_REFS[("sd1", "bf16")][1][0].transpose(1, 2, 0)
    launches = collections.Counter()
    for rank in range(2):
        with open(f"{report}.{rank}.json") as f:
            line = json.load(f)
        shapes = {(k, tuple(q)): n for k, q, n in line.pop("shapes")}
        want = RANK_FLASH[("sd1", "tp2")]
        rel, du8 = _rank_rel(pix, ref)
        phase("ranks", model="sd1", mode="tp2", via="torchrun cli",
              rank=rank, **line, call_s=secs, rel_l2=rel, max_u8_diff=du8,
              limit=RANK_LIMIT)
        if (line["rc"] != 0 or shapes != want or rel > RANK_LIMIT
                or line["jax"]):
            raise AssertionError(f"torchrun cli rank {rank}: exit "
                                 f"{line['rc']}, launches {shapes}, relative"
                                 f" L2 {rel}")
        launches.update(line["launches"])
    if sorted(f for f in os.listdir(tmp) if f.startswith("ranks-cli")
              and f.endswith(".png")) != ["ranks-cli.png"]:
        raise AssertionError("torchrun cli: more than rank 0 wrote")
    return launches


def cli_rank(report: str, argv) -> int:
    """One torchrun rank of ``ranks_cli``: ``cli.main(argv)``, then its
    seconds, peak memory and launches to ``report.<rank>.json``."""
    rank = int(os.environ["RANK"])
    fa.reset_counts()
    qmm.reset_counts()
    t0 = time.time()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    line = {"rc": rc, "seconds": time.time() - t0,
            "transport": comm.backend_for(
                "cuda", int(os.environ["LOCAL_WORLD_SIZE"])),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": {k: v for k, v in _counts().items() if v},
            "shapes": [[k, list(q), n]
                       for (k, q), n in fa.LAUNCH_SHAPES.items()],
            "jax": "jax" in sys.modules}
    with open(f"{report}.{rank}.json", "w") as f:
        json.dump(line, f)
    return rc


def check_imports():
    """The port, its CLI, T5, Flux, the server and the C ABI included, ran
    without jax and without any module of the JAX package."""
    tpu = sorted(m for m in sys.modules if m.split(".")[0] == "mlimgsynth_tpu")
    ran_cli = "mlimgsynth_torch.cli" in sys.modules
    ran = {m: m in sys.modules for m in (
        "mlimgsynth_torch.models.flux", "mlimgsynth_torch.models.t5",
        "mlimgsynth_torch.models.controlnet",
        "mlimgsynth_torch.models.esrgan", "mlimgsynth_torch.server",
        "mlimgsynth_torch.capi")}
    phase("imports", jax="jax" in sys.modules, jax_package=tpu, cli=ran_cli,
          modules=ran)
    if "jax" in sys.modules or tpu or not ran_cli or not all(ran.values()):
        raise AssertionError(f"jax or JAX-package modules loaded: {tpu}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:     # a torchrun rank of ranks_cli
        sys.exit(cli_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
