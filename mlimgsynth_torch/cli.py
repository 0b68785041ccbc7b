"""Command-line interface of the PyTorch port (port of
``mlimgsynth_tpu/cli.py``).

The same command and flag surface as the JAX package's CLI: ``generate``,
``serve`` (the HTTP server, ``--port``, ``--model-dir``),
``list-backends``, ``vae-encode``, ``vae-decode``, ``vae-test``,
``clip-encode``, ``tokenize``, ``upscale``, ``check``, ``help`` and
``version``.  Short
options, unknown long options forwarded to the session's option table
(``option_set_str``), ``-`` as stdout (PPM), progress on stderr, latent
input and output via ``--ilatent``/``--olatent`` and the PNG's
``parameters`` text; ``-i`` (PNG or binary PPM/PGM, ``-`` for stdin) for
img2img, its alpha or ``--imask`` (first channel) for inpainting,
``--lora`` / ``<lora:NAME:MULT>``, ``--embed-dir`` / ``<emb:NAME>``, prompt
editing, the T5 options ``--t5`` / ``--t5-tokenizer`` / ``--t5-tokens``
(SD3, SD3.5, Flux), ``--clip`` / ``--vae`` for a model that ships as
components (Flux), ``--control-image`` for ControlNet, and the ``upscale``
command's ``--upscale-factor`` and ``--upscale-tile``.

``-b``/``--backend`` picks the session's device before it is built: ``cuda``
(the default) or ``cpu``.  Without a card the default exits 1 with the
session's error; there is no silent CPU fallback.  ``-t``/``--threads`` is
accepted and stored.

``--tp``, ``--dp``, ``--sp`` and ``--pp`` run every command on several
ranks, one process each, launched by torchrun (every rank runs the same
command; rank 0 alone writes files and prints; ``serve`` binds its port on
rank 0, and the other ranks follow its batches, ``server.Server.follow``)::

    torchrun --nproc-per-node 2 -m mlimgsynth_torch.cli generate --tp 2 \
        -m sd15.safetensors -p "..." -o out.png
    torchrun --nproc-per-node 2 -m mlimgsynth_torch.cli serve --tp 2 \
        -m sd15.safetensors --port 8188

Without a process group of that many ranks every command exits 1 naming
the torchrun line.

The memory options ``--vae-tile`` and ``--unet-split``, the sampler and
guidance options (``--cfg-rescale``, ``--subseed``, ``--method lcm``,
``--freeu``, ``--pag-*``, ``--deepcache``, ``--tiling``) and the second
stage and control options (``--mask-blur``, ``--inpaint-full-res[-padding]``,
``--control-net``, ``--control-strength``, ``--upscaler``, ``--hires-*``,
``--refiner``, ``--refiner-switch``) forward to the session.

    python -m mlimgsynth_torch.cli generate -m sd2.safetensors -d 768 \\
        -s 20 --method dpmpp2m -S 42 -p "..." -o out.png
    python -m mlimgsynth_torch.cli generate -m sd15.safetensors -i in.png \\
        --f-t-ini 0.6 --lora style.safetensors,0.8 -p "..." -o out.png
    python -m mlimgsynth_torch.cli upscale --upscaler x4.pth -i in.png \\
        --upscale-tile 256 -o out.png
    python -m mlimgsynth_torch.cli serve -m sd15.safetensors --port 8188
"""
from __future__ import annotations

import contextlib
import io
import os
import sys
import time
from typing import List, Optional

import numpy as np

HELP = """mlimgsynth-torch v{version}
Image synthesis using AI, PyTorch/CUDA port.
Currently Stable Diffusion 1.5, 2.1 (768-v), XL-base, 3-medium, 3.5-large
and 3.5-medium, and Flux.1-schnell and -dev are implemented: txt2img,
img2img and inpainting (with mask blur, at full resolution, and
inpaint-variant UNets), with LoRAs, textual-inversion embeddings, prompt
editing (UNet models), ControlNet (SD UNets), skip-layer guidance (SD3,
SD3.5, Flux), perturbed-attention guidance and FreeU (UNet models), CFG
rescale, seed variations, DeepCache, seamless tiling, the hires fix, the
SDXL refiner (alone or as the second stage of SDXL), ESRGAN upscaling and
the T5-XXL context of SD3, SD3.5 and Flux; images are encoded and decoded
by the VAE or the TAE (--tae).

Usage: python -m mlimgsynth_torch.cli [COMMAND] [OPTIONS]

Commands:
  generate             Generate an image.
  serve                Run an HTTP image-generation server (--port 8188,
                       --model-dir DIR).
  list-backends        List the devices (CUDA cards, or the CPU).
  vae-encode           Encode an image to a latent.
  vae-decode           Decode a latent to an image.
  vae-test             Encode and decode an image.
  clip-encode          Encode a prompt with the CLIP tokenizer and model.
  tokenize             Tokenize text (testing).
  upscale              Upscale an image with an ESRGAN model (--upscaler).
  check                Check that all operations (models) are working.

Generation options:
  -p --prompt TEXT     Prompt for text conditioning.
  -n --nprompt TEXT    Negative prompt.
  -d --image-dim W,H   Image dimensions. Default: 512 (SD1), 768 (SD2),
                       1024 (SDXL, SD3, SD3.5, Flux).
  -i --input PATH      Input image for img2img or inpainting (PNG or
                       binary PPM/PGM; - for stdin). Its alpha channel,
                       where it has one, is the inpainting mask.
  --imask PATH         Input image mask for inpainting (first channel;
                       white keeps, black repaints).
  --mask-blur R        Gaussian-blur the inpainting mask (A1111 seam
                       softening; default 0).
  --inpaint-full-res B Crop-around-mask inpainting: process the padded
                       mask region at the full image size, paste back
                       (--inpaint-full-res-padding N, default 32).
  -o --output PATH     Output image path (.png or .ppm; - for stdout as
                       PPM). A batch writes PATH-IDX.EXT.
  --ilatent PATH       Input latent tensor.
  --ilmask PATH        Input latent mask tensor.
  --olatent PATH       Output latent tensor path.
  --no-decode BOOL     Skip the decode: the latent is the result (for
                       --olatent; no image is written).
  --no-prompt-parse B  Use the prompt as raw text (no emphasis, tag or
                       editing parsing). Prompts support A1111 emphasis
                       ((x:1.5), [x]), <lora:NAME:MULT>, <emb:NAME>, and
                       prompt editing ([from:to:when], [add:when],
                       [gone::when], [a|b]; not on SD3, SD3.5, Flux).
  --f-t-ini FLOAT      Initial time factor (img2img strength; default 1).
  --f-t-end FLOAT      End time factor (default 0).
  --subseed N          Variation seed (with --subseed-strength F: the
                       initial noise slerps toward this stream; default
                       seed + 2^31).
  --tiling B           Seamless tiling: circular conv padding in the
                       denoiser and the VAE, the output wraps without seams
                       (textures).
  --deepcache N        DeepCache-style model caching: refresh the deep
                       part every N steps, reuse it in between.  UNets
                       cache the deep levels and the mid transformer;
                       SD3/SD3.5/Flux cache the deep block tail.  1-eval
                       solvers only (euler, dpm++2m[_sde], taylor3, unipc).

Models and backend:
  -m --model PATH      Model file (safetensors or GGUF).
  --model-type NAME    sd1, sd2, sdxl, sdxl_refiner, sd3, sd35_large,
                       sd35_medium, flux_schnell, flux_dev (default:
                       detected; an inpaint-variant UNet by its input
                       width).
  --clip PATH          CLIP-L text tower file (HF text_model.* names), for
                       a model that ships without one (Flux).
  --vae PATH           VAE file (bare encoder./decoder. names), for a
                       model that ships without one (Flux: ae.safetensors).
  --tae PATH           TAE model file. Enables TAE instead of VAE.
  --aux-dir PATH       Directory searched for a relative --tae or LoRA
                       path.
  --lora PATH,MULT     Apply a LoRA (multiplier optional; repeatable).
                       <lora:NAME:MULT> in a prompt applies NAME for one
                       request.
  --lora-dir PATH      Directory searched for <lora:NAME:MULT> prompt tags.
  --embed-dir PATH     Directory searched for <emb:NAME> textual-inversion
                       embeddings (NAME.safetensors or NAME.pt).
  --t5 PATH            SD3/SD3.5/Flux: T5-XXL encoder weights (a T5 file;
                       a model file that bundles text_encoders.t5xxl.*
                       needs none).
  --t5-tokenizer PATH  SD3/SD3.5/Flux: the T5 tokenizer.json; without it
                       the T5 context is zero rows.
  --t5-tokens INT      SD3/SD3.5/Flux: T5 context tokens (default 77).
  --control-net PATH   ControlNet model file (control_model.* / diffusers).
  --control-image PATH Hint image (edge/pose/depth map; output-sized).
  --control-strength F ControlNet residual strength (default 1).
  --upscaler PATH      ESRGAN/RRDBNet/SRVGG upscaler model (.safetensors
                       or .pth); used by the upscale command and the
                       image-space hires fix (--hires-upscaler NAME).
  --upscale-factor F   upscale command: final scale factor (default: the
                       model's own factor, usually 4).
  --upscale-tile N     upscale command: bound a pass's memory by tiling
                       the input at N px (0 = whole image).
  --refiner PATH       Ensemble refiner model: the base model stops at the
                       switch point and this model (e.g. the SDXL refiner)
                       finishes from the same noise level.
  --refiner-switch F   Fraction of the denoising done by the base model
                       before the refiner takes over (default 0.8).
  --hires-fix F        Two-stage hires fix: upscale factor (>1 enables;
                       the first pass at --image-dim).
  --hires-denoise F    Hires second-pass strength (default 0.7).
  --hires-steps INT    Hires second-pass steps (0 = same as --steps).
  --hires-upscaler N   Hires upscale in image space with --upscaler (any
                       name but "latent"; default: the latent, bilinear).
  -b --backend NAME    cuda (default) or cpu.
  -t --threads INT     Host thread count (accepted for compatibility).
  --unet-split BOOL    Stage-wise weight residency to reduce memory usage.
  --vae-tile INT       Tiled VAE encode/decode with NxN pixel tiles.
  --weight-type NAME   Weight dtype (f32, f16/bf16, q8_0, q4_0, ...).
  --batch-size INT     Images per batch.
  --dp INT             Data-parallel ranks: splits the batch over the ranks
                       (batch-size a multiple of it, else replicated).
  --tp INT             Tensor-parallel ranks: Megatron-style split of the
                       UNet/DiT (and T5) attention/FF matmuls over the
                       ranks (every weight type; a quantized weight is
                       split by whole 128-blocks, or kept whole).
  --sp INT             Sequence-parallel ranks: splits the attention token
                       axis over the ranks (ring attention; for the
                       long-sequence DiT families).
  --pp INT             Pipeline-parallel stages: cuts the MMDiT or Flux
                       block stacks into stages with microbatches streamed
                       between the ranks (each stage holds 1/pp of the
                       block weights; alone, not with tp/dp/sp).
                       Ranks are processes: launch any command with
                       torchrun --nproc-per-node tp*dp*sp*pp (rank 0
                       writes, prints and, for serve, binds the port);
                       ranks sharing one card (or on the CPU) talk over
                       gloo, one card a rank over NCCL.

Sampling:
  -S --seed INT        RNG seed.
  -s --steps INT       Denoising steps (model evaluations: heun and dpm++2s
                       take two a step).
  --method NAME        euler, euler_a, heun, taylor3, dpm++2m, dpm++2s,
                       dpm++2s_a, dpm++2m_sde, lcm, unipc (default euler;
                       an _a suffix samples ancestrally; lcm is consistency
                       sampling for LCM/LCM-LoRA UNet models).
  --scheduler NAME     uniform (default), karras, exponential, sgm_uniform,
                       beta, lcm (implied by --method lcm).
  --s-noise FLOAT      Per-step noise injection (try 1).
  --s-ancestral FLOAT  Ancestral sampling noise level (try 1).
  --cfg-scale FLOAT    Classifier-free guidance scale (default 7); on
                       Flux-dev the embedded guidance value (no uncond
                       pass).
  --cfg-rescale FLOAT  CFG std-rescale phi in [0,1] (Lin et al. 2023;
                       counters v-pred over-exposure, try 0.7; default 0).
  --freeu VAL          FreeU backbone/skip reweighting: y = per-family
                       defaults, or explicit B1,B2,S1,S2 (UNet models).
  --slg-scale FLOAT    Skip-layer guidance scale (SD3/SD3.5/Flux;
                       SD3.5-medium recommends 2.5-3; default 0 = off).
  --slg-layers LIST    Blocks left out in the SLG pass (default 7,8,9;
                       Flux: 0-18 double, 19-56 single blocks).
  --slg-start FLOAT    SLG window start, fraction of steps (default 0.01).
  --slg-end FLOAT      SLG window end, fraction of steps (default 0.2).
  --pag-scale FLOAT    Perturbed-attention guidance scale (UNet models;
                       try 3; extra eval with identity mid self-attention).
  --pag-start FLOAT    PAG window start, fraction of steps (default 0).
  --pag-end FLOAT      PAG window end, fraction of steps (default 1).
  --clip-skip INT      CLIP layers to skip. Default: 1 (SD1, Flux), 2
                       (SD2/XL/3/3.5).

Output control:
  -v --verbose         More information output (repeatable).
  -q --quiet           Output only errors.
  --silent             No terminal output.
  --debug              Debug output.
  -h --help            Print this message and exit.
  -V --version         Print the version and exit.
"""

SHORT_OPTS = {
    "h": "help", "V": "version", "v": "verbose", "q": "quiet",
    "b": "backend", "m": "model", "p": "prompt", "n": "nprompt",
    "d": "image-dim", "s": "steps", "S": "seed", "t": "threads",
    "i": "input", "o": "output",
}

# long options handled by the CLI itself; everything else forwards to the
# session's option table
CLI_PATH_OPTS = ("input", "imask", "ilatent", "ilmask", "output", "olatent",
                 "port", "control-image", "upscale-factor", "upscale-tile",
                 "model-dir")
_DEVICES = {"": "cuda", "cuda": "cuda", "cpu": "cpu"}


class CliState:
    def __init__(self):
        self.cmd: Optional[str] = None
        self.paths = {k: None for k in CLI_PATH_OPTS}
        self.opts: List = []
        self.done = False
        self.verbosity = 0
        # False on a rank other than 0: the command writes no file
        self.writes = True


def parse_args(argv: List[str]) -> CliState:
    """The JAX CLI's parser (``mlimgsynth_tpu/cli.py:193-243``)."""
    st = CliState()
    i = 0
    n = len(argv)

    def handle(name: str) -> bool:
        """Returns True if the next argv element was consumed as a value."""
        nxt = argv[i + 1] if i + 1 < n else ""
        if name in ("help", "version"):
            st.cmd = name
            st.done = True
        elif name == "verbose":
            st.verbosity += 1
        elif name == "quiet":
            st.verbosity = -1
        elif name == "silent":
            st.verbosity = -2
        elif name == "debug":
            st.verbosity = 2
        elif name in CLI_PATH_OPTS:
            st.paths[name] = nxt
            return True
        else:
            st.opts.append((name, nxt))
            return True
        return False

    while i < n:
        arg = argv[i]
        if arg.startswith("--"):
            if handle(arg[2:]):
                i += 1
        elif arg.startswith("-") and len(arg) > 1:
            for ch in arg[1:]:
                name = SHORT_OPTS.get(ch)
                if name is None:
                    raise SystemExit(f"Unknown short option '{ch}'")
                if handle(name):
                    i += 1
        elif st.cmd is None:
            st.cmd = arg
        else:
            raise SystemExit("Excess of positional arguments")
        if st.done:
            break
        i += 1
    return st


def _load_image(path: str):
    """An input image file as uint8 [h, w, c]; ``-`` reads it from stdin."""
    from .utils import image as image_mod
    if path == "-":
        return image_mod.image_load_bytes(sys.stdin.buffer.read(), "stdin")
    return image_mod.image_load(path)


def _load_tensor(path: str):
    from .api import MlisError
    from .utils import image as image_mod
    if not os.path.isfile(path):
        raise MlisError(MlisError.E_FILE_NOT_FOUND,
                        f"tensor file not found '{path}'")
    try:
        return image_mod.tensor_load(path)
    except ValueError as e:
        raise MlisError(MlisError.E_IMAGE, f"{path}: {e}")


def _save_tensor(state: CliState, path: str, t) -> None:
    from .utils import image as image_mod
    if state.writes:
        image_mod.tensor_save(path, t)


def _save_image(state: CliState, img_u8, infotext: Optional[str],
                path: str) -> None:
    from .utils import image as image_mod
    if not state.writes:
        return
    if path == "-":
        sys.stdout.buffer.write(image_mod.ppm_bytes(img_u8))
        sys.stdout.buffer.flush()
        return
    image_mod.image_save(path, img_u8, infotext)


def _progress_printer():
    from .api import STAGE_DENOISE, STAGE_NAMES
    from .utils.log import g_logger as log

    def cb(session, prg):
        if log.check(30):
            line = (f"{STAGE_NAMES[prg['stage']]} {prg['step']}/"
                    f"{prg['step_end']} {{{prg['step_time']:.3f}s}}")
            if prg["stage"] == STAGE_DENOISE:
                line += f" nfe:{prg['nfe']}"
            if 1 < prg["step"] < prg["step_end"]:
                etc = (prg["step_end"] - prg["step"]) * prg["step_time"]
                line += f" etc:{etc:.0f}s"
            sys.stderr.write(line + "\n")
        return 0

    return cb


def cmd_generate(session, state: CliState) -> int:
    """The inputs (``mlimgsynth_tpu/cli.py:269-287``), the request, the
    outputs."""
    from .api import TUF_LATENT, TUF_LMASK
    from .utils import image as image_mod
    paths = state.paths
    if paths["input"]:
        session.option_set("image", _load_image(paths["input"]))
    if paths["imask"]:
        m = _load_image(paths["imask"])
        session.option_set("image_mask",
                           image_mod.tensor_from_image_arr(m)[:, :1])
    if paths["ilatent"]:
        session.tensors["latent"] = _load_tensor(paths["ilatent"])
        session.c["tuflags"] |= TUF_LATENT
    if paths["ilmask"]:
        session.tensors["lmask"] = _load_tensor(paths["ilmask"])
        session.c["tuflags"] |= TUF_LMASK
    if paths["control-image"]:
        session.option_set("control_image",
                           _load_image(paths["control-image"]))
    session.generate()
    if state.paths["olatent"]:
        _save_tensor(state, state.paths["olatent"],
                     session.tensors["latent"])
    img = session.tensors["image"]
    if state.paths["output"] and img is not None:     # not with --no-decode
        for idx in range(img.shape[0]):
            path = state.paths["output"]
            if img.shape[0] > 1 and path != "-":
                stem, ext = os.path.splitext(path)
                path = f"{stem}-{idx}{ext}"
            _save_image(state, image_mod.tensor_to_image_arr(img, idx),
                        session.infotext, path)
    return 0


def cmd_upscale(session, state: CliState) -> int:
    """The input image (its first three channels) upscaled by the
    ``--upscaler`` model, at ``--upscale-factor`` (default: the model's)
    and in tiles of ``--upscale-tile`` pixels (``mlimgsynth_tpu/cli.py:
    343-358``)."""
    from .api import MlisError
    from .utils import image as image_mod
    paths = state.paths
    if not paths["input"]:
        raise MlisError(MlisError.E_FILE_NOT_FOUND,
                        "You must set the input image path.")
    if not paths["output"]:
        raise MlisError(MlisError.E_FILE_NOT_FOUND,
                        "You must set the output image path.")
    t = image_mod.tensor_from_image_arr(_load_image(paths["input"]))[:, :3]
    try:
        factor = (float(paths["upscale-factor"])
                  if paths["upscale-factor"] else None)
        tile = int(paths["upscale-tile"]) if paths["upscale-tile"] else 0
    except ValueError as e:
        raise MlisError(MlisError.E_OPT_VALUE, str(e))
    out = session.upscale(t, resize=factor, tile=tile)
    _save_image(state, image_mod.tensor_to_image_arr(out), None,
                paths["output"])
    return 0


def cmd_vae(session, state: CliState, encode: bool, decode: bool) -> int:
    """``vae-encode``, ``vae-decode`` and ``vae-test``
    (``mlimgsynth_tpu/cli.py:310-340``): the input image (its first three
    channels) to a latent (``--olatent``), a latent (``--ilatent``) to an
    image (``-o``), or both, with the round trip's error on stderr."""
    from .api import MlisError
    from .utils import image as image_mod
    orig = None
    if encode:
        if not state.paths["input"]:
            raise MlisError(MlisError.E_FILE_NOT_FOUND,
                            "You must set the input image path.")
        t = image_mod.tensor_from_image_arr(
            _load_image(state.paths["input"]))[:, :3]
        orig = t.copy()
        latent = session.image_encode(t)
        session.tensors["latent"] = latent
        if state.paths["olatent"]:
            _save_tensor(state, state.paths["olatent"], latent)
    else:
        if not state.paths["ilatent"]:
            raise MlisError(MlisError.E_FILE_NOT_FOUND,
                            "You must set the input latent path.")
        session.tensors["latent"] = _load_tensor(state.paths["ilatent"])
    if decode:
        img_t = session.image_decode(session.tensors["latent"])
        session.tensors["image"] = img_t
        if state.paths["output"]:
            _save_image(state, image_mod.tensor_to_image_arr(img_t), None,
                        state.paths["output"])
    if encode and decode and state.writes:
        rmse = float(np.sqrt(np.mean((orig - session.tensors["image"])
                                     ** 2)))
        psnr = 20 * np.log10(1.0 / rmse) if rmse > 0 else float("inf")
        sys.stderr.write(f"Image encode/decode mse: {rmse:.3f} "
                         f"(PSNR {psnr:.1f} dB)\n")
    return 0


def cmd_clip_encode(session, state: CliState) -> int:
    """The prompt through the first text tower: ``clip-embed.tensor`` and,
    where the tower has a projection, ``clip-feat.tensor`` in the working
    directory (``mlimgsynth_tpu/cli.py:360-376``)."""
    from .utils import image as image_mod
    text = session.c["prompt_raw"]
    has_proj = True
    try:
        embed, feat = session.clip_text_encode(text, want_feat=True)
    except KeyError:
        has_proj = False
        embed, feat = session.clip_text_encode(text, want_feat=False)
    _save_tensor(state, "clip-embed.tensor",
                 embed[:, :, :, None].transpose(0, 3, 1, 2))
    if has_proj and feat is not None:
        _save_tensor(state, "clip-feat.tensor",
                     feat[:, :, None, None].transpose(0, 2, 3, 1))
    return 0


def cmd_tokenize(session, state: CliState) -> int:
    toks = session.text_tokenize(session.c["prompt_raw"])
    print(" ".join(str(t) for t in toks))
    return 0


def cmd_check(session, state: CliState) -> int:
    """Small computations through every op family on the session's
    device, then, with a model set, each module once on tiny inputs
    (``mlimgsynth_tpu/cli.py:383-453``)."""
    import torch

    from .ops.attention import attention
    from .rng import philox_randn
    from .tokenizer import tokenize

    dev, checks = session.device, []

    def check(name, fn):
        t0 = time.time()
        try:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            checks.append((name, True, time.time() - t0))
        except Exception as e:  # noqa
            checks.append((name, False, time.time() - t0))
            print(f"  {name}: FAIL ({e})")

    def ones(*shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device=dev)

    check("matmul", lambda: ones(128, 128, dtype=torch.bfloat16)
          @ ones(128, 128, dtype=torch.bfloat16))
    check("conv2d", lambda: torch.nn.functional.conv2d(
        ones(1, 8, 16, 16), ones(8, 8, 3, 3), padding=1))
    check("attention", lambda: attention(
        ones(1, 2, 64, 64), ones(1, 2, 64, 64), ones(1, 2, 64, 64)))
    check("groupnorm", lambda: torch.nn.functional.group_norm(
        ones(1, 32, 4, 4), 32, ones(32), torch.zeros(32, device=dev)))
    check("philox", lambda: philox_randn(0, 0, 1000))
    check("tokenizer", lambda: tokenize("check"))

    if session.c["model"]:
        def check_clip():
            emb, _ = session.clip_text_encode("check")
            assert np.isfinite(emb).all()

        def check_vae():
            lat = session.image_encode(
                np.full((1, 3, 64, 64), 0.5, np.float32), sample=False)
            assert np.isfinite(session.image_decode(lat)).all()

        def check_unet():
            session.option_set("steps", 1)
            session.option_set("no-decode", True)
            session.option_set("image-dim", 64)
            session.option_set("prompt", "check")
            assert np.isfinite(session.generate()).all()
            session.option_set("no-decode", False)

        check("model:clip", check_clip)
        check("model:vae", check_vae)
        check("model:unet", check_unet)
    ok = all(c[1] for c in checks)
    for name, good, dt in checks:
        print(f"  {name:12s} {'OK' if good else 'FAIL'} {{{dt:.3f}s}}")
    print("CHECK OK" if ok else "CHECK FAILED")
    return 0 if ok else 1


def cmd_list_backends(session, state: CliState) -> int:
    info = session.backend_info()
    print(info["name"])
    for d in info["devs"]:
        line = f"\t{d['name']} '{d['desc']}'"
        if d.get("mem_total"):
            gib = 1 / (1024 ** 3)
            line += (f" {d.get('mem_free', 0) * gib:.1f}"
                     f"/{d['mem_total'] * gib:.1f}GiB")
        print(line)
    return 0


def cmd_serve(session, state: CliState) -> int:
    from .server import serve
    serve(session, port=int(state.paths["port"] or 8188),
          model_dir=state.paths["model-dir"] or "")
    return 0


COMMANDS = {"generate": cmd_generate, "serve": cmd_serve,
            "list-backends": cmd_list_backends,
            "vae-encode": lambda s, st: cmd_vae(s, st, True, False),
            "vae-decode": lambda s, st: cmd_vae(s, st, False, True),
            "vae-test": lambda s, st: cmd_vae(s, st, True, True),
            "clip-encode": cmd_clip_encode, "tokenize": cmd_tokenize,
            "upscale": cmd_upscale, "check": cmd_check}


def main(argv: Optional[List[str]] = None) -> int:
    from . import __version__
    from .utils.log import g_logger as log

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        state = parse_args(argv)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    if state.cmd == "help":
        print(HELP.format(version=__version__))
        return 0
    if state.cmd == "version":
        print(f"mlimgsynth-torch v{__version__}")
        return 0
    if state.cmd is None:
        print("No command. Use -h for help.")
        return 0
    if state.cmd not in COMMANDS:
        print(f"Unknown command '{state.cmd}'", file=sys.stderr)
        return 1

    if state.verbosity == -2:
        log.level = 0
    elif state.verbosity == -1:
        log.level = 10
    elif state.verbosity == 2:
        log.level = 50
    elif state.verbosity > 0:
        log.level = 30 + 10 * state.verbosity

    # the backend picks the device the session is built on
    backend, opts = "", []
    for name, value in state.opts:
        if name == "backend":
            backend = value.strip().lower()
        else:
            opts.append((name, value))
    if backend not in _DEVICES:
        print(f"unknown backend '{backend}' (have: cuda, cpu)",
              file=sys.stderr)
        return 1
    ranks = _mesh_ranks(opts)
    from .parallel import comm
    # the ranks' group from torchrun's environment, where none is up yet
    started = (ranks > 1 and comm.world_size() == 1
               and comm.init(_DEVICES[backend]))
    if ranks > 1 and comm.world_size() != ranks:
        print(f"error: --tp/--dp/--sp/--pp ask for {ranks} ranks, have "
              f"{comm.world_size()}: launch with `torchrun --nproc-per-node "
              f"{ranks} -m mlimgsynth_torch.cli {state.cmd} ...`",
              file=sys.stderr)
        if started:
            comm.shutdown()
        return 1
    # every rank runs the command; rank 0 alone writes and prints (its
    # errors every rank prints)
    state.writes = comm.rank() == 0
    quiet = contextlib.nullcontext()
    if not state.writes:
        state.verbosity = -2
        log.level = 0
        quiet = contextlib.redirect_stdout(io.StringIO())
    try:
        with quiet:
            return _run(state, opts, backend)
    finally:
        if started:
            comm.shutdown()


def _mesh_ranks(opts) -> int:
    """The rank count that ``--tp/--dp/--sp/--pp`` ask for."""
    n = 1
    for name, value in opts:
        if name.replace("-", "_") in ("tp", "dp", "sp", "pp"):
            try:
                n *= max(1, int(value))
            except ValueError:
                pass
    return n


def _run(state: CliState, opts, backend: str) -> int:
    """The session and the command (:func:`main`)."""
    from .api import Aborted, MLImgSynth, MlisError
    try:
        session = MLImgSynth(device=_DEVICES[backend])
    except MlisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        # a relative --tae is also looked up beside the launcher, as the
        # JAX CLI seeds its aux dir; an explicit --aux-dir overrides it
        session.option_set_str("aux-dir", os.path.dirname(
            os.path.abspath(sys.argv[0] or ".")))
        for name, value in opts:
            session.option_set_str(name, value)
    except MlisError as e:
        print(f"failed to set option: {e}", file=sys.stderr)
        return 1
    if state.verbosity >= 0:
        session.option_set("callback", _progress_printer())
    try:
        return COMMANDS[state.cmd](session, state) or 0
    except MlisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Aborted:
        return 130


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # stdout reader closed early: exit quietly, as under SIGPIPE
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(141)
