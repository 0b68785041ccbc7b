"""Command-line interface of the PyTorch port (port of
``mlimgsynth_tpu/cli.py``).

The same command and flag surface as the JAX package's CLI for the commands
the port has: ``generate``, ``tokenize``, ``help`` and ``version``.  Short
options, unknown long options forwarded to the session's option table
(``option_set_str``), ``-`` as stdout (PPM), progress on stderr, latent
input and output via ``--ilatent``/``--olatent`` and the PNG's
``parameters`` text; ``-i`` (PNG or binary PPM/PGM, ``-`` for stdin) for
img2img, its alpha or ``--imask`` (first channel) for inpainting,
``--lora`` / ``<lora:NAME:MULT>``, ``--embed-dir`` / ``<emb:NAME>``, prompt
editing, the T5 options ``--t5`` / ``--t5-tokenizer`` / ``--t5-tokens``
(SD3, SD3.5, Flux), and ``--clip`` / ``--vae`` for a model that ships as
components (Flux).  The other commands of the JAX CLI exit 1 and say so.

``-b``/``--backend`` picks the session's device before it is built: ``cuda``
(the default) or ``cpu``.  Without a card the default exits 1 with the
session's error; there is no silent CPU fallback.  Options the port does
not have (``--deepcache``, ...) exit 1 as unknown options.  The memory
options ``--vae-tile`` and ``--unet-split`` forward to the session.

    python -m mlimgsynth_torch.cli generate -m sd2.safetensors -d 768 \\
        -s 20 --method dpmpp2m -S 42 -p "..." -o out.png
    python -m mlimgsynth_torch.cli generate -m sd15.safetensors -i in.png \\
        --f-t-ini 0.6 --lora style.safetensors,0.8 -p "..." -o out.png
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

HELP = """mlimgsynth-torch v{version}
Image synthesis using AI, PyTorch/CUDA port.
Currently Stable Diffusion 1.5, 2.1 (768-v), XL-base, 3-medium, 3.5-large
and 3.5-medium, and Flux.1-schnell and -dev are implemented: txt2img,
img2img and inpainting, with LoRAs, textual-inversion embeddings, prompt
editing (UNet models), skip-layer guidance (SD3, SD3.5, Flux) and the
T5-XXL context of SD3, SD3.5 and Flux; images are encoded and decoded by
the VAE or the TAE (--tae).

Usage: python -m mlimgsynth_torch.cli [COMMAND] [OPTIONS]

Commands:
  generate             Generate an image.
  tokenize             Tokenize text (testing).
The JAX package's other commands (serve, list-backends, vae-encode,
vae-decode, vae-test, clip-encode, upscale, check) are not ported.

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

Models and backend:
  -m --model PATH      Model file (safetensors or GGUF).
  --model-type NAME    sd1, sd2, sdxl, sd3, sd35_large, sd35_medium,
                       flux_schnell, flux_dev (default: detected).
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
  -b --backend NAME    cuda (default) or cpu.
  --unet-split BOOL    Stage-wise weight residency to reduce memory usage.
  --vae-tile INT       Tiled VAE encode/decode with NxN pixel tiles.
  --weight-type NAME   Weight dtype (f32, f16/bf16, q8_0, q4_0, ...).
  --batch-size INT     Images per batch.

Sampling:
  -S --seed INT        RNG seed.
  -s --steps INT       Denoising steps (model evaluations: heun and dpm++2s
                       take two a step).
  --method NAME        euler, euler_a, heun, taylor3, dpm++2m, dpm++2s,
                       dpm++2s_a, dpm++2m_sde, unipc (default euler; an
                       _a suffix samples ancestrally).
  --scheduler NAME     uniform (default), karras, exponential, sgm_uniform,
                       beta.
  --s-noise FLOAT      Per-step noise injection (try 1).
  --s-ancestral FLOAT  Ancestral sampling noise level (try 1).
  --cfg-scale FLOAT    Classifier-free guidance scale (default 7); on
                       Flux-dev the embedded guidance value (no uncond
                       pass).
  --slg-scale FLOAT    Skip-layer guidance scale (SD3/SD3.5/Flux;
                       SD3.5-medium recommends 2.5-3; default 0 = off).
  --slg-layers LIST    Blocks left out in the SLG pass (default 7,8,9;
                       Flux: 0-18 double, 19-56 single blocks).
  --slg-start FLOAT    SLG window start, fraction of steps (default 0.01).
  --slg-end FLOAT      SLG window end, fraction of steps (default 0.2).
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
CLI_PATH_OPTS = ("input", "imask", "ilatent", "ilmask", "output", "olatent")
# the JAX CLI's commands the port does not have
NOT_PORTED = ("serve", "list-backends", "vae-encode", "vae-decode",
              "vae-test", "clip-encode", "upscale", "check")
_DEVICES = {"": "cuda", "cuda": "cuda", "cpu": "cpu"}


class CliState:
    def __init__(self):
        self.cmd: Optional[str] = None
        self.paths = {k: None for k in CLI_PATH_OPTS}
        self.opts: List = []
        self.done = False
        self.verbosity = 0


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


def _save_image(img_u8, infotext: Optional[str], path: str) -> None:
    from .utils import image as image_mod
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
    session.generate()
    if state.paths["olatent"]:
        image_mod.tensor_save(state.paths["olatent"],
                              session.tensors["latent"])
    img = session.tensors["image"]
    if state.paths["output"] and img is not None:     # not with --no-decode
        for idx in range(img.shape[0]):
            path = state.paths["output"]
            if img.shape[0] > 1 and path != "-":
                stem, ext = os.path.splitext(path)
                path = f"{stem}-{idx}{ext}"
            _save_image(image_mod.tensor_to_image_arr(img, idx),
                        session.infotext, path)
    return 0


def cmd_tokenize(session, state: CliState) -> int:
    toks = session.text_tokenize(session.c["prompt_raw"])
    print(" ".join(str(t) for t in toks))
    return 0


COMMANDS = {"generate": cmd_generate, "tokenize": cmd_tokenize}


def main(argv: Optional[List[str]] = None) -> int:
    from . import __version__
    from .api import Aborted, MLImgSynth, MlisError
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
    if state.cmd in NOT_PORTED:
        print(f"Command '{state.cmd}' is not ported to the PyTorch port",
              file=sys.stderr)
        return 1
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
