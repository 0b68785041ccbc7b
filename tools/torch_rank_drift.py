#!/usr/bin/env python3
"""Where an SD1.5 request at tp = 2 departs from the same request on one
rank (needs a CUDA card; the two ranks share it over gloo, as
``chip_smoke.py``'s ``ranks`` lines run them):

    python3 tools/torch_rank_drift.py [--steps N] [WEIGHT_TYPE ...]

On a seeded random full-width SD1.5 checkpoint (numpy, seed 0: the one
``chip_smoke.py`` draws), the rank lines' request (512^2, Euler, uniform
schedule, CFG 7, seed 42, N steps, default 4) runs for each weight type
(default bf16, q8_0 and f32) in a session on one rank in this process,
then in a tp = 2 session on two spawned ranks.  The session refuses f32 on
a card (its attention kernels take bf16): for the f32 witness each process
lifts that refusal and sends f32 attention to the plain path
(``_allow_f32``).  Forward hooks on both
UNets keep the latent before each evaluation, the VAE decoder's input
(the latent after the last step) and, for the first evaluation, the output
of every UNet module in the order they ran (those of more than
``MAX_ELEMS`` elements left out); a column-parallel linear's rank 0 output
is held to its share of the one-rank output.  Prints one JSON line a
weight type: the relative L2 of rank 0's latent against one rank's before
each evaluation and after the last step, and of the u8 image; the first
module whose output differs at all, the first that differs anywhere by
more than one ulp of its type, and the modules that differ, in order,
with their largest departure in ulps (at the larger of the element's
magnitude and the output's RMS), the share of their elements that differ
and their relative L2.  Then the card's name and power limit.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mlimgsynth_torch import api, testing  # noqa: E402
from mlimgsynth_torch.ops import attention as tattn  # noqa: E402
from mlimgsynth_torch.parallel import comm  # noqa: E402
from mlimgsynth_torch.parallel import tensor_parallel as tpar  # noqa: E402

MAX_ELEMS = 4 << 20
SEED, PROMPT = 42, "a photograph of an astronaut riding a horse"
NPROMPT = "blurry, low quality"
# the mantissa bits of each type: one ulp of x is 2^(floor(log2 |x|) - bits)
MANTISSA = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}


def _opts(ckpt: str, wt: str, steps: int) -> list:
    return [("model", ckpt), ("model-type", "sd1"), ("weight-type", wt),
            ("image-dim", 512), ("steps", steps), ("cfg-scale", 7.0),
            ("method", "euler"), ("scheduler", "uniform"),
            ("batch-size", 1), ("seed", SEED), ("prompt", PROMPT),
            ("nprompt", NPROMPT)]


def _hooks(s):
    """Hooks on the session's UNet and VAE decoder: (record, handles).
    record["latents"]: the UNet's input x at each call and the decoder's
    input, f32 on the host; record["out"]: (module name, call) -> output
    of the first UNet call's modules, on the host; record["order"]: those
    keys in the order the modules returned."""
    unet, vae = s._models["unet."], s._models["vae."]
    rec = {"latents": [], "out": {}, "order": [], "done": False}
    calls = collections.Counter()

    def keep(name):
        def hook(mod, args, out):
            if rec["done"] or not isinstance(out, torch.Tensor) \
                    or not out.is_floating_point() or out.numel() > MAX_ELEMS:
                return
            key = (name, calls[name])
            calls[name] += 1
            rec["out"][key] = out.detach().to("cpu", copy=True)
            rec["order"].append(key)
        return hook

    def latent(mod, args):
        rec["latents"].append(args[0].detach().float().cpu())

    def done(mod, args, out):
        rec["done"] = True

    handles = [m.register_forward_hook(keep(n))
               for n, m in unet.named_modules() if n]
    handles += [unet.register_forward_pre_hook(latent),
                unet.register_forward_hook(done),
                vae.register_forward_pre_hook(latent)]
    return rec, handles


def _request(s) -> tuple:
    rec, handles = _hooks(s)
    try:
        img = s.generate()
    finally:
        for h in handles:
            h.remove()
    return rec, np.rint(np.asarray(img) * 255.0).astype(np.uint8)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _ulps(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """|a - b| in ulps of ``dtype`` at the larger of |b| and b's RMS (an
    element near zero, whose own ulp is tiny, is measured on the tensor's
    scale)."""
    a, b = a.float(), b.float()
    rms = b.square().mean().sqrt().clamp_min(2.0 ** -126)
    e = torch.floor(torch.log2(torch.maximum(b.abs(), rms)))
    return (a - b).abs() / torch.exp2(e - MANTISSA.get(dtype, 23))


def _share(ref: torch.Tensor, out: torch.Tensor, name: str):
    """The one-rank output ``ref`` cut to rank 0's share where ``out`` is a
    column-parallel linear's (the last dimension split over 2 ranks), or
    None where the two do not correspond."""
    if ref.shape == out.shape:
        return ref
    if ref.shape[:-1] != out.shape[:-1] or ref.shape[-1] != 2 * out.shape[-1]:
        return None
    parts = tpar._parts("unet." + name, ref.shape[-1], 0, True)
    return tpar._take(ref, ref.dim() - 1, parts, 2, 0)


def compare(ref: dict, rec: dict, img_ref, img) -> dict:
    """Rank 0's record against the one-rank record (module docstring)."""
    lat = [_rel(a, b) for a, b in zip(rec["latents"], ref["latents"])]
    a, b = img.astype(np.float64), img_ref.astype(np.float64)
    diffs, first_any, first_ulp, compared = [], None, None, 0
    for key in rec["order"]:
        r = ref["out"].get(key)
        o = rec["out"][key]
        r = None if r is None else _share(r, o, key[0])
        if r is None:
            continue
        compared += 1
        ne = (o != r)
        if not bool(ne.any()):
            continue
        u = float(_ulps(o, r, o.dtype).max())
        row = {"module": f"{key[0]}#{key[1]}", "dtype": str(o.dtype),
               "shape": list(o.shape), "max_ulps": u,
               "share_differing": float(ne.float().mean()),
               "rel_l2": _rel(o.float(), r.float())}
        first_any = first_any or row
        if first_ulp is None and u > 1.0:
            first_ulp = row
        diffs.append(row)
    return {"latent_rel_l2": lat[:-1], "final_latent_rel_l2": lat[-1],
            "image_rel_l2": float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            "image_max_u8_diff": int(np.abs(a - b).max()),
            "modules_compared": compared, "modules_differing": len(diffs),
            "first_differing": first_any, "first_past_one_ulp": first_ulp,
            "differing": diffs[:40]}


def _allow_f32() -> None:
    """In this process: no refusal of f32 on the card, and the flash gate
    passes bf16 only, so f32 attention takes the plain path."""
    api.MLImgSynth._card_dtype_check = lambda self: None
    gate = tattn.flash_attention_compatible
    if getattr(gate, "bf16_only", False):
        return

    def bf16_gate(q, k, v, causal=False):
        return q.dtype == torch.bfloat16 and gate(q, k, v, causal)
    bf16_gate.bf16_only = True
    tattn.flash_attention_compatible = bf16_gate


def _session(ckpt: str, wt: str, steps: int, mesh=()):
    if wt == "f32":
        _allow_f32()
    s = api.MLImgSynth(device="cuda")
    for k, v in _opts(ckpt, wt, steps) + list(mesh):
        s.option_set(k, v)
    s.setup()
    return s


def _rank(rank: int, world: int, ckpt: str, jobs: list):
    """A tp rank: each (weight type, steps, reference file) of ``jobs`` in a
    session of its own; rank 0 compares and returns the summaries."""
    res = []
    for wt, steps, ref_path in jobs:
        s = _session(ckpt, wt, steps, [("tp", 2)])
        rec, img = _request(s)
        del s
        torch.cuda.empty_cache()
        if rank == 0:
            ref = torch.load(ref_path, weights_only=False)
            res.append({"weight_type": wt, "steps": steps,
                        **compare(ref, rec, ref["image"], img)})
    return res


def drift(types, steps: int) -> list:
    """The summaries of :func:`compare`, one a weight type of ``types``."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sd1-random-f16.safetensors")
        testing.write_random_checkpoint(ckpt, api._model_types()["sd1"],
                                        seed=0)
        jobs = []
        for wt in types:
            s = _session(ckpt, wt, steps)
            rec, img = _request(s)
            del s
            torch.cuda.empty_cache()
            path = os.path.join(tmp, f"ref-{wt}.pt")
            torch.save({"latents": rec["latents"], "out": rec["out"],
                        "image": img}, path)
            del rec
            jobs.append((wt, steps, path))
        return comm.spawn(_rank, 2, (ckpt, jobs), device_type="cuda",
                          threads=0, timeout=1200)[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_rank_drift: needs a CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    steps = 4
    if args[:1] == ["--steps"]:
        steps, args = int(args[1]), args[2:]
    from mlimgsynth_torch.ops import _build
    _build.load_all(["flash_attention", "quant_matmul"])
    for row in drift(args or ["bf16", "q8_0", "f32"], steps):
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
