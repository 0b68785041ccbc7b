#!/usr/bin/env python3
"""Where the time of one request goes on the card (needs a GPU).

Opens a full-width session of the PyTorch port on seeded random weights
(bf16 activations; 20 Euler steps, CFG 7, batch 1): SD1.5 at 512^2, with
``--model sdxl`` SDXL-base or ``--model sd3`` SD3-medium at 1024^2, or with
``--model sd2`` SD2.1-768-v at 768^2 (20 DPM++2M steps; ``--tae`` decodes
with a seeded random full-width taesd decoder instead of the VAE), or
with ``--model sd35_large|sd35_medium|flux_dev|flux_schnell`` those at
1024^2 as ``chip_smoke.py``'s ``sd35`` and ``flux`` lines run them (files
drawn on the card, Flux as component files; a random T5-XXL file and
tokenizer at 77 T5 tokens for SD3.5, 512 for Flux-dev and 256 for
schnell; Flux-dev at guidance 3.5 without CFG, schnell 4 steps at cfg 1),
for each weight type named on the command line (default bf16; q8_0 and
q4_0 store the linears quantized, on every model type, the weights read to
the card and quantized there; ``q8_0:int8`` measures q8_0 under
``MLIS_Q8_MODE=int8``, in the same session as a ``q8_0`` named just
before it), one session at a time (the one before freed first), and
measures, all in this one process:

  * ``requests``: the wall seconds of a cold and of three warm requests;
  * ``stages``: one request split into text encode, sampler loop and VAE
    (or TAE) decode, with a device sync at the end of each;
  * ``denoiser_step``: 20 evaluations of the denoiser on the first
    evaluation's inputs of a request (the CFG batch of 2; Flux-dev and
    schnell at cfg 1 a batch of 1) back to back, by CUDA events;
  * ``trace``: one request traced with ``torch.profiler`` (device activity
    only): device busy time (the union of kernel, copy and fill intervals),
    kernel count, the idle share of that traced request's wall time, and
    device time by kind of kernel and the 20 kernels that took longest;
  * ``derived``: the trace's busy time against the median warm request
    above: two different requests of this run, for an idle share without
    the profiler's cost on the host.

    python3 tools/torch_profile.py [--model sd1|sd2|sdxl|sd3|sd35_large|
        sd35_medium|flux_dev|flux_schnell] [--tae] [bf16] [q8_0]
        [q8_0:int8] [q4_0]

Prints one JSON line per measurement, each naming its model and weight
type.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mlimgsynth_torch import api, testing  # noqa: E402
from mlimgsynth_torch.models import t5 as t5_mod  # noqa: E402

WARM, EVALS, TOP = 3, 20, 20
PROMPTS = ["a photograph of an astronaut riding a horse",
           "a watercolor painting of a lighthouse at dawn",
           "a (red:1.2) fox in the snow, highly detailed"]

# kernel kind: the first of these words found in the kernel's name
KINDS = [("attn_hopper_kernel", "flash kernels"),
         ("attn_wide_kernel", "flash kernels"),
         ("qmm_", "quantized matmul kernels"),
         ("quant_rows", "quantized matmul kernels"),
         ("nchwToNhwc", "cuDNN layout conversion"),
         ("nhwcToNchw", "cuDNN layout conversion"),
         ("fprop", "convolution"), ("conv", "convolution"),
         ("gemm", "GEMM"), ("nvjet", "GEMM"), ("Moments", "norm"),
         ("norm", "norm"), ("softmax", "softmax"), ("copy", "copy/cast"),
         ("Memcpy", "copy/cast"), ("Memset", "fill")]


def out(kind: str, **kv) -> None:
    print(json.dumps({"measure": kind, **kv}), flush=True)


def clocks() -> dict:
    """The card's SM clock, its maximum, power draw and temperature now
    (``nvidia-smi``): a clock well below the maximum under load means the
    card is throttled and the times read slow."""
    keys = ("clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu")
    vals = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(keys)}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(", ")
    return dict(zip(keys, vals))


def kind_of(name: str) -> str:
    for word, kind in KINDS:
        if word.lower() in name.lower():
            return kind
    return "elementwise/other"


def request(s, i: int) -> float:
    s.option_set("seed", 42 + i)
    s.option_set("prompt", PROMPTS[i % len(PROMPTS)])
    s.option_set("nprompt", "blurry, low quality")
    t0 = time.perf_counter()
    s.generate()
    return time.perf_counter() - t0


def timed(label: str, fn, stages: dict):
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[label] = time.perf_counter() - t0
        return r
    return wrapper


def stage_times(s, i: int) -> dict:
    stages: dict = {}
    dec = "tae." if s.c["tae"] else "vae."
    text, vae, sampler = s._text_cond, s._models[dec], api.run_sampler
    s._text_cond = timed("text_encode_s", text, stages)
    s._models[dec] = timed(dec[:3] + "_decode_s", vae, stages)
    api.run_sampler = timed("sampler_loop_s", sampler, stages)
    try:
        stages["request_s"] = request(s, i)
    finally:
        del s._text_cond
        s._models[dec], api.run_sampler = vae, sampler
    return stages


def denoiser_step_ms(s, n: int):
    """One denoiser evaluation on the inputs of a request's first one (its
    first sigma, the CFG batch where the request has one): (ms, batch)."""
    den = s._models[s._denoiser()]
    first = []

    def hook(mod, args):
        if not first:
            first.append(tuple(a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args))

    handle = den.register_forward_pre_hook(hook)
    try:
        request(s, 0)
    finally:
        handle.remove()

    def step():
        den(*first[0])

    with torch.no_grad():
        step()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            step()
        e1.record()
        torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n, first[0][0].shape[0]


def traced_request(s, i: int, tmp: str, top: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = request(s, i)
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise RuntimeError("the trace holds no device activity")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_kind = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_kind[kind_of(e["name"])] += float(e["dur"]) / 1e3
        by_name[e["name"]][0] += float(e["dur"]) / 1e3
        by_name[e["name"]][1] += 1
    busy_s = busy_us / 1e6
    return {
        "wall_s": wall, "device_busy_s": busy_s,
        "idle_share": 1.0 - busy_s / wall,
        "kernels": sum(e["cat"] == "kernel" for e in dev),
        "device_ms_by_kind": dict(sorted(by_kind.items(),
                                         key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:100], "ms": ms, "calls": c}
                        for n, (ms, c) in sorted(by_name.items(),
                                                 key=lambda kv: -kv[1][0])
                        [:top]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    args = sys.argv[1:]
    model, tae = "sd1", ""
    if args[:1] == ["--model"]:
        model, args = args[1], args[2:]
    if args[:1] == ["--tae"]:
        tae, args = "taesd-random-f16.safetensors", args[1:]
    dim = {"sd1": 512, "sd2": 768}.get(model, 1024)
    out("device", nvidia_smi=smi, torch=torch.__version__, model=model,
        tae=bool(tae))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ckpt = write_model(tmp, model)
        out("checkpoint", model=model, write_s=time.perf_counter() - t0,
            bytes=sum(os.path.getsize(p) for p in ckpt.values()))
        if tae:
            tae = os.path.join(tmp, tae)
            testing.write_random_tae(tae, seed=0)
        prev = None          # (weight type, session) to reuse
        for arg in args or ["bf16"]:
            wt, _, mode = arg.partition(":")
            s = prev[1] if prev and prev[0] == wt else None
            prev = None
            gc.collect()
            torch.cuda.empty_cache()
            os.environ["MLIS_Q8_MODE"] = mode or "dq"
            try:
                prev = (wt, profile_path(ckpt, model, dim, wt, tmp, s,
                                         mode or "dq", tae))
            finally:
                del os.environ["MLIS_Q8_MODE"]
    return 0


# the SD3.5 and Flux runs of ``chip_smoke.py``: (steps, cfg, T5 tokens)
DIT_RUNS = {"sd35_large": (20, 7.0, 77), "sd35_medium": (20, 7.0, 77),
            "flux_dev": (20, 3.5, 512), "flux_schnell": (4, 1.0, 256)}


def write_model(tmp: str, model: str) -> dict:
    """The seeded random files of ``model`` in ``tmp``, as session options:
    a numpy-drawn checkpoint ("model"), or for SD3.5 and Flux one drawn on
    the card (Flux: its component files, "model", "clip", "vae") with a
    random T5-XXL file and tokenizer ("t5", "t5-tokenizer")."""
    mt = api._model_types()[model]
    if model not in DIT_RUNS:
        path = os.path.join(tmp, f"{model}-random-f16.safetensors")
        testing.write_random_checkpoint(path, mt, seed=0)
        return {"model": path}
    if model.startswith("flux"):
        files = testing.write_random_flux_files(tmp, mt, seed=0,
                                                device="cuda")
    else:
        files = {"model": os.path.join(tmp, f"{model}.safetensors")}
        testing.write_random_checkpoint(files["model"], mt, seed=0,
                                        device="cuda")
    files["t5"] = os.path.join(tmp, "t5xxl-random-f16.safetensors")
    testing.write_random_t5(files["t5"], t5_mod.T5_XXL, seed=0,
                            device="cuda")
    files["t5-tokenizer"] = os.path.join(tmp, "t5-tokenizer.json")
    testing.write_tokenizer_json(files["t5-tokenizer"],
                                 testing.unigram_tokenizer_spec(
                                     testing.random_unigram_pieces(
                                         t5_mod.T5_XXL.n_vocab, seed=0),
                                     eos=True))
    return files


def profile_path(ckpt: dict, model: str, dim: int, wt: str, tmp: str,
                 s=None, mode: str = "dq", tae: str = ""):
    """Every measurement of one weight type (under ``mode``, decoded by the
    TAE file ``tae`` if given), in session ``s`` or a new one; returns the
    session."""
    tag = {"model": model, "path": wt, "mode": mode, "tae": bool(tae)}
    if s is None:
        s = api.MLImgSynth(device="cuda")
        steps, cfg, t5_tokens = DIT_RUNS.get(model, (20, 7.0, 77))
        for k, v in [*ckpt.items(), ("model-type", model),
                     ("weight-type", wt), ("image-dim", dim),
                     ("steps", steps), ("cfg-scale", cfg),
                     ("t5-tokens", t5_tokens),
                     ("method", "dpmpp2m" if model == "sd2" else "euler"),
                     ("scheduler", "uniform"), ("tae", tae)]:
            s.option_set(k, v)
        t0 = time.perf_counter()
        s.setup()
        if "t5" in ckpt:
            s._t5_load()
        out("setup", **tag, setup_s=time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    cold = request(s, 0)
    warm = [request(s, 1 + i) for i in range(WARM)]
    out("requests", **tag, cold_s=cold, warm_s=warm,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        clocks=clocks())
    out("stages", **tag, **stage_times(s, 1))
    step_ms, batch = denoiser_step_ms(s, EVALS)
    out("denoiser_step", **tag, batch=batch, evals=EVALS, ms=step_ms)
    trace = traced_request(s, 2, tmp, TOP)
    out("trace", **tag, **trace)
    med = statistics.median(warm)
    out("derived", **tag, median_warm_s=med,
        device_busy_s=trace["device_busy_s"],
        idle_share=1.0 - trace["device_busy_s"] / med)
    return s


if __name__ == "__main__":
    sys.exit(main())
