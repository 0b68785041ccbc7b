#!/usr/bin/env python3
"""Where the time of one request goes on the card (needs a GPU).

Opens a full-width session of the PyTorch port on seeded random weights
(bf16 activations; 20 Euler steps, CFG 7, batch 1): SD1.5 at 512^2, with
``--model sdxl`` SDXL-base or ``--model sd3`` SD3-medium at 1024^2, or with
``--model sd2`` SD2.1-768-v at 768^2 (20 DPM++2M steps; ``--tae`` decodes
with a seeded random full-width taesd decoder instead of the VAE),
for each weight type named on the command line (default bf16; q8_0 and
q4_0 store the linears quantized; ``q8_0:int8`` measures q8_0 under
``MLIS_Q8_MODE=int8``, in the same session as a ``q8_0`` named just
before it), one session at a time, and measures, all in this one process:

  * ``requests``: the wall seconds of a cold and of three warm requests;
  * ``stages``: one request split into text encode, sampler loop and VAE
    (or TAE) decode, with a device sync at the end of each;
  * ``denoiser_step``: 20 UNet or MMDiT evaluations (the CFG batch of 2)
    back to back, by CUDA events;
  * ``trace``: one request traced with ``torch.profiler`` (device activity
    only): device busy time (the union of kernel, copy and fill intervals),
    kernel count, the idle share of that traced request's wall time, and
    device time by kind of kernel and the 20 kernels that took longest;
  * ``derived``: the trace's busy time against the median warm request
    above: two different requests of this run, for an idle share without
    the profiler's cost on the host.

    python3 tools/torch_profile.py [--model sd1|sd2|sdxl|sd3] [--tae]
        [bf16] [q8_0] [q8_0:int8] [q4_0]

Prints one JSON line per measurement, each naming its model and weight
type.
"""
from __future__ import annotations

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
from mlimgsynth_torch.models import mmdit as mmdit_mod  # noqa: E402
from mlimgsynth_torch.models import unet as unet_mod  # noqa: E402

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


def denoiser_step_ms(s, n: int) -> float:
    """One denoiser evaluation on the CFG batch at the first sigma."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cond = torch.from_numpy(s.tensors["cond"]).cuda().repeat(2, 1, 1)
    lat = s.tensors["latent"].shape
    if "mmdit." in s._models:
        label = torch.from_numpy(s.tensors["label"]).cuda().repeat(2, 1)
        x = torch.randn(2, *lat[1:], device="cuda", generator=gen)

        def step():
            mmdit_mod.denoise(s._models["mmdit."], x, 1.0, 1000.0, cond,
                              label)
    else:
        x = torch.randn(2, *lat[1:], device="cuda", generator=gen) * 14.6
        label = (None if s.tensors["label"] is None else
                 torch.from_numpy(s.tensors["label"]).cuda().repeat(2, 1))

        def step():
            unet_mod.denoise(s._models["unet."], x, 14.6, 999.0, cond,
                             label)
    with torch.no_grad():
        step()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            step()
        e1.record()
        torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


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
    dim = {"sd1": 512, "sd2": 768, "sdxl": 1024, "sd3": 1024}[model]
    out("device", nvidia_smi=smi, torch=torch.__version__, model=model,
        tae=bool(tae))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, f"{model}-random-f16.safetensors")
        t0 = time.perf_counter()
        testing.write_random_checkpoint(ckpt, api._model_types()[model],
                                        seed=0)
        out("checkpoint", model=model, write_s=time.perf_counter() - t0,
            bytes=os.path.getsize(ckpt))
        if tae:
            tae = os.path.join(tmp, tae)
            testing.write_random_tae(tae, seed=0)
        prev = None          # (weight type, session) to reuse
        for arg in args or ["bf16"]:
            wt, _, mode = arg.partition(":")
            s = prev[1] if prev and prev[0] == wt else None
            prev = None
            torch.cuda.empty_cache()
            os.environ["MLIS_Q8_MODE"] = mode or "dq"
            try:
                prev = (wt, profile_path(ckpt, model, dim, wt, tmp, s,
                                         mode or "dq", tae))
            finally:
                del os.environ["MLIS_Q8_MODE"]
    return 0


def profile_path(ckpt: str, model: str, dim: int, wt: str, tmp: str,
                 s=None, mode: str = "dq", tae: str = ""):
    """Every measurement of one weight type (under ``mode``, decoded by the
    TAE file ``tae`` if given), in session ``s`` or a new one; returns the
    session."""
    tag = {"model": model, "path": wt, "mode": mode, "tae": bool(tae)}
    if s is None:
        s = api.MLImgSynth(device="cuda")
        for k, v in [("model", ckpt), ("model-type", model),
                     ("weight-type", wt), ("image-dim", dim), ("steps", 20),
                     ("cfg-scale", 7.0),
                     ("method", "dpmpp2m" if model == "sd2" else "euler"),
                     ("scheduler", "uniform"), ("tae", tae)]:
            s.option_set(k, v)
        t0 = time.perf_counter()
        s.setup()
        out("setup", **tag, setup_s=time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    cold = request(s, 0)
    warm = [request(s, 1 + i) for i in range(WARM)]
    out("requests", **tag, cold_s=cold, warm_s=warm,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    out("stages", **tag, **stage_times(s, 1))
    out("denoiser_step", **tag, batch=2, evals=EVALS,
        ms=denoiser_step_ms(s, EVALS))
    trace = traced_request(s, 2, tmp, TOP)
    out("trace", **tag, **trace)
    med = statistics.median(warm)
    out("derived", **tag, median_warm_s=med,
        device_busy_s=trace["device_busy_s"],
        idle_share=1.0 - trace["device_busy_s"] / med)
    return s


if __name__ == "__main__":
    sys.exit(main())
