#!/usr/bin/env python3
"""Time the kernels of another version of a kernel source against the
tree's, in one process on one card (needs an H100):

    python3 tools/torch_kernel_ab.py OTHER/flash_attention.cu
    python3 tools/torch_kernel_ab.py [--stripe-ws] OTHER/quant_matmul.cu
    python3 tools/torch_kernel_ab.py --shapes-from LOG OTHER/quant_matmul.cu
    python3 tools/torch_kernel_ab.py --kernels q8_matmul_ws,q4_matmul_ws \
        OTHER/quant_matmul.cu

The file name says which source of ``mlimgsynth_torch/csrc/`` it stands
for; the other version must keep that source's C interface.  Builds both,
then for every case of that source (``testing.ATTN_CASES``, or
``testing.QUANT_CASES`` for q8 and q4, ``testing.INT8_CASES`` and
``testing.Q8_INT8_CASES``) times the tree's kernel, the other's, the
other's again and the tree's again (``testing.median_ms``: device time),
checking each output against the plain twin first, and the host time of
one call with the card busy (``host_us``: the wrapper and the C launcher,
the device work queued behind a spin).  Prints one JSON line per case and
a summary line with the per-source sums, in all and by kernel.

``--shapes-from LOG``: instead of those cases, the tiled products that a
``chip_smoke.py`` log's ``shapes`` lines list (every product of its SD1.5,
SD3 and SDXL requests that the dispatch gives the tiled kernel), each for
q8 and q4.

``--kernels NAMES``: only the cases of those kernels (comma-separated).

``--stripe-ws``: the other source's weight-stationary entry points take
the trailing int of the first ws design, the stripe width (64 up to
K = 1280, 32 above), where the tree's take the tile width of
``quant_matmul.ws_config``.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mlimgsynth_torch import testing  # noqa: E402
from mlimgsynth_torch.ops import _build, quant  # noqa: E402
from mlimgsynth_torch.ops import flash_attention as fa  # noqa: E402
from mlimgsynth_torch.ops import quant_matmul as qmm  # noqa: E402


def flash_cases():
    """(label, kernel call, plain call, error check) per case."""
    for name, shape, sk, where in testing.ATTN_CASES:
        q, k, v = testing.attention_inputs(shape, sk)
        yield ({"kernel": name, "q": list(shape), "sk": sk, "where": where},
               lambda f=getattr(fa, name), a=(q, k, v): f(*a),
               lambda a=(q, k, v): fa.attention_plain(*a),
               testing.attention_error)


def quant_cases():
    for bits in (8, 4):
        plain = quant.q4_matmul_plain if bits == 4 else quant.q8_matmul_plain
        for kind, m, k, n, where in testing.QUANT_CASES:
            name = f"q{bits}_matmul_{kind}"
            a = testing.quant_inputs(m, k, n, bits)
            yield ({"kernel": name, "mkn": [m, k, n], "where": where},
                   lambda f=getattr(qmm, name), a=a: f(*a),
                   lambda p=plain, a=a: p(*a), testing.quant_error)
    for m, k, n, where in testing.INT8_CASES:
        a = testing.int8_inputs(m, k, n)
        yield ({"kernel": "q8_matmul_ws_int8", "mkn": [m, k, n],
                "where": where},
               lambda a=a: qmm.q8_matmul_ws_int8(*a),
               lambda a=a: quant.q8_ws_int8_plain(*a), testing.int8_error)
    for m, k, n, where in testing.Q8_INT8_CASES:
        a = testing.quant_inputs(m, k, n, 8)
        yield ({"kernel": "q8_matmul_int8", "mkn": [m, k, n],
                "where": where},
               lambda a=a: qmm.q8_matmul_int8(*a),
               lambda a=a: quant.q8_matmul_int8_plain(*a),
               testing.q8_int8_error)


CASES = {"flash_attention": flash_cases, "quant_matmul": quant_cases}


def tile_product_cases(log: str):
    """The tiled products of a chip_smoke.py log's shapes lines, as
    :func:`quant_cases` gives its cases."""
    mkn = set()
    for line in Path(log).read_text().splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            if row.get("phase") == "shapes" and row.get("kernel") == "tile":
                mkn.add(tuple(row["mkn"]))

    def cases():
        for bits in (8, 4):
            plain = (quant.q4_matmul_plain if bits == 4
                     else quant.q8_matmul_plain)
            name = f"q{bits}_matmul_tile"
            for m, k, n in sorted(mkn):
                a = testing.quant_inputs(m, k, n, bits)
                yield ({"kernel": name, "mkn": [m, k, n]},
                       lambda f=getattr(qmm, name), a=a: f(*a),
                       lambda p=plain, a=a: p(*a), testing.quant_error)
    return cases


def host_us(fn, n: int = 50) -> float:
    """Host microseconds of one call of ``fn``, the calls queued behind a
    spin of the card so that none waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)   # cycles: ~50 ms at 1.98 GHz
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def stripe_ws_config(m: int, n: int, k: int, sms: int) -> int:
    return 64 if k <= 1280 else 32


def main() -> int:
    args = sys.argv[1:]
    stripe_ws = "--stripe-ws" in args
    args = [a for a in args if a != "--stripe-ws"]
    log = kernels = None
    if args[:1] == ["--kernels"] and len(args) > 1:
        kernels, args = set(args[1].split(",")), args[2:]
    if args[:1] == ["--shapes-from"] and len(args) > 1:
        log, args = args[1], args[2:]
    other = Path(args[0]) if len(args) == 1 else None
    if other is None or other.stem not in CASES \
            or (log and other.stem != "quant_matmul") \
            or not torch.cuda.is_available():
        print("usage: torch_kernel_ab.py [--stripe-ws] [--kernels NAMES] "
              "[--shapes-from LOG] "
              "OTHER/{flash_attention,quant_matmul}.cu (needs a CUDA "
              "device)", file=sys.stderr)
        return 1
    src = other.stem
    cases = tile_product_cases(log) if log else CASES[src]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = {"tree": _build.load(src)}
    csrc0, build0 = _build.CSRC, _build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(other, Path(tmp) / f"{src}.cu")
        for hdr in csrc0.glob("*.cuh"):   # the tree's shared headers
            shutil.copy(hdr, tmp)
        _build.CSRC, _build.BUILD_DIR = Path(tmp), Path(tmp) / "build"
        _build._LIBS.clear()
        libs["other"] = _build.load(src)
        _build.CSRC, _build.BUILD_DIR = csrc0, build0
        ws_configs = {"tree": qmm.ws_config,
                      "other": stripe_ws_config if stripe_ws
                      else qmm.ws_config}
        sums = defaultdict(float)
        by_kernel = defaultdict(lambda: defaultdict(float))
        for row, fn, plain, check in cases():
            if kernels and row["kernel"] not in kernels:
                continue
            for i, which in enumerate(("tree", "other", "other", "tree")):
                _build._LIBS[src] = libs[which]
                qmm.ws_config = ws_configs[which]
                if i < 2:
                    row[f"{which}_ok"] = check(fn(), plain())["ok"]
                    row[f"{which}_host_us"] = host_us(fn)
                t = testing.median_ms(fn)
                row.setdefault(f"{which}_ms", []).append(t)
                sums[which] += t / 2
                by_kernel[row["kernel"]][which] += t / 2
            print(json.dumps(row), flush=True)
        _build._LIBS[src] = libs["tree"]
        qmm.ws_config = ws_configs["tree"]
    print(json.dumps({"device": smi, "source": src, "sum_ms": dict(sums),
                      "sum_ms_by_kernel": by_kernel}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
