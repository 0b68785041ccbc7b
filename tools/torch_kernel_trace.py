#!/usr/bin/env python3
"""Per-stage clock trace of the W8A8 kernels (K7 ``q8_matmul_ws_int8``, K8
``q8_matmul_int8``) on one block (needs an H100):

    python3 tools/torch_kernel_trace.py

Builds a copy of the tree's ``csrc/quant_matmul.cu`` in a temporary
directory with text edits that record ``clock64()`` in block 0 at points of
the producer's and the two consumer warpgroups' loops into a device array,
runs each main-path product (K7 at (8192, 1536, 6144), K8 at (8192, 640,
5120)) and prints one JSON line per product, in SM clocks:

* ``consumer``: per stage, the wait for the stage's data (``wait_full``),
  from the products' issue to the previous stage's completion
  (``issue_to_wait``), and the rest (``between``: frees, folds and the
  epilogue, spread over the stages); ``per_stage`` is the whole;
* ``fold``: per slab, the wait for the last products and the fold;
* ``tile``: the period of a tile and its epilogue (from the last fold to
  the store's issue);
* ``producer``: per stage, the wait for a free slot, the rest of its loop,
  and how far ahead of the consumers it is (``lead``).

The traced kernel's device time (``testing.median_ms``) is printed with
it; the trace adds a few stores a stage.  The repository's own source and
build are not touched.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mlimgsynth_torch import testing  # noqa: E402
from mlimgsynth_torch.ops import _build  # noqa: E402
from mlimgsynth_torch.ops import quant_matmul as qmm  # noqa: E402

CASES = [("q8_matmul_ws_int8", (8192, 1536, 6144)),
         ("q8_matmul_int8", (8192, 640, 5120))]
N = 4096   # entries a row of the trace array
_PROD = "blockIdx.x == 0 && tid == kI8Consumers && gs < 4096"
# (text in the source, the text with its clock records); rows: 0-1 the
# producer's wait for a free slot, 2-4 / 5-7 warpgroup 0 / 1 a stage,
# 8-10 / 11-13 warpgroup 0 / 1 a slab's end, 15 the tile's store issued
EDITS = [
    ("namespace {\n",
     "namespace {\n__device__ long long g_trace[16][4096];\n"),
    ("    // and its loop sets the pace of the ring\n"
     "    int slot = 0, phase = 0;\n    for (int t = 0; t < my_tiles; ++t) {",
     "    // and its loop sets the pace of the ring\n"
     "    int slot = 0, phase = 0, gs = 0;\n"
     "    for (int t = 0; t < my_tiles; ++t) {"),
    ("        mbar_wait(smem_u32(empty + slot), phase ^ 1);\n"
     "        if (lane == 0) {\n          mbar_expect_tx(bar, kI8X",
     f"        if ({_PROD}) g_trace[0][gs] = clock64();\n"
     "        mbar_wait(smem_u32(empty + slot), phase ^ 1);\n"
     f"        if ({_PROD}) g_trace[1][gs] = clock64();\n        ++gs;\n"
     "        if (lane == 0) {\n          mbar_expect_tx(bar, kI8X"),
    ("  int slot = 0, phase = 0, held = -1;",
     "  int slot = 0, phase = 0, held = -1, gs = 0, gsl = 0;\n"
     "  const bool tr = blockIdx.x == 0 && (tid & 127) == 0;"),
    ("        mbar_wait(smem_u32(full + slot), phase);\n",
     "        if (tr && gs < 4096) g_trace[2 + 3 * wg][gs] = clock64();\n"
     "        mbar_wait(smem_u32(full + slot), phase);\n"
     "        if (tr && gs < 4096) g_trace[3 + 3 * wg][gs] = clock64();\n"),
    ("        wgmma_wait<1>();\n",
     "        wgmma_wait<1>();\n"
     "        if (tr && gs < 4096) g_trace[4 + 3 * wg][gs] = clock64();\n"
     "        ++gs;\n"),
    ("      wgmma_wait<0>();   // the slab's end: fold\n      pin_i(dot);\n"
     "      i8_fold<BLOCK_SCALES>(acc, dot, sa + held * kI8BM, "
     "ss + held * BN, row);\n",
     "      if (tr && gsl < 4096) g_trace[8 + 3 * wg][gsl] = clock64();\n"
     "      wgmma_wait<0>();   // the slab's end: fold\n      pin_i(dot);\n"
     "      if (tr && gsl < 4096) g_trace[9 + 3 * wg][gsl] = clock64();\n"
     "      i8_fold<BLOCK_SCALES>(acc, dot, sa + held * kI8BM, "
     "ss + held * BN, row);\n"
     "      if (tr && gsl < 4096) g_trace[10 + 3 * wg][gsl++] = clock64();\n"),
    ("    } else {\n      const Args ya = {nullptr, nullptr, nullptr, a.y, "
     "a.m, a.n, a.k};\n      store_tile(acc, ya,",
     "      if (tr && t < 4096) g_trace[15][t] = clock64();\n"
     "    } else {\n      const Args ya = {nullptr, nullptr, nullptr, a.y, "
     "a.m, a.n, a.k};\n      store_tile(acc, ya,"),
    ('extern "C" int q8_int8_tile_n(',
     'extern "C" int i8_trace_get(void* h) { return (int)cudaMemcpyFromSymbol('
     'h, g_trace, sizeof(g_trace)); }\n'
     'extern "C" int i8_trace_clear() { void* p = nullptr; '
     'cudaGetSymbolAddress(&p, g_trace); '
     'return (int)cudaMemset(p, 0, sizeof(g_trace)); }\n'
     'extern "C" int q8_int8_tile_n('),
]


def summarize(buf: np.ndarray) -> dict:
    ns = int((buf[4] > 0).sum())       # stages warpgroup 0 traced
    nsl = int((buf[10] > 0).sum())     # slabs
    nt = int((buf[15] > 0).sum())      # tiles
    out = {"stages": ns, "slabs": nsl, "tiles": nt}
    for wg in (0, 1):
        a, b, c = (buf[i + 3 * wg][:ns] for i in (2, 3, 4))
        out[f"consumer_wg{wg}"] = {
            "per_stage": float((c[-1] - a[0]) / ns),
            "wait_full": float((b - a).mean()),
            "issue_to_wait": float((c - b).mean()),
            "between": float((a[1:] - c[:-1]).mean())}
        a, b, c = (buf[i + 3 * wg][:nsl] for i in (8, 9, 10))
        out[f"fold_wg{wg}"] = {"wait": float((b - a).mean()),
                               "fold": float((c - b).mean())}
    last_fold = buf[10][np.arange(1, nt + 1) * (nsl // nt) - 1]
    out["tile"] = {"period": float((buf[15][nt - 1] - buf[15][0]) / (nt - 1)),
                   "epilogue": float((buf[15][:nt] - last_fold).mean())}
    p_in, p_out = buf[0][:ns], buf[1][:ns]
    out["producer"] = {"wait_empty": float((p_out - p_in).mean()),
                       "rest": float((p_in[1:] - p_out[:-1]).mean()),
                       "lead": float((buf[2][:ns] - p_out).mean())}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_trace: needs a CUDA device", file=sys.stderr)
        return 1
    csrc0 = _build.CSRC
    src = (_build.CSRC / "quant_matmul.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"'{old}' is not once in the source")
        src = src.replace(old, new)
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "quant_matmul.cu").write_text(src)
        for hdr in csrc0.glob("*.cuh"):   # the shared headers
            (Path(tmp) / hdr.name).write_bytes(hdr.read_bytes())
        _build.CSRC, _build.BUILD_DIR = Path(tmp), Path(tmp) / "build"
        _build._LIBS.clear()
        lib = _build.load("quant_matmul")
        for name, (m, k, n) in CASES:
            args = (testing.int8_inputs(m, k, n) if name == "q8_matmul_ws_int8"
                    else testing.quant_inputs(m, k, n, 8))
            fn = getattr(qmm, name)
            t = testing.median_ms(lambda: fn(*args))
            buf = np.zeros((16, N), np.int64)
            if lib.i8_trace_clear() != 0:
                raise RuntimeError("i8_trace_clear failed")
            fn(*args)
            torch.cuda.synchronize()
            if lib.i8_trace_get(ctypes.c_void_p(buf.ctypes.data)) != 0:
                raise RuntimeError("i8_trace_get failed")
            print(json.dumps({"kernel": name, "mkn": [m, k, n], "ms": t,
                              "tile_n": qmm.i8_tile_n(m, n),
                              **summarize(buf)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
