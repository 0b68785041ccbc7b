#!/usr/bin/env python3
"""Time the weight-stationary kernel (K6, ``q8_matmul_ws``) with parts of
its work taken out, to see which part bounds it (needs an H100):

    python3 tools/torch_kernel_ablate.py

Each variant is the tree's ``csrc/quant_matmul.cu`` with text edits that
skip one stage of the kernel's pipeline (the loads of x and the weight,
the scale copies, the dequantization, the products, the stores), built in
a temporary directory; its outputs are wrong and only its device time
(``testing.median_ms``) is read, at three products of the SD1.5 and SDXL
main paths.  Prints one JSON line per variant, then the card's name and
power limit.  The repository's own source and build are not touched.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mlimgsynth_torch import testing  # noqa: E402
from mlimgsynth_torch.ops import _build  # noqa: E402
from mlimgsynth_torch.ops import quant_matmul as qmm  # noqa: E402

SHAPES = [(2048, 640, 5120), (8192, 2560, 640), (2048, 1280, 10240)]

_X = ("          tma_load_2d(smem_u32(sx + slot * C::kX + h * kXBox), &x_map, "
      "bar, k0 + h * kWsBK, m0);")
_W = ("        tma_load_2d(smem_u32(sw + slot * C::kW), &w_map, bar, "
      "k0 * BITS / 8, n0);")
_OFF = "if (a.m < 0) "   # a condition that never holds: the call is skipped
NO_LOADS = [(_X, "          " + _OFF + _X.strip()),
            (_W, "        " + _OFF + _W.strip()),
            ("mbar_expect_tx(bar, C::kX + C::kW);", "mbar_expect_tx(bar, 0);")]
NO_SCALES = [("        cp_async4(smem_u32(ss", "        " + _OFF
              + "cp_async4(smem_u32(ss")]
NO_DEQUANT = [("      deq_tile<BITS, BN>(sb", "      " + _OFF
               + "deq_tile<BITS, BN>(sb")]
NO_PRODUCTS = [("      wgmma_tile<BN>(acc, sw128", "      " + _OFF
                + "wgmma_tile<BN>(acc, sw128")]
NO_STORES = [("    if (p.tma_store) {", "    " + _OFF + "{"),
             ("      store_tile(acc, a, m0 + warp * 16, n0);",
              "      " + _OFF + "store_tile(acc, a, m0 + warp * 16, n0);")]

ABLATIONS = {
    "full": [],
    "no_loads": NO_LOADS,
    "no_scale_copies": NO_SCALES,
    "no_dequant": NO_DEQUANT,
    "no_products": NO_PRODUCTS,
    "no_stores": NO_STORES,
    "no_dequant_no_products": NO_DEQUANT + NO_PRODUCTS,
    "pipeline_only": NO_LOADS + NO_SCALES + NO_DEQUANT + NO_PRODUCTS,
    "pipeline_only_no_stores": (NO_LOADS + NO_SCALES + NO_DEQUANT
                                + NO_PRODUCTS + NO_STORES),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ablate: needs a CUDA device", file=sys.stderr)
        return 1
    src0 = (_build.CSRC / "quant_matmul.cu").read_text()
    inputs = {s: testing.quant_inputs(*s, 8) for s in SHAPES}
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in ABLATIONS.items():
            src = src0
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"{name}: '{old}' is not in the "
                                       "source")
                src = src.replace(old, new)
            csrc = Path(tmp) / name
            csrc.mkdir()
            (csrc / "quant_matmul.cu").write_text(src)
            _build.CSRC, _build.BUILD_DIR = csrc, csrc / "build"
            _build._LIBS.clear()
            row = {"variant": name}
            for (m, k, n), (x, q, s) in inputs.items():
                row[f"{m}x{k}x{n}_ms"] = testing.median_ms(
                    lambda: qmm.q8_matmul_ws(x, q, s))
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
