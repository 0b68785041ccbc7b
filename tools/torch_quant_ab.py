#!/usr/bin/env python3
"""Time the quantized-matmul kernels of another version of
``csrc/quant_matmul.cu`` against the tree's, in one process on one card
(needs an H100):

    python3 tools/torch_quant_ab.py OTHER.cu

Builds both sources, then for every case of ``testing.QUANT_CASES`` (q8 and
q4) times the tree's kernel, the other's, the other's again and the tree's
again (``testing.median_ms``: device time), checking each output against
the plain twin first.  Prints one JSON line per case and a summary line
with the per-source sums.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mlimgsynth_torch import testing  # noqa: E402
from mlimgsynth_torch.ops import _build, quant  # noqa: E402
from mlimgsynth_torch.ops import quant_matmul as qmm  # noqa: E402


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("usage: torch_quant_ab.py OTHER.cu (needs a CUDA device)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = {"tree": _build.load("quant_matmul")}
    csrc0, build0 = _build.CSRC, _build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(sys.argv[1], Path(tmp) / "quant_matmul.cu")
        _build.CSRC, _build.BUILD_DIR = Path(tmp), Path(tmp) / "build"
        _build._LIBS.clear()
        libs["other"] = _build.load("quant_matmul")
        _build.CSRC, _build.BUILD_DIR = csrc0, build0
        sums = defaultdict(float)
        for bits in (8, 4):
            plain = (quant.q4_matmul_plain if bits == 4
                     else quant.q8_matmul_plain)
            for kind, m, k, n, where in testing.QUANT_CASES:
                name = f"q{bits}_matmul_{kind}"
                x, q, s = testing.quant_inputs(m, k, n, bits)
                fn = getattr(qmm, name)
                row = {"kernel": name, "mkn": [m, k, n], "where": where}
                for i, src in enumerate(("tree", "other", "other", "tree")):
                    _build._LIBS["quant_matmul"] = libs[src]
                    if i < 2:
                        res = testing.quant_error(fn(x, q, s), plain(x, q, s))
                        row[f"{src}_ok"] = res["ok"]
                    t = testing.median_ms(lambda: fn(x, q, s))
                    row.setdefault(f"{src}_ms", []).append(t)
                    sums[src] += t / 2
                print(json.dumps(row), flush=True)
        _build._LIBS["quant_matmul"] = libs["tree"]
    print(json.dumps({"device": smi, "sum_ms": dict(sums)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
