#!/usr/bin/env python3
"""Hold the weight-only quantized kernels and their plain twin to a witness
of the spec math (needs an H100):

    python3 tools/torch_quant_witness.py [M K N ...]

The witness dequantizes the weight to bf16 as both sides do, sums in f32
and rounds once to bf16: ``(x.float() @ w_bf16.float().t()).bfloat16()``
with TF32 off, the function of the JAX package's ``q8_matmul_xla`` /
``q4_matmul_xla`` (f32 accumulation, one rounding).  For each (M, K, N)
(default: the ragged-N ws product (2048, 640, 100) and its 104-column
neighbour) and for q8 and q4, prints one JSON line with the kernel the
dispatch rule picks and, for the pairs kernel / witness, twin / witness
and kernel / twin: the largest absolute difference, the relative L2 error
and the share of elements that differ.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mlimgsynth_torch import testing  # noqa: E402
from mlimgsynth_torch.ops import quant  # noqa: E402
from mlimgsynth_torch.ops import quant_matmul as qmm  # noqa: E402

DEFAULT = [(2048, 640, 100), (2048, 640, 104)]


def diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.float(), b.float()
    return {"max_abs": (a - b).abs().max().item(),
            "rel_l2": ((a - b).norm() / b.norm()).item(),
            "differ": (a != b).float().mean().item()}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_quant_witness: needs a CUDA device", file=sys.stderr)
        return 1
    args = [int(v) for v in sys.argv[1:]]
    cases = [tuple(args[i:i + 3]) for i in range(0, len(args), 3)] or DEFAULT
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for m, k, n in cases:
        kind = "ws" if qmm.use_ws(m, k) else "tile"
        for bits in (8, 4):
            x, q, s = testing.quant_inputs(m, k, n, bits)
            wq = quant.unpack_q4(q) if bits == 4 else q
            w = (wq.float().view(n, -1, quant.KBLOCK) * s[:, :, None]
                 ).view(n, k).bfloat16()
            witness = (x.float() @ w.float().t()).bfloat16()
            kern = getattr(qmm, f"q{bits}_matmul_{kind}")(x, q, s)
            twin = (quant.q4_matmul_plain if bits == 4
                    else quant.q8_matmul_plain)(x, q, s)
            bf16_mm = torch.matmul(x, w.t())
            torch.cuda.synchronize()
            print(json.dumps({
                "mkn": [m, k, n], "bits": bits, "kernel": kind,
                "kernel_vs_witness": diff(kern, witness),
                "twin_vs_witness": diff(twin, witness),
                "kernel_vs_twin": diff(kern, twin),
                "bf16_matmul_vs_witness": diff(bf16_mm, witness),
                "twin_limits_ok": testing.quant_error(kern, twin)["ok"]}),
                flush=True)
    print(json.dumps({"device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
