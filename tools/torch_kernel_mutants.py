#!/usr/bin/env python3
"""Show that the kernel checks catch wrong kernels (needs an H100).

Builds each kernel source (``mlimgsynth_torch/csrc/flash_attention.cu``,
``quant_matmul.cu``) as written and with one planted fault at a time, runs
every case of that source (``testing.ATTN_CASES``, or ``testing.QUANT_CASES``
for q8 and q4 and ``testing.INT8_CASES`` for the W8A8 kernel) against the
plain twin, and holds each result to ``testing.attention_error`` /
``testing.quant_error`` / ``testing.int8_error``:

    python3 tools/torch_kernel_mutants.py

Prints one JSON line per (variant, case), then a summary line.  Exits 0 only
if each source as written passes every case and each planted fault fails at
least one.  The faulty sources and their builds live in a temporary
directory; the repository's own source and build directory are not
touched.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mlimgsynth_torch import testing  # noqa: E402
from mlimgsynth_torch.ops import _build, quant  # noqa: E402
from mlimgsynth_torch.ops import flash_attention as fa  # noqa: E402
from mlimgsynth_torch.ops import quant_matmul as qmm  # noqa: E402

# name -> (source, text in the source, its faulty replacement: every
# occurrence is replaced)
MUTANTS = {
    # the softmax scale of a 40-wide head taken from its padded depth 48
    "scale_from_padded_depth": (
        "flash_attention", "s[j][e] * a.scale_log2 : -INFINITY",
        "s[j][e] * a.scale_log2 * 0.91287093f : -INFINITY"),
    # the last kv tile of 64 rows skipped
    "last_kv_tile_dropped": (
        "flash_attention", "for (int n0 = 0; n0 < a.sk; n0 += kBlockN)",
        "for (int n0 = 0; n0 + kBlockN < a.sk; n0 += kBlockN)"),
    # the last 16 columns of the QK^T depth left out
    "qk_depth_short_by_16": (
        "flash_attention", "for (int kk = 0; kk < DQK / 16; ++kk)",
        "for (int kk = 0; kk < DQK / 16 - 1; ++kk)"),
    # each weight group scaled by its neighbour's scale
    "scale_group_shifted": (
        "quant_matmul", "a.s[(long long)n * n_groups + kg]",
        "a.s[(long long)n * n_groups + (kg + 1) % n_groups]"),
    # q4: the high nibble taken as group row j and the low as row j + 64
    "nibble_order_swapped": (
        "quant_matmul",
        ("deq_store16(d + c, lo, f.sc[j]);\n"
         "      deq_store16(d + 64 + c, hi, f.sc[j]);"),
        ("deq_store16(d + c, hi, f.sc[j]);\n"
         "      deq_store16(d + 64 + c, lo, f.sc[j]);")),
    # the last 128-deep K group left out of the products
    "last_k_group_dropped": (
        "quant_matmul", "mma_group(acc, sx, sw",
        "if (kg + 1 < n_groups) mma_group(acc, sx, sw"),
    # W8A8: each slab folded with the next slab's activation scale
    "slab_scale_shifted": (
        "quant_matmul", "a.amax[(long long)row * n_slab + sb]",
        "a.amax[(long long)row * n_slab + (sb + 1) % n_slab]"),
    # W8A8: activations truncated toward zero instead of rounded
    "activations_truncated": (
        "quant_matmul", "__float2int_rn(__fmul_rn(f, inv))",
        "__float2int_rz(__fmul_rn(f, inv))"),
}


def flash_cases(variant: str) -> bool:
    all_ok = True
    for name, shape, sk, where in testing.ATTN_CASES:
        q, k, v = testing.attention_inputs(shape, sk)
        out = getattr(fa, name)(q, k, v)
        res = testing.attention_error(out, fa.attention_plain(q, k, v))
        print(json.dumps({"variant": variant, "kernel": name, "where": where,
                          "q": list(shape), "sk": sk, **res}), flush=True)
        all_ok &= res["ok"]
    return all_ok


def quant_cases(variant: str) -> bool:
    all_ok = True
    for bits in (8, 4):
        plain = quant.q4_matmul_plain if bits == 4 else quant.q8_matmul_plain
        for kind, m, k, n, where in testing.QUANT_CASES:
            name = f"q{bits}_matmul_{kind}"
            x, q, s = testing.quant_inputs(m, k, n, bits)
            res = testing.quant_error(getattr(qmm, name)(x, q, s),
                                      plain(x, q, s))
            print(json.dumps({"variant": variant, "kernel": name,
                              "where": where, "mkn": [m, k, n], **res}),
                  flush=True)
            all_ok &= res["ok"]
    for m, k, n, where in testing.INT8_CASES:
        x, q, s = testing.int8_inputs(m, k, n)
        res = testing.int8_error(qmm.q8_matmul_ws_int8(x, q, s),
                                 quant.q8_ws_int8_plain(x, q, s))
        print(json.dumps({"variant": variant, "kernel": "q8_matmul_ws_int8",
                          "where": where, "mkn": [m, k, n], **res}),
              flush=True)
        all_ok &= res["ok"]
    return all_ok


CASES = {"flash_attention": flash_cases, "quant_matmul": quant_cases}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_mutants: needs a CUDA device", file=sys.stderr)
        return 1
    csrc0 = _build.CSRC
    summary = {f"as_written:{src}": run(src) for src, run in CASES.items()}
    with tempfile.TemporaryDirectory() as tmp:
        for variant, (src_name, old, new) in MUTANTS.items():
            src = (csrc0 / f"{src_name}.cu").read_text()
            if old not in src:
                raise RuntimeError(f"{variant}: '{old}' is not in the source")
            csrc = Path(tmp) / variant
            csrc.mkdir()
            (csrc / f"{src_name}.cu").write_text(src.replace(old, new))
            _build.CSRC, _build.BUILD_DIR = csrc, csrc / "build"
            _build._LIBS.clear()
            summary[variant] = CASES[src_name](variant)
    written = all(ok for v, ok in summary.items() if v.startswith("as_"))
    caught = all(not ok for v, ok in summary.items()
                 if not v.startswith("as_"))
    print(json.dumps({"passes": summary, "all_faults_caught": caught}))
    return 0 if written and caught else 1


if __name__ == "__main__":
    sys.exit(main())
