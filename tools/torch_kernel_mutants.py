#!/usr/bin/env python3
"""Show that the kernel checks catch wrong kernels (needs an H100).

Builds each kernel source (``mlimgsynth_torch/csrc/flash_attention.cu``,
``quant_matmul.cu``) as written and with one planted fault at a time, runs
every case of that source (``testing.ATTN_CASES``, or ``testing.QUANT_CASES``
for q8 and q4, ``testing.INT8_CASES`` for the per-column W8A8 kernel and
``testing.Q8_INT8_CASES`` for the per-block one) against the plain twin, and
holds each result to ``testing.attention_error`` / ``testing.quant_error`` /
``testing.int8_error`` / ``testing.q8_int8_error``:

    python3 tools/torch_kernel_mutants.py

Prints one JSON line per (variant, case), then a summary line.  Exits 0 only
if each source as written passes every case and each planted fault fails at
least one case of every kernel it targets.  The faulty sources and their builds live in a temporary
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

WEIGHT_ONLY = ("q8_matmul_tile", "q8_matmul_ws", "q4_matmul_tile",
               "q4_matmul_ws")

# name -> (source, [(text in the source, its faulty replacement)]: every
# occurrence of each text is replaced, and the kernels that must each fail
# at least one case)
HOPPER_ATTN = ("flash_attn_fwd", "flash_attn_joint")   # attn_hopper_kernel
WIDE_ATTN = ("flash_attn_fwd_wide",)                   # attn_wide_kernel
MUTANTS = {
    # the softmax scale of a 40-wide head taken from its padded depth 48
    "scale_from_padded_depth": (
        "flash_attention", [("const float sl = p.scale_log2;",
                             "const float sl = p.scale_log2 * 0.91287093f;")],
        HOPPER_ATTN),
    # the last kv tile (the ragged tail) never loaded nor computed
    "last_kv_tile_dropped": (
        "flash_attention", [("const int n = p.n_tiles;",
                             "const int n = p.sk / BN;")], HOPPER_ATTN),
    # the last 16 columns of the QK^T depth left out
    "qk_depth_short_by_16": (
        "flash_attention", [("for (int kk = 0; kk < KS; ++kk)",
                             "for (int kk = 0; kk < KS - 1; ++kk)")],
        HOPPER_ATTN),
    # the columns past Sk of the last kv tile (zero-filled k rows) not
    # left out, so their zero logits count in the softmax
    "tail_mask_dropped": (
        "flash_attention",
        [("softmax_tile<BN, true>(s, sl, p.sk - (n - 1) * BN,",
          "softmax_tile<BN, true>(s, sl, BN,")],
        HOPPER_ATTN),
    # the output sums not rescaled when the running max grows
    "output_not_rescaled": (
        "flash_attention", [("    rescale(o, alpha);\n", "")], HOPPER_ATTN),
    # K2's kernel: the same four faults, and two of its own
    "wide_scale_from_padded_depth": (
        "flash_attention", [("const float sl = arg.scale_log2;",
                             "const float sl = arg.scale_log2 * 0.91287093f;")],
        WIDE_ATTN),
    "wide_last_kv_tile_dropped": (
        "flash_attention", [("const int n = arg.n_tiles;",
                             "const int n = arg.sk / kWBN;")], WIDE_ATTN),
    "wide_qk_depth_short_by_16": (
        "flash_attention", [("for (int kk = 0; kk < 16; ++kk)",
                             "for (int kk = 0; kk < 15; ++kk)")], WIDE_ATTN),
    "wide_tail_mask_dropped": (
        "flash_attention",
        [("softmax_tile<kWBN, true>(s, sl, tail,",
          "softmax_tile<kWBN, true>(s, sl, kWBN,")], WIDE_ATTN),
    # the peer warpgroup's partial logits (the other half of the depth)
    # not added
    "wide_partial_not_added": (
        "flash_attention",
        [("s[j][0] += t.x, s[j][1] += t.y, s[j][2] += t.z, s[j][3] += t.w;",
          "(void)t;")], WIDE_ATTN),
    # the output sums not rescaled when the running max grows
    "wide_output_not_rescaled": (
        "flash_attention", [("    rescale(o[0], alpha);\n    rescale(o[1], alpha);\n",
                             "")], WIDE_ATTN),
    # each weight group scaled by its neighbour's scale (the producer's
    # scale copies of the tiled and ws kernels)
    "scale_group_shifted": (
        "quant_matmul", [("a.s[(long long)n * n_groups + kg]",
                          "a.s[(long long)n * n_groups + (kg + 1) % n_groups]")],
        WEIGHT_ONLY),
    # q4: the high nibble taken as group row j and the low as row j + 64
    "nibble_order_swapped": (
        "quant_matmul",
        [("(half ? words[w4] >> 4 : words[w4])",
          "(half ? words[w4] : words[w4] >> 4)"),
         ("(half ? w >> 4 : w)", "(half ? w : w >> 4)")],
        ("q4_matmul_tile", "q4_matmul_ws")),
    # the last 128-deep K group left out of the products
    "last_k_group_dropped": (
        "quant_matmul",
        [("for (int k16 = 0; k16 < kWsBK / 16; ++k16)",
          "for (int k16 = 0; k16 < kWsBK / 16 && kk + 2 < ksteps; ++k16)"),
         ("for (int c = 0; c < 4; ++c)\n        wgmma_rs<NT>",
          "for (int c = 0; c < 4 && kg + 1 < n_groups; ++c)\n        wgmma_rs<NT>")],
        WEIGHT_ONLY),
    # tiled kernels: one 16-deep product step of every group left out (the
    # last of its second half)
    "tile_product_step_dropped": (
        "quant_matmul",
        [("for (int c = 0; c < 4; ++c)\n        wgmma_rs<NT>",
          "for (int c = 0; c < 4 - h; ++c)\n        wgmma_rs<NT>")],
        ("q8_matmul_tile", "q4_matmul_tile")),
    # W8A8: each slab folded with the next slab's activation scale (the
    # producer's amax copies)
    "slab_scale_shifted": (
        "quant_matmul", [("arow + sb,", "arow + (sb + 1) % n_slab,")],
        ("q8_matmul_ws_int8",)),
    # W8A8 (both kernels share the quantization pass): activations
    # truncated toward zero instead of rounded
    "activations_truncated": (
        "quant_matmul", [("__float2int_rn(__fmul_rn(f, inv))",
                          "__float2int_rz(__fmul_rn(f, inv))")],
        ("q8_matmul_ws_int8", "q8_matmul_int8")),
    # per-block W8A8: each block folded with the next block's weight scale
    # (the producer's scale copies)
    "block_weight_scale_shifted": (
        "quant_matmul", [("a.s + (long long)n * n_slab + kb :",
                          "a.s + (long long)n * n_slab + (kb + 1) % n_slab :")],
        ("q8_matmul_int8",)),
    # W8A8: a slab's int32 sums not cleared after its fold (only a tile's
    # first product overwrites them), so every fold adds the earlier slabs
    # again
    "slab_sums_not_cleared": (
        "quant_matmul", [("k32 > 0 || ks > 0", "k32 > 0 || ks > 0 || sb > 0")],
        ("q8_matmul_ws_int8", "q8_matmul_int8")),
}


def record(passed: dict, name: str, res: dict) -> None:
    """Fold one case's result into ``passed[name]``: (whether every case
    of the kernel passed, its largest relative L2 error)."""
    ok, rel = passed.get(name, (True, 0.0))
    passed[name] = (ok and res["ok"], max(rel, res["rel_l2"]))


def flash_cases(variant: str) -> dict:
    """kernel -> (whether every case of it passed, its largest relative
    L2 error)."""
    passed = {}
    for name, shape, sk, where in testing.ATTN_CASES:
        q, k, v = testing.attention_inputs(shape, sk)
        out = getattr(fa, name)(q, k, v)
        res = testing.attention_error(out, fa.attention_plain(q, k, v))
        print(json.dumps({"variant": variant, "kernel": name, "where": where,
                          "q": list(shape), "sk": sk, **res}), flush=True)
        record(passed, name, res)
    return passed


def quant_cases(variant: str) -> dict:
    """As :func:`flash_cases`."""
    passed = {}
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
            record(passed, name, res)
    int8 = [("q8_matmul_ws_int8", testing.INT8_CASES, testing.int8_inputs,
             quant.q8_ws_int8_plain, testing.int8_error),
            ("q8_matmul_int8", testing.Q8_INT8_CASES,
             lambda m, k, n: testing.quant_inputs(m, k, n, 8),
             quant.q8_matmul_int8_plain, testing.q8_int8_error)]
    for name, cases, inputs, plain, error in int8:
        for m, k, n, where in cases:
            x, q, s = inputs(m, k, n)
            res = error(getattr(qmm, name)(x, q, s), plain(x, q, s))
            print(json.dumps({"variant": variant, "kernel": name,
                              "where": where, "mkn": [m, k, n], **res}),
                  flush=True)
            record(passed, name, res)
    return passed


CASES = {"flash_attention": flash_cases, "quant_matmul": quant_cases}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_mutants: needs a CUDA device", file=sys.stderr)
        return 1
    csrc0 = _build.CSRC
    summary, worst = {}, {}
    for src, run in CASES.items():
        summary[f"as_written:{src}"] = all(ok for ok, _ in run(src).values())
    with tempfile.TemporaryDirectory() as tmp:
        for variant, (src_name, edits, targets) in MUTANTS.items():
            src = (csrc0 / f"{src_name}.cu").read_text()
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"{variant}: '{old}' is not in the "
                                       "source")
                src = src.replace(old, new)
            csrc = Path(tmp) / variant
            csrc.mkdir()
            (csrc / f"{src_name}.cu").write_text(src)
            for hdr in csrc0.glob("*.cuh"):
                (csrc / hdr.name).write_bytes(hdr.read_bytes())
            _build.CSRC, _build.BUILD_DIR = csrc, csrc / "build"
            _build._LIBS.clear()
            passed = CASES[src_name](variant)
            # True: not caught (a targeted kernel passed all its cases)
            summary[variant] = any(passed[t][0] for t in targets)
            worst[variant] = {k: rel for k, (_, rel) in passed.items()
                              if k in targets}
    written = all(ok for v, ok in summary.items() if v.startswith("as_"))
    caught = all(not ok for v, ok in summary.items()
                 if not v.startswith("as_"))
    print(json.dumps({"passes": summary, "largest_rel_l2": worst,
                      "all_faults_caught": caught}))
    return 0 if written and caught else 1


if __name__ == "__main__":
    sys.exit(main())
