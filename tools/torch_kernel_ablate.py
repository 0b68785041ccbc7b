#!/usr/bin/env python3
"""Time the weight-stationary kernel (K6, ``q8_matmul_ws``; with
``--flux`` K6 and K10, ``q4_matmul_ws``, at Flux's ws products), with
``--w8a8`` the W8A8 kernels (K7 ``q8_matmul_ws_int8`` and K8
``q8_matmul_int8``), or with ``--flash`` the Hopper attention kernels (K1
``flash_attn_fwd``, K3 ``flash_attn_joint``, K2 ``flash_attn_fwd_wide``),
with parts of their work taken out, to see which part bounds them (needs
an H100):

    python3 tools/torch_kernel_ablate.py [--w8a8 | --flash | --flux]
        [VARIANT ...]

Each variant is the tree's ``csrc/quant_matmul.cu`` (``--flash``:
``csrc/flash_attention.cu``) with text edits that skip one stage of the
kernel's pipeline (K6: the loads of x or the weight or both, the scale
copies, the dequantization, the products, the stores; K7/K8: the activation
quantization pass, the loads of xq and the weight, the amax and scale
copies, the slab folds, the products, the stores; K1/K3: the k and v
loads, the exponentials, the rest of the softmax, either product, the two
warpgroups' turns; K2 also their exchange of partial logits), built in a
temporary directory; its outputs are wrong
and only its device time (``testing.median_ms``) is read, at shapes of
the main paths.  The variants build together, one ``nvcc`` each.
Prints one JSON line per variant, then the card's name and power limit.
The repository's own source and build are not touched.
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
from mlimgsynth_torch.ops import flash_attention as fa  # noqa: E402
from mlimgsynth_torch.ops import quant_matmul as qmm  # noqa: E402

SHAPES = [(2048, 640, 5120), (8192, 2560, 640), (2048, 1280, 10240)]
# --flux: (kernel, (M, K, N)) of Flux at 1024^2: dev's img_mlp.2 and
# single-block linear2 (q8_0), schnell's single-block linear1 and img_mlp.2
# (q4_0)
FLUX_SHAPES = [("q8_matmul_ws", (4096, 12288, 3072)),
               ("q8_matmul_ws", (4608, 15360, 3072)),
               ("q4_matmul_ws", (4096, 12288, 3072)),
               ("q4_matmul_ws", (4352, 3072, 21504))]

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

NO_X_LOADS = [(_X, "          " + _OFF + _X.strip()),
              ("mbar_expect_tx(bar, C::kX + C::kW);",
               "mbar_expect_tx(bar, C::kW);")]
NO_W_LOADS = [(_W, "        " + _OFF + _W.strip()),
              ("mbar_expect_tx(bar, C::kX + C::kW);",
               "mbar_expect_tx(bar, C::kX);")]

ABLATIONS = {
    "full": [],
    "no_loads": NO_LOADS,
    "no_x_loads": NO_X_LOADS,
    "no_w_loads": NO_W_LOADS,
    "no_scale_copies": NO_SCALES,
    "no_dequant": NO_DEQUANT,
    "no_products": NO_PRODUCTS,
    "no_stores": NO_STORES,
    "no_dequant_no_products": NO_DEQUANT + NO_PRODUCTS,
    "pipeline_only": NO_LOADS + NO_SCALES + NO_DEQUANT + NO_PRODUCTS,
    "pipeline_only_no_stores": (NO_LOADS + NO_SCALES + NO_DEQUANT
                                + NO_PRODUCTS + NO_STORES),
}


# K7 at the SD3 q8_0 x-stream products, K8 at SDXL int8-mode products
W8A8_SHAPES = [("q8_matmul_ws_int8", (8192, 1536, 6144)),
               ("q8_matmul_ws_int8", (8192, 6144, 1536)),
               ("q8_matmul_int8", (8192, 640, 5120)),
               ("q8_matmul_int8", (8192, 640, 640)),
               ("q8_matmul_int8", (2048, 1280, 10240))]
_XI = "          tma_load_2d(smem_u32(sx + slot * kI8X), &x_map, bar, kb * kI8BK, m0);"
_WI = ("          tma_load_2d(smem_u32(sw + slot * C::kW), &w_map, bar, "
       "kb * kI8BK, n0);")
I8_NO_QUANT = [("  quant_rows_kernel<V><<<", "  " + _OFF + "quant_rows_kernel<V><<<")]
I8_NO_LOADS = [(_XI, "          " + _OFF + _XI.strip()),
               (_WI, "          " + _OFF + _WI.strip()),
               ("mbar_expect_tx(bar, kI8X + C::kW);", "mbar_expect_tx(bar, 0);")]
I8_NO_COPIES = [("            cp_async4(smem_u32(sa", "            " + _OFF
                 + "cp_async4(smem_u32(sa"),
                ("              cp_async4(smem_u32(ss", "              " + _OFF
                 + "cp_async4(smem_u32(ss")]
I8_NO_FOLD = [("i8_fold<BLOCK_SCALES>(acc, dot",
               _OFF + "i8_fold<BLOCK_SCALES>(acc, dot")]
I8_NO_PRODUCTS = [("wgmma_i8<BN>(dot, sw128", _OFF + "wgmma_i8<BN>(dot, sw128")]
I8_NO_STORES = [("    if (p.tma_store) {", "    " + _OFF + "{"),
                ("      store_tile(acc, ya, m0 + warp * 16, n0);",
                 "      " + _OFF + "store_tile(acc, ya, m0 + warp * 16, n0);")]
_PIPE = (I8_NO_QUANT + I8_NO_LOADS + I8_NO_FOLD + I8_NO_PRODUCTS
         + I8_NO_STORES)

W8A8_ABLATIONS = {
    "full": [],
    "no_quant_pass": I8_NO_QUANT,
    "no_loads": I8_NO_LOADS,
    "no_amax_scale_copies": I8_NO_COPIES,
    "no_fold": I8_NO_FOLD,
    "no_products": I8_NO_PRODUCTS,
    "no_stores": I8_NO_STORES,
    "no_fold_no_products": I8_NO_FOLD + I8_NO_PRODUCTS,
    "pipeline_only": (I8_NO_QUANT + I8_NO_LOADS + I8_NO_COPIES + I8_NO_FOLD
                      + I8_NO_PRODUCTS),
    "pipeline_only_no_stores": _PIPE + I8_NO_COPIES,
}


# K3 at SD3-medium's joint attention, K1 at SDXL's and SD1.5's largest,
# K2 at the VAE mid-block of SD1.5 (512^2) and of SDXL and SD3 (1024^2)
FLASH_SHAPES = [("flash_attn_joint", (2, 24, 4250, 64)),
                ("flash_attn_fwd", (2, 10, 4096, 64)),
                ("flash_attn_fwd", (2, 20, 1024, 64)),
                ("flash_attn_fwd", (2, 8, 4096, 40)),
                ("flash_attn_fwd_wide", (1, 1, 4096, 512)),
                ("flash_attn_fwd_wide", (1, 1, 16384, 512))]
_K = ("            tma_load_4d(smem_u32(sk + ks * C::kKV + c * C::kKVBox), "
      "&k_map, bar, c * 64, n0, h, b);")
_V = ("            tma_load_4d(smem_u32(sv + vs * C::kKV + c * C::kKVBox), "
      "&v_map, bar, c * 64, n0, h, b);")
FA_NO_LOADS = [(_K, "            if (n < 0) " + _K.strip()),
               (_V, "            if (n < 0) " + _V.strip()),
               ("mbar_expect_tx(bar, C::kKV);", "mbar_expect_tx(bar, 0);")]
FA_NO_EXP = [("float x = ex2(fmaf(s[j][e], sl, -mb[e >> 1]));",
              "float x = fmaf(s[j][e], sl, -mb[e >> 1]);")]
FA_NO_SOFTMAX = [("    softmax_tile<BN, false>(s, sl, 0, m, l, alpha);\n", "")]
FA_NO_QK = [("    wgmma_ss<BN>(s, sw128_desc(",
             "    if (qa == 0xffffffffu) wgmma_ss<BN>(s, sw128_desc(")]
FA_NO_PV = [("wgmma_rs_t<DV>(o, pf[kk],",
             "if (va == 0xffffffffu) wgmma_rs_t<DV>(o, pf[kk],")]
FA_NO_TURNS = [("    mbar_wait(my_turn, tph);\n", ""),
               ("warp_arrive(other_turn);", "(void)other_turn;")]

# K2 (attn_wide_kernel): the same stages, and the two warpgroups' exchange
# of partial logits
W_NO_LOADS = [("tma_load_4d_if(p, dst + c * kWKVBox,",
               "tma_load_4d_if(false, dst + c * kWKVBox,"),
              ("mbar_expect_tx_if(p, bar, 4 * kWKVBox);",
               "mbar_expect_tx_if(p, bar, 0);")]
W_NO_SOFTMAX = [("    softmax_tile<kWBN, false>(s, sl, 0, m, l, alpha);\n", "")]
W_NO_EXCHANGE = [("  wide_exchange(s, x_mine", "  if (n < 0) wide_exchange(s, x_mine")]
W_NO_QK = [("    wgmma_ss<kWBN>(s, sw128_desc(",
            "    if (qa == 0xffffffffu) wgmma_ss<kWBN>(s, sw128_desc(")]
W_NO_PV = [("wgmma_rs_t<128>(o[half], pf[kk],",
            "if (va == 0xffffffffu) wgmma_rs_t<128>(o[half], pf[kk],")]
_SOFTMAX = FA_NO_SOFTMAX + W_NO_SOFTMAX + FA_NO_EXP

FLASH_ABLATIONS = {
    "full": [],
    "no_loads": FA_NO_LOADS + W_NO_LOADS,
    "no_exp": FA_NO_EXP,
    "no_softmax": FA_NO_SOFTMAX + W_NO_SOFTMAX,
    "no_qk": FA_NO_QK + W_NO_QK,
    "no_pv": FA_NO_PV + W_NO_PV,
    "no_products": FA_NO_QK + FA_NO_PV + W_NO_QK + W_NO_PV,
    "no_turns": FA_NO_TURNS,
    "no_exchange": W_NO_EXCHANGE,
    "products_only": _SOFTMAX,
    "products_only_no_loads": _SOFTMAX + FA_NO_LOADS + W_NO_LOADS
                              + W_NO_EXCHANGE,
    "softmax_only": FA_NO_QK + FA_NO_PV + W_NO_QK + W_NO_PV,
    "softmax_only_no_exp": FA_NO_QK + FA_NO_PV + W_NO_QK + W_NO_PV
                           + FA_NO_EXP,
}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ablate: needs a CUDA device", file=sys.stderr)
        return 1
    csrc0 = _build.CSRC
    name0 = "flash_attention" if "--flash" in sys.argv[1:] else "quant_matmul"
    src0 = (_build.CSRC / f"{name0}.cu").read_text()
    if "--flash" in sys.argv[1:]:
        ablations = FLASH_ABLATIONS
        calls = {f"{name}:{'x'.join(map(str, shape))}": (
            getattr(fa, name), testing.attention_inputs(shape, shape[2]))
            for name, shape in FLASH_SHAPES}
    elif "--w8a8" in sys.argv[1:]:
        ablations = W8A8_ABLATIONS
        calls = {f"{name}:{m}x{k}x{n}": (
            getattr(qmm, name),
            testing.int8_inputs(m, k, n) if name == "q8_matmul_ws_int8"
            else testing.quant_inputs(m, k, n, 8))
            for name, (m, k, n) in W8A8_SHAPES}
    elif "--flux" in sys.argv[1:]:
        ablations = ABLATIONS
        calls = {f"{name}:{m}x{k}x{n}": (
            getattr(qmm, name),
            testing.quant_inputs(m, k, n, 4 if name.startswith("q4") else 8))
            for name, (m, k, n) in FLUX_SHAPES}
    else:
        ablations = ABLATIONS
        calls = {f"{m}x{k}x{n}": (qmm.q8_matmul_ws,
                                  testing.quant_inputs(m, k, n, 8))
                 for m, k, n in SHAPES}
    with tempfile.TemporaryDirectory() as tmp:
        only = [a for a in sys.argv[1:] if not a.startswith("--")]
        dirs = {}
        for name, edits in ablations.items():
            if only and name not in only:
                continue
            src = src0
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"{name}: '{old}' is not in the "
                                       "source")
                src = src.replace(old, new)
            csrc = Path(tmp) / name
            csrc.mkdir()
            (csrc / f"{name0}.cu").write_text(src)
            for hdr in csrc0.glob("*.cuh"):   # the shared headers
                (csrc / hdr.name).write_bytes(hdr.read_bytes())
            dirs[name] = csrc
        builds = {}
        for name, csrc in dirs.items():   # every variant's nvcc at once
            _build.CSRC, _build.BUILD_DIR = csrc, csrc / "build"
            out = _build._lib_path(name0)
            out.parent.mkdir(parents=True)
            builds[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                 str(csrc / f"{name0}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        for name, proc in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        for name, csrc in dirs.items():
            _build.CSRC, _build.BUILD_DIR = csrc, csrc / "build"
            _build._LIBS.clear()
            row = {"variant": name}
            for key, (fn, args) in calls.items():
                row[f"{key}_ms"] = testing.median_ms(lambda: fn(*args))
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
