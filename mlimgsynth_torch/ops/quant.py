"""Weight-only quantization: the numpy quantizers and the plain PyTorch
dequantize-and-multiply.

The quantizers are the port's copies of ``quantize_weight``
(``mlimgsynth_tpu/ops/q8_matmul.py:25-37``) and ``quantize_weight_q4``
(``mlimgsynth_tpu/ops/q4_matmul.py:36-48``), with the same arithmetic, so
they give the same int8 values and f32 scales bit for bit.  They keep
nn.Linear's orientation: a weight [N, K] becomes int8 [N, K] (q8) or packed
int8 [N, K/2] (q4), with f32 scales [N, K/128] (the JAX package holds the
transposes).  Symmetric per (128-row K group, output column) scales:
``amax / 127`` (q8) or ``amax / 7`` (q4).  q4 packs each 128-wide group of a
row into 64 bytes: byte j holds group row j in its low nibble and group row
j + 64 in its high nibble.

``q8_matmul_plain`` / ``q4_matmul_plain`` are the plain versions of the CUDA
kernels in ``ops/quant_matmul.py``: the function of the JAX package's
``q8_matmul_xla`` / ``q4_matmul_xla`` (dequantize in f32, round the weight to
``x.dtype``, one product in ``x.dtype``).  ``PLAIN_CUDA_CALLS`` counts their
calls on CUDA tensors (a comparison with a kernel makes them; the main path
never does).
"""
from __future__ import annotations

import numpy as np
import torch

KBLOCK = 128
HALF = KBLOCK // 2

PLAIN_CUDA_CALLS = 0


def quantize_weight(w: np.ndarray):
    """[N, K] float -> (int8 [N, K], f32 scales [N, K/128])."""
    n, k = w.shape
    assert k % KBLOCK == 0, (n, k)
    wb = np.asarray(w, np.float32).reshape(n, k // KBLOCK, KBLOCK)
    amax = np.abs(wb).max(axis=2, keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(wb / np.maximum(scale, 1e-30)), -127, 127)
    return (q.astype(np.int8).reshape(n, k),
            scale.reshape(n, k // KBLOCK))


def quantize_weight_q4(w: np.ndarray):
    """[N, K] float -> (packed int8 [N, K/2], f32 scales [N, K/128])."""
    n, k = w.shape
    assert k % KBLOCK == 0, (n, k)
    wb = np.asarray(w, np.float32).reshape(n, k // KBLOCK, KBLOCK)
    amax = np.abs(wb).max(axis=2, keepdims=True)
    scale = (amax / 7.0).astype(np.float32)
    q = np.clip(np.round(wb / np.maximum(scale, 1e-30)), -7, 7
                ).astype(np.int8)
    lo = q[:, :, :HALF] & 0x0F                    # group rows 0..63
    hi = q[:, :, HALF:] << 4                      # group rows 64..127
    packed = (lo | hi).astype(np.int8).reshape(n, k // 2)
    return packed, scale.reshape(n, k // KBLOCK)


def unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """Packed [N, K/2] -> int32 [N, K] in group-row order."""
    n, k2 = packed.shape
    pb = packed.reshape(n, k2 // HALF, HALF).to(torch.int32)
    lo = ((pb & 15) ^ 8) - 8
    hi = pb >> 4
    return torch.cat([lo, hi], dim=2).reshape(n, 2 * k2)


def _dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1
    n, k = q.shape
    w = (q.float().reshape(n, k // KBLOCK, KBLOCK)
         * scale.float()[:, :, None]).reshape(n, k)
    return torch.matmul(x, w.to(x.dtype).t())


def q8_matmul_plain(x, w_q8, w_scale):
    """x [..., K] . deq(w_q8 [N, K], w_scale [N, K/128])^T -> [..., N] in
    x.dtype."""
    return _dequant_matmul(x, w_q8, w_scale)


def q4_matmul_plain(x, w_q4, w_scale):
    """As :func:`q8_matmul_plain` with packed q4 weights [N, K/2]."""
    return _dequant_matmul(x, unpack_q4(w_q4), w_scale)
