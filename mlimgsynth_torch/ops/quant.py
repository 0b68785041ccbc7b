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
``x.dtype``, one product in ``x.dtype`` summed in f32 and rounded once:
cuBLAS's reduction in bf16 is disallowed for the call, and a product of
fewer than 64 rows on the card is padded to 64 with zero rows, so that
cuBLAS sums over K in the kernels' order).  ``q8_ws_int8_plain`` is the plain
version of the W8A8 kernel on per-column weights (``q8_ws_int8_xla``).
``q8_matmul_int8_plain`` is the plain version of the W8A8 kernel on per-block
weights (``q8_matmul_int8_xla``, the ``MLIS_Q8_MODE=int8`` route).
``PLAIN_CUDA_CALLS`` counts their calls on CUDA tensors (a comparison with a
kernel makes them; the main path never does).

Per-column storage (the DiT families' int8 weight-stationary route):
``percol_from_blocks`` turns a stored per-block pair into int8 [N, K] with
f32 scales [N], as ``mlimgsynth_tpu/ops/q8_matmul.py:347-374`` does.

The session quantizes with the torch versions (``quantize_weight_torch``,
``quantize_weight_q4_torch``, ``percol_from_blocks_torch``), on whatever
device the weight lies: on a card, a weight read there is quantized there.
They do the numpy versions' arithmetic and give their values bit for bit:
``amax / 127`` as a true division (a Python-number divisor would make
CUDA multiply by its reciprocal), the ``1e-30`` floor, ``round`` half to
even, and numpy's median of an even count (the mean of the two middle
values, where ``torch.median`` takes the lower one).
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


def _block_quant(w: torch.Tensor, qmax: float):
    """[N, K] float -> (integer-valued f32 [N, K/128, 128], f32 scales
    [N, K/128, 1]): ``amax / qmax`` per 128-deep group, the values rounded
    half to even and clipped to +-qmax."""
    n, k = w.shape
    assert k % KBLOCK == 0, (n, k)
    wb = w.float().reshape(n, k // KBLOCK, KBLOCK)
    amax = wb.abs().amax(dim=2, keepdim=True)
    scale = amax / torch.full_like(amax, qmax)
    q = torch.round(wb / scale.clamp_min(1e-30)).clamp_(-qmax, qmax)
    return q, scale


def quantize_weight_torch(w: torch.Tensor):
    """:func:`quantize_weight` on a tensor, on its device: [N, K] float ->
    (int8 [N, K], f32 scales [N, K/128])."""
    q, scale = _block_quant(w, 127.0)
    n, k = w.shape
    return q.to(torch.int8).reshape(n, k), scale.reshape(n, k // KBLOCK)


def quantize_weight_q4_torch(w: torch.Tensor):
    """:func:`quantize_weight_q4` on a tensor, on its device: [N, K] float
    -> (packed int8 [N, K/2], f32 scales [N, K/128])."""
    q, scale = _block_quant(w, 7.0)
    q = q.to(torch.int8)
    n, k = w.shape
    packed = (q[:, :, :HALF] & 0x0F) | (q[:, :, HALF:] << 4)
    return packed.reshape(n, k // 2), scale.reshape(n, k // KBLOCK)


def unpack_q4(packed: torch.Tensor) -> torch.Tensor:
    """Packed [N, K/2] -> int32 [N, K] in group-row order."""
    n, k2 = packed.shape
    pb = packed.reshape(n, k2 // HALF, HALF).to(torch.int32)
    lo = ((pb & 15) ^ 8) - 8
    hi = pb >> 4
    return torch.cat([lo, hi], dim=2).reshape(n, 2 * k2)


# the fewest rows of x the plain weight-only product hands to cuBLAS on the
# card (see ``_dequant_matmul``)
PAD_ROWS = 64


def _dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1
    n, k = q.shape
    w = (q.float().reshape(n, k // KBLOCK, KBLOCK)
         * scale.float()[:, :, None]).reshape(n, k)
    # One product summed in f32 and rounded once to x.dtype, as
    # q8_matmul_xla accumulates.  PyTorch lets cuBLAS reduce a bf16 or f16
    # product in that type (at N = 100 it does: one bf16 step off in 40% of
    # the outputs), so that is disallowed for the call.
    # Below PAD_ROWS rows cuBLAS may pick another reduction than the
    # kernels' single pass over K in order (at (1, 3072, 3072), Flux's
    # embedders, 4 of 3,072 outputs one bf16 step off), so such a product
    # on the card runs padded with zero rows, where it picks theirs.
    rows = x.numel() // k
    pad = x.is_cuda and 0 < rows < PAD_ROWS
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_bf16_reduced_precision_reduction,
             flags.allow_fp16_reduced_precision_reduction)
    flags.allow_bf16_reduced_precision_reduction = False
    flags.allow_fp16_reduced_precision_reduction = False
    try:
        if not pad:
            return torch.matmul(x, w.to(x.dtype).t())
        xp = x.new_zeros(PAD_ROWS, k)
        xp[:rows] = x.reshape(rows, k)
        y = torch.matmul(xp, w.to(x.dtype).t())[:rows]
        return y.reshape(x.shape[:-1] + (n,))
    finally:
        (flags.allow_bf16_reduced_precision_reduction,
         flags.allow_fp16_reduced_precision_reduction) = saved


def q8_matmul_plain(x, w_q8, w_scale):
    """x [..., K] . deq(w_q8 [N, K], w_scale [N, K/128])^T -> [..., N] in
    x.dtype."""
    return _dequant_matmul(x, w_q8, w_scale)


def q4_matmul_plain(x, w_q4, w_scale):
    """As :func:`q8_matmul_plain` with packed q4 weights [N, K/2]."""
    return _dequant_matmul(x, unpack_q4(w_q4), w_scale)


def percol_from_blocks(q: np.ndarray, s_block: np.ndarray):
    """A per-block q8 pair (int8 [N, K], f32 [N, K/128]) -> (int8 [N, K],
    f32 scales [N], scale_ratio), bit for bit the JAX package's
    ``percol_from_blocks`` (``q8_matmul.py:347-374``) on the transposes.
    ``scale_ratio`` is the worst column's ``s_col / median block scale``:
    how many per-block steps one per-column step swallows for the column's
    typical block (``PERCOL_MAX_SCALE_RATIO`` bounds it)."""
    n, k = q.shape
    w = (q.astype(np.float32).reshape(n, k // KBLOCK, KBLOCK)
         * s_block[:, :, None]).reshape(n, k)
    amax = np.abs(w).max(axis=1)
    s_col = (amax / 127.0).astype(np.float32)
    q2 = np.clip(np.round(w / np.maximum(s_col, 1e-30)[:, None]), -127, 127)
    med = np.maximum(np.median(s_block, axis=1), 1e-30)
    ratio = float(np.max(s_col / med))
    return q2.astype(np.int8), s_col, ratio


def percol_from_blocks_torch(q: torch.Tensor, s_block: torch.Tensor):
    """:func:`percol_from_blocks` on tensors, on their device: (int8 [N,
    K], f32 [N, K/128]) -> (int8 [N, K], f32 [N], scale_ratio)."""
    n, k = q.shape
    w = (q.float().reshape(n, k // KBLOCK, KBLOCK)
         * s_block[:, :, None]).reshape(n, k)
    amax = w.abs().amax(dim=1)
    s_col = amax / torch.full_like(amax, 127.0)
    q2 = torch.round(w / s_col.clamp_min(1e-30)[:, None]).clamp_(-127, 127)
    srt = s_block.sort(dim=1).values
    nb = srt.shape[1]
    # np.median: the middle value, or the f32 mean of the two middle ones
    med = (srt[:, nb // 2] if nb % 2 else
           (srt[:, nb // 2 - 1] + srt[:, nb // 2]) / torch.full_like(
               srt[:, 0], 2.0))
    ratio = float((s_col / med.clamp_min(1e-30)).max())
    return q2.to(torch.int8), s_col, ratio


# worst-column s_col / median block scale allowed before a weight stays
# per-block (the bits lost on the column's typical block: 8 -> 3)
PERCOL_MAX_SCALE_RATIO = 8.0


def _ws_slab(k: int):
    """The K slab of the W8A8 kernel's per-token activation scales
    (``q8_matmul.py:427-430``): 1024, 512 or 256 where it divides K, else K
    up to 4096, else None."""
    cands = [c for c in (1024, 512, 256) if k % c == 0]
    return cands[0] if cands else (k if k <= 4096 else None)


def quantize_slabs(x, slab: int):
    """x [..., K] -> (xq [M, K/slab, slab], amax [M, K/slab, 1]): the
    per-(row, slab) int8 activations, as integer-valued f32, and their
    amax; ``inv = 127 / amax`` (0 where amax is 0), ``round`` half to
    even."""
    x2 = x.reshape(-1, x.shape[-1] // slab, slab).float()
    amax = x2.abs().amax(dim=2, keepdim=True)
    # a true division: ``127.0 / amax`` would take the reciprocal and then
    # multiply, which rounds twice
    inv = torch.where(amax > 0, amax.new_tensor(127.0) / amax,
                      torch.zeros_like(amax))
    return torch.round(x2 * inv), amax


def q8_ws_int8_plain(x, w_q8, s_col, slab=None):
    """x [..., K] . (w_q8 [N, K] int8 per column, s_col [N] f32) -> [..., N]
    in x.dtype, the function of ``q8_ws_int8_xla`` (``q8_matmul.py:
    487-501``): per (row, slab) amax in f32, ``inv = 127 / amax`` (0 where
    amax is 0), ``round(x * inv)`` half to even; the integer product of each
    slab; ``* amax / 127``; the slabs added in slab order; ``* s_col``.

    The integer product runs as a float matmul of the int8-valued operands:
    exact in f32 while 127^2 * slab < 2^24 (slab <= 1040), else in f64
    (there is no int32 matmul on CUDA)."""
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1
    n, k = w_q8.shape
    slab = slab or _ws_slab(k)
    nb = k // slab
    ct = torch.float32 if 127 * 127 * slab < 2 ** 24 else torch.float64
    xq, amax = quantize_slabs(x, slab)
    xq = xq.to(ct)
    wq = w_q8.reshape(n, nb, slab).to(ct)
    sx = amax[:, :, 0] * (1.0 / 127.0)
    acc = None
    for b in range(nb):
        part = torch.matmul(xq[:, b], wq[:, b].t()).float() * sx[:, b, None]
        acc = part if acc is None else acc + part
    out = acc * s_col.float()[None, :]
    return out.to(x.dtype).reshape(x.shape[:-1] + (n,))


def q8_matmul_int8_plain(x, w_q8, w_scale):
    """x [..., K] . (w_q8 [N, K] int8, w_scale [N, K/128] f32)^T with the
    activations quantized per (row, 128-deep K block) -> [..., N] in
    x.dtype, the function of ``q8_matmul_int8_xla`` (``q8_matmul.py:
    590-602``): :func:`quantize_slabs` at slab 128; the integer product of
    each block; ``(part * (amax * (1/127))) * w_scale`` in that
    association; the blocks added in block order.

    The integer products run as one batched f32 matmul of the int8-valued
    operands, exact since 127^2 * 128 < 2^24."""
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1
    n, k = w_q8.shape
    nb = k // KBLOCK
    xq, amax = quantize_slabs(x, KBLOCK)               # [M, nb, 128]
    wq = w_q8.reshape(n, nb, KBLOCK).float()
    parts = torch.bmm(xq.transpose(0, 1), wq.permute(1, 2, 0))  # [nb, M, N]
    parts = (parts * (amax * (1.0 / 127.0)).transpose(0, 1)
             * w_scale.float().t()[:, None, :])
    acc = parts[0]
    for b in range(1, nb):
        acc = acc + parts[b]
    return acc.to(x.dtype).reshape(x.shape[:-1] + (n,))
