"""GGML block-quantization codecs in vectorized numpy.

Implements the quantized dtypes the reference supports for checkpoint loading
(reference: src/ccompute/tensorstore.c:81-96): q8_0, q4_1 (32-element blocks)
and the K-quants q4_K, q5_K, q6_K (256-element super-blocks).  Dequantization
follows ggml's reference layouts bit-for-bit; quantization is provided for
q8_0/q4_1 (used by the tstore-util convert equivalent).
"""
from __future__ import annotations

import numpy as np

QK = 32      # simple quant block size
QK_K = 256   # K-quant super-block size

# bytes per block
BLOCK_SIZES = {
    "q8_0": 2 + QK,            # f16 d + 32 x i8
    "q4_1": 2 + 2 + QK // 2,   # f16 d + f16 m + 16B nibbles
    "q4_k": 2 + 2 + 12 + QK_K // 2,            # 144
    "q5_k": 2 + 2 + 12 + QK_K // 8 + QK_K // 2,  # 176
    "q6_k": QK_K // 2 + QK_K // 4 + QK_K // 16 + 2,  # 210
}
BLOCK_ELEMS = {"q8_0": QK, "q4_1": QK, "q4_k": QK_K, "q5_k": QK_K,
               "q6_k": QK_K}


def nbytes(dtype: str, n_elem: int) -> int:
    bs, be = BLOCK_SIZES[dtype], BLOCK_ELEMS[dtype]
    assert n_elem % be == 0, (dtype, n_elem)
    return n_elem // be * bs


def _f16(buf: np.ndarray) -> np.ndarray:
    return buf.view(np.float16).astype(np.float32)


def dequant_q8_0(raw: np.ndarray, n_elem: int) -> np.ndarray:
    blocks = raw.reshape(-1, 2 + QK)
    d = _f16(blocks[:, 0:2].copy())[:, 0:1]
    qs = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (d * qs).reshape(-1)[:n_elem]


def quant_q8_0(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32).reshape(-1, QK)
    amax = np.abs(x).max(axis=1, keepdims=True)
    d = amax / 127.0
    inv = np.where(d > 0, 1.0 / np.maximum(d, 1e-30), 0.0)
    qs = np.round(x * inv).astype(np.int8)
    out = np.empty((x.shape[0], 2 + QK), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8)
    out[:, 2:] = qs.view(np.uint8)
    return out.reshape(-1)


def dequant_q4_1(raw: np.ndarray, n_elem: int) -> np.ndarray:
    blocks = raw.reshape(-1, 20)
    d = _f16(blocks[:, 0:2].copy())[:, 0:1]
    m = _f16(blocks[:, 2:4].copy())[:, 0:1]
    qs = blocks[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    out = np.empty((blocks.shape[0], QK), np.float32)
    out[:, :16] = d * lo + m
    out[:, 16:] = d * hi + m
    return out.reshape(-1)[:n_elem]


def quant_q4_1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32).reshape(-1, QK)
    mn = x.min(axis=1, keepdims=True)
    mx = x.max(axis=1, keepdims=True)
    d = (mx - mn) / 15.0
    inv = np.where(d > 0, 1.0 / np.maximum(d, 1e-30), 0.0)
    q = np.clip(np.round((x - mn) * inv), 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 20), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16).view(np.uint8)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def _scale_min_k4(scales: np.ndarray):
    """Unpack the 12-byte 6-bit scale/min table of q4_K/q5_K into 8 pairs."""
    sc = np.empty(scales.shape[:-1] + (8,), np.float32)
    mn = np.empty_like(sc)
    s = scales.astype(np.uint16)
    for j in range(4):
        sc[..., j] = (s[..., j] & 63).astype(np.float32)
        mn[..., j] = (s[..., j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[..., j] = ((s[..., j + 4] & 0x0F) | ((s[..., j - 4] >> 6) << 4)
                      ).astype(np.float32)
        mn[..., j] = ((s[..., j + 4] >> 4) | ((s[..., j] >> 6) << 4)
                      ).astype(np.float32)
    return sc, mn


def dequant_q4_k(raw: np.ndarray, n_elem: int) -> np.ndarray:
    blocks = raw.reshape(-1, 144)
    d = _f16(blocks[:, 0:2].copy())[:, 0]
    dmin = _f16(blocks[:, 2:4].copy())[:, 0]
    sc, mn = _scale_min_k4(blocks[:, 4:16])
    qs = blocks[:, 16:]  # [nb, 128]
    out = np.empty((blocks.shape[0], QK_K), np.float32)
    for j in range(4):  # 64-element groups
        q = qs[:, j * 32:(j + 1) * 32]
        d1 = d * sc[:, 2 * j]
        m1 = dmin * mn[:, 2 * j]
        d2 = d * sc[:, 2 * j + 1]
        m2 = dmin * mn[:, 2 * j + 1]
        out[:, j * 64:j * 64 + 32] = d1[:, None] * (q & 0xF) - m1[:, None]
        out[:, j * 64 + 32:j * 64 + 64] = d2[:, None] * (q >> 4) - m2[:, None]
    return out.reshape(-1)[:n_elem]


def dequant_q5_k(raw: np.ndarray, n_elem: int) -> np.ndarray:
    blocks = raw.reshape(-1, 176)
    d = _f16(blocks[:, 0:2].copy())[:, 0]
    dmin = _f16(blocks[:, 2:4].copy())[:, 0]
    sc, mn = _scale_min_k4(blocks[:, 4:16])
    qh = blocks[:, 16:48]   # [nb, 32]
    qs = blocks[:, 48:]     # [nb, 128]
    out = np.empty((blocks.shape[0], QK_K), np.float32)
    u1, u2 = 1, 2
    for j in range(4):
        q = qs[:, j * 32:(j + 1) * 32]
        d1 = (d * sc[:, 2 * j])[:, None]
        m1 = (dmin * mn[:, 2 * j])[:, None]
        d2 = (d * sc[:, 2 * j + 1])[:, None]
        m2 = (dmin * mn[:, 2 * j + 1])[:, None]
        hi1 = ((qh & u1) != 0).astype(np.float32) * 16.0
        hi2 = ((qh & u2) != 0).astype(np.float32) * 16.0
        out[:, j * 64:j * 64 + 32] = d1 * ((q & 0xF) + hi1) - m1
        out[:, j * 64 + 32:j * 64 + 64] = d2 * ((q >> 4) + hi2) - m2
        u1 <<= 2
        u2 <<= 2
    return out.reshape(-1)[:n_elem]


def dequant_q6_k(raw: np.ndarray, n_elem: int) -> np.ndarray:
    blocks = raw.reshape(-1, 210)
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    scales = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(blocks[:, 208:210].copy())[:, 0:1]
    out = np.empty((blocks.shape[0], QK_K), np.float32)
    for n in range(2):  # 128-element halves
        lql = ql[:, n * 64:n * 64 + 64]
        lqh = qh[:, n * 32:n * 32 + 32]
        sc = scales[:, n * 8:n * 8 + 8]
        l = np.arange(32)
        is_ = l // 16  # 0 or 1
        q1 = ((lql[:, 0:32] & 0xF) | (((lqh >> 0) & 3) << 4)).astype(np.int8) - 32
        q2 = ((lql[:, 32:64] & 0xF) | (((lqh >> 2) & 3) << 4)).astype(np.int8) - 32
        q3 = ((lql[:, 0:32] >> 4) | (((lqh >> 4) & 3) << 4)).astype(np.int8) - 32
        q4 = ((lql[:, 32:64] >> 4) | (((lqh >> 6) & 3) << 4)).astype(np.int8) - 32
        base = n * 128
        out[:, base + 0:base + 32] = d * sc[:, is_ + 0] * q1
        out[:, base + 32:base + 64] = d * sc[:, is_ + 2] * q2
        out[:, base + 64:base + 96] = d * sc[:, is_ + 4] * q3
        out[:, base + 96:base + 128] = d * sc[:, is_ + 6] * q4
    return out.reshape(-1)[:n_elem]


# ---------------------------------------------------------------------------
# K-quant encoders.  Layouts are the exact inverses of the bit-exact
# dequantizers above (so ggml can read the output); the scale search is a
# simple affine/absmax fit rather than ggml's iterative RMSE refinement —
# valid encodings, slightly higher quantization error than ggml's
# (reference converter: src/main_tstore_util.c:141-199 via ggml).
# ---------------------------------------------------------------------------

def _pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _scale_min_k4: 8 x 6-bit (sc, mn) pairs -> 12 bytes."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.empty(sc.shape[:-1] + (12,), np.uint8)
    for j in range(4):
        out[..., j] = (sc[..., j] & 63) | (((sc[..., j + 4] >> 4) & 3) << 6)
        out[..., j + 4] = (mn[..., j] & 63) | (((mn[..., j + 4] >> 4) & 3)
                                               << 6)
        out[..., j + 8] = (sc[..., j + 4] & 0xF) | ((mn[..., j + 4] & 0xF)
                                                    << 4)
    return out


def _affine_k_scales(x: np.ndarray, qmax: int):
    """Per-32-element affine fit for q4_K/q5_K: x ~ (d*sc)*q - (dmin*mn).
    x: [nb, 8, 32].  Returns (d, dmin, sc6, mn6, q)."""
    m = np.maximum(0.0, -x.min(axis=2))            # [nb, 8] >= 0
    scale = (x.max(axis=2) + m) / qmax             # [nb, 8] >= 0
    d = scale.max(axis=1, keepdims=True) / 63.0    # [nb, 1]
    dmin = m.max(axis=1, keepdims=True) / 63.0
    sc6 = np.clip(np.round(np.divide(
        scale, d, out=np.zeros_like(scale), where=d > 0)), 0, 63)
    mn6 = np.clip(np.round(np.divide(
        m, dmin, out=np.zeros_like(m), where=dmin > 0)), 0, 63)
    eff_d = d * sc6                                 # [nb, 8]
    eff_m = dmin * mn6
    q = np.clip(np.round(np.divide(
        x + eff_m[:, :, None], eff_d[:, :, None],
        out=np.zeros_like(x), where=eff_d[:, :, None] > 0)), 0, qmax)
    return d[:, 0], dmin[:, 0], sc6, mn6, q.astype(np.uint8)


def quant_q4_k(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32).reshape(-1, 8, 32)
    nb = x.shape[0]
    d, dmin, sc6, mn6, q = _affine_k_scales(x, 15)
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:16] = _pack_scale_min_k4(sc6, mn6)
    qq = q.reshape(nb, 4, 64)  # 64-element groups: lo nibble then hi nibble
    out[:, 16:] = (qq[:, :, :32] | (qq[:, :, 32:] << 4)).reshape(nb, 128)
    return out.reshape(-1)


def quant_q5_k(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32).reshape(-1, 8, 32)
    nb = x.shape[0]
    d, dmin, sc6, mn6, q = _affine_k_scales(x, 31)
    out = np.empty((nb, 176), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:16] = _pack_scale_min_k4(sc6, mn6)
    qq = q.reshape(nb, 4, 64)
    qh = np.zeros((nb, 32), np.uint8)
    for j in range(4):
        qh |= ((qq[:, j, :32] >> 4) & 1) << (2 * j)
        qh |= ((qq[:, j, 32:] >> 4) & 1) << (2 * j + 1)
    out[:, 16:48] = qh
    out[:, 48:] = ((qq[:, :, :32] & 0xF) |
                   ((qq[:, :, 32:] & 0xF) << 4)).reshape(nb, 128)
    return out.reshape(-1)


def quant_q6_k(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32).reshape(-1, 16, 16)  # 16 groups of 16
    nb = x.shape[0]
    amax = np.abs(x).max(axis=2)                  # [nb, 16]
    s = amax / 31.0                               # symmetric per-16 scale
    d = s.max(axis=1, keepdims=True) / 127.0      # [nb, 1]
    sc = np.clip(np.round(np.divide(
        s, d, out=np.zeros_like(s), where=d > 0)), -128, 127)
    eff = d * sc                                  # [nb, 16]
    q = np.clip(np.round(np.divide(
        x, eff[:, :, None], out=np.zeros_like(x),
        where=eff[:, :, None] != 0)), -32, 31) + 32
    q = q.astype(np.uint8).reshape(nb, QK_K)
    out = np.empty((nb, 210), np.uint8)
    for n in range(2):  # 128-element halves
        base = n * 128
        q1 = q[:, base:base + 32]
        q2 = q[:, base + 32:base + 64]
        q3 = q[:, base + 64:base + 96]
        q4 = q[:, base + 96:base + 128]
        out[:, n * 64:n * 64 + 32] = (q1 & 0xF) | ((q3 & 0xF) << 4)
        out[:, n * 64 + 32:n * 64 + 64] = (q2 & 0xF) | ((q4 & 0xF) << 4)
        out[:, 128 + n * 32:128 + n * 32 + 32] = (
            (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6))
    out[:, 192:208] = sc.astype(np.int8).view(np.uint8)
    out[:, 208:210] = d[:, 0].astype(np.float16)[:, None].view(np.uint8)
    return out.reshape(-1)


DEQUANT = {
    "q8_0": dequant_q8_0,
    "q4_1": dequant_q4_1,
    "q4_k": dequant_q4_k,
    "q5_k": dequant_q5_k,
    "q6_k": dequant_q6_k,
}

QUANT = {
    "q8_0": quant_q8_0,
    "q4_1": quant_q4_1,
    "q4_k": quant_q4_k,
    "q5_k": quant_q5_k,
    "q6_k": quant_q6_k,
}
