"""Philox4x32-10 counter RNG with Box-Muller normal sampling.

Bit-compatible with the torch-CUDA / A1111 noise path used by the reference
implementation (reference: src/ccommon/rng_philox.c:23-51).  Semantics:

* one *call* to ``randn(n)`` uses counter ``[offset, 0, i, 0]`` for element
  ``i`` and key = (seed_lo, seed_hi); after the call ``offset`` increments by
  exactly one, regardless of ``n``.
* the normal variate for element ``i`` is produced from the first two words of
  the 10-round Philox output via Box-Muller in float64:
  ``sqrt(-2 ln u) * sin(v)`` with ``u=(c0+0.5)/2^32``, ``v=2pi*(c1+0.5)/2^32``.

Vectorized numpy (float64 Box-Muller for exact parity).  The port's own copy
of ``mlimgsynth_tpu/rng.py``, kept identical in behaviour.
"""
from __future__ import annotations

import numpy as np

PHILOX_M0 = np.uint64(0xD2511F53)
PHILOX_M1 = np.uint64(0xCD9E8D57)
PHILOX_W0 = np.uint32(0x9E3779B9)
PHILOX_W1 = np.uint32(0xBB67AE85)

_TWO_POW32_INV = 2.3283064365386963e-10  # 1/2^32
_TWO_POW32_INV_2PI = 1.4629180792671596e-09  # 2pi/2^32

_U32 = np.uint32
_U64 = np.uint64


def philox4x32_10(cnt0, cnt1, cnt2, cnt3, key0, key1):
    """Run 10 Philox rounds over vectors of uint32 counters. Returns 4 words."""
    c0 = np.asarray(cnt0, dtype=_U32).copy()
    c1 = np.asarray(cnt1, dtype=_U32).copy()
    c2 = np.asarray(cnt2, dtype=_U32).copy()
    c3 = np.asarray(cnt3, dtype=_U32).copy()
    k0 = _U32(key0)
    k1 = _U32(key1)
    for _ in range(10):
        v1 = c0.astype(_U64) * PHILOX_M0
        v2 = c2.astype(_U64) * PHILOX_M1
        n0 = (v2 >> _U64(32)).astype(_U32) ^ c1 ^ k0
        n1 = v2.astype(_U32)
        n2 = (v1 >> _U64(32)).astype(_U32) ^ c3 ^ k1
        n3 = v1.astype(_U32)
        c0, c1, c2, c3 = n0, n1, n2, n3
        k0 = _U32((int(k0) + int(PHILOX_W0)) & 0xFFFFFFFF)
        k1 = _U32((int(k1) + int(PHILOX_W1)) & 0xFFFFFFFF)
    return c0, c1, c2, c3


def _box_muller(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    u = (x.astype(np.float64) + 0.5) * _TWO_POW32_INV
    v = (y.astype(np.float64) + 0.5) * _TWO_POW32_INV_2PI
    return (np.sqrt(-2.0 * np.log(u)) * np.sin(v)).astype(np.float32)


def philox_randn(seed: int, offset: int, n: int) -> np.ndarray:
    """Generate ``n`` normal variates for a single (seed, offset) call."""
    i = np.arange(n, dtype=np.uint32)
    zeros = np.zeros(n, dtype=_U32)
    seed = np.uint64(seed)
    c0, c1, _, _ = philox4x32_10(
        np.full(n, _U32(offset & 0xFFFFFFFF)), zeros, i, zeros,
        _U32(seed & _U64(0xFFFFFFFF)), _U32(seed >> _U64(32)))
    return _box_muller(c0, c1)


class RngPhilox:
    """Stateful RNG matching the reference's ``RngPhilox`` struct."""

    def __init__(self, seed: int = 0, offset: int = 0):
        self.seed = int(seed)
        self.offset = int(offset)

    def randn(self, n: int) -> np.ndarray:
        out = philox_randn(self.seed, self.offset, int(n))
        self.offset += 1
        return out

    def randn_shaped(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        return self.randn(n).reshape(shape)
