"""Human-comparable tensor statistics (the port's copy of
``mlimgsynth_tpu/utils/tensorstat.py``).

Counterpart of the reference's numeric-observability aid
(reference: src/localtensor.c:98-159): per-tensor stat line
``asum + 8-char segment hash + first`` where the hash encodes the partial
sums of 8 equal segments as base64 characters scaled between the min/max
segment sum — two runs producing the same hash almost certainly computed the
same tensor, and a human can diff the lines at a glance.  The same binning
formula is used so hashes are comparable with reference debug logs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

_B64 = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        "abcdefghijklmnopqrstuvwxyz0123456789+/")


@dataclass
class TensorStats:
    n: int
    first: float
    min: float
    max: float
    asum: float
    hash: str


def tensor_stat(x: np.ndarray) -> TensorStats:
    flat = np.asarray(x, np.float32).reshape(-1)
    n = flat.size
    if n == 0:
        return TensorStats(0, 0.0, 0.0, 0.0, 0.0, "")
    asum = float(np.abs(flat.astype(np.float64)).sum())
    hsep = max(1, n // 8)
    seg_ids = np.minimum(np.arange(n) // hsep, 7)
    hsum = np.zeros(8, np.float64)
    np.add.at(hsum, seg_ids, flat.astype(np.float64))
    h = ""
    if np.isfinite(asum):
        hmn, hmx = hsum.min(), hsum.max()
        f = 63.0 / (hmx - hmn) if hmx > hmn else 0.0
        idx = ((hsum - hmn) * f).astype(np.int64)
        h = "".join(_B64[int(i)] for i in np.clip(idx, 0, 63))
    return TensorStats(n=n, first=float(flat[0]), min=float(flat.min()),
                       max=float(flat.max()), asum=asum, hash=h)


def stat_line(x: Optional[np.ndarray], desc: str = "") -> str:
    """One loggable line matching the reference format:
    ``desc: shape asum hash first``."""
    if x is None or np.size(x) == 0:
        return f"{desc:<8}: empty"
    shape = ",".join(str(s) for s in reversed(np.shape(x)))  # ggml order
    st = tensor_stat(x)
    return (f"{desc:<8}: {shape:<16} {st.asum:.2e} {st.hash} "
            f"{st.first:+.2e}")
