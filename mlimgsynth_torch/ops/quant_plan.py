"""The JAX package's storage and dispatch decisions for 8-bit weights on
the DiT families, copied so that the port makes the same ones.

``_plan_ws``, ``_plan_rs``, ``percol_eligible``, ``dit_m_hint`` and the auto
branch of ``pick_large_m_plan`` follow ``mlimgsynth_tpu/ops/q8_matmul.py``
(``:153-264``, ``:377-424``, ``:623-659``) without their ``MLIS_Q8_*``
knobs.  They are pure arithmetic on the TPU v5e's cost model (its VMEM
budget, HBM rate and MXU rate) and plan nothing on the card.  The port keeps
them only because they decide which weights are stored per column
(``percol_eligible``, at load) and which products then run the W8A8 kernel
(``pick_large_m_plan`` choosing ``"int8ws"``); both choices change the
numbers, so a port that re-derived them would leave the reference.
"""
from __future__ import annotations

KBLOCK = 128
# the large-M floor below which no weight-stationary plan is made
WS_MIN_M = 2048

_WS_BUDGET = 14 << 20          # scoped-VMEM budget of one TPU kernel
_WS_FLOP_PER_BYTE = 243.0      # v5e: MXU flop per HBM byte
_INT8_MXU_GAIN = 2.0           # v5e int8 MXU rate over bf16
_INT8_QUANT_EQ = 1.0           # activation quantization, bytes-equivalent


def _plan_ws(m, k, n, xb, ob, w_bytes=1.0, temp_bytes=2, int8=False):
    """(bm, bn, slab, score) of the weight-stationary grid, or None when no
    geometry fits the VMEM budget (``q8_matmul.py:153-212``)."""
    cands = [c for c in (1024, 512, 256) if k % c == 0]
    slab = cands[0] if cands else (k if k <= 4096 else None)
    if slab is None or k % KBLOCK:
        return None
    g = k // KBLOCK
    best = None
    for bnb in range(1, min((n + KBLOCK - 1) // KBLOCK, 16) + 1):
        bn = bnb * KBLOCK
        stripes = -(-n // bn)
        for bm in (512, 256, 128, 64):
            use = (2 * k * bn * w_bytes
                   + 2 * bm * k * xb
                   + 2 * g * 8 * bn * 4
                   + 2 * bm * bn * ob
                   + bm * bn * 4
                   + slab * bn * temp_bytes)
            if use > _WS_BUDGET:
                continue
            n_pad = stripes * bn
            mem = (m * k * xb * stripes
                   + k * n_pad * w_bytes
                   + m * n * ob)
            mxu = (2.0 * m * k * n_pad / _WS_FLOP_PER_BYTE
                   / (min(bm, 128) / 128.0))
            if int8:
                mxu /= _INT8_MXU_GAIN
                mem += m * k * stripes * _INT8_QUANT_EQ
            score = mem + mxu
            if best is None or score < best[0]:
                best = (score, bm, bn)
            break
    if best is None:
        return None
    return best[1], best[2], slab, best[0]


def _plan_rs(m, k, n, xb, ob, w_bytes=1.0, temp_bytes=2):
    """(bm, kb, score) of the row-sweep grid, or None
    (``q8_matmul.py:215-264``)."""
    if k % KBLOCK or n % KBLOCK:
        return None
    kb_cands = [c for c in (1024, 512, 256, 128) if k % c == 0]
    if k <= 2048:
        kb_cands.insert(0, k)
    best = None
    for kb in kb_cands:
        g = kb // KBLOCK
        for bm in (512, 256, 128, 64):
            use = (2 * bm * kb * xb
                   + 2 * kb * n * w_bytes
                   + 2 * g * 8 * n * 4
                   + 2 * bm * n * ob
                   + bm * n * 4
                   + kb * n * temp_bytes)
            if use > _WS_BUDGET:
                continue
            m_blocks = -(-m // bm)
            mem = (m * k * xb
                   + m_blocks * k * n * w_bytes
                   + m * n * ob)
            mxu = (2.0 * m * k * n / _WS_FLOP_PER_BYTE
                   / (min(bm, 128) / 128.0))
            score = mem + mxu
            if best is None or score < best[0]:
                best = (score, bm, kb)
            break
    if best is None:
        return None
    return best[1], best[2], best[0]


def dit_m_hint(height: int, width: int, *, flux: bool = False,
               ctx_rows: int = 256) -> int:
    """The token count the storage decision assumes
    (``q8_matmul.py:377-391``): the image tokens plus ``ctx_rows`` text
    rows, doubled for the CFG batch (Flux runs one evaluation a step)."""
    tokens = (height // 16) * (width // 16) + ctx_rows
    return tokens if flux else 2 * tokens


def percol_eligible(k, n, m_hint=8192, itemsize=2) -> bool:
    """Store this [K, N] linear per column (a W8A8 candidate) rather than
    per block? (``q8_matmul.py:400-424``, auto mode.)"""
    if k % KBLOCK or n % KBLOCK or m_hint < WS_MIN_M:
        return False
    i8 = _plan_ws(m_hint, k, n, itemsize, itemsize, temp_bytes=6, int8=True)
    if i8 is None:
        return False
    wsp = _plan_ws(m_hint, k, n, itemsize, itemsize)
    rsp = _plan_rs(m_hint, k, n, itemsize, itemsize)
    others = [p[-1] for p in (wsp, rsp) if p is not None]
    return not others or i8[-1] < min(others)


def pick_large_m_plan(m, k, n, itemsize, w_bytes=1.0, ws_temp=2,
                      rs_temp=2, percol=False):
    """("ws" | "rs" | "int8ws", plan) of the lowest score, or None below
    ``WS_MIN_M`` rows (``q8_matmul.py:623-659``, auto mode).  The W8A8
    plan is a candidate only for a weight stored per column."""
    if m < WS_MIN_M:
        return None
    wsp = _plan_ws(m, k, n, itemsize, itemsize, w_bytes=w_bytes,
                   temp_bytes=ws_temp)
    rsp = _plan_rs(m, k, n, itemsize, itemsize, w_bytes=w_bytes,
                   temp_bytes=rs_temp)
    i8p = _plan_ws(m, k, n, itemsize, itemsize, temp_bytes=6,
                   int8=True) if percol else None
    cands = [(p[-1], tag, p) for tag, p in
             (("ws", wsp), ("rs", rsp), ("int8ws", i8p)) if p is not None]
    if not cands:
        return None
    _, tag, p = min(cands, key=lambda c: c[0])
    return (tag, p)
