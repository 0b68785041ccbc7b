"""Quantized matmul wrappers around the CUDA kernels in
``csrc/quant_matmul.cu``, and their dispatch.

Four weight-only kernels compute y = x . deq(W)^T (bf16 x and y, f32
accumulate; see the source note in the .cu file):

* :func:`q8_matmul_tile` replaces the JAX package's ``q8_matmul``
  (``mlimgsynth_tpu/ops/q8_matmul.py:76``, Pallas kernel ``_q8_kernel``);
* :func:`q8_matmul_ws` replaces ``q8_matmul_ws`` (``:286``,
  ``_q8_ws_kernel``);
* :func:`q4_matmul_tile` replaces ``q4_matmul``
  (``mlimgsynth_tpu/ops/q4_matmul.py:105``, ``_q4_kernel``);
* :func:`q4_matmul_ws` replaces ``q4_matmul_ws`` (``:186``,
  ``_q4_ws_kernel``).

A fifth, :func:`q8_matmul_ws_int8`, replaces ``q8_matmul_ws_int8``
(``mlimgsynth_tpu/ops/q8_matmul.py:452``, ``_q8_ws_int8_kernel``): W8A8 on
a weight stored per column (int8 [N, K], scales [N]), the activations
quantized per (row, K slab) by a first pass into scratch that the wrapper
allocates (one launch counted per call).  A sixth, :func:`q8_matmul_int8`,
replaces ``q8_matmul_int8`` (``:552``, ``_q8q8_kernel``): W8A8 on the
per-block weights (scales [N, K/128]), the activations quantized per (row,
128-deep K block) by the same first pass.

:func:`q8_dot` / :func:`q4_dot` pick one by a fixed rule
(:func:`use_ws`): the weight-stationary kernel when the product has at
least ``WS_MIN_M`` rows (the JAX package's ``_WS_MIN_M``), whatever its K,
else the tiled kernel; the ws kernel's tile width is :func:`ws_tile_n`'s
choice for the shape and its walk :func:`ws_band_m`'s, the tiled
kernel's geometry :func:`tile_config`'s (the C launcher applies the same
rules itself).  ``q8_dot`` follows the
reference's order (``q8_matmul.py:662-700``): a per-column weight first asks
the JAX package's plan (``ops/quant_plan.pick_large_m_plan``), and where it
picks ``"int8ws"`` the product runs the W8A8 kernel on per-column scales;
any other per-column weight goes on with its scales broadcast to [N, K/128];
then ``MLIS_Q8_MODE=int8`` (read on every call; default ``dq``) sends the
product to :func:`q8_matmul_int8`, and otherwise the rule above applies.
The mode changes the numbers (the activations are quantized), so the port
keeps the reference's switch.

A wrapper given a CPU tensor runs the plain version (``ops/quant.py``);
given CUDA tensors it launches its kernel or raises.  Each launch adds one
to ``LAUNCHES[<kernel>]`` and to ``LAUNCH_SHAPES[(<kernel>, (M, K, N))]``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import os

import torch

from . import _build
from . import quant
from .quant_plan import pick_large_m_plan

LAUNCHES = {"q8_matmul_tile": 0, "q8_matmul_ws": 0,
            "q4_matmul_tile": 0, "q4_matmul_ws": 0, "q8_matmul_ws_int8": 0,
            "q8_matmul_int8": 0}
LAUNCH_SHAPES = collections.Counter()

WS_MIN_M = 2048
# ws output tiles: WS_BM rows by one of WS_TILE_N columns (the wgmma N),
# walked in bands of ws_band_m(M, K) 128-row tiles; WS_L2_BYTES, the L2 of
# the H100, sizes the bands.  The C launcher picks the band itself by the
# same rule; ``qmm_ws_band_m`` in the library returns its choice.
WS_BM = 128
WS_TILE_N = (80, 160)
WS_L2_BYTES = 50 * 2 ** 20
# W8A8 (K7, K8) output tiles: WS_BM rows by one of I8_TILE_N columns (the
# int8 wgmma N).  The C launcher picks the width itself by the same rule
# (its entry points keep their argtypes); ``q8_int8_tile_n`` in the library
# returns its choice.
I8_TILE_N = (32, 80, 128)
# Tiled (K5, K9) blocks: 64 weight rows by one row range of x, the range
# padded to one of TILE_NT rows (the wgmma N).  The C launcher picks the
# geometry itself by the rule of :func:`tile_config` (its entry points keep
# their argtypes); ``qmm_tile_config`` in the library returns its choice.
TILE_NT = (8, 16, 32, 48, 64, 80, 96, 128, 160, 192, 256)

_TILE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_WS_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the W8A8 entries also take their scratch: int8 x and the (row, slab)
# amax; the per-column one its slab
_I8_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_I8WS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()
    quant.PLAIN_CUDA_CALLS = 0


def ws_tile_n(m: int, n: int, sms: int = 132) -> int:
    """Tile width of the ws kernel for an [m, n] output on ``sms`` SMs: the
    width of ``WS_TILE_N`` with the least (waves x (width + 32)), a wave
    being one tile on every SM and 32 columns standing for a tile's fixed
    cost; ties go to the wider tile."""
    def cost(bn):
        tiles = -(-m // WS_BM) * -(-n // bn)
        return -(-tiles // sms) * (bn + 32), -bn
    return min(WS_TILE_N, key=cost)


def ws_band_m(m: int, k: int) -> int:
    """128-row tiles a band of the ws kernel's walk for a product of ``m``
    rows and depth ``k``.  The kernel takes the output band by band, each
    band N column by N column, M fastest within a column, so the blocks in
    flight read one band's rows of x (and the weight tiles of a few
    columns, each read by the band's blocks and then left).  Where all of
    x (m x k bf16) fits the L2 the band is every tile (the order M fastest
    within each N column); else as many tiles as keep a band's x within
    half the L2 (the other half holds the streamed weight tiles and y),
    spread evenly over the bands that takes.  x is then read from device
    memory about once, the weight once a band."""
    m_tiles = -(-m // WS_BM)
    if m * k * 2 <= WS_L2_BYTES:
        return m_tiles
    g = min(m_tiles, max(1, WS_L2_BYTES // 2 // (WS_BM * k * 2)))
    bands = -(-m_tiles // g)
    return -(-m_tiles // bands)


def i8_tile_n(m: int, n: int, sms: int = 132) -> int:
    """Tile width of the W8A8 kernels for an [m, n] output on ``sms`` SMs:
    the width of ``I8_TILE_N`` with the least (waves x (width + 32)), as
    :func:`ws_tile_n`; ties go to the narrower tile (more blocks on the
    weight stream where M is small)."""
    def cost(bn):
        tiles = -(-m // WS_BM) * -(-n // bn)
        return -(-tiles // sms) * (bn + 32), bn
    return min(I8_TILE_N, key=cost)


def tile_config(m: int) -> tuple:
    """(row ranges, rows a range) of the tiled kernel for a product of ``m``
    rows: ceil(m / 256) ranges of equal size, so that a weight is
    dequantized once where M <= 256 and at most ceil(M / 256) times above,
    each padded to the least width of ``TILE_NT`` that holds it."""
    ranges = -(-m // 256)
    rows = -(-m // ranges)
    return ranges, min(w for w in TILE_NT if w >= rows)


def ws_config(m: int, n: int, k: int, sms: int) -> int:
    """The ws entry points' trailing int: the tile width."""
    return ws_tile_n(m, n, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def use_ws(m: int, k: int) -> bool:
    """The dispatch rule: weight-stationary for M >= WS_MIN_M, at any K
    (the ws kernel keeps no full-K stripe)."""
    return m >= WS_MIN_M


def _lib():
    lib = _build.load("quant_matmul")
    for name in LAUNCHES:
        fn = getattr(lib, name)
        fn.argtypes = (_TILE_ARGTYPES if name.endswith("_tile")
                       else _I8WS_ARGTYPES if name == "q8_matmul_ws_int8"
                       else _I8_ARGTYPES if name == "q8_matmul_int8"
                       else _WS_ARGTYPES)
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, x, w, s, bits: int):
    """Check the operands and launch kernel ``name``; ``bits`` 4 or 8, and
    the per-column W8A8 kernel takes scales [N]."""
    if not (x.is_cuda and w.is_cuda and s.is_cuda):
        raise ValueError(f"{name}: x, weight and scales must all be CUDA "
                         "tensors")
    if not (x.device == w.device == s.device):
        raise ValueError(f"{name}: x, weight and scales on different devices")
    if x.dtype != torch.bfloat16 or w.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise TypeError(f"{name}: takes bf16 x, int8 weight, f32 scales; got "
                        f"{x.dtype}/{w.dtype}/{s.dtype}")
    k = x.shape[-1]
    n = w.shape[0]
    k_w = k // 2 if bits == 4 else k
    percol = name == "q8_matmul_ws_int8"
    s_shape = (n,) if percol else (n, k // quant.KBLOCK)
    if (k % quant.KBLOCK or w.dim() != 2 or tuple(w.shape) != (n, k_w)
            or tuple(s.shape) != s_shape):
        raise ValueError(f"{name}: expected x [..., K] with K a multiple of "
                         f"128, weight [N, {'K/2' if bits == 4 else 'K'}] and "
                         f"scales [{'N' if percol else 'N, K/128'}]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(s.shape)}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    if m == 0 or n == 0:
        raise ValueError(f"{name}: empty product {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    if not (w.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{name}: weight and scales must be contiguous")
    # the kernels load x and the weight as 16-byte vectors
    if x2.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and weight base pointers must be "
                         "16-byte aligned")
    scratch, extra = [], []
    if name.endswith("_int8"):
        slab = quant._ws_slab(k) if percol else quant.KBLOCK
        if slab is None:
            raise ValueError(f"{name}: no activation slab for K={k}")
        scratch = [torch.empty(m, k, dtype=torch.int8, device=x.device),
                   torch.empty(m, k // slab, device=x.device)]
        extra = [slab] if percol else []
    elif name.endswith("_ws"):
        extra = [ws_config(m, n, k, _sm_count(x.device.index))]
    y = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_lib(), name)(x2.data_ptr(), w.data_ptr(), s.data_ptr(),
                                   y.data_ptr(),
                                   *[t.data_ptr() for t in scratch],
                                   m, n, k, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, (m, k, n))] += 1
    return y.reshape(x.shape[:-1] + (n,))


def q8_matmul_tile(x, w_q8, w_scale):
    """x [..., K] . deq(w_q8 [N, K] int8, w_scale [N, K/128] f32)^T ->
    [..., N] (bf16 on CUDA), tiled kernel."""
    if not x.is_cuda:
        return quant.q8_matmul_plain(x, w_q8, w_scale)
    return _launch("q8_matmul_tile", x, w_q8, w_scale, 8)


def q8_matmul_ws(x, w_q8, w_scale):
    """As :func:`q8_matmul_tile`, weight-stationary kernel."""
    if not x.is_cuda:
        return quant.q8_matmul_plain(x, w_q8, w_scale)
    return _launch("q8_matmul_ws", x, w_q8, w_scale, 8)


def q4_matmul_tile(x, w_q4, w_scale):
    """As :func:`q8_matmul_tile` with packed q4 weights [N, K/2]."""
    if not x.is_cuda:
        return quant.q4_matmul_plain(x, w_q4, w_scale)
    return _launch("q4_matmul_tile", x, w_q4, w_scale, 4)


def q4_matmul_ws(x, w_q4, w_scale):
    """As :func:`q4_matmul_tile`, weight-stationary kernel."""
    if not x.is_cuda:
        return quant.q4_matmul_plain(x, w_q4, w_scale)
    return _launch("q4_matmul_ws", x, w_q4, w_scale, 4)


def q8_matmul_ws_int8(x, w_q8, s_col):
    """x [..., K] . (w_q8 [N, K] int8, per-column scales s_col [N] f32)^T
    with the activations quantized per (row, K slab) -> [..., N] (bf16 on
    CUDA), W8A8 kernel."""
    if not x.is_cuda:
        return quant.q8_ws_int8_plain(x, w_q8, s_col)
    return _launch("q8_matmul_ws_int8", x, w_q8, s_col, 8)


def q8_matmul_int8(x, w_q8, w_scale):
    """x [..., K] . (w_q8 [N, K] int8, w_scale [N, K/128] f32)^T with the
    activations quantized per (row, 128-deep K block) -> [..., N] (bf16 on
    CUDA), W8A8 kernel."""
    if not x.is_cuda:
        return quant.q8_matmul_int8_plain(x, w_q8, w_scale)
    return _launch("q8_matmul_int8", x, w_q8, w_scale, 8)


def _rows(x) -> int:
    return x.numel() // x.shape[-1]


def q8_dot(x, w_q8, w_scale, plan_kn=None):
    """Dispatch a q8 product (ref: ``q8_dot``).  ``w_scale`` [N] marks a
    weight stored per column; ``MLIS_Q8_MODE`` is read on every call.
    ``plan_kn``: the (K, N) of the whole weight when ``w_q8`` holds a tp
    rank's rows of it; the route is the whole weight's."""
    if w_scale.dim() == 1:
        n, k = w_q8.shape
        k_all, n_all = plan_kn or (k, n)
        sel = pick_large_m_plan(_rows(x), k_all, n_all, x.element_size(),
                                percol=True)
        if sel is not None and sel[0] == "int8ws":
            return q8_matmul_ws_int8(x, w_q8, w_scale)
        w_scale = w_scale[:, None].expand(n, k // quant.KBLOCK).contiguous()
    if os.environ.get("MLIS_Q8_MODE", "dq") == "int8":
        return q8_matmul_int8(x, w_q8, w_scale)
    if use_ws(_rows(x), x.shape[-1]):
        return q8_matmul_ws(x, w_q8, w_scale)
    return q8_matmul_tile(x, w_q8, w_scale)


def q4_dot(x, w_q4, w_scale):
    """Dispatch a q4 product (ref: ``q4_dot``)."""
    if use_ws(_rows(x), x.shape[-1]):
        return q4_matmul_ws(x, w_q4, w_scale)
    return q4_matmul_tile(x, w_q4, w_scale)
