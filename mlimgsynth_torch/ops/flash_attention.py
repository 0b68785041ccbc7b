"""Flash-attention wrappers around the CUDA kernels in
``csrc/flash_attention.cu``.

Three entry points, all online-softmax forward passes over the natural
[B, H, S, D] layout in bf16 (see the source note in the .cu file):

* :func:`flash_attn_fwd` (D <= 160) replaces the JAX package's
  ``flash_attention_t`` (``mlimgsynth_tpu/ops/flash_attention.py:646``,
  Pallas kernel ``_flash_kernel_t``): the UNet self-attention.  It also
  takes head dims in (128, 160] (SD1.5's level 2 at 1024^2, head dim 160),
  which the JAX package sends to ``flash_attention``: the same function,
  on a kernel whose P V width holds 160 columns.
* :func:`flash_attn_joint` (D <= 128) replaces ``stock_flash``
  (``mlimgsynth_tpu/ops/stock_flash.py:177``, JAX's TPU flash kernel, K3)
  and ``splash_flash`` (``ops/splash_flash.py:114``, K4): the MMDiT joint
  attention over text and image tokens.  It launches the same Hopper
  kernel as :func:`flash_attn_fwd`; the two names keep the launches of
  each TPU kernel's route apart.
* :func:`flash_attn_fwd_wide` (128 < D <= 512) replaces
  ``flash_attention`` (``:353``, kernel ``_flash_kernel``): the VAE
  mid-block's single 512-wide head, on a kernel of its own.
  :func:`flash_attention` sends it the head dims past 160.

A wrapper given CPU tensors runs :func:`attention_plain`, the kernels' plain
PyTorch version; given CUDA tensors it launches its kernel or raises.  Each
launch adds one to ``LAUNCHES[<kernel>]`` and to ``LAUNCH_SHAPES[(<kernel>,
q's shape)]``; ``PLAIN_CUDA_CALLS`` counts calls
of the plain version on CUDA tensors (a benchmark comparing the two makes
them; the main path never does).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _build

LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_fwd_wide": 0,
            "flash_attn_joint": 0}
LAUNCH_SHAPES = collections.Counter()
PLAIN_CUDA_CALLS = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]


def reset_counts() -> None:
    global PLAIN_CUDA_CALLS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()
    PLAIN_CUDA_CALLS = 0


def attention_plain(q, k, v, scale=None):
    """The kernels' plain version: non-causal softmax attention, f32 logits
    and softmax (``attention_xla``)."""
    global PLAIN_CUDA_CALLS
    if q.is_cuda:
        PLAIN_CUDA_CALLS += 1
    from .attention import attention_xla
    return attention_xla(q, k, v, scale=scale)


def _lib():
    lib = _build.load("flash_attention")
    for fn in (lib.flash_attn_fwd, lib.flash_attn_fwd_wide,
               lib.flash_attn_joint):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, q, k, v, scale, d_lo: int, d_hi: int):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name}: q, k, v must all be CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{name}: the kernel takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: expected q [B,H,Sq,D], k/v [B,H,Sk,D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch, heads or head dim")
    if not d_lo < d <= d_hi:
        raise ValueError(f"{name}: head dim {d} outside ({d_lo}, {d_hi}]")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    sk = k.shape[2]
    if b == 0 or h == 0 or sq == 0 or sk == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)} x "
                         f"{tuple(k.shape)}")
    # the kernels load tile rows as 16-byte vectors of 8 bf16
    if d % 8 or any(t.data_ptr() % 16 or any(t.stride(i) % 8
                                              for i in range(3))
                    for t in (q, k, v)):
        raise ValueError(f"{name}: head dim, strides and base pointers must "
                         f"be multiples of 8 elements / 16 bytes (d={d})")
    # keeps the layout of q: a [B,S,H,D] buffer viewed as [B,H,S,D] stays so
    o = torch.empty_like(q)
    ts = (q, k, v, o)
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in ts for i in range(3)])
    if scale is None:
        scale = d ** -0.5
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_lib(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, sq, sk, d, strides, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, tuple(q.shape))] += 1
    return o


def flash_attn_fwd(q, k, v, scale=None):
    """softmax(q k^T * scale) v for head dim <= 160.
    q: [B,H,Sq,D], k/v: [B,H,Sk,D] -> [B,H,Sq,D] (bf16 on CUDA)."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    return _launch("flash_attn_fwd", q, k, v, scale, 0, 160)


def flash_attn_fwd_wide(q, k, v, scale=None):
    """As :func:`flash_attn_fwd` for head dim in (128, 512]."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    return _launch("flash_attn_fwd_wide", q, k, v, scale, 128, 512)


def flash_attn_joint(q, k, v, scale=None):
    """As :func:`flash_attn_fwd` (head dim <= 128, the same kernel): the
    large-S self- and joint-attention route (``attention``'s K3 gate)."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    return _launch("flash_attn_joint", q, k, v, scale, 0, 128)


def flash_attention(q, k, v, scale=None):
    """Pick the kernel by head dim: up to 160 :func:`flash_attn_fwd`, wider
    :func:`flash_attn_fwd_wide`."""
    if q.shape[-1] <= 160:
        return flash_attn_fwd(q, k, v, scale)
    return flash_attn_fwd_wide(q, k, v, scale)
