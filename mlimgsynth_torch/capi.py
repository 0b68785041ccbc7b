"""Python side of the port's C ABI shim (port of ``mlimgsynth_tpu/capi.py``).

``csrc/mlis_shim.c`` (``native/mlis_shim.c`` with this module's name in the
place of the JAX package's) embeds the interpreter and drives sessions
through this module: every function takes/returns only C-friendly values
(ints, strings, contiguous numpy buffers).  C callback pointers are invoked
through ctypes trampolines built from their raw addresses.  A context's
session is on the card unless the caller sets the ``backend`` option to
``cpu`` before ``mlis_setup`` (its device is resolved there; without a card
and without ``cpu`` the setup fails).

:func:`build_shim` compiles the shim with ``cc`` against the repository's
``include/mlimgsynth.h`` into ``build/libmlimgsynth_torch.so`` on its first
use (again when the source, the header or the interpreter changes); a C
program links it and finds this package through ``MLIS_PY_PATH``::

    python -c "from mlimgsynth_torch import capi; print(capi.build_shim())"
    cc -Iinclude app.c -Lbuild -lmlimgsynth_torch -Wl,-rpath,build
    MLIS_PY_PATH=$PWD ./a.out
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .api import Aborted, MLImgSynth, MlisError
from .utils import image as image_mod


class _CProgress(ctypes.Structure):
    _fields_ = [("stage", ctypes.c_int), ("step", ctypes.c_int),
                ("step_end", ctypes.c_int), ("nfe", ctypes.c_int),
                ("step_time", ctypes.c_double)]


_CALLBACK_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.POINTER(_CProgress))
_ERRH_T = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p)


class CSession:
    """One C-level context: wraps MLImgSynth, owns buffers handed to C."""

    def __init__(self, c_ctx_addr: int):
        self.s = MLImgSynth(late_device=True)
        self.c_ctx = c_ctx_addr
        self.errstr = ""
        self.keep: Dict[str, np.ndarray] = {}  # buffers C points into
        self._cb = None
        self._cb_user = 0

    # -- helpers ---------------------------------------------------------

    def _wrap(self, fn, *args):
        try:
            return 1, fn(*args)
        except MlisError as e:
            self.errstr = str(e)
            return int(e.code), None
        except Aborted:
            return 1, None
        except Exception as e:  # noqa
            self.errstr = f"{type(e).__name__}: {e}"
            return -1, None

    # -- C entry points --------------------------------------------------

    def option_set_str(self, name: str, value: str) -> int:
        r, _ = self._wrap(self.s.option_set_str, name, value)
        return r

    def option_get_str(self, name: str) -> str:
        r, v = self._wrap(self.s.option_get, name)
        if r < 0:
            return ""
        return "" if v is None else str(v)

    def set_callback(self, fn_addr: int, user_addr: int) -> int:
        if not fn_addr:
            self.s.callback = None
            return 1
        cfn = _CALLBACK_T(fn_addr)
        self._cb = cfn
        self._cb_user = user_addr

        def cb(session, prg):
            p = _CProgress(stage=prg["stage"], step=prg["step"],
                           step_end=prg["step_end"], nfe=prg["nfe"],
                           step_time=prg["step_time"])
            return cfn(self._cb_user, self.c_ctx, ctypes.byref(p))

        self.s.callback = cb
        return 1

    def set_image(self, buf_addr: int, w: int, h: int, c: int) -> int:
        arr = np.ctypeslib.as_array(
            ctypes.cast(buf_addr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(h, w, c)).copy()
        r, _ = self._wrap(self.s.option_set, "image", arr)
        return r

    def set_image_mask(self, buf_addr: int, w: int, h: int) -> int:
        arr = np.ctypeslib.as_array(
            ctypes.cast(buf_addr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(h, w, 1)).copy()
        t = image_mod.tensor_from_image_arr(arr)
        r, _ = self._wrap(self.s.option_set, "image_mask", t)
        return r

    def set_control_image(self, buf_addr: int, w: int, h: int,
                          c: int) -> int:
        arr = np.ctypeslib.as_array(
            ctypes.cast(buf_addr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(h, w, c)).copy()
        r, _ = self._wrap(self.s.option_set, "control_image", arr)
        return r

    def setup(self) -> int:
        r, _ = self._wrap(self.s.setup)
        return r

    def generate(self) -> int:
        r, _ = self._wrap(self.s.generate)
        return r

    def image_get(self, idx: int):
        """Returns (ptr, w, h, c) of a ctx-owned uint8 HWC buffer."""
        img = self.s.tensors.get("image")
        if img is None or idx >= img.shape[0]:
            self.errstr = "image not ready"
            return 0, 0, 0, 0
        arr = np.ascontiguousarray(image_mod.tensor_to_image_arr(img, idx))
        self.keep["__image__"] = arr
        h, w, c = arr.shape
        return arr.ctypes.data, w, h, c

    def infotext_get(self) -> str:
        return self.s.infotext

    def errstr_get(self) -> str:
        return self.errstr

    def tensor_get(self, name: str):
        """Returns (ptr, n0, n1, n2, n3) of the f32 tensor (ggml dim order)."""
        arr = self.s.tensors.get(name)
        if arr is None:
            return 0, 0, 0, 0, 0
        arr = np.ascontiguousarray(arr, np.float32)
        self.keep[name] = arr
        n, c, h, w = (arr.shape + (1, 1, 1, 1))[:4]
        return arr.ctypes.data, w, h, c, n

    def tensor_set(self, name: str, buf_addr: int, n0: int, n1: int,
                   n2: int, n3: int) -> int:
        arr = np.ctypeslib.as_array(
            ctypes.cast(buf_addr, ctypes.POINTER(ctypes.c_float)),
            shape=(n3, n2, n1, n0)).copy()
        self.s.tensors[name] = arr
        return 1

    def tokenize(self, text: str):
        """Returns (ptr, count) of a ctx-owned int32 token buffer."""
        r, toks = self._wrap(self.s.text_tokenize, text)
        if r < 0:
            return 0, r
        arr = np.asarray(toks, np.int32)
        self.keep["__tokens__"] = arr
        return arr.ctypes.data, len(arr)

    def clip_text_encode(self, text: str, want_feat: int, submodel: str,
                         flags: int) -> int:
        no_norm = bool(flags & 1)
        r, res = self._wrap(self.s.clip_text_encode, text, submodel,
                            bool(want_feat), not no_norm)
        if r < 0:
            return r
        embed, feat = res
        self.s.tensors["tmp0"] = embed[:, :, :, None].transpose(0, 3, 1, 2)
        if feat is not None:
            self.s.tensors["tmp1"] = feat[:, :, None, None].transpose(
                0, 2, 3, 1)
        return 1

    def image_encode(self, name_in: str, name_out: str) -> int:
        r, lat = self._wrap(self.s.image_encode, self.s.tensors[name_in])
        if r >= 0 and lat is not None:
            self.s.tensors[name_out] = lat
        return r

    def image_decode(self, name_in: str, name_out: str) -> int:
        r, img = self._wrap(self.s.image_decode, self.s.tensors[name_in])
        if r >= 0 and img is not None:
            self.s.tensors[name_out] = img
        return r

    def backend_info(self) -> str:
        import json
        r, info = self._wrap(self.s.backend_info)
        return json.dumps(info if r >= 0 else {})


_sessions: Dict[int, CSession] = {}


def ctx_create(c_ctx_addr: int) -> int:
    _sessions[c_ctx_addr] = CSession(c_ctx_addr)
    return 1


def ctx_destroy(c_ctx_addr: int) -> int:
    _sessions.pop(c_ctx_addr, None)
    return 1


def get(c_ctx_addr: int) -> Optional[CSession]:
    return _sessions.get(c_ctx_addr)


REPO = Path(__file__).resolve().parent.parent
SHIM_SOURCE = Path(__file__).resolve().parent / "csrc" / "mlis_shim.c"
SHIM_LIB = REPO / "build" / "libmlimgsynth_torch.so"


def _python_flags():
    """(compile, link) flags that embed this interpreter."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    lib = "python" + sysconfig.get_config_var("VERSION") + (
        sysconfig.get_config_var("ABIFLAGS") or "")
    return ([f"-I{inc}"],
            [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{lib}", "-ldl",
             "-lm"])


def build_shim() -> str:
    """Build the shim into ``build/libmlimgsynth_torch.so`` with ``cc``,
    unless the library there was built from the same source, header and
    interpreter; returns its path."""
    out = SHIM_LIB
    header = REPO / "include" / "mlimgsynth.h"
    cflags, ldflags = _python_flags()
    key = hashlib.sha256(SHIM_SOURCE.read_bytes() + header.read_bytes()
                         + " ".join(cflags + ldflags).encode()).hexdigest()
    stamp = out.with_name(out.name + ".key")
    if out.exists() and stamp.exists() and stamp.read_text() == key:
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    # the source includes "../include/mlimgsynth.h", as it sits in native/
    cmd = (["cc", "-O2", "-fPIC", "-shared", "-Wall", "-Wno-unused-parameter",
            f"-I{REPO / 'include'}"] + cflags
           + ["-o", str(tmp), str(SHIM_SOURCE)] + ldflags)
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"shim build failed:\n{r.stderr[-4000:]}")
    os.replace(tmp, out)
    stamp.write_text(key)
    return str(out)
