"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``build/kernels/`` beside the package, keyed by a hash of its source,
the headers of ``csrc/`` and the flags, so a changed source or header
rebuilds and an unchanged one loads in milliseconds.  Nothing
is built when this module is imported: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> loaded library; build seconds and compiler output of the last build
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    cands: List[str] = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed by the source, every header
    of ``csrc/`` (the sources include ``hopper.cuh``) and the flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        key.update(hdr.name.encode() + hdr.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def load_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Load the kernel libraries ``names``, building the missing ones with
    one ``nvcc`` each, all started together."""
    names = [n for n in dict.fromkeys(names) if n not in _LIBS]
    jobs = {}
    for name in names:
        out = _lib_path(name)
        BUILD_INFO[name] = {"seconds": 0.0, "log": "", "cached": out.exists()}
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out, time.time())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name].update(seconds=time.time() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """Return the loaded kernel library ``name``, building it if needed."""
    if name not in _LIBS:
        load_all([name])
    return _LIBS[name]
