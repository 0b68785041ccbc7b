"""Image buffers and files (the port's copy of
``mlimgsynth_tpu/utils/image.py``, the functions the CLI's ``generate``
needs).

The tensor<->image converters and the ``TENSOR`` latent format are copied
as they are.  ``image_save`` writes the same files as the JAX package's
writer, without pillow (the machine with the card has none): PNG with
``zlib`` and ``struct``, the A1111 ``parameters`` text in a tEXt chunk
(iTXt where it is not Latin-1, as pillow does), and binary PPM/PGM; other
extensions raise.  ``png_read`` decodes the PNGs it writes.

Tensors at this boundary are numpy float32 ``[n,c,h,w]``.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np


def tensor_from_image_arr(img: np.ndarray) -> np.ndarray:
    """uint8 [h,w,c] -> float32 [1,c,h,w] in [0,1]."""
    if img.ndim == 2:
        img = img[:, :, None]
    x = img.astype(np.float32) / 255.0
    return x.transpose(2, 0, 1)[None]


def tensor_to_image_arr(t: np.ndarray, idx: int = 0) -> np.ndarray:
    """float32 [n,c,h,w] in [0,1] -> uint8 [h,w,c]."""
    x = np.clip(t[idx] * 255.0, 0, 255).astype(np.uint8)
    return x.transpose(1, 2, 0)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# channels -> PNG colour type (grey, RGB, RGBA)
_PNG_COLOR = {1: 0, 3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def png_bytes(img: np.ndarray, infotext: Optional[str] = None) -> bytes:
    """uint8 [h,w,c] (c 1, 3 or 4) -> PNG file bytes: every row with
    filter 0, one zlib stream, the infotext as the 'parameters' text."""
    h, w, c = img.shape
    out = [_PNG_SIG, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                 _PNG_COLOR[c], 0, 0, 0))]
    if infotext:
        try:
            out.append(_chunk(b"tEXt", b"parameters\0"
                              + infotext.encode("latin-1")))
        except UnicodeEncodeError:
            out.append(_chunk(b"iTXt", b"parameters\0\0\0\0\0"
                              + infotext.encode("utf-8")))
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(img, np.uint8).reshape(h, w * c)
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def ppm_bytes(img: np.ndarray) -> bytes:
    """uint8 [h,w,c] (c 1 or 3) -> binary PGM / PPM bytes."""
    h, w, c = img.shape
    magic = {1: b"P5", 3: b"P6"}[c]
    return (magic + b"\n%d %d\n255\n" % (w, h)
            + np.ascontiguousarray(img, np.uint8).tobytes())


def image_save(path: str, img: np.ndarray, infotext: Optional[str] = None
               ) -> None:
    """Save uint8 [h,w,c]; PNG embeds infotext as the A1111 'parameters'
    text.  PNG, PPM, PNM and PGM only."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = png_bytes(img, infotext)
    elif ext in (".ppm", ".pnm", ".pgm"):
        data = ppm_bytes(img)
    else:
        raise ValueError(f"image format '{ext}' is not supported by the "
                         "PyTorch port (png, ppm, pnm, pgm)")
    with open(path, "wb") as f:
        f.write(data)


def png_read(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """A PNG written by :func:`image_save` -> (uint8 [h,w,c], its text
    chunks).  Reads 8-bit grey, RGB and RGBA without interlace whose rows
    use filter 0; raises on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, text, hdr = len(_PNG_SIG), [], {}, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            key, _, val = body.partition(b"\0")
            text[key.decode("latin-1")] = val.decode("latin-1")
        elif kind == b"iTXt":
            key, _, rest = body.partition(b"\0")
            text[key.decode("latin-1")] = rest[2:].split(
                b"\0", 2)[2].decode("utf-8")
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    chans = {v: k for k, v in _PNG_COLOR.items()}.get(color)
    if depth != 8 or chans is None or interlace:
        raise ValueError(f"{path}: unsupported PNG layout {hdr}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * chans)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, chans).copy(), text


# ---------------------------------------------------------------------------
# TENSOR file format (reference: src/localtensor.c:196-253)
# "TENSOR F32 n0 n1 n2 n3\n" + raw float32 data, ggml dim order (w h c n).
# ---------------------------------------------------------------------------

def tensor_save(path: str, t: np.ndarray) -> None:
    """t: float32 [n,c,h,w]."""
    t = np.ascontiguousarray(t, dtype=np.float32)
    n, c, h, w = t.shape
    with open(path, "wb") as f:
        f.write(f"TENSOR F32 {w} {h} {c} {n}\n".encode())
        f.write(t.tobytes())


def tensor_load(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            ch = f.read(1)
            if not ch or len(header) > 128:
                raise ValueError("invalid TENSOR file header")
            header += ch
        parts = header.decode().split()
        if len(parts) != 6 or parts[0] != "TENSOR" or parts[1] != "F32":
            raise ValueError(f"invalid TENSOR header: {header!r}")
        w, h, c, n = (int(x) for x in parts[2:6])
        data = np.frombuffer(f.read(), np.float32, n * c * h * w)
        return data.reshape(n, c, h, w).copy()
