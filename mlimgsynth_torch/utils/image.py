"""Image buffers and files (the port's copy of
``mlimgsynth_tpu/utils/image.py``, the functions the CLI's ``generate``
needs).

The tensor<->image converters, ``mask_downsize``, ``image_alpha_split`` and
the ``TENSOR`` latent format are copied as they are.  The files are read
and written without pillow (the machine with the card has none), with
``zlib`` and ``struct``: ``image_save`` writes the same files as the JAX
package's writer (PNG with the A1111 ``parameters`` text in a tEXt chunk,
iTXt where it is not Latin-1, as pillow does; binary PPM/PGM; other
extensions raise); ``image_load`` reads PNG (every colour type, bit depth
and row filter; not interlaced) and binary PGM/PPM into what the JAX
package's pillow-based ``image_load`` returns.

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


def _png_chunks(data: bytes, what: str):
    """(IHDR fields, PLTE bytes, IDAT bytes, text chunks) of PNG file
    bytes, every chunk's CRC checked."""
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{what}: not a PNG file")
    pos, idat, text, hdr, plte = len(_PNG_SIG), [], {}, None, b""
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(kind + body):
            raise ValueError(f"{what}: bad CRC in {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            key, _, val = body.partition(b"\0")
            text[key.decode("latin-1")] = val.decode("latin-1")
        elif kind == b"zTXt":
            key, _, val = body.partition(b"\0")
            text[key.decode("latin-1")] = zlib.decompress(
                val[1:]).decode("latin-1")
        elif kind == b"iTXt":
            key, _, rest = body.partition(b"\0")
            val = rest[2:].split(b"\0", 2)[2]
            if rest[0]:
                val = zlib.decompress(val)
            text[key.decode("latin-1")] = val.decode("utf-8")
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{what}: no IHDR chunk")
    return hdr, plte, b"".join(idat), text


def _paeth_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One row of the Paeth filter undone, left to right."""
    x = raw.astype(np.int32)
    b = prior.astype(np.int32)
    for i in range(len(x)):
        a = int(x[i - bpp]) if i >= bpp else 0
        c = int(b[i - bpp]) if i >= bpp else 0
        p = a + int(b[i]) - c
        pa, pb, pc = abs(p - a), abs(p - int(b[i])), abs(p - c)
        pred = a if pa <= pb and pa <= pc else int(b[i]) if pb <= pc else c
        x[i] = (x[i] + pred) & 0xFF
    return x.astype(np.uint8)


def _unfilter(rows: np.ndarray, bpp: int, what: str) -> np.ndarray:
    """Undo the PNG row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    of ``rows`` [h, 1 + stride]; returns [h, stride] bytes."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f, raw = int(rows[y, 0]), rows[y, 1:]
        if f == 0:
            cur = raw
        elif f == 1:        # Sub: a running sum over each byte lane
            pad = (-stride) % bpp
            lanes = np.concatenate([raw, np.zeros(pad, np.uint8)])
            cur = (np.cumsum(lanes.reshape(-1, bpp).astype(np.uint32),
                             axis=0) & 0xFF).astype(np.uint8).reshape(-1)
            cur = cur[:stride]
        elif f == 2:        # Up
            cur = raw + prior
        elif f == 3:        # Average of left and up, left to right
            x = raw.astype(np.int32)
            b = prior.astype(np.int32)
            x[:bpp] = (x[:bpp] + (b[:bpp] >> 1)) & 0xFF
            for i in range(bpp, stride):
                x[i] = (x[i] + ((int(x[i - bpp]) + int(b[i])) >> 1)) & 0xFF
            cur = x.astype(np.uint8)
        elif f == 4:
            cur = _paeth_row(raw, prior, bpp)
        else:
            raise ValueError(f"{what}: row {y} has filter type {f}")
        out[y] = cur
        prior = out[y]
    return out


# colour type -> (channels, allowed bit depths)
_PNG_LAYOUTS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
_PNG_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha",
              6: "RGBA"}


def png_decode(data: bytes, what: str = "PNG"):
    """PNG file bytes -> (samples, colour type, bit depth, palette [n, 3]
    uint8 or None, text chunks).  ``samples`` is [h, w, c]: uint16 at
    depth 16, else uint8 holding each sample's value (palette indices for
    colour type 3, 0..2^depth-1 at depths below 8).  Every row filter is
    undone; an interlaced (Adam7) file raises ``ValueError``."""
    hdr, plte, idat, text = _png_chunks(data, what)
    w, h, depth, color, _, _, interlace = hdr
    chans, depths = _PNG_LAYOUTS.get(color, (None, ()))
    if depth not in depths:
        raise ValueError(f"{what}: invalid PNG layout: colour type {color} "
                         f"at bit depth {depth}")
    if interlace:
        raise ValueError(f"{what}: Adam7-interlaced {_PNG_NAMES[color]} "
                         f"PNG ({depth}-bit) is not supported")
    bits = chans * depth
    stride = (w * bits + 7) // 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    if rows.size < h * (1 + stride):
        raise ValueError(f"{what}: truncated image data")
    rows = rows[:h * (1 + stride)].reshape(h, 1 + stride)
    raw = _unfilter(rows, max(1, bits // 8), what)
    if depth == 16:
        samples = raw.view(">u2").astype(np.uint16).reshape(h, w, chans)
    elif depth == 8:
        samples = raw.reshape(h, w, chans)
    else:
        bits_ = np.unpackbits(raw, axis=1)[:, :w * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits_.reshape(h, w, depth) * weights).sum(
            axis=2, dtype=np.uint8)[:, :, None]
    palette = None
    if color == 3:
        if not plte or len(plte) % 3:
            raise ValueError(f"{what}: palette PNG without a valid PLTE")
        palette = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    return samples, color, depth, palette, text


def png_read(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """An 8-bit grey, grey+alpha, RGB or RGBA PNG -> (uint8 [h,w,c], its
    text chunks); any row filters.  Raises ``ValueError`` on other
    layouts (:func:`image_load` converts those)."""
    with open(path, "rb") as f:
        samples, color, depth, _, text = png_decode(f.read(), path)
    if depth != 8 or color == 3:
        raise ValueError(f"{path}: {depth}-bit {_PNG_NAMES[color]} PNG; "
                         "png_read takes 8-bit grey, grey+alpha, RGB or "
                         "RGBA (image_load converts the others)")
    return samples.copy(), text


def _png_image(data: bytes, what: str) -> np.ndarray:
    """PNG bytes -> uint8 [h,w,c] as pillow's ``Image.open`` followed by
    the JAX package's ``image_load`` conversion gives it: 8-bit grey, RGB
    and RGBA as they are; grey+alpha as RGBA; palette as RGB (tRNS ignored:
    pillow's mode "P" has no alpha); 1-bit grey as RGB of 0/255; 2- and
    4-bit grey scaled to 0..255; 16-bit RGB, RGBA and grey+alpha by their
    high bytes; 16-bit grey as RGB of the value clipped to 255."""
    samples, color, depth, palette, _ = png_decode(data, what)
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        return pal[samples[:, :, 0]]
    if color == 0 and depth == 16:
        return np.repeat(np.minimum(samples, 255).astype(np.uint8), 3, 2)
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
    elif depth == 1:
        return np.repeat(samples * np.uint8(255), 3, axis=2)
    elif depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if color == 4:
        return np.concatenate([np.repeat(samples[:, :, :1], 3, 2),
                               samples[:, :, 1:]], axis=2)
    return np.ascontiguousarray(samples)


def _pnm_token(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The next whitespace-separated header token of a PNM file, skipping
    ``#`` comments."""
    n = len(data)
    while pos < n:
        if data[pos:pos + 1] == b"#":
            while pos < n and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
        elif data[pos:pos + 1].isspace():
            pos += 1
        else:
            break
    end = pos
    while end < n and not data[end:end + 1].isspace() \
            and data[end:end + 1] != b"#":
        end += 1
    return data[pos:end], end


def ppm_decode(data: bytes, what: str = "PPM") -> np.ndarray:
    """Binary PGM (P5) or PPM (P6) bytes with a maximum value of 255 ->
    uint8 [h,w,1] or [h,w,3].  Other maxima raise ``ValueError``."""
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{what}: not a binary PGM/PPM file")
    pos, vals = 2, []
    for _ in range(3):
        tok, pos = _pnm_token(data, pos)
        if not tok.isdigit():
            raise ValueError(f"{what}: bad PNM header")
        vals.append(int(tok))
    w, h, maxval = vals
    if maxval != 255:
        raise ValueError(f"{what}: PNM maximum value {maxval} is not "
                         "supported (255 only)")
    c = 1 if magic == b"P5" else 3
    body = data[pos + 1:pos + 1 + w * h * c]
    if len(body) != w * h * c:
        raise ValueError(f"{what}: truncated PNM data")
    return np.frombuffer(body, np.uint8).reshape(h, w, c).copy()


def image_load_bytes(data: bytes, what: str = "image") -> np.ndarray:
    """Image file bytes (PNG, or binary PGM/PPM) -> uint8 [h,w,c], as the
    JAX package's ``image_load`` returns it through pillow (see
    :func:`_png_image`).  A format or layout the port cannot read raises
    ``MlisError(E_IMAGE)``."""
    from ..api import MlisError
    try:
        if data.startswith(_PNG_SIG):
            return _png_image(data, what)
        if data[:2] in (b"P5", b"P6"):
            return ppm_decode(data, what)
        raise ValueError(f"{what}: not a PNG or binary PGM/PPM file")
    except (ValueError, zlib.error, struct.error) as e:
        raise MlisError(MlisError.E_IMAGE, str(e))


def image_load(path: str) -> np.ndarray:
    """Load an image file as uint8 [h,w,c] (alpha kept where the file has
    it; see :func:`image_load_bytes`).  A missing file raises
    ``MlisError(E_FILE_NOT_FOUND)``."""
    from ..api import MlisError
    if not os.path.isfile(path):
        raise MlisError(MlisError.E_FILE_NOT_FOUND,
                        f"image file not found '{path}'")
    with open(path, "rb") as f:
        return image_load_bytes(f.read(), path)


def mask_downsize(mask: np.ndarray, f: int) -> np.ndarray:
    """Block-mean downsize of a [n,1,h,w] mask by factor f
    (reference: ltensor_downsize, src/localtensor.c:161-194)."""
    n, c, h, w = mask.shape
    assert h % f == 0 and w % f == 0
    return mask.reshape(n, c, h // f, f, w // f, f).mean(axis=(3, 5))


def image_alpha_split(t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[n,4,h,w] -> rgb [n,3,h,w], mask [n,1,h,w]
    (reference: OPTION(IMAGE) alpha split, mlimgsynth_options_set.c.h)."""
    return t[:, :3], t[:, 3:4]


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
