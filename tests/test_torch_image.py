"""The port's image readers (``mlimgsynth_torch/utils/image.py``) against
pillow, which the JAX package's ``image_load`` uses: PNGs and binary PNMs
written here, for every row filter, colour type and bit depth, decoded by
the port and by the JAX package's ``image_load`` to the same uint8 array
(exactly), and the layouts the port refuses with ``E_IMAGE``."""
import struct
import zlib

import numpy as np
import pytest

from mlimgsynth_tpu.utils import image as jimage
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch.utils import image as timage


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def png_encode(samples, depth, color, filters, palette=None, trns=None,
               interlace=0):
    """A PNG of ``samples`` [h, w, c] (integers; palette indices for colour
    type 3) at ``depth``, row y filtered with ``filters[y % len]``."""
    h, w, c = samples.shape
    if depth == 16:
        raw = samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    elif depth == 8:
        raw = samples.astype(np.uint8).reshape(h, w * c)
    else:
        per = 8 // depth
        s = samples.reshape(h, w * c).astype(np.uint8)
        s = np.concatenate([s, np.zeros((h, (-s.shape[1]) % per), np.uint8)],
                           axis=1).reshape(h, -1, per)
        raw = np.zeros(s.shape[:2], np.uint8)
        for i in range(per):
            raw |= s[:, :, i] << (8 - depth * (i + 1))
    bpp = max(1, c * depth // 8)
    out, prior = bytearray(), np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        x, f = raw[y].astype(np.int64), filters[y % len(filters)]
        res = np.zeros_like(x)
        for i in range(len(x)):
            a = x[i - bpp] if i >= bpp else 0
            cc = prior[i - bpp] if i >= bpp else 0
            pred = [0, a, prior[i], (a + prior[i]) // 2,
                    _paeth(a, prior[i], cc)][f]
            res[i] = (x[i] - pred) % 256
        out.append(f)
        out += bytes(res.astype(np.uint8))
        prior = x
    parts = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))]
    if palette is not None:
        parts.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        parts.append(_chunk(b"tRNS", trns))
    parts.append(_chunk(b"tEXt", b"parameters\0a cat, Steps: 4"))
    parts += [_chunk(b"IDAT", zlib.compress(bytes(out))), _chunk(b"IEND", b"")]
    return b"".join(parts)


# (name, colour type, depth, channels, tRNS)
LAYOUTS = [
    ("L8", 0, 8, 1, None), ("L1", 0, 1, 1, None), ("L2", 0, 2, 1, None),
    ("L4", 0, 4, 1, None), ("L8_trns", 0, 8, 1, b"\0\x07"),
    ("LA8", 4, 8, 2, None), ("RGB8", 2, 8, 3, None),
    ("RGB8_trns", 2, 8, 3, b"\0\x07\0\x07\0\x07"), ("RGBA8", 6, 8, 4, None),
    ("P8", 3, 8, 1, None), ("P8_trns", 3, 8, 1, b"\0\x80\xff"),
    ("P4_trns", 3, 4, 1, b"\x10"), ("P1", 3, 1, 1, None),
    ("L16", 0, 16, 1, None), ("LA16", 4, 16, 2, None),
    ("RGB16", 2, 16, 3, None), ("RGBA16", 6, 16, 4, None),
]


@pytest.mark.parametrize("name,color,depth,chans,trns", LAYOUTS,
                         ids=[l[0] for l in LAYOUTS])
def test_image_load_matches_pillow(tmp_path, name, color, depth, chans,
                                   trns):
    """Seven rows of 13 pixels, the rows' filters 0, 1, 2, 3, 4, 4, 3 (13
    pixels leave a partial last byte at depths below 8); 16-bit grey holds
    values on both sides of 255, which pillow's RGB conversion clips."""
    rng = np.random.default_rng(len(name) * 31 + depth)
    hi = (1 << depth) if color != 3 else 1 << min(depth, 4)
    if color == 0 and depth == 16:
        hi = 600
    samples = rng.integers(0, hi, (7, 13, chans))
    palette = (rng.integers(0, 256, (1 << min(depth, 4), 3))
               if color == 3 else None)
    path = tmp_path / f"{name}.png"
    path.write_bytes(png_encode(samples, depth, color, [0, 1, 2, 3, 4, 4, 3],
                                palette, trns))
    want = jimage.image_load(str(path))
    got = timage.image_load(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.shape[2] == {1: 1 if depth in (2, 4, 8) and color == 0 else 3,
                            2: 4, 3: 3, 4: 4}[chans]


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_read_every_filter(tmp_path, filt):
    """``png_read`` undoes each filter alone on an 8-bit RGBA file (bpp 4),
    as pillow reads it, and returns the text chunk."""
    rng = np.random.default_rng(filt)
    samples = rng.integers(0, 256, (5, 9, 4))
    path = tmp_path / "f.png"
    path.write_bytes(png_encode(samples, 8, 6, [filt]))
    pix, text = timage.png_read(str(path))
    np.testing.assert_array_equal(pix, samples.astype(np.uint8))
    np.testing.assert_array_equal(pix, jimage.image_load(str(path)))
    assert text == {"parameters": "a cat, Steps: 4"}


def test_png_read_pillow_files(tmp_path):
    """PNGs pillow writes (its own filter choice per row, L, LA, RGB and
    RGBA) read back equal."""
    from PIL import Image
    rng = np.random.default_rng(5)
    for mode, c in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        arr = rng.integers(0, 256, (17, 23, c)).astype(np.uint8)
        # smooth rows make pillow pick the predicting filters
        arr = np.cumsum(arr // 16, axis=1).astype(np.uint8)
        path = tmp_path / f"{mode}.png"
        Image.fromarray(arr[:, :, 0] if c == 1 else arr, mode).save(path)
        np.testing.assert_array_equal(timage.png_read(str(path))[0], arr)
        np.testing.assert_array_equal(timage.image_load(str(path)),
                                      jimage.image_load(str(path)))


def test_interlaced_png_raises(tmp_path):
    path = tmp_path / "i.png"
    path.write_bytes(png_encode(np.zeros((4, 4, 3), np.int64), 8, 2, [0],
                                interlace=1))
    with pytest.raises(ValueError, match="Adam7-interlaced RGB"):
        timage.png_read(str(path))
    with pytest.raises(torch_api.MlisError) as e:
        timage.image_load(str(path))
    assert e.value.code == torch_api.MlisError.E_IMAGE


@pytest.mark.parametrize("magic,c", [(b"P5", 1), (b"P6", 3)])
def test_ppm_matches_pillow(tmp_path, magic, c):
    """Binary PGM/PPM at maximum value 255, a comment in the header; other
    maxima raise ``E_IMAGE``."""
    rng = np.random.default_rng(c)
    arr = rng.integers(0, 256, (6, 11, c)).astype(np.uint8)
    path = tmp_path / "x.pnm"
    path.write_bytes(magic + b"\n# made here\n11 6\n255\n" + arr.tobytes())
    got = timage.image_load(str(path))
    np.testing.assert_array_equal(got, jimage.image_load(str(path)))
    np.testing.assert_array_equal(got, arr)
    path.write_bytes(timage.ppm_bytes(arr))
    np.testing.assert_array_equal(timage.image_load(str(path)), arr)
    path.write_bytes(magic + b"\n11 6\n1023\n" + arr.tobytes() * 2)
    with pytest.raises(torch_api.MlisError) as e:
        timage.image_load(str(path))
    assert e.value.code == torch_api.MlisError.E_IMAGE


def test_image_load_bytes_and_errors(tmp_path):
    """The bytes of a file load as the file does; a missing file gives
    ``E_FILE_NOT_FOUND``, a file of another format ``E_IMAGE``."""
    arr = np.random.default_rng(0).integers(0, 256, (4, 6, 4)).astype(
        np.uint8)
    data = timage.png_bytes(arr)
    np.testing.assert_array_equal(timage.image_load_bytes(data), arr)
    with pytest.raises(torch_api.MlisError) as e:
        timage.image_load(str(tmp_path / "missing.png"))
    assert e.value.code == torch_api.MlisError.E_FILE_NOT_FOUND
    with pytest.raises(torch_api.MlisError) as e:
        timage.image_load_bytes(b"GIF89a....")
    assert e.value.code == torch_api.MlisError.E_IMAGE
