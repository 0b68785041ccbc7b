"""The port's copies of the JAX package's host modules (rng, tokenizer,
prompt, nameconv, io.tensorstore, io.gquant, sampling.schedule, utils.log,
utils.image, the session's ``_tile_geometry``) against the originals: the same seeded inputs through both
give equal results, exactly.  The port writes its PNGs without pillow, so
those are compared as pillow reads them (pixels and ``parameters`` text),
not byte for byte."""
import dataclasses
import importlib
import io
import math

import numpy as np
import pytest
import torch

from mlimgsynth_tpu.testing import openclip_name
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.api import _model_types

PACKAGES = ("mlimgsynth_tpu", "mlimgsynth_torch")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores (and the tensors are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TEXTS = ["a photograph of an astronaut riding a horse",
         "Crème brûlée, 3.5kg!! <lora:x:0.5> (café:1.2) naïve 中文",
         "a (red:1.3) fox [in the snow], ((detailed)) BREAK night",
         "[cat:dog:0.4] on a [hill|mountain], \\(escaped\\)"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _tokenizer(pkg, tmp_path):
    tok = _mod(pkg, "tokenizer")
    out = [tok.tokenize(t) for t in TEXTS]
    P = tok.ClipParams(d_embed=32, n_interm=64, n_head=4, n_layer=2)
    toks = out[0] * 9   # three 77-token windows
    out.append(tok.split_windows(P, toks, [1.0 + 0.01 * i
                                           for i in range(len(toks))]))
    out.append([tok.token_str(t) for t in out[1]])
    return out


def _prompt(pkg, tmp_path):
    pm = _mod(pkg, "prompt")
    out = []
    for t in TEXTS + ["(a:1.5", "a [b:c:8] d", "x [y|z] w"]:
        try:
            out.append(pm.prompt_set_parse(t))
        except pm.PromptParseError as e:
            out.append(("error", str(e)))
        out.append(pm.prompt_set_raw(t))
        out.append([pm.expand_editing(t, s, 10) for s in (0, 5, 9)])
        out.append(pm.editing_segments(t, 10))
    return out


def _rng(pkg, tmp_path):
    rng = _mod(pkg, "rng")
    r = rng.RngPhilox(seed=0xDEADBEEFCAFE, offset=3)
    draws = [r.randn_shaped((2, 4, 8, 8)), r.randn(5), r.randn_shaped((3,))]
    return draws + [r.offset, rng.philox_randn(42, 0, 1000)]


def _schedule(pkg, tmp_path):
    sch = _mod(pkg, "sampling.schedule")
    out = [sch.get_log_sigmas(), sch.log_sigmas_flow(3.0)]
    for name in ("uniform", "karras", "exponential", "sgm_uniform", "beta"):
        for n_fe in (1, 2):
            s = sch.make_schedule(20, name, n_fe, 2, 1.0, 0.0)
            out += [s] + [sch.plan_step_noise(s.sigmas, anc, noise, 0.0,
                                              lcm=False)
                          for anc, noise in ((0.0, 0.0), (1.0, 1.0))]
    sig = np.asarray([14.6, 3.0, 0.5, 0.03], np.float32)
    return out + [sch.sigma_to_t(sig), sch.t_to_sigma(np.asarray(
        [999.0, 500.5, 1.0]))]


def _tensorstore(pkg, tmp_path):
    """Each package reads a checkpoint written by the port's writer, writes
    it back as bf16 and f16, and reads those; and both packages' ggml
    codecs round-trip the same data."""
    ts, gq = _mod(pkg, "io.tensorstore"), _mod(pkg, "io.gquant")
    src = tmp_path / "src.safetensors"
    if not src.exists():
        T.write_random_checkpoint(str(src), T.TINY_MODEL_TYPE, seed=2)
    store = ts.TensorStore.open(str(src))
    out = [{k: store.read(k).copy() for k in store.names()}]
    for dt in ("bf16", "f16"):
        path = tmp_path / f"{pkg}-{dt}.safetensors"
        store.write_safetensors(str(path), dtype=dt)
        back = ts.TensorStore.open(str(path))
        out.append({k: (back.tensors[k].dtype, back.read(k).copy())
                    for k in back.names()})
        back.close()
    store.close()
    x = np.random.default_rng(0).standard_normal(256 * 4).astype(
        np.float32)
    for name in ("q8_0", "q4_1", "q4_k", "q5_k", "q6_k"):
        raw = getattr(gq, f"quant_{name}")(x)
        out += [raw, getattr(gq, f"dequant_{name}")(raw, x.size)]
    return out


def _checkpoint_names():
    """The CompVis names of a full SD1.5 checkpoint, its text tower also in
    the OpenCLIP layout, and some diffusers names."""
    nc = importlib.import_module("mlimgsynth_torch.nameconv")
    internal = list(T.model_shapes(_model_types()["sd1"]))
    names = [nc.internal_to_compvis(k) for k in internal]
    names += [openclip_name(k) for k in internal
              if k.startswith("clip.text.") and openclip_name(k)]
    names += ["cond_stage_model.model.transformer.resblocks.3.attn."
              "in_proj_weight",
              "text_model.encoder.layers.0.self_attn.q_proj.weight",
              "down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k."
              "weight", "first_stage_model.encoder.down.0.block.0.conv1.bias",
              "conditioner.embedders.1.model.text_projection", "nonsense.x"]
    return internal, names


def _nameconv(pkg, tmp_path):
    nc = _mod(pkg, "nameconv")
    internal, names = _checkpoint_names()
    return ([nc.normalize_name(n) for n in names],
            [nc.internal_to_compvis(k) for k in internal],
            [nc.normalize_lora_name(n) for n in (
                "lora_unet_down_blocks_1_attentions_0_proj_in",
                "lora_te_text_model_encoder_layers_0_mlp_fc1",
                "lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q")])


def _log(pkg, tmp_path):
    lg = _mod(pkg, "utils.log")
    buf = io.StringIO()
    logger = lg.Logger(level=lg.level_from_str("verbose"))
    stderr, lg.sys.stderr = lg.sys.stderr, buf
    try:
        for fn in (logger.error, logger.warning, logger.info, logger.info2,
                   logger.debug):
            fn("message")
    finally:
        lg.sys.stderr = stderr
    return [buf.getvalue(), lg.level_from_str("42"), sorted(lg.NAMES.items())]


def _image(pkg, tmp_path):
    """The tensor<->image converters, the TENSOR files, and the images
    ``image_save`` writes (PNG with a Latin-1 and a non-Latin-1 infotext,
    grey and RGBA PNG, PPM and PGM) as pillow reads them back."""
    from PIL import Image
    im = _mod(pkg, "utils.image")
    rng = np.random.default_rng(5)
    t = rng.uniform(-0.2, 1.2, (2, 3, 7, 5)).astype(np.float32)
    u8 = rng.integers(0, 256, (7, 5, 4), dtype=np.uint8)
    out = [im.tensor_from_image_arr(u8), im.tensor_from_image_arr(u8[:, :, 0]),
           im.tensor_to_image_arr(t, 1)]
    path = tmp_path / f"{pkg}.tensor"
    im.tensor_save(str(path), t)
    out += [path.read_bytes(), im.tensor_load(str(path))]
    for name, img, info in (("a.png", u8[:, :, :3], "a cat\nSeed: 1"),
                            ("b.png", u8[:, :, :3], "café 中文"),
                            ("c.png", u8[:, :, :1], None),
                            ("d.png", u8, "x"), ("e.ppm", u8[:, :, :3], None),
                            ("f.pgm", u8[:, :, :1], None)):
        path = tmp_path / f"{pkg}-{name}"
        im.image_save(str(path), img, info)
        pil = Image.open(path)
        out += [np.asarray(pil), pil.mode, pil.info.get("parameters")]
        if name.endswith(("ppm", "pgm")):
            out.append(path.read_bytes())
    return out


def _masks(pkg, tmp_path):
    """``mask_downsize`` by 8 and 2 and ``image_alpha_split`` on seeded
    [n, c, h, w] arrays."""
    im = _mod(pkg, "utils.image")
    rng = np.random.default_rng(9)
    mask = rng.uniform(0.0, 1.0, (2, 1, 32, 48)).astype(np.float32)
    rgba = rng.uniform(0.0, 1.0, (2, 4, 16, 8)).astype(np.float32)
    return [im.mask_downsize(mask, 8), im.mask_downsize(mask, 2),
            *im.image_alpha_split(rgba)]


def _tiles(pkg, tmp_path):
    """The session's ``_tile_geometry`` (pure numpy) on the tiled VAE's
    canvases: square and not, a side one tile covers, a clamped last tile,
    the encoder's 64-px margin, one tile."""
    api = _mod(pkg, "api")
    return [api._tile_geometry(*g) for g in (
        (32, 32, 24, 24, 8), (56, 40, 24, 24, 8), (24, 40, 24, 24, 8),
        (50, 37, 24, 24, 8), (448, 320, 192, 192, 64), (24, 24, 24, 24, 8),
        (128, 128, 80, 80, 8), (1024, 1024, 640, 640, 64))]


CASES = {"tokenizer": _tokenizer, "prompt": _prompt, "rng": _rng,
         "schedule": _schedule, "tensorstore": _tensorstore,
         "nameconv": _nameconv, "log": _log, "image": _image,
         "masks": _masks, "tiles": _tiles}


def _plain(x):
    """Results of either package in one comparable form: dataclasses by
    class name and fields (the two packages' classes differ), arrays as
    (dtype, shape, bytes), floats by bits (nan equal to nan)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _plain(dataclasses.asdict(x)))
    if isinstance(x, np.ndarray):
        return ("nd", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return _plain(np.asarray(x))
    if isinstance(x, float):
        return ("f", "nan" if math.isnan(x) else x.hex())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("case", list(CASES))
def test_copy_matches_original(case, tmp_path):
    got = {pkg: _plain(CASES[case](pkg, tmp_path)) for pkg in PACKAGES}
    assert got["mlimgsynth_torch"] == got["mlimgsynth_tpu"]


def test_png_read_reads_what_image_save_writes(tmp_path):
    """The port's own PNG decoder (the card's machine has no pillow) gives
    back the pixels and the text of the files its writer makes, and reads
    a PNG whose rows pillow filtered as pillow does."""
    from PIL import Image
    from mlimgsynth_torch.utils import image as im
    u8 = np.random.default_rng(6).integers(0, 256, (9, 4, 3), np.uint8)
    for info in ("Seed: 1, Sampler: euler", "naïve 中文"):
        im.image_save(str(tmp_path / "a.png"), u8, info)
        pix, text = im.png_read(str(tmp_path / "a.png"))
        np.testing.assert_array_equal(pix, u8)
        assert text == {"parameters": info}
    ramp = np.tile(np.arange(64, dtype=np.uint8), (64, 1))
    Image.fromarray(ramp).save(tmp_path / "f.png")
    pix, _ = im.png_read(str(tmp_path / "f.png"))
    np.testing.assert_array_equal(pix[:, :, 0], ramp)
