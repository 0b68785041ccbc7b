"""The port's checkpoint loader (mlimgsynth_torch.weights) and its numpy
safetensors writer (mlimgsynth_torch.testing) against the JAX package.

A checkpoint written by the JAX package's test writers is read by both
loaders; the port's tensors must equal ``params_from_jax`` of the JAX
loader's, bit for bit (both read the same f32 data and only transpose)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import write_checkpoint_sd2, write_tiny_checkpoint
from mlimgsynth_tpu import weights as jw
from mlimgsynth_tpu.io.tensorstore import TensorStore
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import clip as jclip
from mlimgsynth_tpu.models import unet as junet
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_tpu.testing import (TINY_CLIP, TINY_CLIP2, TINY_UNET_XL,
                                    TINY_VAE, tiny_specs,
                                    write_checkpoint_sdxl)
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tw
from torch_jax_memo import jax_spec_memo  # noqa: F401


def _sdxl_specs():
    """The JAX parameter spec of the tiny SDXL model (both towers, the
    labeled UNet, the VAE decoder), as ``write_checkpoint_sdxl`` traces
    it."""
    spec = JB.trace_spec(
        lambda ctx, toks: jclip.clip_text_apply(ctx, toks, TINY_CLIP),
        jnp.zeros((1, 77), jnp.int32))
    spec.update(JB.trace_spec(
        lambda ctx, toks: jclip.clip_text_apply(
            ctx, toks, TINY_CLIP2, feat_tok_idx=jnp.zeros((1,), jnp.int32),
            pre="clip2"), jnp.zeros((1, 77), jnp.int32)))
    spec.update(JB.trace_spec(
        lambda ctx, x, t, c, l: junet.unet_apply(ctx, x, t, c, l,
                                                 TINY_UNET_XL),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 64)),
        jnp.zeros((1, TINY_UNET_XL.ch_adm_in))))
    spec.update(JB.trace_spec(
        lambda ctx, x: jvae.vae_decode_apply(ctx, x, TINY_VAE),
        jnp.zeros((1, 8, 8, 4))))
    return spec


@pytest.mark.parametrize("writer", [write_tiny_checkpoint,
                                    write_checkpoint_sd2,
                                    write_checkpoint_sdxl])
def test_loader_matches_jax_loader(tmp_path, writer):
    """SD1 CompVis names; (sd2 writer) the OpenCLIP text tower whose q/k/v
    are one fused tensor; (sdxl writer) CLIP-L under ``conditioner.
    embedders.0``, bigG in the OpenCLIP layout with its text projection,
    and the labeled UNet."""
    path = str(tmp_path / "ckpt.safetensors")
    writer(path)
    sdxl = writer is write_checkpoint_sdxl
    spec = {k: dataclasses.replace(ps, dtype=jnp.float32)
            for k, ps in (_sdxl_specs() if sdxl else tiny_specs()).items()}
    store = TensorStore.open(path)
    try:
        want = tw.params_from_jax(
            jw.load_params(store, spec, jw.build_name_map(store)))
        shapes = T.model_shapes(T.TINY_MODEL_TYPE_XL if sdxl
                                else T.TINY_MODEL_TYPE)
        got = tw.load_params(store, tw.build_name_map(store), shapes,
                             "cpu", torch.float32)
    finally:
        store.close()
    assert set(got) <= set(want)
    assert any(k.startswith("clip.text.") for k in got)
    if sdxl:
        assert set(got) == set(want)
        assert "clip2.text.text_proj" in got
        assert "unet.label_embed.0.weight" in got
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


def test_identify_model(tmp_path):
    path = str(tmp_path / "ckpt.safetensors")
    write_tiny_checkpoint(path)
    store = TensorStore.open(path)
    try:
        name_map = tw.build_name_map(store)
        assert tw.identify_model(store, name_map, {32: "sd1"}) == "sd1"
        assert tw.identify_model(store, name_map, {768: "sd1"}) is None
    finally:
        store.close()


def test_load_params_rejects_missing_and_misfit(tmp_path):
    path = str(tmp_path / "ckpt.safetensors")
    write_tiny_checkpoint(path)
    store = TensorStore.open(path)
    try:
        name_map = tw.build_name_map(store)
        with pytest.raises(KeyError):
            tw.load_params(store, name_map, {"unet.nope.weight": (3,)},
                           "cpu", torch.float32)
        with pytest.raises(ValueError):
            tw.load_params(store, name_map,
                           {"unet.out.conv.bias": (5,)}, "cpu",
                           torch.float32)
    finally:
        store.close()


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_random_checkpoint_round_trip(tmp_path, dtype):
    """The numpy safetensors writer: the ``safetensors`` package and the
    JAX package's TensorStore read back what the port's writer wrote."""
    from safetensors.numpy import load_file
    path = str(tmp_path / "rand.safetensors")
    T.write_random_checkpoint(path, T.TINY_MODEL_TYPE, seed=5, dtype=dtype)
    want = dict(T.random_checkpoint_tensors(T.TINY_MODEL_TYPE, seed=5,
                                            dtype=dtype))
    back = load_file(path)
    assert set(back) == set(want)
    store = TensorStore.open(path)
    try:
        for name, arr in want.items():
            assert back[name].dtype == arr.dtype
            np.testing.assert_array_equal(back[name], arr)
            np.testing.assert_array_equal(store.read(name), arr)
    finally:
        store.close()


def test_random_sdxl_checkpoint_loads_like_jax(tmp_path):
    """The port's writer in the sd_xl_base layout (bigG's q/k/v fused in
    OpenCLIP ``in_proj`` tensors, ``proj_in`` / ``proj_out`` stored as
    linears): the JAX loader reads it into the same tensors as the port's
    loader."""
    path = str(tmp_path / "xl.safetensors")
    T.write_random_checkpoint(path, T.TINY_MODEL_TYPE_XL, seed=2,
                              dtype=np.float32)
    store = TensorStore.open(path)
    try:
        assert any(n.endswith("attn.in_proj_weight") for n in store.tensors)
        assert store.tensors[
            "model.diffusion_model.input_blocks.1.1.proj_in.weight"
        ].shape == (32, 32)
        spec = {k: dataclasses.replace(ps, dtype=jnp.float32)
                for k, ps in _sdxl_specs().items()}
        want = tw.params_from_jax(
            jw.load_params(store, spec, jw.build_name_map(store)))
        got = tw.load_params(store, tw.build_name_map(store),
                             T.model_shapes(T.TINY_MODEL_TYPE_XL), "cpu",
                             torch.float32)
    finally:
        store.close()
    assert set(got) == set(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name
