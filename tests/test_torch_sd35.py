"""SD3.5 in the port against the JAX package: the qk-norm MMDiT, the
MMDiT-X block (a second, latent-only attention off the same norm), the
384-side pos-embed crop, identification of SD3, SD3.5-medium, SD3.5-large
and the two Flux types from a file's names and shapes, and two tiny
sessions: an SD3.5-medium (MMDiT-X) file, txt2img and img2img, and a
qk-norm "large" one, whose type is set by the ``model_type`` option (at
tiny width identification cannot see 2432).

Module parameters are seeded f32 numpy in the JAX layout; the sessions
read the JAX package's ``write_checkpoint_sd3`` files.  f32 on the CPU,
atol/rtol 1e-4 on modules and on every step's latent (mirrors
tests/test_mmdit.py:45, :107 and tests/test_sd3.py:325).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu import api as japi
from mlimgsynth_tpu import testing as JT
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import mmdit as jmmdit
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.io.tensorstore import TensorStore
from mlimgsynth_torch.models import mmdit as tmmdit
from mlimgsynth_torch.weights import load_module, params_from_jax
from torch_jax_memo import jax_spec_memo  # noqa: F401

ATOL = RTOL = 1e-4
J_LARGE = dataclasses.replace(JT.TINY_MMDIT, qk_norm=True)
T_LARGE = dataclasses.replace(T.TINY_MMDIT, qk_norm=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(spec, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, ps in spec.items():
        if ps.kind == JB.LINEAR_W:
            std = ps.shape[0] ** -0.5
        elif ps.kind == JB.CONV_W:
            std = float(np.prod(ps.shape[:3])) ** -0.5
        elif ps.kind == JB.VEC:
            std = 0.1
        else:
            std = 0.02
        a = rng.standard_normal(ps.shape).astype(np.float32) * np.float32(std)
        if ps.kind == JB.VEC and name.endswith(".weight"):
            a += 1.0
        out[name] = a
    return out


def _mmdit_case(JP, seed, hw=16, n=2, s_ctx=7):
    spec = JB.trace_spec(
        lambda ctx, x, t, c, y: jmmdit.mmdit_apply(ctx, x, t, c, y, JP),
        jnp.zeros((1, 8, 8, JP.n_ch_in)), jnp.zeros((1,)),
        jnp.zeros((1, 5, JP.d_ctx_in)), jnp.zeros((1, JP.d_pooled)))
    params = _params(spec, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, JP.n_ch_in, hw, hw)).astype(np.float32)
    t = np.array([800.0, 100.0][:n], np.float32)
    cond = rng.standard_normal((n, s_ctx, JP.d_ctx_in)).astype(np.float32)
    pooled = rng.standard_normal((n, JP.d_pooled)).astype(np.float32)
    return params, x, t, cond, pooled


@pytest.mark.parametrize("kind", ["qk_norm", "mmdit_x"])
def test_mmdit_matches_jax(kind):
    """qk-norm alone (SD3.5-large's blocks) and MMDiT-X in blocks 0-1
    (SD3.5-medium's): the port's MMDiT against ``mmdit_apply``."""
    JP, P = J_LARGE, T_LARGE
    if kind == "mmdit_x":
        JP = dataclasses.replace(JP, x_self_attn_layers=(0, 1))
        P = dataclasses.replace(P, x_self_attn_layers=(0, 1))
    params, x, t, cond, pooled = _mmdit_case(JP, seed=3)
    assert "mmdit.joint_blocks.0.x_block.attn.ln_q.weight" in params
    assert ("mmdit.joint_blocks.1.x_block.attn2.qkv.weight" in params) == \
        (kind == "mmdit_x")
    want = np.asarray(jax.jit(
        lambda p, x, t, k, y: jmmdit.mmdit_apply(
            JB.Ctx(p, dtype=jnp.float32), x, t, k, y, JP))(
        params, x.transpose(0, 2, 3, 1), t, cond, pooled)).transpose(
            0, 3, 1, 2)
    model = load_module(tmmdit.MMDiT(P), "mmdit.",
                        params_from_jax(params)).eval()
    assert set(model.state_dict()) == {k[len("mmdit."):] for k in params}
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, t, cond, pooled))).numpy()
    assert float(np.abs(want).mean()) > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_sd35_params_match_jax():
    for mine, theirs in ((tmmdit.MMDIT_SD35_LARGE, jmmdit.MMDIT_SD35_LARGE),
                         (tmmdit.MMDIT_SD35_MEDIUM,
                          jmmdit.MMDIT_SD35_MEDIUM),
                         (T.TINY_MMDIT_X, JT.TINY_MMDIT_X)):
        assert vars(mine) == {k: getattr(theirs, k) for k in vars(mine)}
    assert tmmdit.MMDIT_SD35_LARGE.width == 2432
    assert tmmdit.MMDIT_SD35_LARGE.heads == 38


def test_pos_embed_crop_384_matches_jax():
    """SD3.5-medium's pos-embed grid is 384 on a side: the centre crop to
    the 64 x 64 patches of a 1024^2 image (``_pos_embed_crop``)."""
    JP = dataclasses.replace(jmmdit.MMDIT_SD35_MEDIUM, d_model=4, n_head=1)
    P = dataclasses.replace(tmmdit.MMDIT_SD35_MEDIUM, d_model=4, n_head=1)
    g = P.pos_embed_max
    pe = np.random.default_rng(5).standard_normal(
        (1, g * g, 4)).astype(np.float32)
    want = np.asarray(jmmdit._pos_embed_crop(
        JB.Ctx({"mmdit.pos_embed": jnp.asarray(pe)}, dtype=jnp.float32),
        "mmdit", 64, 64, JP))
    with torch.device("meta"):
        model = tmmdit.MMDiT(dataclasses.replace(P, depth=1))
    model.pos_embed = torch.nn.Parameter(torch.from_numpy(pe))
    got = model._pos_embed_crop(64, 64).detach().numpy()
    assert got.shape == (1, 4096, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got.reshape(64, 64, 4), pe.reshape(g, g, 4)[160:224, 160:224])


def _probe_file(path, names):
    """A safetensors file with one small f32 tensor per (name, shape)."""
    T.write_safetensors(path, dict(names), np.float32,
                        ((n, np.zeros(s, np.float32)) for n, s in names))


@pytest.mark.parametrize("names,want", [
    ([("model.diffusion_model.joint_blocks.0.x_block.attn.qkv.weight",
       (96, 32))], "sd3"),
    ([("model.diffusion_model.joint_blocks.0.x_block.attn.qkv.weight",
       (96, 32)),
      ("model.diffusion_model.joint_blocks.0.x_block.attn2.qkv.weight",
       (96, 32))], "sd35_medium"),
    ([("model.diffusion_model.joint_blocks.0.x_block.attn.qkv.weight",
       (1, 2432))], "sd35_large"),
    ([("double_blocks.0.img_attn.qkv.weight", (96, 32))], "flux_schnell"),
    ([("double_blocks.0.img_attn.qkv.weight", (96, 32)),
      ("guidance_in.in_layer.weight", (32, 256))], "flux_dev"),
    ([("model.diffusion_model.double_blocks.0.img_attn.qkv.weight",
       (96, 32))], "flux_schnell"),
])
def test_identify_matches_jax(tmp_path, names, want):
    """``identify_model`` on a file's names and shapes: width 2432 is
    SD3.5-large, ``attn2`` SD3.5-medium, ``guidance_in`` Flux-dev; the JAX
    package's answers the same."""
    from mlimgsynth_tpu import weights as jweights
    from mlimgsynth_tpu.io.tensorstore import TensorStore as JStore
    path = str(tmp_path / "probe.safetensors")
    _probe_file(path, names)
    st = TensorStore.open(path)
    try:
        got = tweights.identify_model(st, tweights.build_name_map(st), {})
    finally:
        st.close()
    jst = JStore.open(path)
    jwant, _ = jweights.identify_model(jst, jweights.build_name_map(jst), {})
    assert got == jwant == want


# -- sessions ---------------------------------------------------------------

OPTS = [("image-dim", 64), ("steps", 4), ("seed", 21), ("cfg-scale", 5.0),
        ("prompt", "a (cat:1.2) on a [sofa]"), ("nprompt", "blurry")]


def _run(s, path, model_type=None):
    traj = []
    s.option_set("model", path)
    if model_type:
        s.option_set("model-type", model_type)
    for k, v in OPTS:
        s.option_set(k, v)
    if isinstance(s, japi.MLImgSynth):
        s._dtype = jnp.float32
    s.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    img = s.generate()
    return traj, np.asarray(img, np.float32)


CASES = {"sd35_medium": (JT.TINY_MMDIT_X, T.TINY_MMDIT_X, False),
         "sd35_large": (J_LARGE, T_LARGE, True)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX session's request on each tiny SD3.5 file: (path, trajectory,
    image, conditioning), once for the module."""
    out = {}
    saved = japi._model_types
    try:
        for name, (JP, _, set_type) in CASES.items():
            path = str(tmp_path_factory.mktemp(name) / "m.safetensors")
            JT.write_checkpoint_sd3(path, seed=5, P=JP)
            mt = japi.ModelTypeDef(name, JT.TINY_CLIP, JT.TINY_CLIP2, JP,
                                   JT.TINY_VAE_SD3, 64, 2)
            japi._model_types = lambda mt=mt, name=name: {name: mt}
            s = japi.MLImgSynth()
            traj, img = _run(s, path, name if set_type else None)
            assert s.c["model_type"] == name
            out[name] = (path, traj, img)
    finally:
        japi._model_types = saved
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sd35_session_matches_jax(jax_runs, monkeypatch, name):
    _, P, set_type = CASES[name]
    mt = torch_api.ModelTypeDef(name, T.TINY_CLIP, P, T.TINY_VAE_SD3, 64, 2,
                                T.TINY_CLIP2)
    monkeypatch.setattr(torch_api, "_model_types", lambda: {name: mt})
    path, traj_j, img_j = jax_runs[name]
    ts = torch_api.MLImgSynth(device="cpu")
    traj_t, img_t = _run(ts, path, name if set_type else None)
    assert ts.c["model_type"] == name
    assert len(traj_t) == len(traj_j) == 4
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    mse = np.mean((np.round(img_j * 255) - np.round(img_t * 255)) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 40.0
    # conditioned as SD3: 77 CLIP rows then 77 zero T5 rows, two pooled
    # features
    assert ts.tensors["cond"].shape == (1, 154, 80)
    assert ts.tensors["label"].shape == (1, 64)


def test_sd35_img2img_matches_jax(jax_runs, monkeypatch):
    """An SD3.5-medium img2img request at ``f_t_ini`` 0.6 against the JAX
    session whose encode subtracts the VAE's shift as ``latent_sample``
    does (its ``_vae_encode`` leaves it out: ROADMAP Queue C item 4,
    tests/test_torch_sd3_img2img.py)."""
    name = "sd35_medium"
    JP, P, _ = CASES[name]
    shift = (np.float32(T.TINY_VAE_SD3.shift_factor)
             * np.float32(T.TINY_VAE_SD3.scale_factor))
    monkeypatch.setattr(japi, "_model_types", lambda: {
        name: japi.ModelTypeDef(name, JT.TINY_CLIP, JT.TINY_CLIP2, JP,
                                JT.TINY_VAE_SD3, 64, 2)})
    monkeypatch.setattr(torch_api, "_model_types", lambda: {
        name: torch_api.ModelTypeDef(name, T.TINY_CLIP, P, T.TINY_VAE_SD3,
                                     64, 2, T.TINY_CLIP2)})
    js = japi.MLImgSynth()
    encode = js._vae_encode
    monkeypatch.setattr(js, "_vae_encode",
                        lambda *a, **kw: encode(*a, **kw) - shift)
    img = np.random.default_rng(6).uniform(
        0, 1, (1, 3, 64, 64)).astype(np.float32)
    res = []
    for s in (js, torch_api.MLImgSynth(device="cpu")):
        s.option_set("image", img)
        s.option_set("f-t-ini", 0.6)
        res.append(_run(s, jax_runs[name][0]))
    (traj_j, img_j), (traj_t, img_t) = res
    assert len(traj_j) == len(traj_t) == 2
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    mse = np.mean((np.round(img_j * 255) - np.round(img_t * 255)) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 40.0
