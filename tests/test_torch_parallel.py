"""The port's multi-device layer (``mlimgsynth_torch/parallel/``) against
the JAX package's ``mlimgsynth_tpu/parallel/``.

On the host (no ranks): ``param_spec`` equals the JAX one for every
parameter of the tiny SD1, SDXL, SD3, SD3.5-medium, Flux and T5 models;
the mesh's rank grid equals ``make_mesh``'s device grid; ``sp_compatible``
agrees; a mesh larger than the process group raises ``MlisError`` naming
the torchrun line.

On gloo ranks on the CPU (one spawn per world size, every case in it;
tests/torch_parallel_ranks.py, which imports no jax), against the JAX
functions on the conftest's virtual devices, computed here:

- ring attention and the q-sharded cross attention (sp = 2 and 4) within
  2e-6 of the JAX ones, f32;
- the tp basic-transformer block within 1e-5 of ``tp_basic_transformer``
  (tp = 2 and 4; the rank runs n_head / tp heads);
- a tp T5 encoder within 2e-5 of the JAX encoder (the JAX package's own
  sharded T5 test holds GSPMD's to the single-device one at 2e-5);
- ``pipeline_apply`` over a tiny MMDiT stack (pp = 2 and 4) against the
  same blocks run in sequence: bit for bit with one microbatch (every
  product keeps its rows), within 1e-6 with one a row (a row's products
  then run alone).

Sessions on the same ranks, each against the JAX session with the same
model, prompt and seed on one device (the JAX package's own tests hold its
mesh sessions to that within 1.5/255), f32: every step's latent within
atol/rtol 1e-4 and the image within 1.5/255 (the u8 image moves a level
where a float difference straddles a rounding boundary):

- tiny SD1 at tp = 2, sp = 2 (the UNet's self-attention on the ring, its
  77-token cross attention q-sharded, the VAE mid-block on the ring),
  dp = 2 with batch 2, and dp 2 x tp 2 (4 ranks);
- a tiny four-block SD3 at sp = 2, pp = 2 and pp = 4, and the SD3 pattern
  at widths that quantize at pp = 2 with q8_0;
- a tiny Flux-dev of 2 double and 3 single blocks at tp = 2 and pp = 2
  (uneven stages).

tp with a quantized weight type (each weight quantized whole, then cut
to the rank's share: column-parallel rows, row-parallel whole 128-blocks
of K or the whole weight with its input gathered), against the JAX
session at tp = 2 with the same weight type (GSPMD keeps its quantized
weights whole on every device), at the same tolerances: the quantizing
tiny SD1 in q8_0, q4_0 and q8_0 under ``MLIS_Q8_MODE=int8`` (the JAX
caches cleared for it), and the SD3 pattern that quantizes at 512^2, where
its image-stream weights are stored per column and their products take
the W8A8 route.  Each rank's stored ``_q8`` / ``_q4`` and scale tensors
are the matching slices of the one-rank session's, bit for bit.

The server and the CLI on the two ranks: the port's server at tp = 2
(rank 0 serves HTTP, rank 1 follows) merges two queued requests into one
batch whose images are within 1.5/255 of a one-rank server's, and a
request cancelled at its first step stops both ranks at that step;
``vae-test`` and ``clip-encode`` through ``cli.main`` at dp = 2 exit 0,
rank 0 alone writes, and its files equal one rank's.

PAG under tp (its identity self-attention: v_proj, then the row-parallel
out_proj) and the tiny SD3.5-medium under tp (MMDiT-X's attn2, qk-norm on
a rank's heads) are held to the port's one-rank session at the same
tolerances.  pp is also held to the port's single-rank image bit for bit
where every
product keeps its rows: ``MLIS_PP_MICRO=1`` on SD3 (one microbatch of the
CFG pair), and Flux-dev (batch 1, no CFG pair).  With the default of one
microbatch a row, SD3's products run one row at a time, which changes no
function but may change a sum's order, so those are held to the JAX
tolerance only.  Each refusal of the JAX session raises ``MlisError`` in
the ranks: pp with tp or with sp, pp on a UNet, on MMDiT-X or at a depth
it does not divide, SLG with pp, DeepCache under a mesh, and a mesh that is
not the world's size (naming the torchrun line).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from safetensors.numpy import save_file

import torch_parallel_ranks as R
from helpers import TINY_MODEL_TYPE as J_TINY_SD1
from helpers import spec_to_checkpoint_arrays, write_tiny_checkpoint
from mlimgsynth_tpu import api as japi
from mlimgsynth_tpu import testing as JT
from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import clip as jclip
from mlimgsynth_tpu.models import flux as jflux
from mlimgsynth_tpu.models import mmdit as jmmdit
from mlimgsynth_tpu.models import t5 as jt5
from mlimgsynth_tpu.models import unet as junet
from mlimgsynth_tpu.models import vae as jvae
from mlimgsynth_tpu.parallel import mesh as jmesh
from mlimgsynth_tpu.parallel import ring_attention as jring
from mlimgsynth_tpu.parallel.shard_map_tp import (shard_transformer_params,
                                                  tp_basic_transformer)
from mlimgsynth_torch import api as tapi
from mlimgsynth_torch import cli
from mlimgsynth_torch import testing as T
from mlimgsynth_torch.api import MlisError
from mlimgsynth_torch.models import t5 as tt5
from mlimgsynth_torch.parallel import comm
from mlimgsynth_torch.parallel import mesh as pmesh
from mlimgsynth_torch.parallel import ring_attention as tring
from mlimgsynth_torch.utils import image as image_mod
from mlimgsynth_torch.weights import module_shapes, params_from_jax
from torch_jax_memo import jax_spec_memo  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")


# -- host -------------------------------------------------------------------

def _t5_names():
    import torch
    with torch.device("meta"):
        m = tt5.T5Encoder(T.TINY_T5_SD3)
    return module_shapes(m, "t5.")


MODELS = {"sd1": T.TINY_MODEL_TYPE, "sdxl": T.TINY_MODEL_TYPE_XL,
          "sd3": T.TINY_MODEL_TYPE_SD3, "sd35_medium": T.TINY_MODEL_TYPE_SD35,
          "flux": T.TINY_MODEL_TYPE_FLUX_DEV}


@pytest.mark.parametrize("model", list(MODELS) + ["t5"])
def test_param_spec_matches_jax(model):
    shapes = (_t5_names() if model == "t5"
              else T.model_shapes(MODELS[model]))
    n_split = 0
    for name, shape in shapes.items():
        want = tuple(jmesh.param_spec(name, len(shape)))
        got = tuple(pmesh.param_spec(name, len(shape)))
        assert got == want, name
        assert tuple(pmesh.param_spec(name, len(shape), tp=False)) == ()
        n_split += bool(got)
    assert n_split > 0


@pytest.mark.parametrize("tp,sp,pp", [(2, 1, 1), (1, 2, 1), (1, 1, 2),
                                      (2, 2, 1), (4, 1, 1)])
def test_rank_grid_matches_make_mesh(tp, sp, pp):
    m = jmesh.make_mesh(8, tp=tp, sp=sp, pp=pp)
    ids = np.vectorize(lambda d: d.id)(m.devices)
    np.testing.assert_array_equal(pmesh.grid(8, tp=tp, sp=sp, pp=pp), ids)


class _Shape:
    def __init__(self, **kw):
        self.shape = kw


def test_sp_compatible_matches_jax():
    for dp, tp, sp in ((1, 1, 2), (2, 1, 2), (1, 2, 4), (2, 2, 2)):
        mesh = _Shape(dp=dp, tp=tp, sp=sp, pp=1)
        for b, h, sq, sk in ((2, 4, 64, 64), (1, 4, 64, 64), (2, 3, 64, 7),
                             (2, 4, 6, 6), (2, 4, 64, 77), (4, 8, 16, 12)):
            assert (tring.sp_compatible(mesh, b, h, sq, sk)
                    == jring.sp_compatible(mesh, b, h, sq, sk)), \
                (dp, tp, sp, b, h, sq, sk)
        assert tring.sp_compatible(mesh, 1, 1, 8 * sp, 8 * sp, local=True)


@pytest.mark.parametrize("kw,n", [({"tp": 2}, 2), ({"dp": 2, "sp": 2}, 4),
                                  ({"pp": 4}, 4)])
def test_mesh_needs_its_ranks(kw, n):
    with pytest.raises(MlisError) as e:
        pmesh.Mesh(**kw)
    assert e.value.code == MlisError.E_OPT_VALUE
    assert f"torchrun --nproc-per-node {n}" in str(e.value)


def test_backend_choice():
    assert comm.backend_for("cpu", 2) == "gloo"
    assert comm.world_size() == 1 and comm.rank() == 0


# -- the functions on ranks -------------------------------------------------

D_MODEL, N_HEAD, D_CTX = 64, 8, 32
P5 = dict(d_model=32, d_kv=8, n_head=4, d_ff=36, n_layer=2, n_vocab=64)


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


def _block_params():
    def f(ctx, x, c):
        return JB.basic_transformer(ctx, "blk", x, c, D_MODEL, D_MODEL,
                                    N_HEAD)

    spec = JB.trace_spec(f, jnp.zeros((2, 16, D_MODEL)),
                         jnp.zeros((2, 7, D_CTX)))
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.1
              for k, s in spec.items()}
    rx = np.random.default_rng(1)
    x = rx.standard_normal((2, 16, D_MODEL)).astype(np.float32)
    c = rx.standard_normal((2, 7, D_CTX)).astype(np.float32)
    return f, params, x, c


def _port(params, prefix):
    return {k[len(prefix):]: v.numpy()
            for k, v in params_from_jax(params).items()}


def _t5_case():
    P = jt5.T5Params(**P5)
    toks = (np.arange(16, dtype=np.int32).reshape(2, 8) * 5) % P.n_vocab
    spec = JB.trace_spec(lambda ctx, t: jt5.t5_encode_apply(ctx, t, P),
                         jnp.asarray(toks))
    rng = np.random.default_rng(7)
    params = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.05
              for k, s in spec.items()}
    ref = np.asarray(jax.jit(lambda p, t: jt5.t5_encode_apply(
        JB.Ctx(p, dtype=jnp.float32), t, P))(params, jnp.asarray(toks)))
    return _port(params, "t5."), toks, ref


QKV = {"ring": (64, 64), "cross": (64, 7)}


@pytest.fixture(scope="module")
def fn_refs():
    """The JAX functions' outputs, once (2 devices; the functions do not
    depend on the device count) and the inputs they were given."""
    refs, inputs = {}, {}
    mesh = jmesh.make_mesh(2, sp=2)
    for name, (sq, sk) in QKV.items():
        q, k, v = _qkv(3, 2, 4, sq, sk, 16)
        fn = jring.ring_attention if sq == sk else jring.sp_cross_attention
        refs[name] = np.asarray(fn(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), mesh))
        inputs[name] = {"q": q, "k": k, "v": v}
    f, params, x, c = _block_params()
    mesh = jmesh.make_mesh(2, tp=2)
    fwd = tp_basic_transformer(mesh, "blk", N_HEAD, D_MODEL)
    placed = shard_transformer_params(
        {k: jnp.asarray(v) for k, v in params.items()}, "blk", mesh, N_HEAD)
    # jitted with the placed weights closed over (their shardings give
    # the shard_map's specs); eager, it compiles op by op
    refs["tp_block"] = np.asarray(jax.jit(lambda x_, c_: fwd(placed, x_, c_))(
        jnp.asarray(x), jnp.asarray(c)))
    inputs["tp_block"] = {"params": _port(params, "blk."), "d": D_MODEL,
                          "d_ctx": D_CTX, "n_head": N_HEAD, "x": x, "c": c}
    p5, toks, refs["tp_t5"] = _t5_case()
    inputs["tp_t5"] = {"params": p5, "P": P5, "tokens": toks}
    return refs, inputs


def _fn_cases(world, inputs, files):
    """The function cases for ``world`` ranks: every axis at that size;
    on two, the server at tp = 2 and the CLI at dp = 2."""
    front = [("serve", "serve", {"ckpt": files["sd1"], "mesh": {"tp": 2}}),
             ("cli", "cli", {"ckpt": files["sd1"], "png": files["png"],
                             "mesh": {"dp": 2}})]
    return ([(n, "ring", {**inputs[n], "sp": world}) for n in QKV]
            + [(n, n, {**inputs[n], "tp": world})
               for n in ("tp_block", "tp_t5")]
            + [("pipeline", "pipeline", {"depth": 4, "pp": world, "n": 4,
                                         "seed": world})]
            + (front + [(f"q_linears_{k}", "q_linears", {"kind": k})
                        for k in R.Q_LINEARS] if world == 2 else []))


# -- sessions ---------------------------------------------------------------

PROMPT = "a (cat:1.3) riding a [bicycle]"
NPROMPT = "blurry, low quality"
J_SD3 = dataclasses.replace(JT.TINY_MMDIT, depth=4)
J_SD3_Q = jmmdit.MmditParams(**{**vars(R.SD3_Q), "ch_adm_in": 64})
J_FLUX = dataclasses.replace(JT.TINY_FLUX_DEV, depth_double=2,
                             depth_single=3)
# the quantizing SD1 geometry in the JAX package's parameter classes
J_SD1_Q = japi.ModelTypeDef(
    "sd1", jclip.ClipParams(**vars(T.TINY_Q_CLIP)), None,
    junet.UnetParams(**vars(T.TINY_Q_UNET)), T.TINY_VAE, 64, 1)
J_TYPES = {
    "sd1": {"sd1": J_TINY_SD1},
    "sd1_q": {"sd1": J_SD1_Q},
    "sd3": {"sd3": japi.ModelTypeDef("sd3", JT.TINY_CLIP, JT.TINY_CLIP2,
                                     J_SD3, JT.TINY_VAE_SD3, 64, 2)},
    "sd3_q": {"sd3": japi.ModelTypeDef("sd3", JT.TINY_CLIP, JT.TINY_CLIP2,
                                       J_SD3_Q, JT.TINY_VAE_SD3, 64, 2)},
    "flux": {"flux_dev": japi.ModelTypeDef("flux_dev", JT.TINY_CLIP, None,
                                           J_FLUX, JT.TINY_VAE_FLUX, 64,
                                           1)},
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    out = {"sd1": str(d / "sd1.safetensors"), "sd3": str(d / "sd3.safetensors"),
           "sd3_q": str(d / "sd3q.safetensors"),
           "sd35": str(d / "sd35.safetensors"),
           "sd3_d3": str(d / "sd3d3.safetensors")}
    write_tiny_checkpoint(out["sd1"])
    out["sd1_q"] = str(d / "sd1q.safetensors")
    _write_sd1_q(out["sd1_q"])
    out["png"] = str(d / "in.png")
    rng = np.random.default_rng(3)
    image_mod.image_save(out["png"], rng.integers(0, 256, (64, 64, 3),
                                                  dtype=np.uint8))
    JT.write_checkpoint_sd3(out["sd3"], seed=5, P=J_SD3)
    JT.write_checkpoint_sd3(out["sd3_q"], seed=6, P=J_SD3_Q)
    (d / "flux").mkdir()
    out["flux"] = JT.write_tiny_flux_files(d / "flux", P=J_FLUX)
    for k in ("sd35", "sd3_d3"):
        mt = next(iter(R.TYPES[k].values()))
        T.write_random_checkpoint(out[k], mt, seed=7, dtype=np.float32)
    return out


def _write_sd1_q(path):
    """A checkpoint of the quantizing SD1 geometry from the JAX package's
    parameter specs (tests/test_torch_e2e.py's ``tiny_q_ckpt``)."""
    P = J_SD1_Q
    spec = JB.trace_spec(
        lambda ctx, toks: jclip.clip_text_apply(ctx, toks, P.clip_p),
        jnp.zeros((1, 77), jnp.int32))
    spec.update(JB.trace_spec(
        lambda ctx, x, t, c: junet.unet_apply(ctx, x, t, c, None, P.unet_p),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 128))))
    spec.update(JB.trace_spec(
        lambda ctx, x: jvae.vae_encode_apply(ctx, x, T.TINY_VAE),
        jnp.zeros((1, 64, 64, 3))))
    spec.update(JB.trace_spec(
        lambda ctx, x: jvae.vae_decode_apply(ctx, x, T.TINY_VAE),
        jnp.zeros((1, 8, 8, 4))))
    save_file(spec_to_checkpoint_arrays(spec, seed=7), path)


def _opts(files, types, extra=(), steps=2):
    """A request's options: the model files of ``types``, then ``extra``."""
    if types == "flux":
        f = files["flux"]
        base = [("model", f["model"]), ("clip", f["clip"]), ("vae", f["vae"]),
                ("model-type", "flux_dev"), ("cfg-scale", 3.5)]
    else:
        mt = next(iter(R.TYPES[types]))
        base = [("model", files[types]), ("model-type", mt),
                ("cfg-scale", 7.0 if types == "sd1" else 5.0),
                ("nprompt", NPROMPT)]
    return base + [("image-dim", 64), ("steps", steps), ("seed", 42),
                   ("prompt", PROMPT)] + list(extra)


def _jax_run(types, opts, env=None):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "_model_types", lambda: dict(J_TYPES[types]))
        if env:
            # the JAX package reads MLIS_Q8_MODE when it traces: no
            # program traced in the other mode may be reused
            for k, v in env.items():
                mp.setenv(k, v)
            jax.clear_caches()
        s = japi.MLImgSynth()
        traj = []
        for k, v in opts:
            s.option_set(k, v)
        s._dtype = jnp.float32
        s.step_observer = lambda i, lat: traj.append(
            np.asarray(lat, np.float32).copy())
        img = np.asarray(s.generate(), np.float32)
    return traj, img


B2 = [("batch-size", 2)]
Q8 = [("weight-type", "q8_0")]
Q4 = [("weight-type", "q4_0")]
TP2 = [("tp", 2)]
M1 = {"MLIS_PP_MICRO": "1"}
I8 = {"MLIS_Q8_MODE": "int8"}
# the SD3 pattern at the size where its image-stream weights are stored
# per column (2 x 1024 image tokens)
D512 = [("image-dim", 512)]
# name -> (model, options, environment, the JAX reference's key or None)
SESSIONS = {
    2: {"sd1_tp2": ("sd1", [("tp", 2)], None, "sd1"),
        "sd1_sp2": ("sd1", [("sp", 2)], None, "sd1"),
        "sd1_dp2": ("sd1", B2 + [("dp", 2)], None, "sd1_b2"),
        "sd3_sp2": ("sd3", [("sp", 2)], None, "sd3"),
        "sd3_pp2": ("sd3", [("pp", 2)], None, "sd3"),
        "sd3_pp2_m1": ("sd3", [("pp", 2)], M1, "sd3"),
        "sd3_one": ("sd3", [], None, None),
        "sd3q_pp2": ("sd3_q", Q8 + [("pp", 2)], None, "sd3_q"),
        "flux_tp2": ("flux", [("tp", 2)], None, "flux"),
        "flux_pp2": ("flux", [("pp", 2)], None, "flux"),
        "flux_one": ("flux", [], None, None),
        "sd1_tp2_pag": ("sd1", [("tp", 2), ("pag-scale", 3.0)], None, None),
        "sd1_pag": ("sd1", [("pag-scale", 3.0)], None, None),
        "sd35_tp2": ("sd35", [("tp", 2)], None, None),
        "sd35_one": ("sd35", [], None, None),
        "sd1q_tp2_q8": ("sd1_q", Q8 + TP2, None, "sd1q_q8"),
        "sd1q_tp2_q4": ("sd1_q", Q4 + TP2, None, "sd1q_q4"),
        "sd1q_tp2_int8": ("sd1_q", Q8 + TP2, I8, "sd1q_int8"),
        "sd3q_tp2_q8": ("sd3_q", Q8 + TP2 + D512, None, "sd3q_512"),
        "no_pp_tp": ("sd1", [("pp", 2), ("tp", 2)], None, None),
        "no_pp_unet": ("sd1", [("pp", 2)], None, None),
        "no_pp_mmditx": ("sd35", [("pp", 2)], None, None),
        "no_pp_depth": ("sd3_d3", [("pp", 2)], None, None),
        "no_slg_pp": ("sd3", [("pp", 2), ("slg-scale", 2.5),
                              ("slg-layers", "1")], None, None),
        "no_deepcache_mesh": ("sd1", [("tp", 2), ("deepcache", 3)], None,
                              None),
        "no_pp_sp": ("sd1", [("pp", 2), ("sp", 2)], None, None)},
    4: {"sd1_dp2tp2": ("sd1", B2 + [("dp", 2), ("tp", 2)], None, "sd1_b2"),
        "sd3_pp4": ("sd3", [("pp", 4)], None, "sd3"),
        "sd3_pp4_m1": ("sd3", [("pp", 4)], M1, "sd3"),
        "sd3_one": ("sd3", [], None, None),
        "no_world": ("sd1", [("tp", 2)], None, None)},
}
JAX_REFS = {"sd1_b2": ("sd1", B2), "sd3": ("sd3", []),
            "sd3_q": ("sd3_q", Q8), "flux": ("flux", []),
            "sd1q_q8": ("sd1_q", Q8 + TP2), "sd1q_q4": ("sd1_q", Q4 + TP2),
            "sd3q_512": ("sd3_q", Q8 + TP2 + D512),
            "sd1q_int8": ("sd1_q", Q8 + TP2, I8)}


@pytest.fixture(scope="module")
def jax_refs(files):
    """The JAX session's requests; SD1's batch of one is row 0 of its
    batch of two (each row draws its own noise stream, seed + row)."""
    out = {k: _jax_run(t, _opts(files, t, extra), *env)
           for k, (t, extra, *env) in JAX_REFS.items()}
    traj, img = out["sd1_b2"]
    out["sd1"] = [a[:1] for a in traj], img[:1]
    return out


def _spawn(world, files, inputs):
    """One spawn of ``world`` ranks: the function cases, then the
    sessions; each rank's results."""
    scases = [(name, t, _opts(files, t, extra), env)
              for name, (t, extra, env, _) in SESSIONS[world].items()]
    return comm.spawn(R.run, world, (_fn_cases(world, inputs, files),
                                     scases), timeout=600)


@pytest.fixture(scope="module")
def ranks2(files, fn_refs):
    return _spawn(2, files, fn_refs[1])


@pytest.fixture(scope="module")
def ranks4(files, fn_refs):
    return _spawn(4, files, fn_refs[1])


@pytest.fixture(params=[2, 4], ids=["ranks2", "ranks4"])
def ranks(request, fn_refs):
    """(world, each rank's results, the JAX function references)."""
    return (request.param, request.getfixturevalue(f"ranks{request.param}"),
            fn_refs[0])


def test_ring_attention_matches_jax(ranks):
    world, out, refs = ranks
    for r in range(world):
        np.testing.assert_allclose(out[r]["ring"], refs["ring"], atol=2e-6)


def test_sp_cross_attention_matches_jax(ranks):
    world, out, refs = ranks
    for r in range(world):
        np.testing.assert_allclose(out[r]["cross"], refs["cross"],
                                   atol=2e-6)


def test_tp_block_matches_tp_basic_transformer(ranks):
    world, out, refs = ranks
    for r in range(world):
        y, heads = out[r]["tp_block"]
        assert heads == [N_HEAD // world] * 2
        np.testing.assert_allclose(y, refs["tp_block"], atol=1e-5)


def test_tp_t5_matches_jax(ranks):
    world, out, refs = ranks
    for r in range(world):
        np.testing.assert_allclose(out[r]["tp_t5"], refs["tp_t5"],
                                   atol=2e-5)


def test_pipeline_matches_sequential_stack(ranks):
    world, out, _ = ranks
    for r in range(world):
        ref, outs, n_blocks = out[r]["pipeline"]
        assert n_blocks == 4 // world
        np.testing.assert_array_equal(outs[1], ref)
        for m in (2, 4):
            np.testing.assert_allclose(outs[m], ref, atol=1e-6,
                                       err_msg=f"m={m}")


def test_t5_tp_params_shape():
    """The T5 relative-position bias keeps the rank's heads: a tp share of
    the tiny T5 holds n_head / tp bias columns and attention heads."""
    import torch
    from mlimgsynth_torch.parallel import tensor_parallel as tpar

    P = tt5.T5Params(**P5)
    with torch.device("meta"):
        m = tt5.T5Encoder(P)
    full = {k: torch.zeros(s) for k, s in module_shapes(m, "t5.").items()}
    sh = tpar.shard(m, "t5.", full, 2, 1, None)
    key = "t5.encoder.block.0.layer.0.SelfAttention.relative_attention_bias" \
          ".weight"
    assert tuple(sh[key].shape) == (P.rel_buckets, P.n_head // 2)
    att = m.encoder.block[1].layer[0].SelfAttention
    assert att.n_head == 2 and att.q.out_features == 2 * P.d_kv
    assert att.o.in_features == 2 * P.d_kv and att.o.out_features == 32
    assert dataclasses.asdict(P)["n_head"] == 4


def _session_cases(world):
    return [(world, n) for n, c in SESSIONS[world].items() if c[3]]


# sessions whose products take the W8A8 route (weights stored per column):
# the activations are quantized, and an f32 ulp upstream can move one of
# them a step, which later layers spread; held, as one rank is in
# tests/test_torch_dit_quant_session.py, to a relative L2 of 1e-3 a step
W8A8 = {"sd3q_tp2_q8"}


def _check_session(got, ref, name):
    traj, img = got[:2]
    traj_j, img_j = ref
    assert len(traj) == len(traj_j) == 2
    for i, (a, b) in enumerate(zip(traj_j, traj)):
        if name.split(" ")[0] in W8A8:
            rel = np.linalg.norm(b - a) / np.linalg.norm(a)
            assert rel < 1e-3, (name, i, rel)
            continue
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name}: step {i + 1} latent")
    assert img.shape == img_j.shape
    np.testing.assert_allclose(img, img_j, atol=1.5 / 255,
                               err_msg=f"{name}: image")


@pytest.mark.parametrize("world,name", _session_cases(2) + _session_cases(4),
                         ids=[n for _, n in _session_cases(2)
                              + _session_cases(4)])
def test_session_matches_jax(request, jax_refs, world, name):
    out = request.getfixturevalue(f"ranks{world}")
    ref = jax_refs[SESSIONS[world][name][3]]
    for r in range(world):
        _check_session(out[r][name], ref, f"{name} rank {r}")
    # every rank holds the same image
    for r in range(1, world):
        np.testing.assert_array_equal(out[r][name][1], out[0][name][1])


@pytest.mark.parametrize("world,name,single", [
    (2, "sd3_pp2_m1", "sd3_one"), (4, "sd3_pp4_m1", "sd3_one"),
    (2, "flux_pp2", "flux_one")])
def test_pp_bit_for_bit_with_one_rank(request, world, name, single):
    out = request.getfixturevalue(f"ranks{world}")
    for r in range(world):
        traj, img = out[r][name][:2]
        traj1, img1 = out[r][single][:2]
        for a, b in zip(traj, traj1):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(img, img1)


@pytest.mark.parametrize("name,single", [("sd1_tp2_pag", "sd1_pag"),
                                         ("sd35_tp2", "sd35_one")])
def test_tp_matches_one_rank(ranks2, name, single):
    """Under tp, PAG's identity self-attention (v_proj then the
    row-parallel out_proj) and MMDiT-X's attn2 with qk-norm on a rank's
    heads give the one-rank session's latents and image."""
    for r in range(2):
        traj, img = ranks2[r][name][:2]
        traj1, img1 = ranks2[r][single][:2]
        assert len(traj) == len(traj1) == 2
        for i, (a, b) in enumerate(zip(traj1, traj)):
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                       err_msg=f"{name}: step {i + 1}")
        np.testing.assert_allclose(img, img1, atol=1.5 / 255)


REFUSALS = {"no_pp_tp": "does not compose", "no_pp_unet": "MMDiT",
            "no_pp_mmditx": "MMDiT-X", "no_pp_depth": "must divide",
            "no_slg_pp": "slg-scale", "no_deepcache_mesh": "mesh",
            "no_pp_sp": "does not compose",
            "no_world": "torchrun --nproc-per-node 2"}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_mesh_refusals_raise(request, name):
    world = 2 if name in SESSIONS[2] else 4
    out = request.getfixturevalue(f"ranks{world}")
    for r in range(world):
        kind, code, msg = out[r][name]
        assert kind == "error" and code == MlisError.E_OPT_VALUE, msg
        assert REFUSALS[name] in msg, msg


# -- tp with quantized weight types: the shares ------------------------------

# the fused column-parallel projections: their parts, each split over tp
_FUSED = {".qkv": 3, ".ff.net.0.proj": 2}


def _share(full, got, name, r):
    """Rank ``r``'s share of the one-rank tensor ``full``, told from the
    shape it holds: the whole tensor, rows of each fused part, or whole
    128-blocks of K (the packed int4 half as many bytes, the per-block
    scales one column a block)."""
    if got.shape == full.shape:
        return full
    stem = name.rsplit(".weight", 1)[0]
    if got.shape[0] != full.shape[0]:
        n = next((v for k, v in _FUSED.items() if stem.endswith(k)), 1)
        parts = np.split(full, n, axis=0)
        return np.concatenate([np.split(p, 2, axis=0)[r] for p in parts])
    return np.split(full, 2, axis=1)[r]


@pytest.mark.parametrize("name", ["sd1q_tp2_q8", "sd1q_tp2_q4",
                                  "sd3q_tp2_q8"])
def test_tp_quantized_shares_are_slices(ranks2, files, name):
    """Each rank's stored quantized tensors against the one-rank port
    session's (the same file and weight type, loaded here): bit for bit
    the matching slice; some column-parallel, some row-parallel split by
    K, and (SD3) some kept whole with their input gathered."""
    types, extra, _, _ = SESSIONS[2][name]
    opts = [o for o in _opts(files, types, extra) if o[0] != "tp"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "_model_types", lambda: dict(R.TYPES[types]))
        s = tapi.MLImgSynth(device="cpu")
        for k, v in opts:
            s.option_set(k, v)
        s.setup()
        full = R._q_shares(s)
    kinds = set()
    for r in range(2):
        got = ranks2[r][name][2]
        assert got.keys() == full.keys() and len(got) > 20
        for key, v in got.items():
            want = _share(full[key], v, key, r)
            np.testing.assert_array_equal(v, want, err_msg=key)
            kinds.add("whole" if v.shape == full[key].shape
                      else "rows" if v.shape[0] != full[key].shape[0]
                      else "k")
    if name.startswith("sd3"):
        # the per-column row-parallel weights stay whole
        percol = [k for k, v in full.items()
                  if k.endswith("_scale") and v.ndim == 1]
        assert percol and {"rows", "whole"} <= kinds
    else:
        assert kinds == {"rows", "k", "whole"}


@pytest.mark.parametrize("kind", list(R.Q_LINEARS))
def test_tp_quantized_linears(ranks2, kind):
    """A rank's quantized linears against the whole ones on the same input:
    a column-parallel share gives the whole output's columns bit for bit
    (the per-column weight on the W8A8 route the whole (K, N) picks, at
    its slab); a per-block row-parallel share whose K splits into whole
    128-blocks sums to the whole output in f32 (QRowLinear); a per-column
    row-parallel weight and K 640 stay whole, their input gathered, bit
    for bit (QGatherLinear)."""
    for r in range(2):
        for name, (whole, got, cls, slabs) in \
                ranks2[r][f"q_linears_{kind}"].items():
            k = R.Q_LINEARS[kind][2][name][0]
            if name.endswith("q_proj"):
                assert cls == "QLinear" and slabs == [((128, 512), 512)]
                np.testing.assert_array_equal(
                    got, np.split(whole, 2, axis=1)[r])
            elif k == 640 or kind == "percol":
                assert cls == "QGatherLinear"
                assert slabs == ([((256, 2048), 1024)] if kind == "percol"
                                 else [])
                np.testing.assert_array_equal(got, whole)
            else:
                assert cls == "QRowLinear" and slabs == []
                np.testing.assert_allclose(got, whole, rtol=1e-5,
                                           atol=1e-5 * np.abs(whole).max())


def test_server_on_ranks(ranks2):
    """rank 0 serves, rank 1 follows: the queued pair is one merged batch
    within 1.5/255 of a one-rank server's images; the request cancelled at
    its first step answers 499 and both ranks leave its loop there."""
    out0 = ranks2[0]["serve"]
    assert out0["merged"] == 1
    for a, b in zip(out0["images"], out0["one_rank"]):
        assert a.shape == b.shape == (64, 64, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1.5
    assert out0["cancel"] == "cancelling"
    assert out0["cancelled"] == (499, "cancelled")
    steps0 = out0["steps"]
    assert steps0 == ranks2[1]["serve"]["steps"]
    assert steps0 == [(2, 1, False), (2, 2, False), (2, 3, False),
                      (1, 1, True)]


def test_cli_commands_on_ranks(ranks2, files, tmp_path, monkeypatch):
    """``vae-test`` and ``clip-encode`` at dp = 2: both ranks exit 0, rank 0
    alone writes, and its files equal the one-rank CLI's."""
    out = [ranks2[r]["cli"] for r in range(2)]
    assert [o["rc"] for o in out] == [[0, 0], [0, 0]]
    assert out[1]["files"] == []
    assert "round.png" in out[0]["files"]
    assert "clip-embed.tensor" in out[0]["files"]
    monkeypatch.setattr(tapi, "_model_types",
                        lambda: dict(R.TYPES["sd1"]))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["vae-test", "-b", "cpu", "-m", files["sd1"], "-i",
                     files["png"], "-o", "round.png", "-S", "5"]) == 0
    assert cli.main(["clip-encode", "-b", "cpu", "-m", files["sd1"], "-p",
                     "a (cat:1.2)"]) == 0
    np.testing.assert_array_equal(out[0]["image"],
                                  image_mod.png_read("round.png")[0])
    np.testing.assert_array_equal(out[0]["embed"],
                                  image_mod.tensor_load("clip-embed.tensor"))
