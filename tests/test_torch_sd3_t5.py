"""SD3 with T5 context: the port's session against the JAX session's on a
tiny SD3 checkpoint with a tiny T5 encoder, in f32 on the CPU.

The T5 weights come two ways: a file of their own through the ``t5``
option (bare HF names, as ``testing.write_random_t5`` writes them) and
bundled in the model file under ``text_encoders.t5xxl.transformer.`` (the
sd3 single-file layout); the tokenizer is a Unigram ``tokenizer.json``
whose post-processor appends ``</s>``.  At ``t5_tokens`` 77 and 128 the
conditioning (77 CLIP rows, then the T5 rows zero-padded to the context
width) and every step's latent agree with the JAX session at atol/rtol
1e-4.  Without a tokenizer the T5 rows stay zero in both; a missing file,
a file without T5 tensors and a missing tensor raise ``MlisError``; under
``unet_split`` the encoder stays on the device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from mlimgsynth_tpu.api import MLImgSynth as JaxSession
from mlimgsynth_tpu.testing import write_checkpoint_sd3
from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import testing as T
from torch_jax_memo import jax_spec_memo  # noqa: F401

PROMPT = "a (red:1.2) fox, in the  snow…"
BUNDLE = "text_encoders.t5xxl.transformer."


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sd3t5")
    out = {k: str(d / f"{k}.safetensors") for k in ("sd3", "t5", "bundle")}
    write_checkpoint_sd3(out["sd3"], seed=5)
    T.write_random_t5(out["t5"], T.TINY_T5_SD3, seed=6, dtype=np.float32)
    merged = load_file(out["sd3"])
    merged.update({BUNDLE + k: v for k, v in load_file(out["t5"]).items()})
    save_file(merged, out["bundle"])
    out["tok"] = str(d / "tokenizer.json")
    T.write_tokenizer_json(out["tok"], T.unigram_tokenizer_spec(
        T.random_unigram_pieces(T.TINY_T5_SD3.n_vocab, seed=7),
        charsmap=T.build_charsmap({"…": "..."}), eos=True))
    return out


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setenv("MLIS_TINY_MODELS", "1")
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd3": T.TINY_MODEL_TYPE_SD3})


def _run(s, model, opts):
    traj = []
    if isinstance(s, JaxSession):
        s._dtype = jnp.float32
    for k, v in [("model", model), ("image-dim", 64), ("steps", 3),
                 ("seed", 9), ("cfg-scale", 4.0), ("prompt", PROMPT),
                 ("nprompt", "blurry")] + opts:
        s.option_set(k, v)
    s.step_observer = lambda i, lat: traj.append(
        np.asarray(lat, np.float32).copy())
    s.generate()
    return traj


@pytest.mark.parametrize("how", ["t5_file", "bundled"])
@pytest.mark.parametrize("n_tok", [77, 128])
def test_sd3_t5_matches_jax(files, how, n_tok):
    model = files["sd3"] if how == "t5_file" else files["bundle"]
    opts = [("t5-tokenizer", files["tok"]), ("t5-tokens", n_tok)]
    if how == "t5_file":
        opts.append(("t5", files["t5"]))
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    traj_j, traj_t = _run(js, model, opts), _run(ts, model, opts)
    cond_t = ts.tensors["cond"]
    assert cond_t.shape == (1, 77 + n_tok, 80)
    t5_rows = cond_t[:, 77:]
    assert np.abs(t5_rows[..., :64]).max() > 0.1
    assert not t5_rows[..., 64:].any()          # zero-padded to 80
    np.testing.assert_allclose(cond_t, np.asarray(js.tensors["cond"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ts.tensors["ncond"],
                               np.asarray(js.tensors["ncond"]),
                               atol=1e-4, rtol=1e-4)
    assert len(traj_t) == len(traj_j) == 3
    for i, (a, b) in enumerate(zip(traj_j, traj_t)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i} latent mismatch")
    assert ts._t5 is not None and ts._t5.P == T.TINY_T5_SD3


def test_no_tokenizer_keeps_zero_rows(files):
    """T5 weights without a tokenizer: the JAX session warns and keeps 77
    zero rows; so does the port, and it loads no encoder."""
    js, ts = JaxSession(), torch_api.MLImgSynth(device="cpu")
    opts = [("t5", files["t5"])]
    traj_j, traj_t = _run(js, files["sd3"], opts), _run(ts, files["sd3"],
                                                         opts)
    assert ts.tensors["cond"].shape == (1, 154, 80)
    assert not ts.tensors["cond"][:, 77:].any()
    assert ts._t5 is None
    for a, b in zip(traj_j, traj_t):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)


def test_t5_stays_resident_under_unet_split(files):
    ts = torch_api.MLImgSynth(device="cpu")
    opts = [("t5", files["t5"]), ("t5-tokenizer", files["tok"]),
            ("unet-split", 1)]
    _run(ts, files["sd3"], opts)
    assert ts._t5 is not None
    assert "clip.text." not in ts.resident and "mmdit." not in ts.resident
    first = ts._t5
    _run(ts, files["sd3"], opts)
    assert ts._t5 is first                       # loaded once


@pytest.mark.parametrize("case", ["missing_file", "no_t5_tensors",
                                  "missing_tensor"])
def test_t5_load_errors(files, tmp_path, case):
    path = str(tmp_path / "t5.safetensors")
    code = torch_api.MlisError.E_UNKNOWN
    if case == "missing_file":
        path, code = str(tmp_path / "none.safetensors"), \
            torch_api.MlisError.E_FILE_NOT_FOUND
    elif case == "no_t5_tensors":
        save_file({"other.weight": np.zeros((2, 2), np.float32)}, path)
    else:
        t5 = load_file(files["t5"])
        del t5["encoder.block.1.layer.1.DenseReluDense.wo.weight"]
        save_file(t5, path)
    ts = torch_api.MLImgSynth(device="cpu")
    with pytest.raises(torch_api.MlisError) as e:
        _run(ts, files["sd3"], [("t5", path),
                                ("t5-tokenizer", files["tok"])])
    assert e.value.code == code
