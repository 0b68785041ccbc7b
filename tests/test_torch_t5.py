"""The port's T5 v1.1 encoder and T5 tokenization against the JAX
package's on the CPU.

The encoder (``mlimgsynth_torch.models.t5.T5Encoder``) against
``t5_encode_apply`` on the same seeded parameters and tokens, in f32, at
d_model 128, 2 layers, 4 heads of 32, d_ff 256 and a 512-token vocabulary
(atol 1e-4); the relative-position buckets and the geometry read from
tensor shapes equal the JAX functions'; ``tokenize`` gives the JAX
``tokenize``'s ids on the tokenizer files the tests write, the JAX side
reading them through the ``tokenizers`` package, the port through its own
reader.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlimgsynth_tpu.models import blocks as JB
from mlimgsynth_tpu.models import t5 as jt5
from mlimgsynth_torch import testing as T
from mlimgsynth_torch import weights as tweights
from mlimgsynth_torch.api import MlisError
from mlimgsynth_torch.models import t5 as tt5
from torch_jax_memo import jax_spec_memo  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(P, seed=0):
    """Seeded JAX-layout parameters of a T5 encoder of geometry ``P``:
    norm scales around 1, the rest N(0, 1/fan_in)."""
    spec = JB.trace_spec(lambda ctx, t: jt5.t5_encode_apply(ctx, t, P),
                         jnp.zeros((1, 9), jnp.int32))
    rng = np.random.default_rng(seed)
    out = {}
    for name, ps in spec.items():
        if len(ps.shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(ps.shape)
        else:
            a = rng.standard_normal(ps.shape) / np.sqrt(ps.shape[0])
        out[name] = a.astype(np.float32)
    return out


def _port_encoder(P, np_params):
    with torch.device("meta"):
        m = tt5.T5Encoder(P)
    return tweights.load_module(m, "t5.", tweights.params_from_jax(
        np_params)).eval()


@pytest.mark.parametrize("seq", [9, 77, 140])
def test_t5_encoder_matches_jax(seq):
    P = T.TINY_T5
    params = _jax_params(P)
    rng = np.random.default_rng(seq)
    toks = rng.integers(0, P.n_vocab, (2, seq)).astype(np.int32)
    want = np.asarray(jt5.t5_encode_apply(
        JB.Ctx({k: jnp.asarray(v) for k, v in params.items()},
               dtype=jnp.float32), jnp.asarray(toks), P), np.float32)
    m = _port_encoder(P, params)
    with torch.no_grad():
        got = m(torch.from_numpy(toks.astype(np.int64))).numpy()
    assert got.shape == (2, seq, P.d_model)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("s", [1, 23, 77, 256])
def test_rel_bias_indices_match_jax(s):
    np.testing.assert_array_equal(tt5.rel_bias_indices(s),
                                  jt5.rel_bias_indices(s))


@pytest.mark.parametrize("P", [T.TINY_T5, T.TINY_T5_SD3, tt5.T5_XXL],
                         ids=["tiny", "tiny_sd3", "xxl"])
def test_geometry_from_shapes_matches_jax(P):
    shapes = {"t5." + k: v for k, v in T.t5_file_shapes(P).items()}
    got = tt5.params_from_spec_shapes(shapes)
    want = jt5.params_from_spec_shapes(shapes)
    assert got.__dict__ == want.__dict__
    assert got == P


def test_t5_file_writer_loads_through_the_session_loader(tmp_path):
    """A file from ``write_random_t5`` holds exactly the tensors the
    encoder loads, in HF names, and T5-XXL's come to 4.76 B values."""
    path = tmp_path / "t5.safetensors"
    T.write_random_t5(path, T.TINY_T5, seed=2, dtype=np.float32)
    from mlimgsynth_torch.io.tensorstore import TensorStore
    st = TensorStore.open(str(path))
    try:
        names = set(st.names())
        assert names == set(T.t5_file_shapes(T.TINY_T5))
        assert "encoder.block.1.layer.1.DenseReluDense.wo.weight" in names
    finally:
        st.close()
    n_xxl = sum(int(np.prod(s)) for s in T.t5_file_shapes(tt5.T5_XXL)
                .values())
    assert 4.7e9 < n_xxl < 4.8e9


def _word_level_file(path):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, "a": 3, "cat": 4, "dog": 5,
             "photo": 6, "of": 7}
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(path))


def _unigram_file(path, eos: bool):
    T.write_tokenizer_json(path, T.unigram_tokenizer_spec(
        T.random_unigram_pieces(512, seed=3), eos=eos))


TEXTS = ["a photo of a cat", "dog", "", "a cat, a dog!  of  photos",
         "x " * 200]


@pytest.mark.parametrize("kind", ["wordlevel", "unigram", "unigram_eos"])
@pytest.mark.parametrize("n_token", [8, 77, 256])
def test_tokenize_matches_jax(tmp_path, kind, n_token):
    """``tokenize`` against the JAX ``tokenize`` (which reads the file with
    ``tokenizers``): cut at n_token - 1, EOS, padding.  A file whose
    post-processor appends ``</s>`` gives ids that end in two EOS in both
    packages (the JAX ``tokenize`` appends its own)."""
    path = str(tmp_path / "tokenizer.json")
    if kind == "wordlevel":
        _word_level_file(path)
    else:
        _unigram_file(path, eos=kind == "unigram_eos")
    want = jt5.tokenize(TEXTS, n_token=n_token, tokenizer_json=path)
    got = tt5.tokenize(TEXTS, n_token=n_token, tokenizer_json=path)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if kind == "unigram_eos" and n_token > 8:
        n = int((got[0] != tt5.T5_PAD_ID).sum())
        assert list(got[0, n - 2:n]) == [tt5.T5_EOS_ID, tt5.T5_EOS_ID]


def test_tokenize_without_a_file_raises():
    with pytest.raises(MlisError):
        tt5.tokenize(["x"], 8, None)
    with pytest.raises(MlisError):
        tt5.tokenize(["x"], 8, "/nonexistent/tokenizer.json")
