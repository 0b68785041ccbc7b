"""The port's quantized-matmul wrappers and CUDA kernels
(mlimgsynth_torch.ops.quant_matmul).

This file imports no jax, so that its ``cuda``-marked tests run on a
machine with an NVIDIA GPU and no JAX:

    MLIS_NO_TEST_CACHE=1 python -m pytest tests/test_torch_quant_kernels.py -q

Without a GPU those tests skip; the CPU tests check that CPU tensors take
the plain twin and never reach a kernel.
"""
import numpy as np
import pytest
import torch

from mlimgsynth_torch import testing
from mlimgsynth_torch.ops import _build, quant
from mlimgsynth_torch.ops import quant_matmul as qmm

KERNELS = ["q8_matmul_tile", "q8_matmul_ws", "q4_matmul_tile",
           "q4_matmul_ws", "q8_matmul_ws_int8", "q8_matmul_int8"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several pytest workers share a few cores (and the tensors are
    small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(k, n, bits, seed=0, percol=False):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)
    q, s = (quant.quantize_weight_q4 if bits == 4
            else quant.quantize_weight)(w)
    if percol:
        q, s, _ = quant.percol_from_blocks(q, s)
    return torch.from_numpy(q), torch.from_numpy(s)


def _plain(name):
    if name == "q8_matmul_ws_int8":
        return quant.q8_ws_int8_plain
    if name == "q8_matmul_int8":
        return quant.q8_matmul_int8_plain
    return quant.q4_matmul_plain if name.startswith("q4") \
        else quant.q8_matmul_plain


@pytest.mark.parametrize("name", KERNELS)
def test_cpu_tensors_take_the_plain_twin(monkeypatch, name):
    def no_build(lib):
        raise AssertionError(f"built {lib} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    qmm.reset_counts()
    bits = 4 if name.startswith("q4") else 8
    q, s = _pair(256, 48, bits, percol=name == "q8_matmul_ws_int8")
    x = torch.randn(2, 5, 256, generator=torch.Generator().manual_seed(0))
    out = getattr(qmm, name)(x, q, s)
    assert out.shape == (2, 5, 48)
    torch.testing.assert_close(out, _plain(name)(x, q, s), rtol=0, atol=0)
    assert set(qmm.LAUNCHES.values()) == {0}
    assert quant.PLAIN_CUDA_CALLS == 0


def test_unpack_q4_nibble_order():
    """Byte j of a 128-wide group holds group rows j (low nibble) and
    j + 64 (high nibble)."""
    w = np.zeros((1, 128), np.float32)
    w[0, 3], w[0, 67], w[0, 64] = 7.0, -7.0, 1.0
    q, _ = quant.quantize_weight_q4(w)
    assert q.shape == (1, 64) and q[0, 3] == np.int8(-112 | 7)
    got = quant.unpack_q4(torch.from_numpy(q))[0]
    want = torch.zeros(128, dtype=torch.int32)
    want[3], want[67], want[64] = 7, -7, 1
    assert torch.equal(got, want)


# The weight-stationary products of the main paths (M, K, N): SD1.5 512^2
# and SDXL 1024^2, CFG batch 2; K6 on q8_0, K10 on q4_0.
WS_PRODUCTS = [
    (8192, 1280, 320), (2048, 640, 5120), (2048, 2560, 640), (2048, 640, 640),
    (2048, 1280, 1280), (2048, 1280, 10240), (8192, 640, 640),
    (8192, 640, 5120), (8192, 2560, 640)]


@pytest.mark.parametrize("m,k,n", WS_PRODUCTS + [(2048, 5120, 1280)])
def test_use_ws_takes_exactly_the_ws_products(m, k, n):
    """The rule sends every SD1.5 and SDXL product with M >= 2048 to the ws
    kernel, SDXL's K = 5120 ff.net.2 (2048 rows) included: the ws kernel
    keeps no full-K stripe."""
    assert qmm.use_ws(m, k)


# The ws tiles of every main-path product fill at least this share of the
# waves they take on the H100's 132 SMs (a persistent block per SM).
WS_WAVE_FILL_MIN = 0.95


@pytest.mark.parametrize("m,k,n", WS_PRODUCTS)
def test_ws_tile_config_fills_whole_waves(m, k, n):
    bn = qmm.ws_tile_n(m, n)
    assert bn in qmm.WS_TILE_N and bn % 16 == 0 and bn <= 256
    assert qmm.ws_config(m, n, k, 132) == bn
    tiles = -(-m // qmm.WS_BM) * -(-n // bn)
    assert tiles / (132 * -(-tiles // 132)) >= WS_WAVE_FILL_MIN, (bn, m, n)


# The W8A8 products of the main paths with M >= 2048 (M, K, N): K7 on the
# SD3-medium 1024^2 x stream (CFG batch 2), K8 on an SDXL 1024^2 request
# under MLIS_Q8_MODE=int8.
I8_PRODUCTS = [
    (8192, 1536, 4608), (8192, 1536, 1536), (8192, 1536, 6144),
    (8192, 6144, 1536), (8192, 640, 5120), (8192, 2560, 640),
    (8192, 640, 640), (2048, 1280, 10240), (2048, 5120, 1280),
    (2048, 1280, 1280)]


@pytest.mark.parametrize("m,k,n", I8_PRODUCTS)
def test_i8_tile_n_fills_whole_waves(m, k, n):
    bn = qmm.i8_tile_n(m, n)
    assert bn in qmm.I8_TILE_N
    tiles = -(-m // qmm.WS_BM) * -(-n // bn)
    assert tiles / (132 * -(-tiles // 132)) >= WS_WAVE_FILL_MIN, (bn, m, n)


@pytest.mark.parametrize("m,k,n", [(2, 2816, 1280), (154, 2048, 1280)])
def test_i8_tile_n_spreads_small_m(m, k, n):
    """Where M fits one 128-row tile the narrowest width puts the most
    blocks on the weight stream (no split-K: it would change the f32
    rounding)."""
    assert qmm.i8_tile_n(m, n) == min(qmm.I8_TILE_N)


# The tiled products of the main paths (M, K, N), CFG batch 2: SD1.5 512^2
# (the 16 x 16 level's 512 rows, the 8 x 8 level's 128, cross-attention k/v
# and CLIP-L at 2 x 77 tokens, the embeddings at 2 rows), SDXL 1024^2 (k/v
# at K 2048, the two text towers, the embeddings and the label MLP) and
# SD3-medium 1024^2 (the context stream at 2 x 154 tokens, the context
# embedder, adaLN and the t/y embedders at 2 rows).
TILE_PRODUCTS = [
    (512, 1280, 1280), (512, 1280, 10240), (512, 5120, 1280),
    (128, 1280, 1280), (128, 1280, 10240), (128, 5120, 1280),
    (154, 768, 320), (154, 768, 640), (154, 768, 1280), (154, 768, 768),
    (154, 768, 3072), (154, 3072, 768), (2, 1280, 1280), (2, 1280, 640),
    (2, 1280, 320),
    (154, 2048, 640), (154, 2048, 1280), (154, 1280, 3840),
    (154, 1280, 1280), (154, 1280, 5120), (154, 5120, 1280),
    (2, 2816, 1280),
    (308, 1536, 4608), (308, 1536, 1536), (308, 1536, 6144),
    (308, 6144, 1536), (308, 4096, 1536), (2, 1536, 9216), (2, 1536, 3072),
    (2, 256, 1536), (2, 1536, 1536), (2, 2048, 1536)]


@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 63, 64, 65, 77, 128, 129, 154,
                               192, 193, 255, 256])
def test_tile_config_holds_every_row_up_to_256(m):
    """Up to 256 rows one row range holds every row of the product, so each
    weight is dequantized once."""
    ranges, nt = qmm.tile_config(m)
    assert ranges == 1 and m <= nt <= 256


@pytest.mark.parametrize("m", [257, 308, 512, 1000, 2047, 4097])
def test_tile_config_dequantizes_at_most_once_per_256_rows(m):
    ranges, nt = qmm.tile_config(m)
    assert ranges == -(-m // 256)
    assert (ranges - 1) * nt < m <= ranges * nt   # no range is empty


@pytest.mark.parametrize("m,k,n", TILE_PRODUCTS)
def test_tile_config_pads_little(m, k, n):
    """At the main paths' products a range is padded by at most a quarter
    (or to the narrowest wgmma N, 8 rows): the padded rows cost tensor-core
    work and shared memory, not bytes from device memory."""
    ranges, nt = qmm.tile_config(m)
    rows = -(-m // ranges)
    assert rows <= nt <= max(8, 1.25 * rows), (ranges, nt)


@pytest.mark.parametrize("m,k,n", TILE_PRODUCTS)
def test_tile_width_is_a_wgmma_n(m, k, n):
    """The width is a bf16 wgmma N (a multiple of 8 up to 256) that the
    launcher instantiates."""
    _, nt = qmm.tile_config(m)
    assert nt in qmm.TILE_NT and nt % 8 == 0 and 8 <= nt <= 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build with nvcc for "
                    "sm_90a)")


# bf16 in and out, held to the limits of testing.quant_error (relative L2
# 4e-3 and elementwise 2^-8 + 2^-7 |ref|; the reasons are stated there)
@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind,m,k,n,where", testing.QUANT_CASES)
def test_kernel_matches_plain_on_cuda(cuda, bits, kind, m, k, n, where):
    name = f"q{bits}_matmul_{kind}"
    x, q, s = testing.quant_inputs(m, k, n, bits)
    before = dict(qmm.LAUNCHES)
    out = getattr(qmm, name)(x, q, s)
    plain = quant.q4_matmul_plain if bits == 4 else quant.q8_matmul_plain
    ref = plain(x, q, s)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES[name] == before[name] + 1
    res = testing.quant_error(out, ref)
    assert res["ok"], (where, res)


# Flux's one-row products (a sample's embedders and modulations, no CFG
# batch): the kernel bit for bit its plain version, on an input drawn as in
# the model (SiLU of a normal row, the embedders' and modulations' input).
# Unpadded, cuBLAS summed (1, 3072, 3072) in another order than the kernel
# (4 of 3,072 outputs a bf16 step off on the H100), which drifted a whole
# Flux-dev q8_0 evaluation by 1.8e-2 against its plain run.
FEW_ROW_PRODUCTS = [(1, 3072, 3072, "Flux time_in / vector_in out_layer"),
                    (1, 3072, 18432, "Flux double-block modulation"),
                    (1, 3072, 9216, "Flux single-block modulation"),
                    (1, 256, 3072, "Flux time_in in_layer"),
                    (2, 3072, 3072, "a CFG batch of two rows")]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n,where", FEW_ROW_PRODUCTS)
def test_few_row_products_match_plain_bit_for_bit_on_cuda(cuda, bits, m, k,
                                                          n, where):
    _, q, s = testing.quant_inputs(m, k, n, bits)
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    x = torch.nn.functional.silu(
        torch.randn(m, k, device="cuda", generator=gen) * 2.0).bfloat16()
    name = f"q{bits}_matmul_tile"
    out = getattr(qmm, name)(x, q, s)
    ref = (quant.q4_matmul_plain if bits == 4 else quant.q8_matmul_plain)(
        x, q, s)
    assert torch.equal(out, ref), (where, (out != ref).sum().item())


# bf16 in and out, held to the limits of testing.int8_error (the reasons
# are stated there)
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,where", testing.INT8_CASES)
def test_int8_kernel_matches_plain_on_cuda(cuda, m, k, n, where):
    x, q, s = testing.int8_inputs(m, k, n)
    before = dict(qmm.LAUNCHES)
    out = qmm.q8_matmul_ws_int8(x, q, s)
    ref = quant.q8_ws_int8_plain(x, q, s)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["q8_matmul_ws_int8"] == before["q8_matmul_ws_int8"] + 1
    res = testing.int8_error(out, ref)
    assert res["ok"], (where, res)


# bf16 in and out, held to the limits of testing.q8_int8_error (the reasons
# are stated there)
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,where", testing.Q8_INT8_CASES)
def test_q8_int8_kernel_matches_plain_on_cuda(cuda, m, k, n, where):
    x, q, s = testing.quant_inputs(m, k, n, 8)
    before = dict(qmm.LAUNCHES)
    out = qmm.q8_matmul_int8(x, q, s)
    ref = quant.q8_matmul_int8_plain(x, q, s)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["q8_matmul_int8"] == before["q8_matmul_int8"] + 1
    res = testing.q8_int8_error(out, ref)
    assert res["ok"], (where, res)


@pytest.mark.cuda
def test_int8_mode_dispatch_on_cuda(cuda, monkeypatch):
    """Under MLIS_Q8_MODE=int8 a per-block weight runs K8 at every M; a
    per-column weight keeps the W8A8 kernel on per-column scales where the
    plan picks it and runs K8 on broadcast scales elsewhere."""
    monkeypatch.setenv("MLIS_Q8_MODE", "int8")
    for m in (2, 2048):
        x, q, s = testing.quant_inputs(m, 640, 64, 8)
        before = dict(qmm.LAUNCHES)
        qmm.q8_dot(x.view(1, m, 640), q, s)
        assert qmm.LAUNCHES["q8_matmul_int8"] == before["q8_matmul_int8"] + 1
    for m, kind in ((8192, "ws_int8"), (308, "int8")):
        x, q, s = testing.int8_inputs(m, 1536, 1536)
        before = dict(qmm.LAUNCHES)
        qmm.q8_dot(x.view(1, m, 1536), q, s)
        name = f"q8_matmul_{kind}"
        assert qmm.LAUNCHES[name] == before[name] + 1, m


@pytest.mark.cuda
def test_percol_dispatch_on_cuda(cuda):
    """A per-column weight runs the W8A8 kernel where the plan picks it
    (the SD3 x stream's 8192 rows), the tiled kernel on broadcast scales at
    the context stream's 308 rows."""
    for m, kind in ((8192, "ws_int8"), (308, "tile")):
        x, q, s = testing.int8_inputs(m, 1536, 1536)
        before = dict(qmm.LAUNCHES)
        qmm.q8_dot(x.view(1, m, 1536), q, s)
        name = f"q8_matmul_{kind}"
        assert qmm.LAUNCHES[name] == before[name] + 1, m


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_dispatch_launches_the_rule_on_cuda(cuda, bits):
    dot = qmm.q4_dot if bits == 4 else qmm.q8_dot
    for m, k, kind in ((2048, 640, "ws"), (2047, 640, "tile"),
                       (4096, 3456, "ws")):
        x, q, s = testing.quant_inputs(m, k, 64, bits)
        before = dict(qmm.LAUNCHES)
        dot(x.view(1, m, k), q, s)
        name = f"q{bits}_matmul_{kind}"
        assert qmm.LAUNCHES[name] == before[name] + 1, (m, k)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_ws_kernel_takes_any_k_on_cuda(cuda, bits):
    """The ws kernel keeps no full-K stripe: K = 3456, past the largest K
    whose stripe fit the first ws design, runs and agrees with the twin
    (ragged N)."""
    name = f"q{bits}_matmul_ws"
    x, q, s = testing.quant_inputs(2048, 3456, 200, bits)
    out = getattr(qmm, name)(x, q, s)
    ref = (quant.q4_matmul_plain if bits == 4 else quant.q8_matmul_plain)(
        x, q, s)
    torch.cuda.synchronize()
    res = testing.quant_error(out, ref)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_ws_kernel_ragged_n_on_cuda(cuda, bits):
    """N not a multiple of 8 (no tensor map of y: the kernel stores from
    registers): the first 100 columns of a 104-column product, the latter
    held to the twin (its TMA store path), bit for bit."""
    name = f"q{bits}_matmul_ws"
    x, q, s = testing.quant_inputs(2048, 640, 104, bits)
    full = getattr(qmm, name)(x, q, s)
    part = getattr(qmm, name)(x, q[:100].contiguous(), s[:100].contiguous())
    ref = (quant.q4_matmul_plain if bits == 4 else quant.q8_matmul_plain)(
        x, q, s)
    torch.cuda.synchronize()
    assert testing.quant_error(full, ref)["ok"]
    assert torch.equal(part, full[:, :100])


@pytest.mark.cuda
def test_i8_tile_n_matches_the_launcher_on_cuda(cuda):
    """The C launcher of K7 and K8 picks its tile width by the rule of
    ``i8_tile_n``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = qmm._lib()
    for m, _, n in I8_PRODUCTS + [(2, 2816, 1280), (154, 2048, 1280),
                                  (77, 1280, 72), (4097, 640, 200)]:
        assert lib.q8_int8_tile_n(m, n, sms) == qmm.i8_tile_n(m, n, sms)


@pytest.mark.cuda
def test_tile_config_matches_the_launcher_on_cuda(cuda):
    """The C launcher of K5 and K9 picks its geometry by the rule of
    ``tile_config``."""
    lib = qmm._lib()
    for m in sorted({m for m, _, _ in TILE_PRODUCTS} | {1, 77, 257, 4097}):
        ranges, nt = qmm.tile_config(m)
        assert lib.qmm_tile_config(m) == (ranges << 16) | nt, m


@pytest.mark.cuda
def test_launch_checks_inputs_on_cuda(cuda):
    x, q, s = testing.quant_inputs(64, 256, 64, 8)
    before = dict(qmm.LAUNCHES)
    with pytest.raises(TypeError):
        qmm.q8_matmul_tile(x.float(), q, s)
    with pytest.raises(ValueError, match="multiple of 128"):
        qmm.q8_matmul_tile(x[:, :192], q[:, :192], s)
    with pytest.raises(ValueError, match="multiple of 128"):
        qmm.q4_matmul_tile(x, q, s)   # a q8 weight is not [N, K/2]
    with pytest.raises(ValueError, match="16-byte"):
        off = torch.zeros(64 * 256 + 4, device="cuda",
                          dtype=torch.bfloat16)[4:].view(64, 256)
        qmm.q8_matmul_tile(off, q, s)
    with pytest.raises(ValueError, match="scales"):
        qmm.q8_matmul_ws_int8(x, q, s)       # per-block scales
    with pytest.raises(ValueError, match="slab"):
        xi, qi, si = testing.int8_inputs(8, 4224, 32)
        qmm.q8_matmul_ws_int8(xi, qi, si)
    with pytest.raises(ValueError, match="scales"):
        xi, qi, si = testing.int8_inputs(8, 256, 32)
        qmm.q8_matmul_int8(xi, qi, si)       # per-column scales
    assert qmm.LAUNCHES == before
