"""The port's flash-attention wrappers and CUDA kernels
(mlimgsynth_torch.ops.flash_attention).

This file imports no jax, so that its ``cuda``-marked tests run on a
machine with an NVIDIA GPU and no JAX:

    MLIS_NO_TEST_CACHE=1 python -m pytest tests/test_torch_kernels.py -q

Without a GPU those tests skip; the CPU tests check that CPU tensors take
the plain twin and never reach a kernel.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mlimgsynth_torch import testing
from mlimgsynth_torch.ops import _build
from mlimgsynth_torch.ops import attention as tattn
from mlimgsynth_torch.ops import flash_attention as tfa


def _qkv(b, h, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)) for s in (sq, sk, sk)]


def test_cpu_tensors_never_launch(monkeypatch):
    """On CPU tensors the wrappers run the plain twin, build nothing and
    count no launch."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    tfa.reset_counts()
    for d in (40, 160):
        q, k, v = _qkv(1, 2, 512, 520, d, seed=d)
        want = tattn.attention_xla(q, k, v)
        for fn in (tfa.flash_attention, tattn.attention, tfa.flash_attn_fwd,
                   *([tfa.flash_attn_fwd_wide] if d > 128 else [])):
            torch.testing.assert_close(fn(q, k, v), want, rtol=0, atol=0)
    q, k, v = (t.bfloat16() for t in _qkv(1, 2, 2048, 2048, 64, seed=3))
    torch.testing.assert_close(tattn.attention(q, k, v),
                               tfa.flash_attn_joint(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(tfa.flash_attn_joint(q, k, v),
                               tattn.attention_xla(q, k, v), rtol=0, atol=0)
    assert tfa.LAUNCHES == {"flash_attn_fwd": 0, "flash_attn_fwd_wide": 0,
                            "flash_attn_joint": 0}
    assert tfa.PLAIN_CUDA_CALLS == 0


def test_build_key_covers_headers(tmp_path, monkeypatch):
    """A library is keyed on its source and on every header of csrc/ (the
    sources include hopper.cuh), so an edited header rebuilds it."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build._lib_path("k")
    assert first == _build._lib_path("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert len({first, second, _build._lib_path("k")}) == 3
    assert first.parent == tmp_path / "build"


def test_sources_share_the_hopper_header():
    """Both kernel sources take the mbarrier, TMA and wgmma helpers from
    the one header the build key covers, and define none of them again."""
    for name in ("flash_attention", "quant_matmul"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in src
        for helper in ("void mbar_wait(", "void tma_load_2d(",
                       "uint64_t sw128_desc(", "EncodeTiledFn encode_tiled("):
            assert helper not in src, (name, helper)
    assert (_build.CSRC / "hopper.cuh").exists()


# head dim -> the kernel flash_attention picks: up to 160 the Hopper
# kernel of K1 and K3 (its P V width 40, 64, 80, 128 or 160), wider the
# wide kernel of K2
@pytest.mark.parametrize("d,name", [
    (40, "flash_attn_fwd"), (64, "flash_attn_fwd"), (80, "flash_attn_fwd"),
    (128, "flash_attn_fwd"), (136, "flash_attn_fwd"),
    (144, "flash_attn_fwd"), (160, "flash_attn_fwd"),
    (168, "flash_attn_fwd_wide"), (256, "flash_attn_fwd_wide"),
    (512, "flash_attn_fwd_wide")])
def test_flash_attention_routes_by_head_dim(monkeypatch, d, name):
    got = []
    for n in ("flash_attn_fwd", "flash_attn_fwd_wide", "flash_attn_joint"):
        monkeypatch.setattr(tfa, n, lambda *a, n=n, **k: got.append(n))
    q, k, v = _qkv(1, 1, 512, 512, d)
    tfa.flash_attention(q, k, v)
    assert got == [name]


# the session's routes (ops.attention) at head dim 160: SD1.5's level 2 at
# 1024^2 (S 1024, the flash gate) and at 2048^2 (S 4096: past the K3 gate's
# S floor, which a head dim of 160, no multiple of 128, does not pass)
@pytest.mark.parametrize("s", [1024, 4096])
def test_session_attention_takes_head_dim_160_to_flash_attn_fwd(
        monkeypatch, s):
    got = []
    for n in ("flash_attn_fwd", "flash_attn_fwd_wide", "flash_attn_joint"):
        monkeypatch.setattr(tfa, n, lambda *a, n=n, **k: got.append(n))
    q = torch.zeros(2, 8, s, 160, dtype=torch.bfloat16)
    for fn in (tattn.attention, tattn.attention_t):
        fn(q, q, q)
    assert got == ["flash_attn_fwd"] * 2


# The flash gate is the JAX package's whatever the dtype: an f32 or f16
# tensor past it reaches the flash wrapper, which on a card launches the
# bf16 kernel or raises, and never gives way to the plain path (meta tensors
# stand for the card's here); a weight-type f32 session is refused on the
# card instead (test_session_refuses_f32_on_a_card)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_attention_routes_every_dtype_by_the_jax_gate(monkeypatch, dtype):
    got = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, *a, **k: got.append(("flash", q.dtype)))
    monkeypatch.setattr(tattn, "attention_xla",
                        lambda q, *a, **k: got.append(("plain", q.dtype)))
    for s, d in ((1024, 40), (1024, 160), (1024, 512)):
        q = torch.empty(2, 8, s, d, dtype=dtype, device="meta")
        for fn in (tattn.attention, tattn.attention_t):
            fn(q, q, q)
        tattn.attention_t(q, q, q, causal=True)
    assert got == [("flash", dtype), ("flash", dtype), ("plain", dtype)] * 3


# On a card the compute type is bf16: a session whose weight type computes
# in f32 is refused at setup, before it loads anything, with the reason;
# every other weight type passes, and the CPU takes f32 (the device is set
# to the card's after the session is made, before the weight type: there is
# no card here)
@pytest.mark.parametrize("wt,refused", [
    ("f32", True), ("bf16", False), ("f16", False), ("q8_0", False),
    ("q4_0", False)])
def test_session_refuses_f32_on_a_card(wt, refused):
    from mlimgsynth_torch import api
    from mlimgsynth_torch.errors import MlisError
    s = api.MLImgSynth(device="cpu")
    s.option_set("weight-type", wt)
    s._card_dtype_check()                  # the CPU runs every weight type
    s = api.MLImgSynth(device="cpu")
    s.device = torch.device("cuda")
    s.option_set("weight-type", wt)
    if refused:
        with pytest.raises(MlisError, match="bf16") as e:
            s.setup()
        assert e.value.code == MlisError.E_OPT_VALUE
    else:
        s._card_dtype_check()


def test_launch_refuses_cpu_tensors():
    q, k, v = _qkv(1, 1, 512, 512, 40)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._launch("flash_attn_fwd", q, k, v, None, 0, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build with nvcc for "
                    "sm_90a)")


# bf16 in and out, held to the limits of testing.attention_error (relative
# L2 1e-2 and elementwise 4e-3 + 2^-6 |ref|; the reasons are stated there)
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 8, 4096, 4096, 40),
    (2, 8, 1024, 1024, 80),
    (2, 8, 4096, 4095, 40),
    (2, 10, 4096, 4096, 64),   # SDXL UNet, 64 x 64 level
    (2, 20, 1024, 1024, 64),   # SDXL UNet, 32 x 32 level
    (2, 4, 1000, 700, 64),
    (1, 1, 4096, 4096, 512),
    (1, 1, 4096, 4095, 512),
    (1, 2, 600, 520, 160),     # wide kernel below its 512 columns (by name)
    (1, 2, 600, 520, 256),     # wide kernel: the second warpgroup's columns all past d
    (1, 2, 600, 520, 384),     # wide kernel: half of them past d
    (1, 1, 1000, 700, 512),    # wide kernel, ragged Sq and Sk
    (2, 2, 600, 520, 512),     # wide kernel, B * H > 1
    (2, 8, 1000, 1024, 80),    # head dim 80 (two boxes, PV width 80), ragged Sq
    (1, 3, 650, 700, 80),      # head dim 80, ragged Sq and Sk
])
def test_kernel_matches_plain_on_cuda(cuda, b, h, sq, sk, d):
    q, k, v = testing.attention_inputs((b, h, sq, d), sk)
    before = dict(tfa.LAUNCHES)
    # past 128 the wide kernel by name: flash_attention sends d 160 to
    # flash_attn_fwd (test_head_dim_160_kernel_matches_plain_on_cuda)
    out = (tfa.flash_attn_fwd_wide if d > 128 else tfa.flash_attention)(
        q, k, v)
    ref = tfa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    name = "flash_attn_fwd" if d <= 128 else "flash_attn_fwd_wide"
    assert tfa.LAUNCHES[name] == before[name] + 1
    res = testing.attention_error(out, ref)
    assert res["ok"], res


# head dims in (128, 160] on flash_attn_fwd (three 64-column boxes, P V
# 160 wide), reached through flash_attention: the hires pass's level 2 and
# ragged Sq and Sk at d 136, 144 and 160
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 8, 1024, 1024, 160),
    (1, 2, 600, 520, 160),
    (2, 3, 1000, 700, 136),
    (1, 4, 777, 1100, 144),
    (1, 2, 64, 65, 160),
])
def test_head_dim_160_kernel_matches_plain_on_cuda(cuda, b, h, sq, sk, d):
    q, k, v = testing.attention_inputs((b, h, sq, d), sk)
    before = dict(tfa.LAUNCHES)
    out = tfa.flash_attention(q, k, v)
    ref = tfa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attn_fwd"] == before["flash_attn_fwd"] + 1
    assert tfa.LAUNCHES["flash_attn_fwd_wide"] == before["flash_attn_fwd_wide"]
    res = testing.attention_error(out, ref)
    assert res["ok"], res


# the joint kernel at the SD3-medium 1024^2 shape (CFG batch, 77 + 77 text
# rows and 4096 image tokens), a ragged S, and head dims 128 and 40
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,d", [
    (2, 24, 4250, 64),
    (1, 4, 2049, 64),
    (1, 2, 2100, 128),
    (1, 2, 2048, 40),
])
def test_joint_kernel_matches_plain_on_cuda(cuda, b, h, s, d):
    q, k, v = testing.attention_inputs((b, h, s, d), s)
    before = dict(tfa.LAUNCHES)
    out = tattn.attention(q, k, v)
    ref = tfa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attn_joint"] == before["flash_attn_joint"] + 1
    res = testing.attention_error(out, ref)
    assert res["ok"], res


@pytest.mark.cuda
def test_launch_checks_inputs_on_cuda(cuda):
    before = dict(tfa.LAUNCHES)
    q = torch.zeros(1, 1, 512, 40, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tfa.flash_attn_fwd(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        tfa.flash_attn_fwd(q, q[..., :32], q[..., :32])
    with pytest.raises(ValueError):
        tfa.flash_attn_fwd_wide(q, q, q)
    with pytest.raises(ValueError):
        q160 = torch.zeros(1, 1, 512, 160, device="cuda", dtype=torch.bfloat16)
        tfa.flash_attn_joint(q160, q160, q160)
    with pytest.raises(ValueError):
        kt = torch.zeros(1, 1, 40, 512, device="cuda", dtype=torch.bfloat16)
        tfa.flash_attn_fwd(q, kt.transpose(-1, -2), kt.transpose(-1, -2))
    # the tile loads are 16-byte vectors: d % 8 and unaligned bases refuse
    q36 = torch.zeros(1, 1, 512, 36, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_attn_fwd(q36, q36, q36)
    off = torch.zeros(1, 1, 512, 48, device="cuda",
                      dtype=torch.bfloat16)[..., 4:44]
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_attn_fwd(off, off, off)
    assert tfa.LAUNCHES == before


# the main path's layouts: the UNet's [N, S, H*D] projections viewed as
# [N, H, S, D], and the VAE mid-block's [N, S, 512] as [N, 1, S, 512]
@pytest.mark.cuda
@pytest.mark.parametrize("name,width,view", [
    ("flash_attn_fwd", 8 * 40, lambda t: t.view(2, 4096, 8, 40).transpose(1, 2)),
    ("flash_attn_fwd_wide", 512, lambda t: t[:, None]),
], ids=["unet", "vae"])
def test_kernel_reads_head_views_on_cuda(cuda, name, width, view):
    """The kernels read those strided views in place; the output keeps
    the same layout."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (view(torch.randn(2, 4096, width, device="cuda", generator=gen)
                    .bfloat16()) for _ in range(3))
    before = tfa.LAUNCHES[name]
    out = getattr(tfa, name)(q, k, v)
    assert tfa.LAUNCHES[name] == before + 1
    assert out.stride() == q.stride()
    ref = tfa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    res = testing.attention_error(out, ref)
    assert res["ok"], res


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent.parent / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_anchors():
    """(tool, source, the edits of its variant, the edit's index) for every
    distinct edit anchor of the kernel tools, which plant their faults,
    ablations and clock records by text replacement."""
    mutants = _tool("torch_kernel_mutants")
    ablate = _tool("torch_kernel_ablate")
    trace = _tool("torch_kernel_trace")
    tables = [("mutants", {v: (src, edits)
                           for v, (src, edits, _) in mutants.MUTANTS.items()})]
    for src, table in (("quant_matmul", ablate.ABLATIONS),
                       ("quant_matmul", ablate.W8A8_ABLATIONS),
                       ("flash_attention", ablate.FLASH_ABLATIONS)):
        tables.append(("ablate", {v: (src, e) for v, e in table.items()}))
    tables.append(("trace", {"clocks": ("quant_matmul", trace.EDITS)}))
    seen, out = set(), []
    for tool, table in tables:
        for variant, (src, edits) in table.items():
            for i, (old, _) in enumerate(edits):
                if (tool, src, old) not in seen:
                    seen.add((tool, src, old))
                    out.append(pytest.param(tool, src, edits, i,
                                            id=f"{tool}-{variant}-{i}"))
    return out


@pytest.mark.parametrize("tool,src,edits,i", _tool_anchors())
def test_tool_anchor_in_source(tool, src, edits, i):
    """Each edit anchor of tools/torch_kernel_{mutants,ablate,trace}.py is
    in its kernel source once the variant's earlier edits are made, as the
    tool applies them: a source change must not leave a tool editing
    nothing.  The trace tool's anchors occur exactly once (it refuses
    others), and so does every mutant anchor of the attention source, so
    that a fault planted in one attention kernel is planted in no other."""
    text = (_build.CSRC / f"{src}.cu").read_text()
    for old, new in edits[:i]:
        text = text.replace(old, new)
    count = text.count(edits[i][0])
    if tool == "trace" or (tool == "mutants" and src == "flash_attention"):
        assert count == 1, (edits[i][0], count)
    else:
        assert count >= 1, edits[i][0]
