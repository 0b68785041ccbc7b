"""tools/torch_rank_drift.py's comparison of a tp rank's record with one
rank's (the tool itself needs a card)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "torch_rank_drift",
    Path(__file__).resolve().parent.parent / "tools" / "torch_rank_drift.py")
drift = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(drift)


@pytest.mark.parametrize("name,want", [
    # a plain column-parallel linear: rank 0 holds the first half
    ("out.0.1.transf.0.attn1.q_proj", [0, 1, 2, 3]),
    # GEGLU's fused projection: the first half of the value and of the gate
    ("in.1.1.transf.0.ff.net.0.proj", [0, 1, 4, 5]),
])
def test_share_cuts_rank_0s_columns(name, want):
    ref = torch.arange(8.0).repeat(2, 3, 1)
    out = torch.zeros(2, 3, 4)
    assert drift._share(ref, out, name)[0, 0].tolist() == want
    assert drift._share(ref, ref.clone(), name) is ref
    assert drift._share(ref, torch.zeros(2, 3, 3), name) is None


def test_ulps_at_the_tensors_scale():
    b = torch.tensor([1.0, 3.0, 1e-6, -2.0], dtype=torch.bfloat16)
    a = b.clone()
    a[1] = 3.015625                        # one bf16 step above 3 (2^-6)
    a[2] = 1e-6 + 2.0 ** -8                # near zero: the RMS's ulp
    u = drift._ulps(a, b, torch.bfloat16)
    assert u[0] == 0 and u[3] == 0
    assert u[1] == 1.0
    assert 0 < u[2] <= 1.0


def test_compare_finds_the_first_departures():
    """In the order the modules ran: equal, one ulp off, two ulps off."""
    x = torch.full((4, 8), 1.5, dtype=torch.bfloat16)
    ref = {"out": {("a", 0): x, ("b", 0): x, ("c", 0): x, ("d", 0): x},
           "latents": [torch.ones(4), torch.ones(4)]}
    one, two = x.clone(), x.clone()
    one[0, 0] = 1.5078125                  # 1.5 + 2^-7: one ulp
    two[1, 1] = 1.515625                   # two ulps
    rec = {"out": {("a", 0): x, ("b", 0): one, ("c", 0): two,
                   ("d", 0): torch.zeros(4, 3)},
           "order": [("a", 0), ("b", 0), ("c", 0), ("d", 0)],
           "latents": [torch.ones(4), torch.full((4,), 1.1)]}
    img = np.full((2, 2, 3), 100, np.uint8)
    got = drift.compare(ref, rec, img, img)
    assert got["modules_compared"] == 3          # d's shapes do not match
    assert got["first_differing"]["module"] == "b#0"
    assert got["first_differing"]["max_ulps"] == 1.0
    assert got["first_past_one_ulp"]["module"] == "c#0"
    assert got["latent_rel_l2"] == [0.0]
    assert got["final_latent_rel_l2"] == pytest.approx(0.1)
    assert got["image_rel_l2"] == 0.0 and got["image_max_u8_diff"] == 0


def test_allow_f32_lifts_the_refusal_and_keeps_f32_off_the_kernels(
        monkeypatch):
    """Only in the tool's process, and only for f32: bf16 keeps the flash
    route (meta tensors stand for the card's)."""
    from mlimgsynth_torch import api
    from mlimgsynth_torch.ops import attention as tattn
    from mlimgsynth_torch.ops import flash_attention as tfa
    monkeypatch.setattr(tattn, "flash_attention_compatible",
                        tattn.flash_attention_compatible)
    monkeypatch.setattr(api.MLImgSynth, "_card_dtype_check",
                        api.MLImgSynth._card_dtype_check)
    drift._allow_f32()
    drift._allow_f32()                     # once is enough
    got = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, *a, **k: got.append(("flash", q.dtype)))
    monkeypatch.setattr(tattn, "attention_xla",
                        lambda q, *a, **k: got.append(("plain", q.dtype)))
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.empty(2, 8, 1024, 40, dtype=dtype, device="meta")
        tattn.attention_t(q, q, q)
    assert got == [("flash", torch.bfloat16), ("plain", torch.float32)]
    s = api.MLImgSynth(device="cpu")
    s.device = torch.device("cuda")
    s.option_set("weight-type", "f32")
    s._card_dtype_check()
