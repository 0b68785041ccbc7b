"""Checkpoint -> model parameters (port of ``mlimgsynth_tpu/weights.py``).

Raw checkpoint names map to the internal names through the ``nameconv``
rules (OpenCLIP fused qkv split into thirds, HF Linear-stored
text projection transposed).  Checkpoints already hold torch layouts, so a
tensor only changes shape where the checkpoint stores a 1x1 conv as a linear
or the reverse (SDXL's ``proj_in`` / ``proj_out`` are linears [C, C], the
UNet's 1x1 convs [C, C, 1, 1]: the same values, reshaped).
``params_from_jax`` converts the JAX package's parameter layouts (linear
[in, out], conv HWIO) for the parity tests.
"""
from __future__ import annotations

import concurrent.futures
import os
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from .io.tensorstore import TensorStore
from .models import tae as tae_mod
from .models.blocks import QLinear
from .nameconv import QKV, TProj, normalize_lora_name, normalize_name
from .ops import quant, quant_plan


@dataclass
class NameRef:
    raw: str                     # raw checkpoint tensor name
    split: Optional[int] = None  # 0/1/2 = q/k/v third of a fused tensor
    transpose: bool = False      # HF Linear-stored text_projection.weight


def register_name(out: Dict[str, NameRef], raw: str, r) -> None:
    """Register one ``normalize_name`` result (a name, a ``QKV`` or a
    ``TProj``) for ``raw``; the first mapping wins.  ``final_layer.*`` has
    the same names in the MMDiT and Flux layouts: an ``mmdit.`` one is
    also registered under ``flux.`` (``mlimgsynth_tpu/weights.py:
    39-59``)."""
    if r is None:
        return
    if isinstance(r, QKV):
        stem, suffix = ((r.name[:-len("in_proj_weight")], "weight")
                        if r.name.endswith("in_proj_weight")
                        else (r.name[:-len("in_proj_bias")], "bias"))
        for i, which in enumerate(("q_proj", "k_proj", "v_proj")):
            out.setdefault(f"{stem}{which}.{suffix}", NameRef(raw, split=i))
    elif isinstance(r, TProj):
        out.setdefault(r.name, NameRef(raw, transpose=True))
    else:
        out.setdefault(r, NameRef(raw))
        if r.startswith("mmdit.final_layer."):
            out.setdefault("flux." + r[len("mmdit."):], NameRef(raw))


def build_name_map(store: TensorStore) -> Dict[str, NameRef]:
    """Internal name -> checkpoint entry; the first mapping wins."""
    out: Dict[str, NameRef] = {}
    for raw in store.tensors:
        register_name(out, raw, normalize_name(raw))
    return out


def merge_prefixed(name_map: Dict[str, NameRef], store: TensorStore,
                   prefix: str, transform: Callable) -> int:
    """Map the tensors of an auxiliary file, read into ``store`` under
    ``prefix``, into ``name_map`` through ``transform(name in the file)``,
    a ``normalize_name``-style result (``merge_prefixed``,
    ``mlimgsynth_tpu/weights.py:67-75``).  Returns how many names it
    added."""
    n0 = len(name_map)
    for raw in store.tensors:
        if raw.startswith(prefix):
            register_name(name_map, raw, transform(raw[len(prefix):]))
    return len(name_map) - n0


# the denoiser tensors ``identify_model`` reads, in its order
_PROBES = ("unet.in.1.1.transf.0.attn2.k_proj.weight",
           "unet.in.4.1.transf.0.attn2.k_proj.weight",
           "mmdit.joint_blocks.0.x_block.attn.qkv.weight",
           "flux.double_blocks.0.img_attn.qkv.weight")


def identify_model(store: TensorStore, name_map: Dict[str, NameRef],
                   width_table: Mapping[int, str]) -> Optional[str]:
    """Model type from the UNet cross-attention K width (ref:
    mlis_model_identify), probed in the first block that has one (SDXL's
    first level has no attention); the SD3 family from its MMDiT joint
    blocks (width 2432: SD3.5-large; a second x-block attention: SD3.5-
    medium); Flux from its double blocks (``guidance_in``: dev)
    (``mlimgsynth_tpu/weights.py:78-114``).  None when nothing matches."""
    for probe in _PROBES[:2]:
        ref = name_map.get(probe)
        if ref is not None:
            return width_table.get(int(store.tensors[ref.raw].shape[-1]))
    ref = name_map.get(_PROBES[2])
    if ref is not None:
        if int(store.tensors[ref.raw].shape[-1]) == 2432:
            return "sd35_large"
        if "mmdit.joint_blocks.0.x_block.attn2.qkv.weight" in name_map:
            return "sd35_medium"
        return "sd3"
    if _PROBES[3] in name_map:
        return ("flux_dev" if "flux.guidance_in.in_layer.weight" in name_map
                else "flux_schnell")
    return None


def stored_type(store: TensorStore, name_map: Dict[str, NameRef]
                ) -> Optional[str]:
    """The stored type ("f16", "q8_0", ...) of the denoiser tensor that
    :func:`identify_model` reads, the file's weight type (the second value
    of the JAX package's ``identify_model``); None where it reads none."""
    ref = next((name_map[p] for p in _PROBES if p in name_map), None)
    return None if ref is None else store.tensors[ref.raw].dtype


def read_entry(store: TensorStore, ref: NameRef) -> np.ndarray:
    """One (possibly split or transposed) checkpoint tensor, in its stored
    float type (f32 for bf16 and quantized data)."""
    x = store.read(ref.raw)
    if ref.split is not None:
        d = x.shape[0] // 3
        x = x[ref.split * d:(ref.split + 1) * d]
    if ref.transpose:
        x = x.T
    return x


def module_shapes(module: nn.Module, prefix: str) -> Dict[str, Tuple[int, ...]]:
    """Internal name -> shape of every parameter of ``module``."""
    return {prefix + k: tuple(v.shape) for k, v in module.state_dict().items()}


def load_params(store: TensorStore, name_map: Dict[str, NameRef],
                shapes: Mapping[str, Tuple[int, ...]], device,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Read every parameter in ``shapes`` to ``device`` in ``dtype``."""
    out: Dict[str, torch.Tensor] = {}
    missing = []
    for name, shape in shapes.items():
        ref = name_map.get(name)
        if ref is None:
            missing.append(name)
            continue
        x = read_entry(store, ref)
        if x.size != int(np.prod(shape)):
            raise ValueError(f"{name}: checkpoint shape {x.shape} does not "
                             f"fit {shape}")
        t = torch.from_numpy(np.array(x, copy=True).reshape(shape))
        out[name] = t.to(device=device).to(dtype)
    if missing:
        raise KeyError(f"{len(missing)} tensors missing from checkpoint, "
                       "e.g. " + ", ".join(missing[:8]))
    return out


def load_module(module: nn.Module, prefix: str,
                params: Mapping[str, torch.Tensor]) -> nn.Module:
    """Assign ``params`` (internal names) to ``module``'s parameters; the
    module may live on the meta device.  Every parameter must be given."""
    sd = {k[len(prefix):]: v for k, v in params.items()
          if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True, assign=True)
    return module


def load_tae(path: str, device, dtype: torch.dtype, encoder: bool = False
             ) -> Optional[nn.Module]:
    """The TAE decoder (or, with ``encoder``, the encoder) of a taesd file
    (diffusers AutoencoderTiny names, no prefix;
    ``mlimgsynth_tpu/api.py:942-976`` reads them under ``tae.``), its
    geometry read from the file's shapes.  None for an encoder the file
    does not hold."""
    store = TensorStore.open(path)
    try:
        P = tae_mod.tae_params_from_shapes(
            {k: tuple(e.shape) for k, e in store.tensors.items()})
        if encoder and "encoder.layers.0.weight" not in store.tensors:
            return None
        with torch.device("meta"):
            m = (tae_mod.TaeEncoder if encoder else tae_mod.TaeDecoder)(P)
        name_map = {"tae." + raw: NameRef(raw) for raw in store.tensors}
        params = load_params(store, name_map, module_shapes(m, "tae."),
                             device, dtype)
    finally:
        store.close()
    return load_module(m, "tae.", params).eval()


# ---------------------------------------------------------------------------
# LoRA merging (the port of ``mlimgsynth_tpu/weights.py:218-296``,
# reference: src/lora.c)
# ---------------------------------------------------------------------------

def _lora_family(model_map: Mapping[str, NameRef]) -> str:
    """The loaded model's family, which tells the diffusers "transformer_
    blocks" layout of flux double blocks from SD3's joint blocks."""
    for k in model_map:
        if k.startswith("flux.double_blocks."):
            return "flux"
        if k.startswith("mmdit.joint_blocks."):
            return "mmdit"
    return "sd"


def _lora_names(lora_store: TensorStore, family: str) -> Dict[str, str]:
    """Internal (normalised) name -> raw name of a LoRA file's tensors."""
    out: Dict[str, str] = {}
    for raw in lora_store.tensors:
        r = normalize_lora_name(raw, family)
        if isinstance(r, str):
            out[r] = raw
    return out


def lora_targets(model_map: Mapping[str, NameRef],
                 lora_store: TensorStore) -> Set[str]:
    """The internal ``<stem>.weight`` names a LoRA file patches, from its
    tensor names alone (no data read)."""
    out = set()
    for internal in _lora_names(lora_store, _lora_family(model_map)):
        if internal.endswith(".lora_down.weight"):
            stem = internal[:-len(".lora_down.weight")]
            out.add(stem.split("@", 1)[0] + ".weight")
    return out


def lora_apply(model_store: TensorStore, model_map: Dict[str, NameRef],
               lora_store: TensorStore, mult: float,
               only: Optional[Callable[[str], bool]] = None) -> int:
    """Merge ``dst += mult * scale * up @ down`` into the model store's
    cache for every ``*.lora_down.weight`` of the LoRA file, in numpy f32 on
    the host, before the loader casts or quantizes anything (the JAX
    package's ``lora_apply``; ``scale`` is the file's ``.scale``, else its
    ``.alpha`` / rank, else 1).  A fused OpenCLIP q/k/v tensor takes the
    delta in its third; a diffusers-peft DiT stem's ``@num/span/den``
    fragment addresses rows ``[num*d, (num+span)*d)`` of the fused tensor,
    ``d = out // den``.  ``only(internal weight name)`` limits the merge to
    the weights it accepts.  The patches of one tensor apply in the file's
    order; different tensors merge in parallel threads (numpy's array
    operations release the interpreter lock), each by the same arithmetic
    as one at a time.  Raises ``FloatingPointError`` when a merged tensor
    is not finite (reference: src/lora.c:81-87).  Returns the number of
    tensors patched."""
    lora_map = _lora_names(lora_store, _lora_family(model_map))
    # checkpoint tensor -> its patches in file order: (stem, fragment,
    # destination entry, down name, up name)
    patches: Dict[str, list] = {}
    for internal, raw in lora_map.items():
        if not internal.endswith(".lora_down.weight"):
            continue
        stem = internal[:-len(".lora_down.weight")]
        base, frac = stem, None
        if "@" in stem:
            base, f = stem.split("@", 1)
            frac = tuple(int(v) for v in f.split("/"))
        if only is not None and not only(base + ".weight"):
            continue
        dst_ref = model_map.get(base + ".weight")
        if dst_ref is None:
            raise KeyError(f"lora tensor not found in model: {base}.weight")
        up_raw = lora_map.get(stem + ".lora_up.weight")
        if up_raw is None:
            raise KeyError(f"lora up tensor not found: {stem}.lora_up.weight")
        patches.setdefault(dst_ref.raw, []).append(
            (stem, frac, dst_ref, raw, up_raw))

    def scale_of(stem: str, rank: int) -> float:
        if stem + ".scale" in lora_map:
            return float(lora_store.read(lora_map[stem + ".scale"],
                                         "f32").reshape(-1)[0])
        if stem + ".alpha" in lora_map:
            return float(lora_store.read(lora_map[stem + ".alpha"],
                                         "f32").reshape(-1)[0]) / rank
        return 1.0

    def merge(dst_raw: str) -> np.ndarray:
        """The tensor ``dst_raw`` with its patches merged in order."""
        cur = None          # the tensor after the patches so far
        for stem, frac, dst_ref, raw, up_raw in patches[dst_raw]:
            down = lora_store.read(raw, "f32")
            up = lora_store.read(up_raw, "f32")
            scale = scale_of(stem, down.shape[0]) * mult
            delta = (up.reshape(up.shape[0], -1) @
                     down.reshape(down.shape[0], -1) * scale)
            if frac is not None or dst_ref.split is not None:
                # rows of a fused tensor: a peft slice or an OpenCLIP third
                full = np.array(model_store.read(dst_raw) if cur is None
                                else cur, np.float32, copy=True)
                num, span, den = (frac if frac is not None
                                  else (dst_ref.split, 1, 3))
                if full.shape[0] % den:
                    raise KeyError(f"lora slice {stem}: out dim "
                                   f"{full.shape[0]} not divisible by {den}")
                d = full.shape[0] // den
                sl = slice(num * d, (num + span) * d)
                full[sl] = full[sl] + delta.reshape(full[sl].shape)
            else:
                base_w = (read_entry(model_store, dst_ref) if cur is None
                          else cur.T if dst_ref.transpose else cur)
                full = base_w + delta.reshape(base_w.shape)
            if not np.isfinite(full).all():
                raise FloatingPointError(f"NaN in LoRA result for {stem}")
            cur = full
        return cur

    workers = min(8, os.cpu_count() or 1, max(len(patches), 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for dst_raw, full in zip(patches, pool.map(merge, patches)):
            model_store.cache_set(dst_raw, full)
    return sum(len(p) for p in patches.values())


def quantize_linear_weights(module: nn.Module, prefix: str,
                            params: Dict[str, torch.Tensor],
                            bits: int,
                            percol_m_hint: Optional[int] = None) -> int:
    """Weight-only quantization at load (ref: ``quantize_linear_weights``,
    ``mlimgsynth_tpu/weights.py:299-359``).  Every ``nn.Linear`` of
    ``module`` whose input width is a multiple of 128 becomes a ``QLinear``
    of ``bits`` (on the meta device, to be loaded), and its ``.weight`` in
    ``params`` (tensors in the compute dtype, on the CPU or the card)
    becomes ``.weight_q8`` or ``.weight_q4`` and ``.weight_scale``, made
    from the weight as loaded in that dtype, on the weight's device, by the
    torch quantizers of ``ops/quant.py`` (bit for bit the numpy ones).

    ``percol_m_hint`` (the DiT families' token count, ``quant_plan.
    dit_m_hint``): 8-bit weights whose shape ``percol_eligible`` picks are
    stored per column (int8 [N, K], scales [N]), all or none per (K, N):
    one weight whose worst column exceeds ``PERCOL_MAX_SCALE_RATIO`` keeps
    its whole shape group per block.  ``percol_from_blocks`` runs once per
    candidate weight.  Returns the number quantized."""
    fn = (quant.quantize_weight_q4_torch if bits == 4
          else quant.quantize_weight_torch)
    names = [name for name, m in module.named_modules()
             if isinstance(m, nn.Linear) and m.in_features % quant.KBLOCK == 0]
    groups: Dict[Tuple[int, int], list] = {}
    for name in names:
        lin = module.get_submodule(name)
        key = f"{prefix}{name}.weight"
        q, scale = fn(params.pop(key))
        params[f"{key}_q{bits}"] = q
        params[f"{key}_scale"] = scale
        k, n = lin.in_features, lin.out_features
        if (bits == 8 and percol_m_hint is not None
                and quant_plan.percol_eligible(k, n, percol_m_hint)):
            groups.setdefault((k, n), []).append(
                (name, quant.percol_from_blocks_torch(q, scale)))
    percol = set()
    for members in groups.values():
        if max(r for _, (_, _, r) in members) > quant.PERCOL_MAX_SCALE_RATIO:
            continue
        for name, (qc, sc, _) in members:
            key = f"{prefix}{name}.weight"
            params[f"{key}_q8"] = qc
            params[f"{key}_scale"] = sc
            percol.add(name)
    for name in names:
        lin = module.get_submodule(name)
        parent, _, attr = name.rpartition(".")
        with torch.device("meta"):
            ql = QLinear(lin.in_features, lin.out_features, bits,
                         bias=lin.bias is not None, percol=name in percol)
        setattr(module.get_submodule(parent), attr, ql)
    return len(names)


# JAX 2-D params kept as-is (embedding tables, position embeddings, text
# projection, T5's token and relative-position tables); every other 2-D
# param is a [in, out] linear weight
_AS_IS_2D = (".embed.token.weight", ".embed.position.weight", ".text_proj",
             ".shared.weight", ".relative_attention_bias.weight")


def params_from_jax(np_params: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """JAX-layout params (linear [in, out], conv HWIO; see
    ``mlimgsynth_tpu/models/blocks.py:28-32``) -> torch layout ([out, in],
    OIHW), f32 tensors on the CPU.  Quantized weights keep their type and
    turn over like linears: ``_q8`` [K, N] and ``_q4`` [K/2, N] int8 become
    [N, K] and [N, K/2], ``_scale`` [K/128, N] becomes [N, K/128]; a
    per-column ``_scale`` [N] and the MMDiT's ``pos_embed`` [1, g*g, d]
    stay as they are."""
    out = {}
    for name, a in np_params.items():
        # a copy: the source may be read-only
        a = np.array(a, np.int8 if name.endswith(("_q8", "_q4"))
                     else np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2 and not name.endswith(_AS_IS_2D):
            a = a.T
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out
