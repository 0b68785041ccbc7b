"""Checkpoint tensor-name normalization.

Maps every known checkpoint layout (CompVis SD1, OpenCLIP SD2, SDXL
``conditioner.embedders.{0,1}``, diffusers ``te/te1/te2`` and
``down_blocks/up_blocks/mid_block``) onto the internal naming scheme
``clip./clip2./vae./unet.`` used by the model param dicts
(reference: src/tensor_name_conv.c).  ``.``, ``_`` and ``/`` are treated as
equivalent separators when matching prefixes.

Return convention mirrors the reference: ``None`` = tensor unused,
``str`` = renamed, ``QKV(str)`` = OpenCLIP fused in_proj tensor that must be
split into q/k/v entries by the caller.
"""
from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class QKV:
    """Marker for fused OpenCLIP attention in_proj tensors."""
    name: str  # normalized prefix ending in 'attn.', plus 'in_proj_weight'/'bias'


@dataclass(frozen=True)
class TProj:
    """Marker for HF-layout ``text_projection.weight`` tensors: stored as a
    Linear [out,in] weight, while the internal ``text_proj`` param is the
    OpenCLIP-convention plain matrix — the loader transposes."""
    name: str


_SEPS = "._/"


def _match_prefix(name: str, pre: str) -> bool:
    """Prefix match treating '.' in the pattern as any of ``._/``."""
    if len(name) < len(pre):
        return False
    for a, b in zip(name, pre):
        if b == ".":
            if a not in _SEPS:
                return False
        elif a != b:
            return False
    return True


class _M:
    """Small matcher cursor over a tensor name."""

    def __init__(self, name: str):
        self.s = name
        self.out: list = []

    def match(self, pre: str) -> bool:
        return _match_prefix(self.s, pre)

    def rep(self, pre: str, rep: str) -> bool:
        if _match_prefix(self.s, pre):
            self.s = self.s[len(pre):]
            if rep:
                self.out.append(rep)
            return True
        return False

    def push(self, pre: str) -> bool:
        return self.rep(pre, pre)

    def num_push(self) -> bool:
        m = re.match(r"(\d+)[._/]", self.s)
        if not m:
            return False
        self.out.append(m.group(1) + ".")
        self.s = self.s[m.end():]
        return True

    def num_get(self):
        m = re.match(r"(\d+)[._/]", self.s)
        if not m:
            return None
        self.s = self.s[m.end():]
        return int(m.group(1))

    def done(self) -> str:
        # '/' never appears in internal names; '_' is kept (meaningful inside
        # component words like "time_embed").
        return "".join(self.out) + self.s.replace("/", ".")


def _clip_compvis(m: _M):
    # CompVis / HF transformers CLIPTextModel layout
    if not m.rep("transformer.text_model.", "text."):
        return None
    if m.rep("embeddings.", "embed."):
        if m.rep("position_embedding.", "position.") or \
           m.rep("token_embedding.", "token."):
            return m.done()
        return None
    if m.push("encoder.layers."):
        m.num_push()
        if m.rep("layer_norm1.", "norm1.") or m.rep("layer_norm2.", "norm2.") \
           or m.rep("self_attn.", "attn.") or m.push("mlp."):
            return m.done()
        return None
    if m.rep("final_layer_norm.", "ln_final."):
        return m.done()
    if m.rep("text_projection.weight", "text_proj"):
        # HF CLIPTextModelWithProjection stores the projection as a Linear
        # weight ([out,in]); internal text_proj is the plain matrix
        return TProj(m.done())
    if m.rep("text_projection", "text_proj"):
        return m.done()
    return None


def _clip_openclip(m: _M):
    if not m.rep("model.", "text."):
        return None
    if m.push("ln_final."):
        return m.done()
    if m.rep("token_embedding.", "embed.token."):
        return m.done()
    if m.rep("positional_embedding", "embed.position.weight"):
        return m.done()
    if m.rep("text_projection", "text_proj"):
        return m.done()
    if m.rep("transformer.resblocks.", "encoder.layers."):
        m.num_push()
        if m.rep("ln_1.", "norm1.") or m.rep("ln_2.", "norm2."):
            return m.done()
        if m.push("attn."):
            if m.push("in_proj_bias") or m.push("in_proj_weight"):
                return QKV(m.done())
            if m.push("out_proj."):
                return m.done()
            return None
        if m.rep("mlp.c_fc.", "mlp.fc1.") or m.rep("mlp.c_proj.", "mlp.fc2."):
            return m.done()
    return None


def _clip_diffusers(m: _M):
    if not m.rep("text_model.", "text."):
        return None
    if m.push("encoder.layers."):
        m.num_push()
        if m.rep("ln_1.", "norm1.") or m.rep("ln_2.", "norm2.") or \
           m.rep("self_attn.", "attn.") or m.push("mlp."):
            return m.done()
    return None


def _vae(m: _M):
    if m.push("decoder."):
        if m.push("up.") and m.num_push() and m.push("block.") and m.num_push():
            m.rep("nin_shortcut.", "skip_conv.")
        return m.done()
    if m.push("encoder."):
        if m.push("down.") and m.num_push() and m.push("block.") and m.num_push():
            m.rep("nin_shortcut.", "skip_conv.")
        return m.done()
    if m.push("quant_conv.") or m.push("post_quant_conv."):
        return m.done()
    return None


def _unet_block(m: _M):
    if m.rep("transformer_blocks.", "transf."):
        m.num_push()
        if m.push("attn1.") or m.push("attn2."):
            (m.rep("to_q.", "q_proj.") or m.rep("to_k.", "k_proj.") or
             m.rep("to_v.", "v_proj.") or m.rep("to_out.0.", "out_proj."))
            return m.done()
        if m.push("ff."):
            if m.push("net.0.") or m.push("net.2."):
                return m.done()
            return None
        if m.push("norm1.") or m.push("norm2.") or m.push("norm3."):
            return m.done()
        return None
    for pre, rep in (("in_layers.0.", "norm1."), ("in_layers.2.", "conv1."),
                     ("out_layers.0.", "norm2."), ("out_layers.3.", "conv2."),
                     ("emb_layers.1.", "emb_proj."),
                     ("skip_connection.", "skip_conv."), ("op.", "conv."),
                     # diffusers ResnetBlock2D inner names (the reference
                     # drops these; supported here for full diffusers layouts)
                     ("time_emb_proj.", "emb_proj."),
                     ("conv_shortcut.", "skip_conv.")):
        if m.rep(pre, rep):
            return m.done()
    for pre in ("norm.", "proj_in.", "proj_out.", "conv.",
                "norm1.", "norm2.", "conv1.", "conv2."):
        if m.push(pre):
            return m.done()
    return None


def _unet(m: _M):
    if m.push("time_embed."):
        return m.done()
    if m.rep("label_emb.0.", "label_embed."):
        return m.done()
    if m.rep("input_blocks.0.0.", "in.conv."):
        return m.done()
    if m.rep("out.0.", "out.norm.") or m.rep("out.2.", "out.conv."):
        return m.done()
    if (m.rep("input_blocks.", "in.") and m.num_push()) or \
       (m.rep("output_blocks.", "out.") and m.num_push()) or \
       m.rep("middle_block.", "mid."):
        m.num_push()
        return _unet_block(m)
    # diffusers layouts
    if m.rep("down_blocks.", "in."):
        n1 = m.num_get()
        if n1 is None:
            return None
        if m.rep("downsamplers.0.conv.", ""):
            # The reference emits "op." here and then fails to re-match it,
            # dropping diffusers downsampler weights (bug in
            # tensor_name_conv.c:239); we map straight to the internal name.
            m.out.append(f"{3 * (n1 + 1)}.0.conv.")
            return m.done()
        else:
            if m.rep("attentions.", ""):
                n2 = 1
            elif m.rep("resnets.", ""):
                n2 = 0
            else:
                return None
            n3 = m.num_get()
            if n3 is None:
                return None
            m.out.append(f"{3 * n1 + n3 + 1}.{n2}.")
        return _unet_block(m)
    if m.rep("up_blocks.", "out."):
        n1 = m.num_get()
        if n1 is None:
            return None
        if m.rep("upsamplers.0.", ""):
            m.out.append(f"{3 * n1 + 2}.{1 if n1 == 0 else 2}.")
        else:
            if m.rep("attentions.", ""):
                n2 = 1
            elif m.rep("resnets.", ""):
                n2 = 0
            else:
                return None
            n3 = m.num_get()
            if n3 is None:
                return None
            m.out.append(f"{3 * n1 + n3}.{n2}.")
        return _unet_block(m)
    if m.rep("mid_block.", "mid."):
        if m.rep("attentions.0.", "1."):
            return _unet_block(m)
        if m.rep("resnets.0.", "0.") or m.rep("resnets.1.", "2."):
            return m.done()
    return None


def _cnet(m: _M):
    """ControlNet body: CompVis ``control_model.`` layout.  The encoder /
    middle / time-embed names reuse the UNet rules; ControlNet-only parts
    are the hint encoder, the per-skip zero convs, and the middle output
    conv (models/controlnet.py)."""
    if m.rep("input_hint_block.", "hint."):
        n = m.num_get()
        if n is None or n % 2:
            return None             # odd indices are the SiLUs (no params)
        m.out.append(f"{n // 2}.")
        return m.done()
    if m.rep("zero_convs.", "zc."):
        n = m.num_get()
        if n is None or not m.rep("0.", ""):
            return None
        m.out.append(f"{n}.")
        return m.done()
    if m.rep("middle_block_out.0.", "mid.out."):
        return m.done()
    return _unet(m)


def _cnet_diffusers(m: _M):
    """diffusers ControlNetModel layout (bare names inside the model file)."""
    if m.rep("controlnet_cond_embedding.conv_in.", "hint.0."):
        return m.done()
    if m.rep("controlnet_cond_embedding.blocks.", "hint."):
        n = m.num_get()
        if n is None:
            return None
        m.out.append(f"{n + 1}.")
        return m.done()
    if m.rep("controlnet_cond_embedding.conv_out.", "hint.7."):
        return m.done()
    if m.rep("controlnet_down_blocks.", "zc."):
        m.num_push()
        return m.done()
    if m.rep("controlnet_mid_block.", "mid.out."):
        return m.done()
    if m.rep("time_embedding.linear_1.", "time_embed.0.") or \
       m.rep("time_embedding.linear_2.", "time_embed.2."):
        return m.done()
    if m.rep("conv_in.", "in.conv."):
        return m.done()
    return _unet(m)                 # down_blocks / mid_block diffusers rules


def normalize_cnet_name(name: str):
    """Normalize a ControlNet checkpoint tensor name to the internal
    ``cnet.`` scheme.  Accepts the CompVis single-file layout
    (``control_model.*``, the standard distribution format for SD
    ControlNets) and the diffusers ControlNetModel layout (bare names).
    Returns None for unused tensors."""
    m = _M(name)
    if m.rep("control_model.", "cnet."):
        return _cnet(m)
    m = _M(name)
    m.out.append("cnet.")
    return _cnet_diffusers(m)


def normalize_name(name: str):
    """Normalize a checkpoint tensor name (reference: tnconv_sd).

    Returns the internal name, ``QKV(...)`` for fused qkv tensors, or ``None``
    if the tensor is unused.
    """
    m = _M(name)
    if m.rep("cond_stage_model.1.", "clip2."):
        return _clip_compvis(m)
    if m.rep("cond_stage_model.", "clip."):
        if m.match("transformer.text_model."):
            return _clip_compvis(m)
        if m.match("model."):
            return _clip_openclip(m)
        return None
    if m.rep("te.", "clip."):
        return _clip_diffusers(m)
    if m.rep("conditioner.embedders.0.", "clip."):
        if m.match("model."):
            # SDXL-refiner: the single embedder is OpenCLIP bigG
            return _clip_openclip(m)
        return _clip_compvis(m)
    if m.rep("conditioner.embedders.1.", "clip2."):
        return _clip_openclip(m)
    if m.rep("te1.", "clip."):
        return _clip_diffusers(m)
    if m.rep("te2.", "clip2."):
        return _clip_diffusers(m)
    if m.rep("first_stage_model.", "vae."):
        return _vae(m)
    # SD3 family: the single-file layout bundles the text encoders under
    # ``text_encoders.`` (HF transformers layout incl. a Linear-stored
    # text_projection) and the MMDiT under ``model.diffusion_model.``
    # whose tails map verbatim to the internal ``mmdit.`` scheme.
    if m.rep("text_encoders.clip_l.", "clip."):
        return _clip_compvis(m)
    if m.rep("text_encoders.clip_g.", "clip2."):
        return _clip_compvis(m)
    if m.match("text_encoders.t5xxl."):
        return _t5(name)
    if m.match("model.diffusion_model.joint_blocks.") or \
       m.match("model.diffusion_model.x_embedder.") or \
       m.match("model.diffusion_model.t_embedder.") or \
       m.match("model.diffusion_model.y_embedder.") or \
       m.match("model.diffusion_model.context_embedder") or \
       m.match("model.diffusion_model.final_layer.") or \
       m.match("model.diffusion_model.pos_embed"):
        # final_layer.* is shared by the MMDiT and Flux layouts; the loader
        # aliases mmdit.final_layer.* under flux. too (weights.py), so one
        # mapping serves both families.
        m.rep("model.diffusion_model.", "mmdit.")
        return m.done()
    # Flux transformer tails — prefixed (ComfyUI-style single files) or
    # bare (black-forest-labs distribution flux1-*.safetensors; bare files
    # unambiguously own final_layer too)
    for fpre, heads in (("model.diffusion_model.", _FLUX_HEADS),
                        ("", _FLUX_HEADS + ("final_layer.",))):
        for head in heads:
            if _match_prefix(name, fpre + head):
                m2 = _M(name)
                if fpre:
                    m2.rep(fpre, "flux.")
                else:
                    m2.out.append("flux.")
                return m2.done()
    if m.rep("model.diffusion_model.", "unet.") or m.push("unet."):
        return _unet(m)
    # bare VAE files (flux ae.safetensors): encoder./decoder. at top level
    if _match_prefix(name, "encoder.") or _match_prefix(name, "decoder."):
        m2 = _M(name)
        m2.out.append("vae.")
        return _vae(m2)
    return None


_FLUX_HEADS = ("double_blocks.", "single_blocks.", "img_in.", "txt_in.",
               "time_in.", "vector_in.", "guidance_in.")


def _t5(name: str):
    """T5-XXL tensors (``text_encoders.t5xxl.transformer.*``): map the HF
    T5EncoderModel layout verbatim under the internal ``t5.`` prefix (the
    T5 module keys params by the HF names — see models/t5.py)."""
    tail = name.split("t5xxl", 1)[1].lstrip("._/")
    if tail.startswith("transformer."):
        tail = tail[len("transformer."):]
    return "t5." + tail


_UNET_BLOCK_INV = [
    ("transf.", "transformer_blocks."),
    ("q_proj.", "to_q."), ("k_proj.", "to_k."), ("v_proj.", "to_v."),
    ("out_proj.", "to_out.0."),
    ("norm1.", "in_layers.0."), ("conv1.", "in_layers.2."),
    ("norm2.", "out_layers.0."), ("conv2.", "out_layers.3."),
    ("emb_proj.", "emb_layers.1."), ("skip_conv.", "skip_connection."),
]


def internal_to_compvis(name: str):
    """Inverse mapping: internal name -> CompVis checkpoint name.

    Covers the subset needed to export/synthesize single-file SD checkpoints
    (the exact inverse of :func:`normalize_name` on the names the models
    emit).  Returns None for names with no CompVis equivalent."""
    def unet_block(tail: str, in_attn: bool) -> str:
        if re.match(r"transf\.\d+\.(attn1|attn2)\.", tail):
            for a, b in _UNET_BLOCK_INV[:5]:
                tail = tail.replace(a, b)
            return tail
        if tail.startswith("transf."):
            tail = tail.replace("transf.", "transformer_blocks.")
            return tail
        for a, b in _UNET_BLOCK_INV[5:]:
            if tail.startswith(a):
                return b + tail[len(a):]
        if tail.startswith("conv.") and not in_attn:
            return "op." + tail[len("conv."):]  # downsample
        return tail

    if name.startswith("unet."):
        t = name[5:]
        if t.startswith("time_embed."):
            return "model.diffusion_model." + t
        if t.startswith("label_embed."):
            return "model.diffusion_model.label_emb.0." + t[len("label_embed."):]
        if t.startswith("in.conv."):
            return "model.diffusion_model.input_blocks.0.0." + t[len("in.conv."):]
        if t.startswith("out.norm."):
            return "model.diffusion_model.out.0." + t[len("out.norm."):]
        if t.startswith("out.conv."):
            return "model.diffusion_model.out.2." + t[len("out.conv."):]
        m = re.match(r"(in|out)\.(\d+)\.(\d+)\.(.*)", t)
        if m:
            side = "input_blocks" if m.group(1) == "in" else "output_blocks"
            tail = m.group(4)
            # upsample convs live in sub-block >= 1 of output blocks and keep
            # their "conv." name in CompVis
            in_upsample = (m.group(1) == "out" and tail.startswith("conv."))
            blk = unet_block(tail, in_attn=False) if not in_upsample else tail
            return f"model.diffusion_model.{side}.{m.group(2)}.{m.group(3)}.{blk}"
        m = re.match(r"mid\.(\d+)\.(.*)", t)
        if m:
            return ("model.diffusion_model.middle_block."
                    f"{m.group(1)}.{unet_block(m.group(2), False)}")
        return None
    if name.startswith("vae."):
        t = name[4:].replace("skip_conv.", "nin_shortcut.")
        return "first_stage_model." + t
    if name.startswith("clip.text.") or name.startswith("clip2.text."):
        pre = ("cond_stage_model.transformer."
               if name.startswith("clip.text.")
               else "conditioner.embedders.1.")  # clip2 as CompVis layout
        t = name.split(".text.", 1)[1]
        if name.startswith("clip2.text."):
            pre = "cond_stage_model.1.transformer."
        t = "text_model." + t
        t = t.replace("embed.position.", "embeddings.position_embedding.")
        t = t.replace("embed.token.", "embeddings.token_embedding.")
        t = t.replace(".norm1.", ".layer_norm1.")
        t = t.replace(".norm2.", ".layer_norm2.")
        t = t.replace(".attn.", ".self_attn.")
        t = t.replace("text_model.ln_final.", "text_model.final_layer_norm.")
        t = t.replace("text_model.text_proj", "text_model.text_projection")
        return pre + t
    return None


def internal_to_cnet_ckpt(name: str):
    """Inverse of :func:`normalize_cnet_name` for the CompVis
    ``control_model.`` layout (used to synthesize test checkpoints)."""
    if not name.startswith("cnet."):
        return None
    t = name[5:]
    m = re.match(r"hint\.(\d+)\.(.*)", t)
    if m:
        return f"control_model.input_hint_block.{2 * int(m.group(1))}." \
            + m.group(2)
    m = re.match(r"zc\.(\d+)\.(.*)", t)
    if m:
        return f"control_model.zero_convs.{m.group(1)}.0." + m.group(2)
    if t.startswith("mid.out."):
        return "control_model.middle_block_out.0." + t[len("mid.out."):]
    cv = internal_to_compvis("unet." + t)
    if cv is None:
        return None
    return cv.replace("model.diffusion_model.", "control_model.", 1)


# kohya (sd-scripts) DiT LoRA module names: the module path is flattened
# to underscores ("lora_unet_double_blocks_0_img_attn_qkv.lora_down.weight"),
# so the canonical dotted internal tail is reconstructed from a fixed
# vocabulary.  Values are the internal module paths of models/flux.py and
# models/mmdit.py; all targets are fused linears, so lora_apply patches
# them without split refs (beyond-reference: the reference has no DiT
# families at all).
_DIT_LORA_MODULES = {
    # flux double-stream
    "img_attn_qkv": "img_attn.qkv", "img_attn_proj": "img_attn.proj",
    "txt_attn_qkv": "txt_attn.qkv", "txt_attn_proj": "txt_attn.proj",
    "img_mlp_0": "img_mlp.0", "img_mlp_2": "img_mlp.2",
    "txt_mlp_0": "txt_mlp.0", "txt_mlp_2": "txt_mlp.2",
    "img_mod_lin": "img_mod.lin", "txt_mod_lin": "txt_mod.lin",
    # flux single-stream
    "linear1": "linear1", "linear2": "linear2",
    "modulation_lin": "modulation.lin",
    # SD3 MMDiT joint blocks (attn2 = MMDiT-X dual attention)
    "x_block_attn_qkv": "x_block.attn.qkv",
    "x_block_attn_proj": "x_block.attn.proj",
    "x_block_attn2_qkv": "x_block.attn2.qkv",
    "x_block_attn2_proj": "x_block.attn2.proj",
    "context_block_attn_qkv": "context_block.attn.qkv",
    "context_block_attn_proj": "context_block.attn.proj",
    "x_block_mlp_fc1": "x_block.mlp.fc1",
    "x_block_mlp_fc2": "x_block.mlp.fc2",
    "context_block_mlp_fc1": "context_block.mlp.fc1",
    "context_block_mlp_fc2": "context_block.mlp.fc2",
    "x_block_adaLN_modulation_1": "x_block.adaLN_modulation.1",
    "context_block_adaLN_modulation_1": "context_block.adaLN_modulation.1",
}

_DIT_LORA_RE = re.compile(
    r"(double_blocks|single_blocks|joint_blocks)[._/](\d+)[._/]"
    r"([A-Za-z0-9_]+)\.(lora_down\.weight|lora_up\.weight|lora_A\.weight|"
    r"lora_B\.weight|alpha|scale)$")


def _lora_dit(t: str):
    """Flux / SD3-MMDiT LoRA tails under the kohya ``unet_`` prefix."""
    if not _match_prefix(t, "unet."):
        return None
    m = _DIT_LORA_RE.match(t[len("unet."):])
    if m is None:
        return None
    blocks, idx, mod, sfx = m.groups()
    modpath = _DIT_LORA_MODULES.get(mod)
    if modpath is None:
        return None
    single = blocks == "single_blocks"
    if (blocks == "joint_blocks") != mod.startswith(("x_block",
                                                     "context_block")):
        return None
    if single != (mod in ("linear1", "linear2", "modulation_lin")):
        return None
    fam = "mmdit." if blocks == "joint_blocks" else "flux."
    # peft suffix aliases: lora_A == lora_down, lora_B == lora_up
    sfx = {"lora_A.weight": "lora_down.weight",
           "lora_B.weight": "lora_up.weight"}.get(sfx, sfx)
    return f"{fam}{blocks}.{idx}.{modpath}.{sfx}"


# diffusers-peft DiT LoRA module names ("transformer."-prefixed, lora_A/B
# suffixes — the ai-toolkit / SimpleTuner / diffusers-trained format).
# diffusers splits the fused qkv (and flux's single-block linear1) into
# separate to_q/to_k/to_v/proj_mlp linears, so the internal target is a
# fused weight plus a fractional ROW slice of its raw [out,in] tensor,
# encoded as "...qkv@num/span/den" (den divides out_features; flux
# single-block linear1 is [3d+4d, d] => sevenths, mlp_ratio is 4 for both
# flux models).  weights.lora_apply decodes the fragment.
_PEFT_DOUBLE = {  # flux transformer_blocks.N. (img = x stream, txt = add)
    "attn.to_q": ("img_attn.qkv", (0, 1, 3)),
    "attn.to_k": ("img_attn.qkv", (1, 1, 3)),
    "attn.to_v": ("img_attn.qkv", (2, 1, 3)),
    "attn.add_q_proj": ("txt_attn.qkv", (0, 1, 3)),
    "attn.add_k_proj": ("txt_attn.qkv", (1, 1, 3)),
    "attn.add_v_proj": ("txt_attn.qkv", (2, 1, 3)),
    "attn.to_out.0": ("img_attn.proj", None),
    "attn.to_add_out": ("txt_attn.proj", None),
    "ff.net.0.proj": ("img_mlp.0", None),
    "ff.net.2": ("img_mlp.2", None),
    "ff_context.net.0.proj": ("txt_mlp.0", None),
    "ff_context.net.2": ("txt_mlp.2", None),
    "norm1.linear": ("img_mod.lin", None),
    "norm1_context.linear": ("txt_mod.lin", None),
}
_PEFT_SINGLE = {  # flux single_transformer_blocks.N.
    "attn.to_q": ("linear1", (0, 1, 7)),
    "attn.to_k": ("linear1", (1, 1, 7)),
    "attn.to_v": ("linear1", (2, 1, 7)),
    "proj_mlp": ("linear1", (3, 4, 7)),
    "proj_out": ("linear2", None),
    "norm.linear": ("modulation.lin", None),
}
_PEFT_MMDIT = {  # SD3 transformer_blocks.N. (x = sample, context = add)
    "attn.to_q": ("x_block.attn.qkv", (0, 1, 3)),
    "attn.to_k": ("x_block.attn.qkv", (1, 1, 3)),
    "attn.to_v": ("x_block.attn.qkv", (2, 1, 3)),
    "attn.add_q_proj": ("context_block.attn.qkv", (0, 1, 3)),
    "attn.add_k_proj": ("context_block.attn.qkv", (1, 1, 3)),
    "attn.add_v_proj": ("context_block.attn.qkv", (2, 1, 3)),
    "attn.to_out.0": ("x_block.attn.proj", None),
    "attn.to_add_out": ("context_block.attn.proj", None),
    "attn2.to_q": ("x_block.attn2.qkv", (0, 1, 3)),
    "attn2.to_k": ("x_block.attn2.qkv", (1, 1, 3)),
    "attn2.to_v": ("x_block.attn2.qkv", (2, 1, 3)),
    "attn2.to_out.0": ("x_block.attn2.proj", None),
    "ff.net.0.proj": ("x_block.mlp.fc1", None),
    "ff.net.2": ("x_block.mlp.fc2", None),
    "ff_context.net.0.proj": ("context_block.mlp.fc1", None),
    "ff_context.net.2": ("context_block.mlp.fc2", None),
    "norm1.linear": ("x_block.adaLN_modulation.1", None),
    "norm1_context.linear": ("context_block.adaLN_modulation.1", None),
}

_PEFT_SFX = {"lora_A.weight": "lora_down.weight",
             "lora_B.weight": "lora_up.weight",
             "lora_down.weight": "lora_down.weight",
             "lora_up.weight": "lora_up.weight",
             "alpha": "alpha", "scale": "scale"}

_PEFT_RE = re.compile(
    r"transformer\.(transformer_blocks|single_transformer_blocks)\."
    r"(\d+)\.(.+?)\.(lora_A\.weight|lora_B\.weight|lora_down\.weight|"
    r"lora_up\.weight|alpha|scale)$")


def _peft_dit_lora(name: str, family: str):
    """diffusers-peft flux/SD3 LoRA names.  ``transformer_blocks`` is used
    by BOTH families with identical module names, so the target family
    (from the loaded model's param names) disambiguates."""
    m = _PEFT_RE.match(name)
    if m is None:
        return None
    blocks, idx, mod, sfx = m.groups()
    if blocks == "single_transformer_blocks":
        if family != "flux":
            return None
        table, fam, blk = _PEFT_SINGLE, "flux.", "single_blocks"
    elif family == "flux":
        table, fam, blk = _PEFT_DOUBLE, "flux.", "double_blocks"
    elif family == "mmdit":
        table, fam, blk = _PEFT_MMDIT, "mmdit.", "joint_blocks"
    else:
        return None
    hit = table.get(mod)
    if hit is None:
        return None
    modpath, frac = hit
    at = "@%d/%d/%d" % frac if frac else ""
    return f"{fam}{blk}.{idx}.{modpath}{at}.{_PEFT_SFX[sfx]}"


def normalize_lora_name(name: str, family: str = "sd"):
    """Normalize a lora tensor name: strip ``lora_`` prefix then normalize
    (reference: tensor_callback_lora, src/mlimgsynth.c:1060-1083).  DiT
    module paths (flux/SD3 kohya LoRAs) are reconstructed from their
    flattened-underscore form; diffusers-peft ``transformer.*`` names map
    through the fused-weight slice tables (``family`` = "flux"/"mmdit"
    from the loaded model disambiguates the shared layout)."""
    if name.startswith("transformer."):
        return _peft_dit_lora(name, family)
    if name.startswith(("unet.", "text_encoder.", "text_encoder_2.")):
        # diffusers-peft SD LoRA state dicts: the module paths are the
        # plain diffusers checkpoint scheme, which normalize_name already
        # maps (suffixes pass through); only the prefixes and the
        # lora_A/lora_B suffix names differ.
        t = name
        if t.startswith("text_encoder_2."):
            t = "te2." + t[len("text_encoder_2."):]
        elif t.startswith("text_encoder."):
            t = "te." + t[len("text_encoder."):]
        t = t.replace(".lora_A.weight", ".lora_down.weight") \
             .replace(".lora_B.weight", ".lora_up.weight")
        return normalize_name(t)
    if not name.startswith("lora_"):
        return None
    t = name[len("lora_"):]
    r = _lora_dit(t)
    if r is not None:
        return r
    return normalize_name(t)
