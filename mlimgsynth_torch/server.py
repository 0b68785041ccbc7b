"""HTTP serving mode (port of ``mlimgsynth_tpu/server.py``).

A stdlib server over persistent sessions: the weights stay on the card
across requests, and the port's CUDA kernels build on the first request
(the warm-up request with ``--warmup-gen``).  Standard library and numpy;
images are read and written by the port's ``utils/image`` (PNG, and binary
PPM/PGM, without pillow).

* **request-merging batch queue**: concurrent requests whose shared
  sampling options match are merged into one device batch
  (``MLImgSynth.generate_batch``), so k concurrent users cost one batched
  denoise loop instead of k;
* **cancellation**: every request gets a ``request_id``; ``POST /cancel``
  removes it from the queue, or aborts the running device batch once every
  request in it is cancelled;
* **streaming previews**: ``"preview": true`` requests get a frame every
  chunk of steps (the TAE's decode where loaded, else the linear
  latent -> RGB map); clients poll ``GET /preview?request_id=...`` while
  ``POST /generate`` blocks.

Endpoints:
  GET  /health            -> {"status": "ok", "model": ..., "requests": N}
  GET  /info              -> session config + device info + queue stats
  GET  /metrics           -> Prometheus text: counters, batch latencies
  POST /generate          -> image/png (or application/json, see "format")
      body: JSON {"prompt": str, "nprompt": str, "seed": int,
                  "steps": int, "width": int, "height": int,
                  "cfg_scale": float, "cfg_rescale": float,
                  "method": str, "scheduler": str,
                  "s_ancestral": float, "s_noise": float,
                  "batch_size": int, "format": "png"|"json",
                  "request_id": str (optional),
                  "image": base64 PNG (img2img init image),
                  "mask": base64 grayscale image (inpainting; with image),
                  "f_t_ini": float (img2img strength),
                  "model": str (multi-model serving: name from launch),
                  "preview": bool (enable streaming previews),
                  "preview_every": int (steps per preview frame; default =
                  the cancellable path's chunk size)}
      format "json" returns {"images": [base64 PNG, ...], "infotexts": ...}.
  GET  /preview?request_id=ID -> {"state": "queued"|"running",
                  "step": int, "n_step": int, "images": [base64 PNG, ...]}
      (latest frame; 404 once the request finished or was never seen)
  POST /cancel            -> {"status": "dequeued"|"cancelling"|"not found"}
      body: JSON {"request_id": str}
  POST /sdapi/v1/txt2img, /sdapi/v1/img2img (and the A1111 listing routes),
       /v1/images/generations, /v1/images/edits, /v1/images/variations
       (the OpenAI Images dialect, b64_json).

Run: python -m mlimgsynth_torch.server -m MODEL [--port 8188]  or
     python -m mlimgsynth_torch.cli serve -m MODEL

**On ranks** (the session options tp, dp, sp, pp, e.g. ``-o tp=2``; every
rank the same command under torchrun): the sessions set up on every rank
first, which joins the ranks' group.  Rank 0 binds the port and runs
everything above.  Every other rank serves no HTTP and runs
:meth:`Server.follow`: for each batch rank 0 broadcasts what a follower
needs to make the same ``generate_batch`` call (the model's name, the
options it set, the entries, the init latents and latent mask), and at
every step callback rank 0's cancellation decision, so that every rank
leaves the loop at the same step.  Previews are made on rank 0 only.  A
hot-loaded model loads on every rank.  :meth:`Server.stop` ends the
followers.

    torchrun --nproc-per-node 2 -m mlimgsynth_torch.cli serve --tp 2 \
        -m sd15.safetensors --port 8188
"""
from __future__ import annotations

import base64
import json
import os
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from .parallel import comm
from .utils import image as image_mod

# options shared by a whole device batch: requests are only merged when all
# of these match (anything absent falls back to the session default)
_SHARED_OPTS = {
    "steps": "steps", "cfg_scale": "cfg-scale", "method": "method",
    "scheduler": "scheduler", "s_ancestral": "s-ancestral",
    "s_noise": "s-noise", "clip_skip": "clip-skip", "f_t_ini": "f-t-ini",
    "hires_fix": "hires-fix", "hires_denoise": "hires-denoise",
    "hires_steps": "hires-steps", "hires_upscaler": "hires-upscaler",
    "subseed_strength": "subseed-strength", "deepcache": "deepcache",
    "tiling": "tiling", "cfg_rescale": "cfg-rescale", "freeu": "freeu",
    "slg_scale": "slg-scale", "slg_layers": "slg-layers",
    "slg_start": "slg-start", "slg_end": "slg-end",
    "pag_scale": "pag-scale", "pag_start": "pag-start",
    "pag_end": "pag-end",
}
_SHARED_KEYS = tuple(_SHARED_OPTS) + ("width", "height", "model",
                                      "preview", "preview_every")


def _image_u8(data: bytes) -> np.ndarray:
    """Image file bytes (PNG, or binary PGM/PPM) -> uint8 [h, w, c] (c 1,
    3 or 4), as ``utils.image.image_load_bytes`` reads them."""
    return image_mod.image_load_bytes(data, "image")


def _png_color_type(data: bytes):
    """The PNG colour type of file bytes (6: RGBA), None for another
    format."""
    if not data.startswith(b"\x89PNG\r\n\x1a\n") or len(data) < 26:
        return None
    return data[25]


def _to_rgb(arr: np.ndarray) -> np.ndarray:
    """uint8 [h, w, c] -> [h, w, 3] (pillow's ``convert("RGB")``)."""
    return np.repeat(arr, 3, axis=2) if arr.shape[2] == 1 else arr[:, :, :3]


def _to_gray(arr: np.ndarray) -> np.ndarray:
    """uint8 [h, w, c] -> [h, w] (pillow's ``convert("L")``: ITU-R 601-2
    luma in 16-bit fixed point)."""
    if arr.shape[2] == 1:
        return arr[:, :, 0]
    rgb = arr[:, :, :3].astype(np.uint32)
    return ((rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470
             + rgb[:, :, 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _image_b64_size(b64: str):
    """(w, h) of a base64 image."""
    arr = _image_u8(base64.b64decode(b64))
    return arr.shape[1], arr.shape[0]


def _lora_tags_of(req: dict):
    """``<lora:...>`` tags of a request's prompt: part of the merge key —
    one merged device batch shares one patched weight set, so only
    same-tag requests may merge.  Parse errors get a unique key (no
    merge; the error surfaces at generate time)."""
    from .prompt import PromptParseError, prompt_set_parse
    try:
        return tuple(prompt_set_parse(str(req.get("prompt", ""))).loras)
    except PromptParseError:
        return ("!parse-error", str(req.get("prompt", "")))


def _shared_of(req: dict) -> dict:
    d = {k: req.get(k) for k in _SHARED_KEYS}
    # img2img only merges with img2img of the SAME init-image size;
    # ditto inpainting (mask presence is part of the key)
    d["_image_size"] = (_image_b64_size(req["image"])
                        if req.get("image") else None)
    d["_has_mask"] = bool(req.get("mask"))
    d["_loras"] = _lora_tags_of(req)
    d["_fullres"] = (bool(req.get("inpaint_full_res")),
                     req.get("inpaint_full_res_padding"),
                     req.get("mask_blur"), req.get("resize_mode"))
    return d


def _init_resize(t: "np.ndarray", th: int, tw: int,
                 mode: int) -> "np.ndarray":
    """A1111 img2img resize modes for float NCHW tensors: 0 just-resize,
    1 crop-to-fit (cover + center crop), 2 fill-to-fit (contain +
    edge-replicate pad)."""
    _resize_float_nchw = image_mod.resize_float_nchw
    h, w = t.shape[2], t.shape[3]
    if mode == 1:       # cover then center-crop
        s = max(th / h, tw / w)
        rh, rw = max(th, int(round(h * s))), max(tw, int(round(w * s)))
        r = _resize_float_nchw(t, rh, rw)
        y0, x0 = (rh - th) // 2, (rw - tw) // 2
        return r[:, :, y0:y0 + th, x0:x0 + tw]
    if mode == 2:       # contain then pad
        s = min(th / h, tw / w)
        rh, rw = min(th, int(round(h * s))), min(tw, int(round(w * s)))
        r = _resize_float_nchw(t, rh, rw)
        py, px = th - rh, tw - rw
        return np.pad(r, ((0, 0), (0, 0),
                          (py // 2, py - py // 2),
                          (px // 2, px - px // 2)), mode="edge")
    return _resize_float_nchw(t, th, tw)


def load_styles(path: str) -> dict:
    """A1111 styles.csv: name,prompt,negative_prompt rows; ``{prompt}``
    in the style text is replaced by the user prompt (otherwise the
    style text is appended after a comma)."""
    import csv
    styles = {}
    with open(path, newline="", encoding="utf-8-sig") as f:
        for row in csv.DictReader(f):
            name = (row.get("name") or "").strip()
            if name:
                styles[name] = ((row.get("prompt") or "").strip(),
                                (row.get("negative_prompt") or "").strip())
    return styles


def apply_styles(styles: dict, names, prompt: str, nprompt: str):
    """Apply the named styles to (prompt, nprompt), A1111 semantics."""
    def merge(base, tpl):
        if not tpl:
            return base
        if "{prompt}" in tpl:
            return tpl.replace("{prompt}", base)
        return f"{base}, {tpl}" if base else tpl

    for n in names or []:
        tpl = styles.get(str(n))
        if tpl is None:
            raise ValueError(f"unknown style {n!r}")
        prompt = merge(prompt, tpl[0])
        nprompt = merge(nprompt, tpl[1])
    return prompt, nprompt


def _parse_multipart(ctype: str, body: bytes) -> dict:
    """multipart/form-data -> {field: bytes|str} (file parts stay bytes,
    text parts decode to str)."""
    import email.parser
    msg = email.parser.BytesParser().parsebytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        raise ValueError("malformed multipart body")
    fields = {}
    for part in msg.get_payload():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True)
        if part.get_filename() is None:
            try:
                payload = payload.decode()
            except UnicodeDecodeError:
                pass
        fields[name] = payload
    return fields


def _openai_mask_to_gray(mask_png: bytes) -> str:
    """OpenAI edit masks mark the area to REPAINT with transparency;
    convert to the internal white-repaints grayscale convention."""
    arr = _image_u8(mask_png)
    alpha = (arr[:, :, 3] if arr.shape[2] == 4
             else np.full(arr.shape[:2], 255, np.uint8))
    return base64.b64encode(image_mod.png_bytes(
        (255 - alpha).astype(np.uint8)[:, :, None])).decode()


def _split_alpha_b64(img_b64: str):
    """(rgb_b64, repaint_mask_b64 or None): split a base64 image's alpha
    channel into the white-repaints serving mask (transparent = edit)."""
    data = base64.b64decode(img_b64)
    if _png_color_type(data) != 6:
        return img_b64, None
    arr = _image_u8(data)
    alpha = arr[:, :, 3]
    if alpha.min() == 255:
        return img_b64, None
    return (base64.b64encode(image_mod.png_bytes(
                np.ascontiguousarray(arr[:, :, :3]))).decode(),
            base64.b64encode(image_mod.png_bytes(
                (255 - alpha).astype(np.uint8)[:, :, None])).decode())


def _decode_image_b64(b64: str, gray: bool = False) -> "np.ndarray":
    """base64 PNG (or binary PPM/PGM) -> float NCHW [1,3|1,H,W] in
    [0,1]."""
    arr = _image_u8(base64.b64decode(b64))
    if gray:
        return (_to_gray(arr).astype(np.float32) / 255.0)[None, None]
    arr = _to_rgb(arr).astype(np.float32) / 255.0
    return arr.transpose(2, 0, 1)[None]



# Minimal web UI served at GET /.  Single self-contained page:
# posts JSON to /generate (format "json"), renders the base64 images and
# infotexts, and can cancel the in-flight request.
_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>mlimgsynth-torch</title><style>
 body{font-family:system-ui,sans-serif;margin:2rem auto;max-width:64rem;
      padding:0 1rem;background:#111;color:#ddd}
 h1{font-size:1.2rem;font-weight:600}
 form{display:grid;grid-template-columns:repeat(6,1fr);gap:.5rem}
 textarea{grid-column:1/-1;background:#1c1c1c;color:#ddd;border:1px solid
          #333;border-radius:4px;padding:.5rem;min-height:3rem}
 label{font-size:.75rem;color:#999;display:flex;flex-direction:column}
 input,select{background:#1c1c1c;color:#ddd;border:1px solid #333;
              border-radius:4px;padding:.35rem}
 button{grid-column:span 2;padding:.5rem;border:0;border-radius:4px;
        background:#3b6ef5;color:#fff;font-weight:600;cursor:pointer}
 button.cancel{background:#555}
 #status{margin:.75rem 0;color:#999;font-size:.85rem;white-space:pre-wrap}
 #out{display:flex;flex-wrap:wrap;gap:.75rem}
 #out figure{margin:0}
 #out img{max-width:24rem;border-radius:4px}
 #out figcaption{font-size:.7rem;color:#888;max-width:24rem;
                 white-space:pre-wrap}
</style></head><body>
<h1>mlimgsynth-torch</h1>
<form id="f">
 <textarea id="prompt" placeholder="prompt">a photograph of an astronaut riding a horse</textarea>
 <textarea id="nprompt" placeholder="negative prompt"></textarea>
 <label>steps<input id="steps" type="number" value="20"></label>
 <label>cfg<input id="cfg" type="number" step="0.5" value="7"></label>
 <label>seed<input id="seed" type="number" value="42"></label>
 <label>width<input id="w" type="number" step="64" value="512"></label>
 <label>height<input id="h" type="number" step="64" value="512"></label>
 <label>batch<input id="batch" type="number" value="1"></label>
 <label>preview<input id="preview" type="checkbox" checked></label>
 <button type="submit">Generate</button>
 <button type="button" class="cancel" id="cancel">Cancel</button>
</form>
<div id="status"></div><div id="out"></div>
<script>
const $=id=>document.getElementById(id);let reqId=null;let pvTimer=null;
function pollPreview(){pvTimer=setInterval(async()=>{if(!reqId)return;
 try{const r=await fetch("/preview?request_id="+reqId);
  if(!r.ok)return;const j=await r.json();
  if(j.images&&j.images.length){
   let img=$("pv");if(!img){img=new Image();img.id="pv";
    img.style.imageRendering="pixelated";img.style.maxWidth="24rem";
    $("out").append(img);}
   img.src="data:image/png;base64,"+j.images[0];
   $("status").textContent="step "+j.step+"/"+j.n_step;}
 }catch(e){}},400);}
$("f").addEventListener("submit",async ev=>{ev.preventDefault();
 reqId=Math.random().toString(36).slice(2,14);
 const body={prompt:$("prompt").value,nprompt:$("nprompt").value,
  steps:+$("steps").value,cfg_scale:+$("cfg").value,seed:+$("seed").value,
  width:+$("w").value,height:+$("h").value,batch_size:+$("batch").value,
  preview:$("preview").checked,format:"json",request_id:reqId};
 $("status").textContent="generating…";$("out").innerHTML="";
 if(body.preview)pollPreview();
 const t0=performance.now();
 try{
  const r=await fetch("/generate",{method:"POST",
   headers:{"Content-Type":"application/json"},body:JSON.stringify(body)});
  const j=await r.json();
  if(pvTimer){clearInterval(pvTimer);pvTimer=null;}
  $("out").innerHTML="";
  if(!r.ok){$("status").textContent="error: "+(j.error||r.status);return}
  const dt=((performance.now()-t0)/1000).toFixed(2);
  $("status").textContent=j.images.length+" image(s) in "+dt+" s";
  j.images.forEach((b64,i)=>{const fig=document.createElement("figure");
   const img=new Image();img.src="data:image/png;base64,"+b64;
   const cap=document.createElement("figcaption");
   cap.textContent=(j.infotexts||[])[i]||"";
   fig.append(img,cap);$("out").append(fig);});
 }catch(e){if(pvTimer){clearInterval(pvTimer);pvTimer=null;}
  $("status").textContent="error: "+e}});
$("cancel").addEventListener("click",async()=>{if(!reqId)return;
 const r=await fetch("/cancel",{method:"POST",
  headers:{"Content-Type":"application/json"},
  body:JSON.stringify({request_id:reqId})});
 $("status").textContent="cancel: "+JSON.stringify(await r.json());});
</script></body></html>"""

class _Pending:
    """One queued /generate request."""
    __slots__ = ("req", "shared", "event", "id", "imgs", "infotexts",
                 "error", "cancelled", "time_s", "preview")

    def __init__(self, req: dict):
        self.req = req
        self.shared = _shared_of(req)
        self.event = threading.Event()
        self.id = str(req.get("request_id") or uuid.uuid4().hex[:12])
        self.imgs = None
        self.infotexts: List[str] = []
        self.error: Optional[str] = None
        self.cancelled = False
        self.time_s = 0.0
        # latest streaming-preview frame {"step","n_step","images":[b64..]}
        # (written by the worker thread, read by GET /preview pollers; the
        # whole dict is replaced atomically so no lock is needed)
        self.preview: Optional[dict] = None


class Server:
    """``session`` may be a single MLImgSynth or a {name: session} dict
    (multi-model serving: requests route by their "model" key; the first
    entry is the default).  Weights of every session stay resident on the
    card, so k models cost k weight sets but zero swap latency."""

    def __init__(self, session, max_batch: int = 8,
                 merge_window_s: float = 0.02, start_worker: bool = True,
                 model_dir: str = "", weight_type: str = "",
                 launch_opts=()):
        if isinstance(session, dict):
            self.sessions = dict(session)
        else:
            self.sessions = {"default": session}
        self.default_model = next(iter(self.sessions))
        self.session = self.sessions[self.default_model]
        self.max_batch = max_batch
        self.merge_window_s = merge_window_s
        # checkpoint discovery + hot loading: requests may name any
        # NAME.safetensors/.gguf under model_dir (or an absolute path);
        # a session is created lazily and kept resident like the
        # launched ones
        self.model_dir = model_dir
        self._new_session_opts = (weight_type, tuple(launch_opts))
        self._load_lock = threading.Lock()
        self.styles: dict = {}
        # launch-time option values: requests that OMIT a shared option
        # get these, not whatever the previous batch happened to set.
        # Snapshots are taken lazily on each model's FIRST batch, AFTER
        # setup(): model load resolves per-type defaults (clip skip 0 ->
        # 1/2, dims) and a pre-resolution snapshot would reset later
        # batches to the wrong values (e.g. SD2's clip skip back to 0).
        self.defaults, self.defaults_dim = {}, {}
        self.n_requests = 0
        self.n_merged = 0
        self.t_total = 0.0
        self.n_images = 0
        self.n_errors = 0
        self.n_batches = 0
        # batch-latency histogram buckets (seconds, cumulative-style)
        self.lat_buckets = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0)
        self.lat_counts = [0] * (len(self.lat_buckets) + 1)
        self.per_model_requests: dict = {}
        self.queue: List[_Pending] = []
        self.cond = threading.Condition()
        self.running: List[_Pending] = []
        self.running_lock = threading.Lock()
        self.stopping = False
        self.worker = None
        if start_worker:
            self.worker = threading.Thread(target=self._worker, daemon=True)
            self.worker.start()

    def ranked(self) -> bool:
        """Whether the sessions run on ranks (their mesh resolved at
        setup): the batches are then broadcast to the followers."""
        return self.session._mesh is not None

    # -- client side -------------------------------------------------------

    def _model_path_of(self, name: str):
        """(canonical_name, checkpoint_path) for a non-launched model
        name discoverable under model_dir, else None.  Only basenames
        inside model_dir resolve — requests can NOT name arbitrary
        filesystem paths (no traversal, no absolute paths)."""
        if not self.model_dir:
            return None
        base = os.path.basename(name)
        if base != name or not base or base.startswith("."):
            return None
        stem = (os.path.splitext(base)[0]
                if base.endswith((".safetensors", ".gguf")) else base)
        for ext in (".safetensors", ".gguf"):
            cand = os.path.join(self.model_dir, stem + ext)
            if os.path.isfile(cand):
                return stem, cand
        return None

    def discovered_models(self):
        """Model names loadable from model_dir (not yet sessions)."""
        out = []
        if self.model_dir and os.path.isdir(self.model_dir):
            seen = set()
            for f in sorted(os.listdir(self.model_dir)):
                base, ext = os.path.splitext(f)
                if ext in (".safetensors", ".gguf") \
                        and base not in self.sessions \
                        and base not in seen:
                    seen.add(base)
                    out.append(base)
        return out

    def resolve_model(self, name: str):
        """Session for ``name``, hot-loading it from model_dir if
        discovered.  The new session inherits dtype, the launch
        weight-type (falling back to the default session's) and -o
        options, and stays resident like the launched ones."""
        s = self.sessions.get(name)
        if s is not None:
            return s
        hit = self._model_path_of(name)
        if hit is None:
            return None
        key, path = hit
        with self._load_lock:
            s = self.sessions.get(key)     # lost the race: reuse
            if s is not None:
                return s
            sys.stderr.write(f"[serve] hot-loading model '{key}' "
                             f"from {path}\n")
            from .api import MLImgSynth
            # on the launched sessions' device, in their compute type
            s = MLImgSynth(device=self.session.device)
            s.dtype = self.session.dtype
            s.option_set("model", path)
            wt, opts = self._new_session_opts
            wt = wt or self.session.c.get("weight_type", "")
            if wt:
                s.option_set("weight-type", wt)
            for kv in opts:
                oname, _, oval = kv.partition("=")
                s.option_set_str(oname, oval)
            # copy-on-write: concurrent readers iterate a stable dict
            # (defaults snapshot happens on the first batch, post-setup)
            self.sessions = {**self.sessions, key: s}
        return s

    def _defaults_of(self, model: str, s):
        """Post-setup launch-default snapshot for ``model`` (lazy)."""
        d = self.defaults.get(model)
        if d is not None:
            return d
        try:
            s.setup()
            d = {opt: s.option_get(opt) for opt in _SHARED_OPTS.values()}
            dim = (s.c["width"], s.c["height"])
        except Exception:
            d, dim = {}, None
        self.defaults = {**self.defaults, model: d}
        self.defaults_dim = {**self.defaults_dim, model: dim}
        return d

    def submit(self, req: dict) -> _Pending:
        if "prompt" not in req:
            raise ValueError("missing 'prompt'")
        if req.get("styles"):
            p, n = apply_styles(self.styles, req["styles"],
                                str(req.get("prompt", "")),
                                str(req.get("nprompt", "")))
            req = {**req, "prompt": p, "nprompt": n}
            req.pop("styles")
        if req.get("model") and req["model"] not in self.sessions \
                and self._model_path_of(req["model"]) is None:
            raise ValueError(
                f"unknown model '{req['model']}' "
                f"(have: {', '.join(self.sessions)}"
                + (f"; discoverable: {', '.join(self.discovered_models())}"
                   if self.model_dir else "") + ")")
        p = _Pending(req)  # _shared_of validates the image header too
        size = p.shared["_image_size"]
        if (size is not None and (size[0] % 64 or size[1] % 64)
                and not (req.get("width") or req.get("height"))
                and not req.get("inpaint_full_res")):
            # fail fast with a clean error instead of a doomed UNet
            # request (explicit width/height resizes the init instead)
            raise ValueError(
                f"init image size {size[0]}x{size[1]} must be a multiple "
                "of 64 (or pass width/height to resize)")
        if req.get("mask"):
            if size is None:
                raise ValueError("'mask' (inpainting) needs 'image'")
            if _image_b64_size(req["mask"]) != size:
                raise ValueError("mask size must match the init image")
        with self.cond:
            self.queue.append(p)
            self.cond.notify()
        return p

    def preview_of(self, request_id: str):
        """(state, frame_dict|None) for GET /preview polling."""
        with self.running_lock:
            for p in self.running:
                if p.id == request_id:
                    return "running", p.preview
        with self.cond:
            for p in self.queue:
                if p.id == request_id:
                    return "queued", None
        return "not found", None

    def cancel(self, request_id: str) -> str:
        with self.cond:
            for p in self.queue:
                if p.id == request_id and not p.cancelled:
                    p.cancelled = True
                    p.error = "cancelled"
                    self.queue.remove(p)
                    p.event.set()
                    return "dequeued"
        with self.running_lock:
            for p in self.running:
                if p.id == request_id and not p.cancelled:
                    p.cancelled = True
                    return "cancelling"
        return "not found"

    # -- worker side ---------------------------------------------------

    def stop(self) -> None:
        """End the worker once the queue is empty; on ranks it tells the
        followers to return."""
        with self.cond:
            self.stopping = True
            self.cond.notify()

    def _worker(self):
        while True:
            with self.cond:
                while not self.queue and not self.stopping:
                    self.cond.wait()
                if not self.queue:
                    if self.ranked():
                        comm.broadcast_object(None, 0)
                    return
                first = self.queue.pop(0)
            # visible to cancel() immediately: a popped request must never
            # be in neither list (cancel would report 'not found' and the
            # request would run anyway)
            with self.running_lock:
                self.running = [first]
            if self.merge_window_s:
                # let near-simultaneous requests arrive so they can merge
                time.sleep(self.merge_window_s)
            batch = [first]
            with self.cond:
                i = 0
                while len(batch) < self.max_batch and i < len(self.queue):
                    if self.queue[i].shared == first.shared:
                        batch.append(self.queue.pop(i))
                    else:
                        i += 1
            self._run_batch(batch)

    def follow(self) -> None:
        """A follower rank's loop (module docstring): rank 0's batches, each
        run as the same ``generate_batch`` call, until rank 0 stops.  An
        error that rank 0 meets too (an option refused, the batch
        cancelled) ends the batch; any other one raises."""
        from .api import Aborted, MlisError
        while True:
            msg = comm.broadcast_object(None, 0)
            if msg is None:
                return
            s = self.resolve_model(msg["model"])
            if s is None:
                raise RuntimeError(f"follower: unknown model "
                                   f"'{msg['model']}'")
            for name, vals in msg["opts"]:
                s.option_set(name, *vals)
            try:
                s.generate_batch(
                    msg["entries"],
                    step_callback=lambda i, n: comm.broadcast_flag(False, 0),
                    init_latents=msg["init_latents"],
                    init_lmask=msg["init_lmask"],
                    preview_chunk=msg["preview_chunk"])
            except (MlisError, Aborted):
                continue

    def _run_batch(self, batch: List[_Pending]):
        t0 = time.time()
        with self.running_lock:
            self.running = batch
        ranked = self.ranked()
        sets = []       # the option_set calls, for the followers

        def setopt(s, name, *vals):
            s.option_set(name, *vals)
            sets.append((name, vals))

        try:
            r0 = batch[0].req
            model = r0.get("model") or self.default_model
            asked = model
            s = self.resolve_model(model)
            if s is None:
                raise RuntimeError(f"unknown model '{model}'")
            if model not in self.sessions:  # hot-loaded: canonical stem
                model = os.path.splitext(os.path.basename(model))[0]
            defaults = self._defaults_of(model, s)
            defaults_dim = self.defaults_dim.get(model)
            w = int(r0.get("width", 0))
            h = int(r0.get("height", 0))
            if w or h:
                setopt(s, "image-dim", w or h, h or w)
            elif defaults_dim and any(defaults_dim):
                setopt(s, "image-dim", *defaults_dim)
            for key, opt in _SHARED_OPTS.items():
                if key in r0:
                    setopt(s, opt, r0[key])
                elif defaults.get(opt) is not None:
                    # omitted option = launch default, not the previous
                    # batch's leftover value
                    setopt(s, opt, defaults[opt])
            entries, slices, init_imgs, init_masks = [], [], [], []
            fullres_orig = []   # (entry_index, orig_img, orig_mask, box)
            use_img2img = bool(r0.get("image"))
            use_mask = bool(r0.get("mask"))
            use_fullres = (use_img2img and use_mask
                           and bool(r0.get("inpaint_full_res")))
            mblur = float(r0.get("mask_blur", 0) or 0)
            # explicit request dims resize the init (A1111 resize-mode-0);
            # without them native-size img2img is preserved
            rw = int(r0.get("width", 0))
            rh = int(r0.get("height", 0))
            if use_fullres or use_img2img:
                from .utils.image import inpaint_crop_region
                from .utils.image import mask_gaussian_blur
                from .utils.image import resize_float_nchw as \
                    _resize_float_nchw
            if use_fullres:
                fw = rw or s.c["width"]
                fh = rh or s.c["height"]
                fpad = int(r0.get("inpaint_full_res_padding", 32) or 32)
            for p in batch:
                k = max(1, int(p.req.get("batch_size", 1)))
                seed = p.req.get("seed")
                seed = (int(seed) if seed is not None
                        else int.from_bytes(os.urandom(6), "big"))
                start = len(entries)
                img_arr = (_decode_image_b64(p.req["image"])
                           if use_img2img else None)
                mask_arr = (_decode_image_b64(p.req["mask"], gray=True)
                            if use_mask else None)
                if mask_arr is not None and mblur > 0:
                    mask_arr = mask_gaussian_blur(mask_arr, mblur)
                if (use_img2img and not use_fullres and rw and rh
                        and img_arr.shape[2:] != (rh, rw)):
                    # A1111 resize modes: 0 just-resize, 1 crop-to-fit,
                    # 2 fill-to-fit (resize preserving aspect, then
                    # center-crop / edge-pad)
                    rmode = int(r0.get("resize_mode", 0) or 0)
                    img_arr = _init_resize(img_arr, rh, rw, rmode)
                    if mask_arr is not None:
                        mask_arr = np.clip(
                            _init_resize(mask_arr, rh, rw, rmode), 0, 1)
                if use_fullres:
                    # crop-around-mask: each request crops its own box,
                    # every crop resizes to the SAME processing dims, so
                    # the device batch stays uniform; results paste back
                    # per request after the merged generate
                    fw = fw or img_arr.shape[3]
                    fh = fh or img_arr.shape[2]
                    box = inpaint_crop_region(mask_arr, fw, fh, fpad)
                    if box is None:  # empty mask: whole-image "crop"
                        box = (0, 0, img_arr.shape[3], img_arr.shape[2])
                    x0, y0, x1, y1 = box
                    fullres_orig.append(
                        (slice(start, start + k), img_arr, mask_arr,
                         box))
                    img_arr = _resize_float_nchw(
                        img_arr[:, :, y0:y1, x0:x1], fh, fw)
                    mask_arr = np.clip(_resize_float_nchw(
                        mask_arr[:, :, y0:y1, x0:x1], fh, fw), 0, 1)
                subseed = p.req.get("subseed")
                for j in range(k):  # seed+j per image, like generate.sh
                    e = {"prompt": p.req.get("prompt", ""),
                         "nprompt": p.req.get("nprompt", ""),
                         "seed": seed + j}
                    if subseed is not None and int(subseed) >= 0:
                        e["subseed"] = int(subseed) + j
                    entries.append(e)
                    if img_arr is not None:
                        init_imgs.append(img_arr)
                    if mask_arr is not None:
                        init_masks.append(mask_arr)
                slices.append((p, slice(start, len(entries))))
            init_lat = init_lmask = None
            if use_img2img:
                # VAE latent sampling draws from the session rng; re-seed
                # from the request so identical requests reproduce exactly
                if r0.get("seed") is not None:
                    setopt(s, "seed", int(r0["seed"]))
                # one batched encode for the whole merged batch
                init_lat = s.image_encode(np.concatenate(init_imgs, 0))
            if use_mask:
                # serving masks are white = REGENERATE (A1111/doc
                # convention); the library/reference latent mask is
                # 1 = KEEP (src/sampling.c:98-110), so invert here
                init_lmask = s.mask_encode(
                    1.0 - np.concatenate(init_masks, 0))
            if len(batch) > 1:
                sys.stderr.write(
                    f"[serve] merged {len(batch)} requests into one "
                    f"device batch of {len(entries)}\n")

            preview_chunk = int(r0.get("preview_every", 0) or 0)
            if ranked:
                # the followers' same call; rank 0's cancellation decision
                # goes to them at every step callback
                comm.broadcast_object({
                    "model": asked, "opts": sets, "entries": entries,
                    "init_latents": init_lat, "init_lmask": init_lmask,
                    "preview_chunk": preview_chunk}, 0)

            def cb(i_step, n_step):
                stop = all(p.cancelled for p in batch)
                return comm.broadcast_flag(stop, 0) if ranked else stop

            pv_cb = None
            if r0.get("preview"):
                # streaming previews: store the latest frame per request;
                # clients poll GET /preview?request_id=... while /generate
                # blocks.  Frames are tiny PNGs (TAE res, or latent res for
                # the linear approximation) encoded on this worker thread.
                def pv_cb(i_step, n_step, imgs_u8):
                    for p, sl in slices:
                        if p.cancelled:
                            continue
                        frames = imgs_u8[sl]
                        p.preview = {
                            "step": int(i_step), "n_step": int(n_step),
                            "images": [_u8_png_b64(frames[j])
                                       for j in range(frames.shape[0])]}

            imgs, infos = s.generate_batch(
                entries, step_callback=cb, init_latents=init_lat,
                init_lmask=init_lmask, preview_callback=pv_cb,
                preview_chunk=preview_chunk)
            if fullres_orig:
                # merged requests share one original size (merge key);
                # paste each crop back into its own original
                from .utils.image import inpaint_paste
                oh, ow = fullres_orig[0][1].shape[2:]
                full = np.empty((imgs.shape[0], imgs.shape[1], oh, ow),
                                np.float32)
                for sl, oimg, omask, box in fullres_orig:
                    nrep = sl.stop - sl.start
                    full[sl] = inpaint_paste(
                        np.repeat(oimg, nrep, 0), imgs[sl],
                        np.repeat(omask, nrep, 0), box)
                imgs = full
            dt = time.time() - t0
            if all(p.cancelled for p in batch):
                raise RuntimeError("cancelled")
            for p, sl in slices:
                if p.cancelled:
                    p.error = "cancelled"
                else:
                    p.imgs = imgs[sl]
                    p.infotexts = infos[sl]
                    p.time_s = dt
                p.event.set()
            self.n_requests += len(batch)
            self.n_merged += len(batch) - 1
            self.t_total += dt
            self.n_images += len(entries)
            self.n_batches += 1
            self.per_model_requests[model] = (
                self.per_model_requests.get(model, 0) + len(batch))
            for i, b in enumerate(self.lat_buckets):
                if dt <= b:
                    self.lat_counts[i] += 1
                    break
            else:
                self.lat_counts[-1] += 1
        except Exception as e:  # noqa
            # client cancellations are not server errors (metrics)
            self.n_errors += sum(1 for p in batch if not p.cancelled)
            for p in batch:
                p.error = p.error or ("cancelled" if p.cancelled
                                      else str(e))
                p.event.set()
        finally:
            with self.running_lock:
                self.running = []


# ---------------------------------------------------------------------------
# AUTOMATIC1111-compatible API surface (/sdapi/v1/*): lets the existing SD
# tool ecosystem (webui clients, plugins, load testers) point at this server
# unchanged.  Only the generation core is mapped — model management beyond
# listing is out of scope.
# ---------------------------------------------------------------------------

# sampler_name -> (method, scheduler or None); " Karras" suffix handled
# separately (A1111 historically encodes the schedule in the sampler name,
# newer clients pass a separate "scheduler" field — both accepted)
_A1111_SAMPLERS = {
    "euler": ("euler", None),
    "euler a": ("euler_a", None),
    "heun": ("heun", None),
    "dpm++ 2m": ("dpm++2m", None),
    "dpm++ 2s": ("dpm++2s", None),
    "dpm++ 2s a": ("dpm++2s_a", None),
    "dpm++ 2m sde": ("dpm++2m_sde", None),
    "lcm": ("lcm", None),
    "unipc": ("unipc", None),
}


def _a1111_to_req(req: dict, img2img: bool = False) -> dict:
    """Translate an A1111 /sdapi/v1/txt2img|img2img body to the internal
    /generate request shape."""
    out = {"format": "json"}
    if req.get("prompt") is not None:
        out["prompt"] = str(req["prompt"])
    if req.get("negative_prompt"):
        out["nprompt"] = str(req["negative_prompt"])
    for src, dst in (("steps", "steps"), ("cfg_scale", "cfg_scale"),
                     ("width", "width"), ("height", "height"),
                     ("eta", "s_ancestral"), ("model", "model")):
        if req.get(src) is not None:
            out[dst] = req[src]
    seed = req.get("seed")
    if seed is not None and int(seed) != -1:   # -1 = random (A1111)
        out["seed"] = int(seed)
    if req.get("subseed_strength"):
        out["subseed_strength"] = float(req["subseed_strength"])
        sub = req.get("subseed")
        if sub is not None and int(sub) != -1:
            out["subseed"] = int(sub)
    n = max(1, int(req.get("batch_size", 1))) * \
        max(1, int(req.get("n_iter", 1)))      # n_iter folds into the batch
    out["batch_size"] = n
    if req.get("styles"):
        out["styles"] = list(req["styles"])
    if req.get("tiling"):
        out["tiling"] = 1
    ov = req.get("override_settings") or {}
    if ov.get("CLIP_stop_at_last_layers") is not None:
        out["clip_skip"] = int(ov["CLIP_stop_at_last_layers"])
    if ov.get("sd_model_checkpoint"):
        out["model"] = str(ov["sd_model_checkpoint"])
    name = str(req.get("sampler_name") or req.get("sampler_index")
               or "euler").strip().lower()
    sched = str(req.get("scheduler", "")).strip().lower()
    if name.endswith(" karras"):
        name, sched = name[:-7], "karras"
    if name not in _A1111_SAMPLERS:
        raise ValueError(
            f"unsupported sampler_name {name!r}; supported: "
            + ", ".join(sorted(_A1111_SAMPLERS)))
    method, msched = _A1111_SAMPLERS[name]
    out["method"] = method
    sched = {"sgm uniform": "sgm_uniform",
             "automatic": "", "simple": "uniform"}.get(sched, sched)
    if sched in ("karras", "lcm", "uniform", "exponential", "sgm_uniform",
                 "beta"):
        out["scheduler"] = sched
    elif msched:
        out["scheduler"] = msched
    if img2img:
        imgs = req.get("init_images") or []
        if not imgs:
            raise ValueError("img2img needs init_images")
        out["image"] = _strip_data_url(imgs[0])
        if req.get("mask"):
            out["mask"] = _strip_data_url(req["mask"])
        if req.get("denoising_strength") is not None:
            out["f_t_ini"] = float(req["denoising_strength"])
        if req.get("inpaint_full_res"):
            out["inpaint_full_res"] = 1
            if req.get("inpaint_full_res_padding") is not None:
                out["inpaint_full_res_padding"] = \
                    int(req["inpaint_full_res_padding"])
        if req.get("mask_blur") is not None:
            out["mask_blur"] = float(req["mask_blur"])
        if req.get("resize_mode") is not None:
            out["resize_mode"] = int(req["resize_mode"])
    elif req.get("enable_hr"):
        # A1111 highres-fix: two-pass latent upscale + refine.
        # Latent-family hr_upscaler names run the latent path; any other
        # name runs the server's configured ESRGAN model in image space.
        # hr_resize_x/y absolute-target mode is not supported.
        out["hires_fix"] = float(req.get("hr_scale", 2.0))
        if req.get("hr_second_pass_steps"):
            out["hires_steps"] = int(req["hr_second_pass_steps"])
        if req.get("denoising_strength") is not None:
            out["hires_denoise"] = float(req["denoising_strength"])
        upname = str(req.get("hr_upscaler", "") or "")
        if upname and not upname.lower().startswith("latent"):
            out["hires_upscaler"] = upname
    return out


def _strip_data_url(b64: str) -> str:
    s = str(b64)
    return s.split(",", 1)[1] if s.startswith("data:") else s


def _u8_png_b64(img_u8_hwc: np.ndarray) -> str:
    """uint8 [H,W,C] preview frame -> base64 PNG string."""
    return base64.b64encode(image_mod.png_bytes(
        np.ascontiguousarray(img_u8_hwc, np.uint8))).decode()


def _png_bytes(img_nchw_1: np.ndarray, infotext: str) -> bytes:
    arr = image_mod.tensor_to_image_arr(img_nchw_1[None], 0)
    return image_mod.png_bytes(arr, infotext)


def make_handler(srv: Server):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            sys.stderr.write("[serve] %s\n" % (fmt % args))

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/health":
                self._json(200, {"status": "ok",
                                 "model": srv.session.c["model"],
                                 "model_type": srv.session.c["model_type"],
                                 "models": list(srv.sessions),
                                 "requests": srv.n_requests})
            elif self.path.startswith("/preview"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                rid = (q.get("request_id") or [""])[0]
                state, frame = srv.preview_of(rid)
                if state == "not found":
                    self._json(404, {"error": "not found",
                                     "request_id": rid})
                else:
                    self._json(200, {"request_id": rid, "state": state,
                                     **(frame or {})})
            elif self.path == "/sdapi/v1/sd-models":
                rows = [{"title": name, "model_name": name,
                         "filename": ses.c["model"], "hash": None,
                         "sha256": None, "config": None}
                        for name, ses in srv.sessions.items()]
                rows += [{"title": name, "model_name": name,
                          "filename": (srv._model_path_of(name) or
                                       (None, None))[1],
                          "hash": None, "sha256": None, "config": None}
                         for name in srv.discovered_models()]
                self._json(200, rows)
            elif self.path == "/sdapi/v1/refresh-checkpoints":
                self._json(200, {})
            elif self.path == "/sdapi/v1/prompt-styles":
                self._json(200, [
                    {"name": n, "prompt": p, "negative_prompt": np_}
                    for n, (p, np_) in sorted(srv.styles.items())])
            elif self.path == "/sdapi/v1/loras":
                base = srv.session.c.get("lora_dir", "")
                rows = []
                if base and os.path.isdir(base):
                    for f in sorted(os.listdir(base)):
                        n, ext = os.path.splitext(f)
                        if ext == ".safetensors":
                            rows.append({"name": n, "alias": n,
                                         "path": os.path.join(base, f),
                                         "metadata": {}})
                self._json(200, rows)
            elif self.path == "/sdapi/v1/embeddings":
                base = srv.session.c.get("embed_dir", "")
                loaded = {}
                if base and os.path.isdir(base):
                    for f in sorted(os.listdir(base)):
                        n, ext = os.path.splitext(f)
                        if ext in (".safetensors", ".pt"):
                            loaded[n] = {"step": None, "shape": None,
                                         "vectors": None}
                self._json(200, {"loaded": loaded, "skipped": {}})
            elif self.path == "/sdapi/v1/samplers":
                self._json(200, [
                    {"name": k.title(), "aliases": [k, v[0]], "options": {}}
                    for k, v in _A1111_SAMPLERS.items()])
            elif self.path == "/sdapi/v1/schedulers":
                self._json(200, [
                    {"name": n, "label": n.replace("_", " ").title(),
                     "aliases": [n]}
                    for n in ("uniform", "karras", "exponential",
                              "sgm_uniform", "beta", "lcm")])
            elif self.path == "/sdapi/v1/options":
                self._json(200, {
                    "sd_model_checkpoint": srv.default_model,
                    "samples_format": "png"})
            elif self.path == "/sdapi/v1/upscalers":
                ups = [{"name": "Latent", "model_name": None,
                        "model_path": None, "scale": 2}]
                path = srv.session.c.get("upscaler", "")
                if path:
                    base = os.path.splitext(os.path.basename(path))[0]
                    ups.append({"name": base, "model_name": base,
                                "model_path": path, "scale": 4})
                self._json(200, ups)
            elif self.path == "/sdapi/v1/progress":
                with srv.running_lock:
                    run = list(srv.running)
                pv = next((p.preview for p in run if p.preview), None)
                prog, img = 0.0, None
                if pv:
                    prog = pv["step"] / max(1, pv["n_step"])
                    img = pv["images"][0] if pv["images"] else None
                self._json(200, {
                    "progress": prog, "eta_relative": 0.0,
                    "state": {"job_count": len(run),
                              "sampling_step": pv["step"] if pv else 0,
                              "sampling_steps": pv["n_step"] if pv else 0},
                    "current_image": img, "textinfo": None})
            elif self.path == "/metrics":
                # Prometheus text exposition (counters + batch-latency
                # histogram) for production scraping
                lines = [
                    "# TYPE mlis_requests_total counter",
                    f"mlis_requests_total {srv.n_requests}",
                    "# TYPE mlis_images_total counter",
                    f"mlis_images_total {srv.n_images}",
                    "# TYPE mlis_merged_requests_total counter",
                    f"mlis_merged_requests_total {srv.n_merged}",
                    "# TYPE mlis_errors_total counter",
                    f"mlis_errors_total {srv.n_errors}",
                    "# TYPE mlis_queue_depth gauge",
                    f"mlis_queue_depth {len(srv.queue)}",
                    "# TYPE mlis_batch_seconds histogram",
                ]
                cum = 0
                for b, c in zip(srv.lat_buckets, srv.lat_counts):
                    cum += c
                    lines.append(
                        f'mlis_batch_seconds_bucket{{le="{b}"}} {cum}')
                cum += srv.lat_counts[-1]
                lines.append(
                    f'mlis_batch_seconds_bucket{{le="+Inf"}} {cum}')
                lines.append(f"mlis_batch_seconds_sum {srv.t_total:.3f}")
                lines.append(f"mlis_batch_seconds_count {srv.n_batches}")
                for m, c in sorted(srv.per_model_requests.items()):
                    lines.append(
                        f'mlis_model_requests_total{{model="{m}"}} {c}')
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/info":
                info = srv.session.backend_info()
                cfg = {k: v for k, v in srv.session.c.items()
                       if isinstance(v, (str, int, float, bool))}
                self._json(200, {"backend": info, "config": cfg,
                                 "requests": srv.n_requests,
                                 "merged": srv.n_merged,
                                 "queued": len(srv.queue),
                                 "avg_latency_s": (srv.t_total /
                                                   max(1, srv.n_requests))})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                ctype = self.headers.get("Content-Type", "")
                if ctype.lower().startswith("multipart/"):
                    # OpenAI images/edits|variations post form-data
                    req = _parse_multipart(ctype, self.rfile.read(n))
                else:
                    req = json.loads(self.rfile.read(n) or b"{}")
            except Exception as e:  # noqa
                self._json(400, {"error": str(e)})
                return
            if self.path in ("/v1/images/edits", "/v1/images/variations"):
                self._openai_edit(req,
                                  self.path.endswith("variations"))
                return
            if self.path == "/cancel":
                self._json(200, {"status": srv.cancel(
                    str(req.get("request_id", "")))})
                return
            if self.path in ("/sdapi/v1/txt2img", "/sdapi/v1/img2img"):
                self._sdapi_generate(req,
                                     self.path.endswith("img2img"))
                return
            if self.path == "/v1/images/generations":
                self._openai_generate(req)
                return
            if self.path == "/sdapi/v1/options":
                # A1111 model switching: sd_model_checkpoint picks the
                # default model among the launched sessions by name
                want = str(req.get("sd_model_checkpoint", "") or "")
                if want:
                    name = next((n for n in srv.sessions
                                 if n == want or want.startswith(n)), None)
                    if name is None and srv.resolve_model(want):
                        name = want    # hot-loaded from model_dir
                    if name is None:
                        self._json(400, {
                            "error": f"unknown model {want!r}; launched: "
                                     + ", ".join(srv.sessions)})
                        return
                    srv.default_model = name
                self._json(200, {})
                return
            if self.path == "/sdapi/v1/extra-single-image":
                # A1111 "Extras" upscale: runs the session's configured
                # ESRGAN model directly (no diffusion), synchronous.
                try:
                    img = _decode_image_b64(
                        _strip_data_url(str(req.get("image", ""))))
                    resize = float(req.get("upscaling_resize", 2) or 2)
                    out = srv.session.upscale(
                        img, resize=resize,
                        tile=int(req.get("upscale_tile", 0) or 0))
                    self._json(200, {
                        "image": _u8_png_b64(
                            (np.clip(out[0], 0, 1).transpose(1, 2, 0)
                             * 255.0 + 0.5).astype(np.uint8)),
                        "html_info": ""})
                except Exception as e:  # noqa
                    self._json(400, {"error": str(e)})
                return
            if self.path == "/sdapi/v1/png-info":
                try:
                    raw = base64.b64decode(
                        _strip_data_url(str(req.get("image", ""))))
                    text = (image_mod.png_decode(raw)[4]
                            if _png_color_type(raw) is not None else {})
                    self._json(200, {"info": text.get("parameters", ""),
                                     "items": dict(text)})
                except Exception as e:  # noqa
                    self._json(400, {"error": str(e)})
                return
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                p = srv.submit(req)
            except Exception as e:  # noqa
                self._json(400, {"error": str(e)})
                return
            p.event.wait()
            if p.error == "cancelled":
                self._json(499, {"error": "cancelled", "request_id": p.id})
                return
            if p.error:
                self._json(400, {"error": p.error, "request_id": p.id})
                return
            if req.get("format") == "json":
                self._json(200, {
                    "request_id": p.id,
                    "shape": list(p.imgs.shape),
                    "time_s": round(p.time_s, 4),
                    "infotexts": p.infotexts,
                    "images": [base64.b64encode(
                        _png_bytes(p.imgs[i], p.infotexts[i])).decode()
                        for i in range(p.imgs.shape[0])]})
                return
            body = _png_bytes(p.imgs[0], p.infotexts[0])
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Generation-Time", f"{p.time_s:.3f}")
            self.send_header("X-Request-Id", p.id)
            self.end_headers()
            self.wfile.write(body)

        def _sdapi_generate(self, a1111_req, img2img):
            """A1111 txt2img/img2img: translate, run through the same
            merging queue, answer in the A1111 response shape."""
            try:
                req = _a1111_to_req(a1111_req, img2img=img2img)
                p = srv.submit(req)
            except Exception as e:  # noqa
                self._json(400, {"error": str(e)})
                return
            p.event.wait()
            if p.error:
                code = 499 if p.error == "cancelled" else 400
                self._json(code, {"error": p.error, "request_id": p.id})
                return
            images = [base64.b64encode(
                _png_bytes(p.imgs[i], p.infotexts[i])).decode()
                for i in range(p.imgs.shape[0])]
            self._json(200, {
                "images": images,
                "parameters": a1111_req,
                "info": json.dumps({"infotexts": p.infotexts,
                                    "time_s": round(p.time_s, 4),
                                    "request_id": p.id})})

        def _openai_edit(self, oreq, variation: bool):
            """OpenAI images/edits (inpainting: transparent mask areas
            are repainted) and images/variations (img2img around the
            input).  Accepts multipart form-data (image/mask file parts)
            or JSON with base64 fields."""
            try:
                if oreq.get("response_format", "b64_json") != "b64_json":
                    raise ValueError(
                        'only response_format "b64_json" is supported')
                img = oreq.get("image")
                if not img:
                    raise ValueError("missing 'image'")
                if isinstance(img, bytes):
                    img = base64.b64encode(img).decode()
                req = {"format": "json", "image": _strip_data_url(img),
                       "prompt": str(oreq.get("prompt", ""))}
                if variation:
                    req["f_t_ini"] = 0.7       # nearby-image strength
                else:
                    req["f_t_ini"] = 1.0       # full repaint under mask
                    mask = oreq.get("mask")
                    if mask:
                        if isinstance(mask, str):
                            mask = base64.b64decode(
                                _strip_data_url(mask))
                        req["mask"] = _openai_mask_to_gray(mask)
                    else:
                        # OpenAI contract: without a mask, the image's
                        # own transparency marks the area to edit
                        rgb, alpha_mask = _split_alpha_b64(req["image"])
                        if alpha_mask is not None:
                            req["image"] = rgb
                            req["mask"] = alpha_mask
                if oreq.get("model"):
                    req["model"] = str(oreq["model"])
                if oreq.get("size"):
                    w, _, h = str(oreq["size"]).lower().partition("x")
                    req["width"], req["height"] = int(w), int(h or w)
                req["batch_size"] = max(1, int(oreq.get("n", 1)))
                if oreq.get("seed") is not None:   # extension
                    req["seed"] = int(oreq["seed"])
                p = srv.submit(req)
            except Exception as e:  # noqa
                self._json(400, {"error": {
                    "message": str(e), "type": "invalid_request_error"}})
                return
            p.event.wait()
            if p.error:
                self._json(400, {"error": {"message": p.error,
                                           "type": "server_error"}})
                return
            self._json(200, {
                "created": int(time.time()),
                "data": [{"b64_json": base64.b64encode(
                    _png_bytes(p.imgs[i], p.infotexts[i])).decode()}
                    for i in range(p.imgs.shape[0])]})

        def _openai_generate(self, oreq):
            """OpenAI Images API dialect (POST /v1/images/generations):
            prompt / n / size "WxH" / model; response_format b64_json
            (the default; "url" is refused — nothing is hosted)."""
            try:
                if oreq.get("response_format", "b64_json") != "b64_json":
                    raise ValueError(
                        'only response_format "b64_json" is supported')
                req = {"format": "json", "prompt": str(oreq.get("prompt",
                                                                ""))}
                if oreq.get("model"):
                    req["model"] = oreq["model"]
                if oreq.get("size"):
                    w, _, h = str(oreq["size"]).lower().partition("x")
                    req["width"], req["height"] = int(w), int(h or w)
                req["batch_size"] = max(1, int(oreq.get("n", 1)))
                if oreq.get("seed") is not None:   # extension, not OpenAI
                    req["seed"] = int(oreq["seed"])
                p = srv.submit(req)
            except Exception as e:  # noqa
                self._json(400, {"error": {"message": str(e),
                                           "type": "invalid_request_error"}})
                return
            p.event.wait()
            if p.error:
                self._json(400, {"error": {"message": p.error,
                                           "type": "server_error"}})
                return
            self._json(200, {
                "created": int(time.time()),
                "data": [{"b64_json": base64.b64encode(
                    _png_bytes(p.imgs[i], p.infotexts[i])).decode(),
                    "revised_prompt": None}
                    for i in range(p.imgs.shape[0])]})

    return Handler


def warmup_generate(session) -> float:
    """One throwaway generation through generate_batch with a no-op
    cancellation callback, at the session's default size and steps: the
    path requests take.  On a card it builds the port's CUDA kernels
    (``ops/_build.py``: nvcc at the first launch, or the cached library),
    so that the first user request runs at steady-state latency.  Returns
    seconds spent."""
    t0 = time.time()
    session.generate_batch([{"prompt": "warmup", "seed": 0}],
                           step_callback=lambda i, n: False)
    return time.time() - t0


def serve(session, port: int = 8188, host: str = "127.0.0.1",
          warmup: bool = True, warmup_gen: bool = False,
          model_dir: str = "", weight_type: str = "", launch_opts=(),
          styles: str = ""):
    # cancellation and previews are checked after every chunk of steps
    os.environ.setdefault("MLIS_PROGRESS_CHUNK", "4")
    srv = Server(session, model_dir=model_dir, weight_type=weight_type,
                 launch_opts=launch_opts, start_worker=False)
    if styles:
        srv.styles = load_styles(styles)
        sys.stderr.write(f"[serve] {len(srv.styles)} prompt styles\n")
    # on ranks every session sets up on every rank, in one order: that
    # joins the ranks' group and makes the mesh's groups, collectively
    if warmup or _mesh_opts(srv.session):
        for ses in srv.sessions.values():
            if ses.c["model"]:
                ses.setup()
    if warmup_gen:
        for name, ses in srv.sessions.items():
            if ses.c["model"]:
                dt = warmup_generate(ses)
                sys.stderr.write(f"[serve] warmed '{name}' in {dt:.1f}s\n")
    if _mesh_opts(srv.session) and not srv.ranked():
        raise RuntimeError("serve: the mesh options need a model to set up "
                           "on every rank (-m)")
    if srv.ranked() and comm.rank() != 0:
        srv.follow()
        return
    srv.worker = threading.Thread(target=srv._worker, daemon=True)
    srv.worker.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(srv))
    sys.stderr.write(f"[serve] listening on http://{host}:{port}\n")
    httpd.serve_forever()


def _mesh_opts(session) -> bool:
    """Whether the session's options ask for several ranks."""
    c = session.c
    return c["tp"] * c["dp"] * c["sp"] * c["pp"] > 1


def main(argv: Optional[list] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True, action="append",
                    help="model file; repeatable as NAME=PATH for "
                         "multi-model serving")
    ap.add_argument("--port", type=int, default=8188)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--weight-type", default="")
    ap.add_argument("-o", "--opt", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="session option applied to every model (any "
                         "library option name, e.g. -o backend=cpu "
                         "-o tae=taesd.safetensors); repeatable")
    ap.add_argument("--warmup-gen", action="store_true",
                    help="run one throwaway generation per model before "
                         "accepting traffic (builds the CUDA kernels)")
    ap.add_argument("--model-dir", default="",
                    help="directory of additional checkpoints "
                         "(NAME.safetensors/.gguf): listed by "
                         "/sdapi/v1/sd-models and hot-loaded on first "
                         "request")
    ap.add_argument("--styles", default="",
                    help="A1111 styles.csv (name,prompt,negative_prompt);"
                         " requests apply them with \"styles\": [names]")
    args = ap.parse_args(argv)
    sessions = build_sessions(args.model, args.weight_type, args.opt)
    serve(sessions if len(sessions) > 1 else next(iter(sessions.values())),
          port=args.port, host=args.host, warmup_gen=args.warmup_gen,
          model_dir=args.model_dir, weight_type=args.weight_type,
          launch_opts=args.opt, styles=args.styles)
    return 0


def build_sessions(model_specs, weight_type="", opts=()):
    """NAME=PATH model specs -> {name: session}, with launch-time session
    options (-o NAME=VALUE) applied to every model through the same
    string-option surface the CLI and C ABI use.  Each session is on the
    card unless ``-o backend=cpu`` asks for the CPU (its device is resolved
    at its first setup).  ``-o tp=2`` and the other mesh options put the
    sessions on ranks: the mesh resolves at their first setup."""
    from .api import MLImgSynth
    sessions = {}
    for i, spec in enumerate(model_specs):
        name, _, path = spec.rpartition("=")
        name = name or (os.path.splitext(os.path.basename(path))[0]
                        if len(model_specs) > 1 else "default")
        s = MLImgSynth(late_device=True)
        s.option_set("model", path)
        if weight_type:
            s.option_set("weight-type", weight_type)
        for kv in opts:
            oname, _, oval = kv.partition("=")
            s.option_set_str(oname, oval)
        sessions[name or f"model{i}"] = s
    return sessions


if __name__ == "__main__":
    sys.exit(main())
