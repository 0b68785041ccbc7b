"""The port's C ABI: ``mlimgsynth_torch/csrc/mlis_shim.c`` (the JAX
package's ``native/mlis_shim.c`` with the port's module name) built with
``cc`` by ``capi.build_shim`` and driven from C on the CPU.

A small C program links the shim, sets ``backend`` to ``cpu`` before
``mlis_setup``, generates a 64 x 64 image from a tiny SD1 checkpoint with a
progress callback, and writes the image's bytes; they equal the port's
Python session on the same options.  A context without ``backend cpu``
resolves its device at setup: the card, or an error without one.  No jax
is loaded in the program (the port's modules only).

The same program started as two processes with torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) and the option
``tp`` 2 joins the ranks' group when its context sets up; both generate,
and rank 0's image is within one u8 level of the one-process image.
"""
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mlimgsynth_torch import api as torch_api
from mlimgsynth_torch import capi
from mlimgsynth_torch import testing as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("cc") is None,
                                reason="no C compiler")

PROGRAM = r"""
#include <stdio.h>
#include <string.h>
#include "mlimgsynth.h"

static int g_steps = 0;

static int progress_cb(void *user, MLIS_Ctx *ctx, const MLIS_Progress *prg)
{
	(void)user; (void)ctx;
	if (prg->stage == MLIS_STAGE_DENOISE) g_steps++;
	return 0;
}

#define CHECK(COND, MSG) do { \
	if (!(COND)) { printf("FAIL: %s (%s)\n", MSG, mlis_errstr_get(ctx)); \
		return 1; } \
	printf("ok: %s\n", MSG); \
} while (0)

int main(int argc, char **argv)
{
	MLIS_Ctx *ctx = mlis_ctx_create();
	CHECK(ctx != NULL, "ctx create");
	CHECK(mlis_option_set_str(ctx, "definitely-not-real", "1")
		== MLIS_E_UNK_OPT, "unknown option");
	CHECK(mlis_option_set(ctx, MLIS_OPT_BACKEND, "cpu", "") >= 0,
		"backend cpu");
	CHECK(mlis_option_set(ctx, MLIS_OPT_MODEL, argv[1]) >= 0, "model");
	CHECK(mlis_option_set(ctx, MLIS_OPT_SEED, (uint64_t)42) >= 0, "seed");
	CHECK(mlis_option_set(ctx, MLIS_OPT_STEPS, 2) >= 0, "steps");
	CHECK(mlis_option_set(ctx, MLIS_OPT_THREADS, 2) >= 0, "threads");
	CHECK(mlis_option_set(ctx, MLIS_OPT_IMAGE_DIM, 64, 64) >= 0, "dim");
	CHECK(mlis_option_set_str(ctx, "weight-type", "f32") >= 0, "wtype");
	CHECK(mlis_option_set(ctx, MLIS_OPT_CALLBACK, progress_cb, (void*)0)
		>= 0, "callback");
	CHECK(mlis_option_set(ctx, MLIS_OPT_PROMPT, "a (cat:1.2) photo") >= 0,
		"prompt");
	if (argc > 3)   /* on ranks: the tp option */
		CHECK(mlis_option_set_str(ctx, "tp", argv[3]) >= 0, "tp");
	{
		const char *v = NULL;
		CHECK(mlis_option_get(ctx, MLIS_OPT_BACKEND, &v) >= 0 && v &&
			!strcmp(v, "cpu"), "option_get backend");
		CHECK(mlis_option_get(ctx, MLIS_OPT_PROMPT, &v) >= 0 && v &&
			!strcmp(v, "a (cat:1.2) photo"), "option_get prompt");
	}
	CHECK(mlis_setup(ctx) >= 0, "setup");
	{
		/* the shim hands the session's backend_info as JSON text */
		const MLIS_BackendInfo *bi = mlis_backend_info_get(ctx, 0, 0);
		CHECK(bi && strstr(bi->name, "\"name\": \"cpu\""),
			"backend info cpu");
	}
	CHECK(mlis_generate(ctx) >= 0, "generate");
	CHECK(g_steps == 2, "per-step callbacks");
	MLIS_Image *img = mlis_image_get(ctx, 0);
	CHECK(img && img->w == 64 && img->h == 64 && img->c == 3, "image");
	const char *info = mlis_infotext_get(ctx, 0);
	CHECK(info && strstr(info, "Seed: 42"), "infotext");
	MLIS_Tensor *lat = mlis_tensor_get(ctx, MLIS_TENSOR_LATENT);
	CHECK(lat && lat->n[0] == 8 && lat->n[2] == 4, "latent tensor");
	FILE *f = fopen(argv[2], "wb");
	CHECK(f && fwrite(img->d, 1, 64 * 64 * 3, f) == 64 * 64 * 3,
		"image written");
	fclose(f);
	mlis_ctx_destroy(&ctx);

	/* no backend: the card at setup, an error without one */
	ctx = mlis_ctx_create();
	mlis_option_set(ctx, MLIS_OPT_MODEL, argv[1]);
	int r = mlis_setup(ctx);
	printf("default setup: %d %s\n", r, mlis_errstr_get(ctx));
	mlis_ctx_destroy(&ctx);
	printf("TEST OK\n");
	return 0;
}
"""

# run in the embedded interpreter at its start: the tiny model types, and
# whether jax or the JAX package was imported, said as each context goes
SITECUSTOMIZE = """
import sys
from mlimgsynth_torch import api, capi, testing
api._model_types = lambda: {"sd1": testing.TINY_MODEL_TYPE}
_destroy = capi.ctx_destroy


def ctx_destroy(addr):
    print("JAX LOADED" if any(m == "jax" or m.startswith(
        ("jax.", "mlimgsynth_tpu")) for m in sys.modules) else "NO JAX",
        flush=True)
    return _destroy(addr)


capi.ctx_destroy = ctx_destroy
"""


def test_shim_copy_differs_only_in_module_name():
    with open(os.path.join(REPO, "native", "mlis_shim.c")) as f:
        native = f.read()
    with open(capi.SHIM_SOURCE) as f:
        port = f.read()
    assert native.replace("mlimgsynth_tpu.capi",
                          "mlimgsynth_torch.capi") == port
    assert "mlimgsynth_tpu" not in port


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    """(the compiled C program, the tiny checkpoint, its environment)."""
    d = tmp_path_factory.mktemp("capi")
    lib = capi.build_shim()
    assert capi.build_shim() == lib      # built once
    src, exe = d / "drive.c", d / "drive"
    src.write_text(PROGRAM)
    r = subprocess.run(["cc", "-O1", f"-I{REPO}/include", "-o", str(exe),
                        str(src), f"-L{os.path.dirname(lib)}",
                        "-lmlimgsynth_torch",
                        f"-Wl,-rpath,{os.path.dirname(lib)}"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    ckpt = d / "tiny.safetensors"
    T.write_random_checkpoint(ckpt, T.TINY_MODEL_TYPE, seed=3,
                              dtype=np.float32)
    site = d / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = dict(os.environ, MLIS_PY_PATH=REPO, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(site), REPO]))
    return exe, ckpt, env


def _image(path):
    return np.fromfile(path, np.uint8).reshape(64, 64, 3)


def _session_image(ckpt, monkeypatch):
    """The port's Python session's image of the program's options."""
    monkeypatch.setattr(torch_api, "_model_types",
                        lambda: {"sd1": T.TINY_MODEL_TYPE})
    s = torch_api.MLImgSynth(device="cpu")
    for k, v in [("model", str(ckpt)), ("seed", 42), ("steps", 2),
                 ("image-dim", 64), ("weight-type", "f32"),
                 ("prompt", "a (cat:1.2) photo")]:
        s.option_set(k, v)
    img = s.generate()
    return np.clip(img[0] * 255.0, 0, 255).astype(np.uint8).transpose(
        1, 2, 0)


def test_shim_generates_on_cpu(tmp_path, monkeypatch, program):
    exe, ckpt, env = program
    r = subprocess.run([str(exe), str(ckpt), str(tmp_path / "img.u8")],
                       capture_output=True, text=True, env=env,
                       cwd=str(tmp_path), timeout=600)
    assert "TEST OK" in r.stdout, r.stdout + r.stderr
    assert "FAIL" not in r.stdout and "JAX LOADED" not in r.stdout
    assert r.stdout.count("NO JAX") == 2
    code = int(r.stdout.split("default setup: ")[1].split()[0])
    assert code < 0 if not torch.cuda.is_available() else code >= 0
    if not torch.cuda.is_available():
        assert "no CUDA device" in r.stdout
    np.testing.assert_array_equal(_image(tmp_path / "img.u8"),
                                  _session_image(ckpt, monkeypatch))
    assert sys.modules.get("mlimgsynth_torch.capi") is capi


def test_shim_generates_on_two_ranks(tmp_path, monkeypatch, program):
    """Two processes of the C program with torchrun's environment and tp 2:
    both exit after generating, no jax loaded, and rank 0's image is within
    one u8 level of one process's image of the same options (the port's
    session here, which the one-process program equals bit for bit)."""
    exe, ckpt, env = program
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        renv = dict(env, RANK=str(rank), LOCAL_RANK=str(rank),
                    WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [str(exe), str(ckpt), str(tmp_path / f"img{rank}.u8"), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=renv, cwd=str(tmp_path)))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append(out + err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "TEST OK" in out, out
        assert "ok: tp" in out and "JAX LOADED" not in out
    one, got = _session_image(ckpt, monkeypatch), _image(tmp_path / "img0.u8")
    assert np.abs(got.astype(int) - one.astype(int)).max() <= 1
    np.testing.assert_array_equal(_image(tmp_path / "img1.u8"), got)
