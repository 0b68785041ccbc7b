"""The port's CLI on several ranks: ``torchrun --standalone --nproc-per-node
2 -m mlimgsynth_torch.cli generate -b cpu --tp 2 ...`` on a tiny SD1
checkpoint (gloo on the CPU) writes one PNG, from rank 0, within one u8
level of the single-rank CLI's image of the same request; neither rank
loads jax.  Without a process group of that size the CLI exits 1 naming
the torchrun line.  The ranks take the tiny model types from a
``sitecustomize.py`` on their ``PYTHONPATH``."""
import os
import subprocess
import sys

import numpy as np

from mlimgsynth_torch import api, cli, testing
from mlimgsynth_torch.utils import image as image_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SITECUSTOMIZE = """
import atexit
import os
import sys

from mlimgsynth_torch import api, testing

api._model_types = lambda: {"sd1": testing.TINY_MODEL_TYPE}


def _report():
    bad = [m for m in ("jax", "mlimgsynth_tpu") if m in sys.modules]
    print(("JAX LOADED " if bad else "NO JAX ") + os.environ.get("RANK", "?"))


atexit.register(_report)
"""
ARGS = ["generate", "-b", "cpu", "-d", "64", "-s", "3", "-S", "7",
        "-p", "a (cat:1.2) on a bicycle", "-n", "blurry"]


def test_torchrun_tp2_generate_matches_one_rank(tmp_path, monkeypatch,
                                                capsys):
    ckpt = str(tmp_path / "sd1.safetensors")
    testing.write_random_checkpoint(ckpt, testing.TINY_MODEL_TYPE, seed=3,
                                    dtype=np.float32)
    monkeypatch.setattr(api, "_model_types",
                        lambda: {"sd1": testing.TINY_MODEL_TYPE})
    one = str(tmp_path / "one.png")
    assert cli.main(ARGS + ["-m", ckpt, "-o", one]) == 0
    # no process group of 2 ranks here: exit 1 with the launch line
    assert cli.main(ARGS + ["-m", ckpt, "--tp", "2", "-o",
                            str(tmp_path / "x.png")]) == 1
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    out_dir = tmp_path / "ranks"
    out_dir.mkdir()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), REPO]),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "mlimgsynth_torch.cli"]
        + ARGS + ["-m", ckpt, "--tp", "2", "-t", "1", "-o",
                  str(out_dir / "two.png")],
        env=env, cwd=str(out_dir), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert sorted(os.listdir(out_dir)) == ["two.png"]
    # the launcher reports too, under no rank
    assert "NO JAX 0" in r.stdout and "NO JAX 1" in r.stdout
    assert "JAX LOADED" not in r.stdout
    a, _ = image_mod.png_read(one)
    b, text = image_mod.png_read(str(out_dir / "two.png"))
    assert a.shape == b.shape == (64, 64, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert "Seed: 7" in text.get("parameters", "")
