"""mlimgsynth_torch: the PyTorch/CUDA port of mlimgsynth_tpu.

Same module names as the JAX package; inside, PyTorch idiom: nn.Modules,
NCHW activations, an explicit device.  The attention and quantized-linear
hot paths run hand-written CUDA kernels (csrc/) on an NVIDIA Hopper GPU.
The package imports nothing of mlimgsynth_tpu: it keeps its own copies of
the host modules it needs (rng, tokenizer, prompt, nameconv, io, the sigma
schedule, the logger, the image files).  ``python -m mlimgsynth_torch.cli``
is its command line.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing the package loads no model code and builds nothing
    if name in ("MLImgSynth", "MlisError"):
        from . import api
        return getattr(api, name)
    raise AttributeError(name)
