"""Ranks as a (dp, pp, sp, tp) mesh over ``torch.distributed`` (port of
``mlimgsynth_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and lets
GSPMD place the collectives; here every rank is a process that builds the
same session, and the mesh is a grid of ranks with one process group per
line of each axis.  Rank r sits where device r sits in ``make_mesh``'s grid:
tp innermost, then sp, then pp, dp outermost.

The Megatron rules (``_TP_RULES``, ``param_spec``) are the JAX package's,
over the same internal parameter names, with a small spec type of the
port's own; they say which linears ``tensor_parallel`` splits.

The session holds its mesh for one request with :func:`scope`, a context
variable, so that two sessions in one process never see each other's mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

from ..errors import MlisError
from . import comm

DP_AXIS = "dp"
PP_AXIS = "pp"
SP_AXIS = "sp"
TP_AXIS = "tp"
AXES = (DP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS)


class Spec(tuple):
    """A partition spec: one entry per dimension of a parameter in the JAX
    package's ``[in, out]`` layout, the mesh axis it is split over or
    None; ``Spec()`` is replicated (``jax.sharding.PartitionSpec``'s
    meaning)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"Spec{tuple(self)!r}"


# Megatron-style tensor-parallel rules (``mesh.py:44-91``): column-parallel
# (output dim split), row-parallel (input dim split), over the JAX
# package's [in, out] weight layout
_TP_RULES = [
    (r"\.(attn1|attn2|attn)\.(q_proj|k_proj|v_proj)\.weight$",
     Spec(None, TP_AXIS)),
    (r"\.(attn1|attn2|attn)\.(q_proj|k_proj|v_proj)\.bias$", Spec(TP_AXIS)),
    (r"\.(attn1|attn2|attn)\.out_proj\.weight$", Spec(TP_AXIS, None)),
    (r"\.ff\.net\.0\.proj\.weight$", Spec(None, TP_AXIS)),
    (r"\.ff\.net\.0\.proj\.bias$", Spec(TP_AXIS)),
    (r"\.ff\.net\.2\.weight$", Spec(TP_AXIS, None)),
    (r"\.mlp\.fc1\.weight$", Spec(None, TP_AXIS)),
    (r"\.mlp\.fc1\.bias$", Spec(TP_AXIS)),
    (r"\.mlp\.fc2\.weight$", Spec(TP_AXIS, None)),
    # MMDiT: fused qkv column-parallel, the out-projection row-parallel;
    # attn2 is MMDiT-X's second self-attention
    (r"\.(attn|attn2)\.qkv\.weight$", Spec(None, TP_AXIS)),
    (r"\.(attn|attn2)\.qkv\.bias$", Spec(TP_AXIS)),
    (r"\.(attn|attn2)\.proj\.weight$", Spec(TP_AXIS, None)),
    # Flux double-stream blocks
    (r"\.(img_attn|txt_attn)\.qkv\.weight$", Spec(None, TP_AXIS)),
    (r"\.(img_attn|txt_attn)\.qkv\.bias$", Spec(TP_AXIS)),
    (r"\.(img_attn|txt_attn)\.proj\.weight$", Spec(TP_AXIS, None)),
    (r"\.(img_mlp|txt_mlp)\.0\.weight$", Spec(None, TP_AXIS)),
    (r"\.(img_mlp|txt_mlp)\.0\.bias$", Spec(TP_AXIS)),
    (r"\.(img_mlp|txt_mlp)\.2\.weight$", Spec(TP_AXIS, None)),
    # Flux single-stream blocks: linear1 emits [qkv | mlp], linear2 takes
    # [attn | mlp]
    (r"\.single_blocks\.\d+\.linear1\.weight$", Spec(None, TP_AXIS)),
    (r"\.single_blocks\.\d+\.linear1\.bias$", Spec(TP_AXIS)),
    (r"\.single_blocks\.\d+\.linear2\.weight$", Spec(TP_AXIS, None)),
    # T5: q/k/v and wi_0/wi_1 column-parallel, o and wo row-parallel
    (r"\.SelfAttention\.(q|k|v)\.weight$", Spec(None, TP_AXIS)),
    (r"\.SelfAttention\.o\.weight$", Spec(TP_AXIS, None)),
    (r"\.DenseReluDense\.(wi_0|wi_1)\.weight$", Spec(None, TP_AXIS)),
    (r"\.DenseReluDense\.wo\.weight$", Spec(TP_AXIS, None)),
]


def param_spec(name: str, ndim: int, tp: bool = True) -> Spec:
    """The spec of the parameter ``name`` (``param_spec``, ``mesh.py:
    94-103``, without its rule for the pipeline-stacked slabs: the port's
    pipeline keeps each stage's blocks unstacked)."""
    if tp:
        for pat, spec in _TP_RULES:
            if re.search(pat, name):
                return spec
    return Spec()


def grid(world: int, tp: int = 1, sp: int = 1, pp: int = 1) -> np.ndarray:
    """Ranks 0 .. world - 1 as the [dp, pp, sp, tp] grid of
    ``make_mesh`` (``mesh.py:25-40``)."""
    return np.arange(world).reshape(world // (tp * sp * pp), pp, sp, tp)


# (the default group, dp, pp, sp, tp) -> {axis: [(ranks of a line, its
# group)]}: the groups of a mesh shape are made once for a default group,
# by every rank in the same order (``dist.new_group`` is collective)
_GROUPS: Dict[tuple, Dict[str, list]] = {}


class Mesh:
    """This rank's place in a (dp, pp, sp, tp) grid of the default process
    group's ranks, and the group of each of its axis lines.  An axis of
    size 1 has no group."""

    def __init__(self, tp: int = 1, dp: int = 1, sp: int = 1, pp: int = 1):
        self.shape = {DP_AXIS: dp, PP_AXIS: pp, SP_AXIS: sp, TP_AXIS: tp}
        n = tp * dp * sp * pp
        world = comm.world_size()
        if world != n:
            raise MlisError(
                MlisError.E_OPT_VALUE,
                f"tp={tp} x dp={dp} x sp={sp} x pp={pp} needs {n} ranks, "
                f"have {world}: launch with `torchrun --nproc-per-node {n} "
                "-m mlimgsynth_torch.cli generate ...`")
        self.world = world
        self.rank = dist.get_rank()
        g = grid(world, tp, sp, pp)
        self.coords = dict(zip(AXES, (int(i) for i in
                                      np.argwhere(g == self.rank)[0])))
        key = (dist.group.WORLD, dp, pp, sp, tp)
        if key not in _GROUPS:
            lines = {}
            for ax_i, ax in enumerate(AXES):
                if self.shape[ax] == 1:
                    continue
                moved = np.moveaxis(g, ax_i, -1).reshape(-1, self.shape[ax])
                lines[ax] = [(tuple(int(r) for r in row),
                              dist.new_group([int(r) for r in row]))
                             for row in moved]
            _GROUPS[key] = lines
        self._lines = {ax: next((ranks, grp) for ranks, grp in lines
                                if self.rank in ranks)
                       for ax, lines in _GROUPS[key].items()}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line of ``axis`` (None for an
        axis of size 1)."""
        line = self._lines.get(axis)
        return None if line is None else line[1]

    def ranks(self, axis: str) -> Tuple[int, ...]:
        """The global ranks of this rank's line of ``axis``, in axis
        order."""
        line = self._lines.get(axis)
        return (self.rank,) if line is None else line[0]


_CURRENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "mlis_mesh", default=None)


def current() -> Optional[Mesh]:
    """The mesh of the request running in this context, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def scope(mesh: Optional[Mesh]):
    """Make ``mesh`` the current one for the body (a session's request)."""
    tok = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(tok)
