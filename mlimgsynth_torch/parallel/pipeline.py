"""Pipeline parallelism over the ``pp`` ranks, GPipe-style inference (port
of ``mlimgsynth_tpu/parallel/pipeline.py``).

A DiT's block stack is cut into ``pp`` stages of consecutive blocks; rank s
loads and keeps only stage s's blocks (:func:`keep_stage`).  Microbatches
stream through the stages: stage s runs microbatch t - s at tick t and
hands its activations to stage s + 1 (a send each tick, started before the
next microbatch runs); the last stage's output is broadcast over the pp
group, which is what the JAX package's ``psum`` of a buffer that only the
last stage wrote amounts to.  ``MLIS_PP_MICRO`` picks the microbatch count
M (it divides the model batch N; 0 or unset: M = N).

The JAX package stacks the blocks into [pp, L, ...] slabs and zero-pads
Flux's stacks to a multiple of pp with identity blocks; here a stage runs
its own blocks, so Flux's stages are uneven instead (stage s holds blocks
[s L, min((s + 1) L, depth)) with L = ceil(depth / pp), the same partition
less the identity blocks).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from . import comm


@dataclass(frozen=True)
class Stage:
    """This rank's stage: its index, the stage count, the global ranks of
    its pp line in stage order and their group."""
    index: int
    n: int
    ranks: Tuple[int, ...]
    group: object


def stage_range(depth: int, n_stage: int, s: int) -> Tuple[int, int]:
    """Blocks [lo, hi) of stage ``s`` out of ``n_stage`` for a stack of
    ``depth`` (the JAX package's padded partition, ``api.py:1385-1425``,
    without the padding)."""
    per = -(-depth // n_stage)
    return min(s * per, depth), min((s + 1) * per, depth)


class _Absent(nn.Module):
    """Another stage's block: no parameters on this rank."""


def keep_stage(blocks: nn.ModuleList, lo: int, hi: int) -> None:
    """Drop every block of ``blocks`` outside [lo, hi) (a module on the
    meta device, before its parameters are read), so that the rank reads
    and holds only its stage's weights; the kept blocks keep their
    indices, and names."""
    for i in range(len(blocks)):
        if not lo <= i < hi:
            blocks[i] = _Absent()


def present(blocks: nn.ModuleList) -> list:
    """The blocks of ``blocks`` this rank holds, in order."""
    return [b for b in blocks if not isinstance(b, _Absent)]


def pipeline_apply(stage: Stage, stage_fn: Callable, acts: tuple,
                   collect: int = 0, m: Optional[int] = None
                   ) -> torch.Tensor:
    """Run ``stage_fn`` (this rank's blocks: a tuple of [n, ...] tensors
    -> a tuple of the same) over the pipeline (``pipeline_apply``,
    ``pipeline.py:55-126``).  ``acts``: [N, ...] inputs, whole on every
    rank; returns ``acts[collect]``'s counterpart after the last stage,
    [N, ...], on every rank."""
    n = acts[0].shape[0]
    if m is None:
        m = int(os.environ.get("MLIS_PP_MICRO", "0")) or n
    if m < 1 or n % m:
        raise ValueError(f"pipeline microbatch count {m} (MLIS_PP_MICRO) "
                         f"must divide the model batch {n}")
    per = n // m
    s, last = stage.index, stage.n - 1

    def micro(j):
        return tuple(None if a is None else a[j * per:(j + 1) * per]
                     for a in acts)

    outs, pending = [], []
    for j in range(m):
        if s == 0:
            act = micro(j)
        else:
            act = tuple(None if a is None else
                        comm.recv(a, stage.ranks[s - 1], stage.group)
                        for a in micro(j))
        y = stage_fn(act)
        if s < last:
            for req, _ in pending:
                req.wait()
            pending = [comm.send(a, stage.ranks[s + 1], stage.group)
                       for a in y if a is not None]
        else:
            outs.append(y[collect])
    for req, _ in pending:
        req.wait()
    like = acts[collect]
    out = (torch.cat(outs) if s == last else
           torch.empty(like.shape, dtype=like.dtype, device=like.device))
    return comm.broadcast(out, stage.ranks[last], stage.group)
