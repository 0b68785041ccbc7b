"""Process groups and the collectives of the multi-rank modes.

The JAX package's collectives are XLA's over ICI; here they are
``torch.distributed``'s, between processes:

- :func:`init` joins the default group: from ``torchrun``'s environment
  (``env://``) or, for the tests and ``chip_smoke.py``, a ``file://``
  rendezvous (:func:`spawn`).
- The transport is picked from the topology, once: NCCL when every local
  rank has a card of its own, gloo when ranks share one card or run on the
  CPU (NCCL does not put two ranks on one device).
- Gloo moves host memory: a CUDA tensor is staged through pinned host
  memory for every collective here (a copy each way, in the open).
- :func:`all_reduce_sum`, :func:`all_gather`, :func:`ring_shift`,
  :func:`send` / :func:`recv` and :func:`broadcast` are the collectives the
  modes need; a bf16 tensor that is only moved travels as its bytes.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """The rank on this host (torchrun's ``LOCAL_RANK``, else the global
    rank)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def backend_for(device_type: str, n_local: int) -> str:
    """NCCL when each of the ``n_local`` ranks on this host has a card of
    its own, else gloo."""
    if (device_type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() >= n_local
            and dist.is_nccl_available()):
        return "nccl"
    return "gloo"


def init(device_type: str, init_method: Optional[str] = None,
         rank_: Optional[int] = None, world: Optional[int] = None) -> bool:
    """Join the default process group when there is one to join: from
    ``init_method`` with ``rank_`` and ``world``, or from torchrun's
    environment.  Returns whether a group is up."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                             "MASTER_ADDR", "MASTER_PORT")):
            return False
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank_ = int(os.environ["RANK"])
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dist.init_process_group(backend_for(device_type, n_local),
                            init_method=init_method, rank=rank_,
                            world_size=world)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def transport() -> str:
    return dist.get_backend() if dist.is_initialized() else "none"


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (the gloo stage)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) viewed as a type every gloo build moves: bf16 as
    its bytes."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks, in ``t``'s dtype (callers
    pass f32 partial sums)."""
    if not _staged(t, group):
        t = t.contiguous()
        dist.all_reduce(t, group=group)
        return t
    h = _host(t)
    dist.all_reduce(h, group=group)
    return h.to(t.device, non_blocking=True)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (one shape) concatenated along ``dim`` in group
    order."""
    n = dist.get_world_size(group)
    src = _host(t) if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather([_bits(p) for p in parts], _bits(src), group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device, non_blocking=True) if src is not t else out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the global rank ``src`` on every rank of ``group`` (the
    others pass a tensor of the same shape and dtype to fill)."""
    if not _staged(t, group):
        t = t.contiguous()
        dist.broadcast(_bits(t), src, group=group)
        return t
    h = _host(t)
    dist.broadcast(_bits(h), src, group=group)
    return h.to(t.device, non_blocking=True)


def send(t: torch.Tensor, dst: int, group):
    """Start sending ``t`` to the global rank ``dst``; returns (request,
    buffer): the buffer must live until the request is waited for."""
    buf = _host(t) if _staged(t, group) else t.contiguous()
    return dist.isend(_bits(buf), dst, group=group), buf


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor shaped as ``like`` received from the global rank ``src``,
    on ``like``'s device."""
    staged = _staged(like, group)
    buf = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
           if staged else torch.empty(like.shape, dtype=like.dtype,
                                      device=like.device))
    dist.recv(_bits(buf), src, group=group)
    return buf.to(like.device, non_blocking=True) if staged else buf


def ring_shift(ts: Sequence[torch.Tensor], ranks: Sequence[int], group
               ) -> List[torch.Tensor]:
    """One hop around the ring ``ranks`` (global ranks in ring order):
    each tensor of ``ts`` goes to the next rank, and the previous rank's
    come back (``lax.ppermute`` with the perm i -> i + 1)."""
    me = ranks.index(dist.get_rank())
    nxt, prv = ranks[(me + 1) % len(ranks)], ranks[me - 1]
    sent = [send(t, nxt, group) for t in ts]
    out = [recv(t, prv, group) for t in ts]
    for req, _ in sent:
        req.wait()
    return out


# -- spawning ranks (tests, chip_smoke.py) ----------------------------------

def _entry(fn, rk: int, world: int, init_file: str, device_type: str,
           threads: int, args, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        init(device_type, f"file://{init_file}", rk, world)
        try:
            out = fn(rk, world, *args)
        finally:
            shutdown()
        results.put((rk, True, out))
    except BaseException:                            # noqa: BLE001
        results.put((rk, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args: tuple = (),
          device_type: str = "cpu", threads: int = 1,
          timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` method: no state of this one, no jax) joined by a
    ``file://`` rendezvous; returns their results in rank order.  A rank
    that raises, or a run past ``timeout`` seconds, raises here, and every
    process is ended before this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    fd, init_file = tempfile.mkstemp(prefix="mlis_rdv_")
    os.close(fd)
    os.remove(init_file)        # the rendezvous makes it
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, world, init_file, device_type,
                               threads, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, err = {}, None
    deadline = time.time() + timeout
    try:
        while len(got) < world:
            left = deadline - time.time()
            if left <= 0:
                raise TimeoutError(f"spawn: {world} ranks not done in "
                                   f"{timeout:.0f} s")
            try:
                rk, ok, out = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"spawn: a rank exited with {dead[0].exitcode}")
                continue
            if not ok:
                err = f"rank {rk}:\n{out}"
                break
            got[rk] = out
    finally:
        for p in procs:
            p.join(timeout=0 if err else 10)
            if p.is_alive():
                p.terminate()
                p.join(5)
        if os.path.exists(init_file):
            os.remove(init_file)
    if err:
        raise RuntimeError("spawn: " + err)
    return [got[r] for r in range(world)]
