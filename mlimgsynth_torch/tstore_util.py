"""tstore-util: checkpoint inspector / converter CLI (the port's copy of
``mlimgsynth_tpu/tstore_util.py``, over its own ``io.tensorstore``).

    python -m mlimgsynth_torch.tstore_util -i model.safetensors info

Mirrors the reference utility (reference: src/main_tstore_util.c): commands
info / bench / checksum / convert / extract over safetensors and GGUF files,
with the same additive-u32 checksum so outputs are comparable across the two
implementations.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np

HELP = """Usage: tstore-util [OPTIONS] [COMMAND]
Utility to work with model/tensor files.
Formats supported: safetensors, GGUF.

Commands:
  info          Dump information.
  bench         Benchmark tensor reading.
  checksum      Calculate tensors checksums.
  convert       Convert all float tensors to the target type.
  extract       Extract one tensor.

Options:
  -i PATH     Input file
  -o PATH     Output file (default stdout)
  -n INT      Number of times to repeat the benchmark.
  -t NAME     Tensor name to extract.
  -T TYPE     Tensor type for convert (f32, f16, bf16, q8_0, q4_1,
              q4_k, q5_k, q6_k).

  -q          Quiet: reduces information output
  -v          Verbose: increases information output
  -d          Enables debug output
  -h          Print this message
"""


def _checksum_u32(raw: np.ndarray) -> int:
    """Additive uint32 checksum (reference: tsu_checksum,
    main_tstore_util.c:237-277)."""
    n4 = raw.size // 4 * 4
    s = int(raw[:n4].view(np.uint32).sum(dtype=np.uint64))
    return s & 0xFFFFFFFF


def cmd_info(store, out, args):
    meta = store.meta
    if meta:
        out.write("Metadata:\n")
        for k, v in sorted(meta.items()):
            v = str(v)
            if len(v) > 120:
                v = v[:117] + "..."
            out.write(f"  {k}: {v}\n")
    out.write(f"Tensors ({len(store.tensors)}):\n")
    total = 0
    for name in store.names():
        e = store.tensors[name]
        shape = "x".join(str(s) for s in e.shape)
        out.write(f"  {name}: {e.dtype} {shape} @{e.offset} [{e.size}]\n")
        total += e.size
    out.write(f"Total data: {total / 1024**3:.3f} GiB\n")
    return 0


def cmd_bench(store, out, args):
    n_rep = args.n_rep or 4
    for rep in range(n_rep):
        t0 = time.time()
        chksum = 0
        sz = 0
        for name in store.names():
            e = store.tensors[name]
            chksum = (chksum + _checksum_u32(e.raw())) & 0xFFFFFFFF
            sz += e.size
        dt = time.time() - t0
        gib = sz / 1024**3
        sys.stderr.write(
            f"Done 0x{chksum:08X} {len(store.tensors)} tensors "
            f"{dt:.3f}s {gib:.2f}GiB {gib / dt:.2f}GiB/s\n")
    return 0


def cmd_checksum(store, out, args):
    t0 = time.time()
    total = 0
    sz = 0
    for name in store.names():
        e = store.tensors[name]
        c = _checksum_u32(e.raw())
        total = (total + c) & 0xFFFFFFFF
        sz += e.size
        out.write(f"{name}: 0x{c:08X}\n")
    out.write(f"TOTAL: 0x{total:08X}\n")
    sys.stderr.write(
        f"Done {len(store.tensors)} tensors "
        f"{{{time.time() - t0:.3f}s {sz / 1024**3:.2f}GiB}}\n")
    return 0


def cmd_convert(store, out, args):
    if not args.dtype:
        sys.stderr.write("use -T to set the target tensor type\n")
        return 1
    if not args.path_out:
        sys.stderr.write("use -o to set the output file\n")
        return 1
    t0 = time.time()
    if args.path_out.endswith(".gguf"):
        store.write_gguf(args.path_out, dtype=args.dtype)
    else:
        store.write_safetensors(args.path_out, dtype=args.dtype)
    sys.stderr.write(f"Converted to {args.dtype} "
                     f"{{{time.time() - t0:.3f}s}}\n")
    return 0


def cmd_extract(store, out, args):
    if not args.tname:
        sys.stderr.write("use -t to set the tensor name to extract\n")
        return 1
    e = store.tensors.get(args.tname)
    if e is None:
        sys.stderr.write(f"could not find tensor '{args.tname}'\n")
        return 1
    shape = " ".join(str(s) for s in reversed(e.shape))  # ggml dim order
    data = e.raw().tobytes()
    obuf = sys.stdout.buffer if args.path_out in (None, "-") else \
        open(args.path_out, "wb")
    obuf.write(f"TENSOR {e.dtype.upper()} {shape}\n".encode())
    obuf.write(data)
    if obuf is not sys.stdout.buffer:
        obuf.close()
    return 0


class Args:
    cmd = None
    path_in = None
    path_out = None
    tname = None
    dtype = None
    n_rep = 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = Args()
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) > 1 and a != "-":
            for ch in a[1:]:
                nxt = argv[i + 1] if i + 1 < len(argv) else ""
                if ch == "i":
                    args.path_in = nxt
                    i += 1
                elif ch == "o":
                    args.path_out = nxt
                    i += 1
                elif ch == "t":
                    args.tname = nxt
                    i += 1
                elif ch == "T":
                    args.dtype = nxt.lower()
                    i += 1
                elif ch == "n":
                    args.n_rep = int(nxt)
                    i += 1
                elif ch in "qvd":
                    pass
                elif ch == "h":
                    print(HELP)
                    return 0
                else:
                    sys.stderr.write(f"Unknown option '{ch}'\n")
                    return 1
        elif args.cmd is None:
            args.cmd = a
        else:
            sys.stderr.write("Excess of arguments\n")
            return 1
        i += 1

    if args.cmd is None:
        print(HELP)
        return 0
    if not args.path_in:
        sys.stderr.write("use -i to set the input file\n")
        return 1

    from .io.tensorstore import TensorStore
    store = TensorStore.open(args.path_in)

    out = sys.stdout if args.path_out in (None, "-") or \
        args.cmd == "convert" else open(args.path_out, "w")
    try:
        fn = {"info": cmd_info, "bench": cmd_bench, "checksum": cmd_checksum,
              "convert": cmd_convert, "extract": cmd_extract}.get(args.cmd)
        if fn is None:
            sys.stderr.write(f"Unknown command '{args.cmd}'\n")
            return 1
        return fn(store, out, args)
    finally:
        if out is not sys.stdout:
            out.close()


if __name__ == "__main__":
    sys.exit(main())
