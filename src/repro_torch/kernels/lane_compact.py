"""Binding of the CUDA kernel ``csrc/lane_compact.cu``: lane-batched stable
compaction, ``rel_compact`` of the relational substrate.

Replaces no TPU kernel: the reference compacts with a stable ``lax.sort``
on the keep flag, which XLA compiles.  One call enqueues three launches on
the current stream over tiles of 1 024 or 4 096 rows (the kernel picks by
shape): the tiles' kept counts, a scan of them a lane (offsets and the new
counts), and the move.  Outputs and scratch come from ``torch.empty`` and
nothing synchronises, so a CUDA graph can capture a call.  ``launches``
counts the calls of this process (the plain version,
``core.relational.lane_compact``, does not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_COLS = 8  # the kernel's by-value pointer struct
TILE = 1024  # the fewest rows a tile has (256 threads x 4): sizes the scratch

launches = 0


def _lib():
    lib = build.load("lane_compact")
    if lib.repro_lane_compact.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        q = ctypes.c_longlong
        lib.repro_lane_compact.argtypes = [p, q, p, p, p, p, i, i, i, p, p, p]
        lib.repro_lane_compact.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def lane_compact(cols, count, keep):
    """``cols``: 1 to 8 (lanes, cap) int32 tensors, each with unit stride
    along its rows and any lane stride (0 for a column shared by every
    lane); ``count`` (lanes,) contiguous int32; ``keep`` (lanes, cap) bool
    with unit stride along its rows; all on one CUDA device.  Returns (the
    compacted columns, each (lanes, cap) contiguous int32, and the new
    counts, (lanes,) int32), bit for bit ``ref.lane_compact``."""
    global launches
    cols = tuple(cols)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"lane_compact takes 1 to {MAX_COLS} columns, "
                         f"got {len(cols)}")
    build.check_i32("count", count, 1)
    checks = [(f"cols[{j}]", c, torch.int32) for j, c in enumerate(cols)]
    for name, x, dtype in checks + [("keep", keep, torch.bool)]:
        if not x.is_cuda or x.dtype != dtype or x.dim() != 2:
            raise ValueError(f"{name}: need a 2-D {dtype} CUDA tensor, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    lanes, cap = keep.shape
    if any(c.shape != keep.shape for c in cols) or count.shape[0] != lanes:
        raise ValueError("lane_compact: mismatched shapes")
    if cap > 1 and any(x.stride(1) != 1 for x in (keep, *cols)):
        raise ValueError("lane_compact: rows need unit stride")
    if lanes > build.MAX_LANES:
        raise ValueError(f"{lanes} lanes exceed the grid limit {build.MAX_LANES}")
    if cap > 2**31 - 1:
        raise ValueError(f"lane_compact: capacity {cap} exceeds int32")
    if len({x.device for x in (keep, count, *cols)}) != 1:
        raise ValueError("all tensors must lie on one device")
    outs = tuple(torch.empty((lanes, cap), dtype=torch.int32, device=keep.device)
                 for _ in cols)
    new_count = torch.empty(lanes, dtype=torch.int32, device=keep.device)
    if lanes == 0 or cap == 0:
        return outs, new_count.zero_()
    offsets = torch.empty((lanes, -(-cap // TILE)), dtype=torch.int32,
                          device=keep.device)
    n = len(cols)
    src = (ctypes.c_void_p * n)(*(c.data_ptr() for c in cols))
    strides = (ctypes.c_longlong * n)(*(c.stride(0) for c in cols))
    dst = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
    lib = _lib()
    with torch.cuda.device(keep.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_lane_compact(
            keep.data_ptr(), keep.stride(0), count.data_ptr(), src, strides,
            dst, n, lanes, cap, offsets.data_ptr(), new_count.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError("lane_compact launch failed: "
                           + lib.repro_error_string(err).decode())
    launches += 1
    return outs, new_count
