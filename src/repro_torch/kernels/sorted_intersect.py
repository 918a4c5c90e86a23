"""Binding of the CUDA kernel ``csrc/sorted_intersect.cu``: sorted-set
membership, the class-space CONJUNCTION hot spot (Prop. 4.1).

Replaces the TPU kernel ``repro/kernels/sorted_intersect.py``
(``sorted_member_mask``).  One thread per query, the grid (ceil(n_q /
threads), lanes) with ``threads`` a block (:data:`DEFAULT_THREADS` unless a
tuned cost table names another, ``ops.set_tuned_blocks``); nothing is
padded to blocks.  :func:`launch_plan` decides where a
lane's haystack is searched: staged in shared memory when it fits the
budget, in device memory when it is larger, or small enough to sit in one
L1 line (two paths of the one kernel).
``launches`` counts the kernel launches of this process (the plain version
in ``ref.py`` does not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# Bytes of haystack a block stages at most (6 144 ids).  Every query block
# of a lane copies the haystack again, so the copy grows with the haystack
# and the search it saves only with its log.  Measured on the H100 at 16
# query blocks a lane (chip_smoke.py, PERF.md): staging won at 4 097 and
# 6 144 ids and lost at 12 288 (48 KB, the kernel's most).  The path's
# haystacks stay far below this (at most 256 ids).
SHARED_BUDGET = 24 * 1024
# A haystack within one 128-byte L1 line is searched in place: after its
# first miss every step hits L1, so a copy would save nothing.
SHARED_FLOOR = 128
# Threads a block when no tuned cost table is active.
DEFAULT_THREADS = 256

launches = 0


def _lib():
    lib = build.load("sorted_intersect")
    if lib.repro_sorted_member_mask.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.repro_sorted_member_mask.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.repro_sorted_member_mask.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def launch_plan(n_hay: int) -> tuple[str, int]:
    """Where the kernel searches a lane's haystack of ``n_hay`` int32 ids:
    ``("shared", 4 * n_hay)`` stages the live ids in that many bytes of
    dynamic shared memory a block, when they fill more than one L1 line
    (:data:`SHARED_FLOOR`) and fit :data:`SHARED_BUDGET`; ``("global", 0)``
    searches the haystack where it lies."""
    need = 4 * n_hay
    if SHARED_FLOOR < need <= SHARED_BUDGET:
        return "shared", need
    return "global", 0


def sorted_member_mask(hay: torch.Tensor, hay_count: torch.Tensor,
                       queries: torch.Tensor,
                       threads: int = DEFAULT_THREADS) -> torch.Tensor:
    """(B, n_q) int32 0/1: ``queries[b, i]`` in sorted
    ``hay[b, :hay_count[b]]``.  ``hay`` (B, n_hay), ``hay_count`` (B,),
    ``queries`` (B, n_q): contiguous int32 on one CUDA device.
    ``threads`` a block: a multiple of 32 in [32, 1024]."""
    global launches
    build.check_i32("hay", hay, 2)
    build.check_i32("hay_count", hay_count, 1)
    build.check_i32("queries", queries, 2)
    lanes, n_hay = hay.shape
    n_q = queries.shape[1]
    if queries.shape[0] != lanes or hay_count.shape[0] != lanes:
        raise ValueError("hay, hay_count and queries need the same lanes")
    if lanes > build.MAX_LANES:
        raise ValueError(f"{lanes} lanes exceed the grid limit {build.MAX_LANES}")
    if not (hay.device == hay_count.device == queries.device):
        raise ValueError("all tensors must lie on one device")
    out = torch.empty_like(queries)
    if lanes == 0 or n_q == 0:
        return out
    launch(hay, hay_count, queries, out, launch_plan(n_hay)[1], threads)
    launches += 1
    return out


def launch(hay, hay_count, queries, out, shared_bytes: int,
           threads: int = DEFAULT_THREADS) -> None:
    """One launch on checked tensors: ``shared_bytes`` > 0 stages each
    lane's haystack in that many bytes (4 * n_hay up to 48 KB), 0 searches
    it in place; ``threads`` a block.  :func:`sorted_member_mask` takes
    ``launch_plan``'s bytes; a measurement may time either path of the
    same input.  The kernel refuses a block size that is not a multiple of
    32 in [32, 1024], and the launch raises."""
    lib = _lib()
    with torch.cuda.device(hay.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_sorted_member_mask(
            hay.data_ptr(), hay_count.data_ptr(), queries.data_ptr(),
            out.data_ptr(), hay.shape[0], hay.shape[1], queries.shape[1],
            shared_bytes, threads, stream)
    if err != 0:
        raise RuntimeError("sorted_member_mask launch failed: "
                           + lib.repro_error_string(err).decode())
