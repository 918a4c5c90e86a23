"""Binding of the CUDA kernel ``csrc/sorted_intersect.cu``: sorted-set
membership, the class-space CONJUNCTION hot spot (Prop. 4.1).

Replaces the TPU kernel ``repro/kernels/sorted_intersect.py``
(``sorted_member_mask``).  One thread per query binary-searches its
lane's haystack; the grid is (ceil(n_q / 256), lanes) and nothing is
padded to blocks.  ``launches`` counts the kernel launches of this
process (the plain version in ``ref.py`` does not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0


def _lib():
    lib = build.load("sorted_intersect")
    if lib.repro_sorted_member_mask.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.repro_sorted_member_mask.argtypes = [p, p, p, p, i, i, i, p]
        lib.repro_sorted_member_mask.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def sorted_member_mask(hay: torch.Tensor, hay_count: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """(B, n_q) int32 0/1: ``queries[b, i]`` in sorted
    ``hay[b, :hay_count[b]]``.  ``hay`` (B, n_hay), ``hay_count`` (B,),
    ``queries`` (B, n_q): contiguous int32 on one CUDA device."""
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
    lib = _lib()
    with torch.cuda.device(hay.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_sorted_member_mask(
            hay.data_ptr(), hay_count.data_ptr(), queries.data_ptr(),
            out.data_ptr(), lanes, n_hay, n_q, stream)
    if err != 0:
        raise RuntimeError("sorted_member_mask launch failed: "
                           + lib.repro_error_string(err).decode())
    launches += 1
    return out
