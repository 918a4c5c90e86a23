"""Binding of the CUDA kernel ``csrc/expand_join.cu``: the fused CSR
expansion gather, the ``I_c2p`` materialization hot spot.

Replaces the TPU kernel ``repro/kernels/expand_join.py``
(``expand_join_gather``).  One thread per output row binary-searches its
lane's inclusive-cumsum ``ends`` and gathers the build row and the probe
payload; the grid is (ceil(out_capacity / threads), lanes), ``threads``
a block (:data:`DEFAULT_THREADS` unless a tuned cost table names another,
``ops.set_tuned_blocks``).  ``launches``
counts the kernel launches of this process (the plain version in
``ref.py`` does not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# Threads a block when no tuned cost table is active.
DEFAULT_THREADS = 256

launches = 0


def _lib():
    lib = build.load("expand_join")
    if lib.repro_expand_join_gather.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.repro_expand_join_gather.argtypes = [p] * 9 + [i, i, i, i, i, p]
        lib.repro_expand_join_gather.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def expand_join_gather(ends, lo, a_payload, b_v, b_u, total,
                       out_capacity: int, threads: int = DEFAULT_THREADS):
    """``ends``/``lo``/``a_payload`` (B, n_a), ``b_v``/``b_u`` (n_b,),
    ``total`` (B,): contiguous int32 on one CUDA device.  Returns three
    (B, out_capacity) int32 tensors (see ``ref.expand_join_gather``).
    ``threads`` a block: a multiple of 32 in [32, 1024] (the kernel
    refuses any other, and the launch raises)."""
    global launches
    for name, x in (("ends", ends), ("lo", lo), ("a_payload", a_payload)):
        build.check_i32(name, x, 2)
    for name, x in (("b_v", b_v), ("b_u", b_u), ("total", total)):
        build.check_i32(name, x, 1)
    lanes, n_a = ends.shape
    n_b = b_v.shape[0]
    if lo.shape != ends.shape or a_payload.shape != ends.shape \
            or total.shape[0] != lanes or b_u.shape[0] != n_b:
        raise ValueError("expand_join_gather: mismatched shapes")
    if n_a == 0 or n_b == 0:
        raise ValueError("expand_join_gather: empty probe or build side")
    if lanes > build.MAX_LANES:
        raise ValueError(f"{lanes} lanes exceed the grid limit {build.MAX_LANES}")
    if len({x.device for x in (ends, lo, a_payload, b_v, b_u, total)}) != 1:
        raise ValueError("all tensors must lie on one device")
    outs = [torch.empty((lanes, out_capacity), dtype=torch.int32,
                        device=ends.device) for _ in range(3)]
    if lanes == 0 or out_capacity == 0:
        return tuple(outs)
    lib = _lib()
    with torch.cuda.device(ends.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_expand_join_gather(
            ends.data_ptr(), lo.data_ptr(), a_payload.data_ptr(),
            b_v.data_ptr(), b_u.data_ptr(), total.data_ptr(),
            *(o.data_ptr() for o in outs), lanes, n_a, n_b, out_capacity,
            threads, stream)
    if err != 0:
        raise RuntimeError("expand_join_gather launch failed: "
                           + lib.repro_error_string(err).decode())
    launches += 1
    return tuple(outs)
