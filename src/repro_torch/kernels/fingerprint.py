"""Binding of the CUDA kernel ``csrc/fingerprint.cu``: the two-lane
avalanche row fingerprint, the signature-set hashing hot spot of index
construction (bisim's per-level set grouping, iaCPQx class ids).

Replaces the TPU kernel ``repro/kernels/fingerprint.py``
(``fingerprint_rows``).  One thread per row chains the row's columns
through ``mix32`` in registers; the column pointers go to the kernel by
value, so nothing is stacked.  ``launches`` counts the kernel launches of
this process (the plain version in ``ref.py`` does not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_COLS = 8  # the kernel's by-value pointer struct
_M32 = 0xFFFFFFFF

launches = 0


def _lib():
    lib = build.load("fingerprint")
    if lib.repro_fingerprint_rows.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        u = ctypes.c_uint
        lib.repro_fingerprint_rows.argtypes = [p, i, i, u, u, p, p, p]
        lib.repro_fingerprint_rows.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def fingerprint_rows(cols, salt: int = 0) -> tuple:
    """Two uint32 fingerprints per row of the int32 columns ``cols`` (1 to
    8 contiguous 1-D tensors of one length, on one CUDA device), as two
    int64 tensors holding values in [0, 2^32) — bit-identical to
    ``core.relational.fingerprint_rows``."""
    global launches
    cols = tuple(cols)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"fingerprint_rows takes 1 to {MAX_COLS} columns, "
                         f"got {len(cols)}")
    for j, c in enumerate(cols):
        build.check_i32(f"cols[{j}]", c, 1)
    n = cols[0].shape[0]
    if any(c.shape[0] != n for c in cols):
        raise ValueError("fingerprint_rows: columns of unequal length")
    if n > 2**31 - 1:
        raise ValueError(f"fingerprint_rows: {n} rows exceed the int32 grid")
    if len({c.device for c in cols}) != 1:
        raise ValueError("all tensors must lie on one device")
    h1 = torch.empty(n, dtype=torch.int64, device=cols[0].device)
    h2 = torch.empty_like(h1)
    if n == 0:
        return h1, h2
    lib = _lib()
    ptrs = (ctypes.c_void_p * len(cols))(*(c.data_ptr() for c in cols))
    with torch.cuda.device(h1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_fingerprint_rows(
            ptrs, len(cols), n, (2 * salt + 101) & _M32,
            (2 * salt + 202) & _M32, h1.data_ptr(), h2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("fingerprint_rows launch failed: "
                           + lib.repro_error_string(err).decode())
    launches += 1
    return h1, h2
