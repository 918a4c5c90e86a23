"""Binding of the CUDA kernel ``csrc/segment_softmax.cu``: the fused
normalize pass of the segment softmax, the GNN substrate's edge softmax.

Replaces the TPU kernel ``repro/kernels/segment_softmax.py``
(``segment_softmax``, body ``_norm_kernel``).  The segment max and sum come
in one packed (N, D, 2) float32 table from ``ref.segment_tables`` (PyTorch
reductions), as they came from XLA segment ops outside the Pallas call; the
kernel gathers one float2 per element from it.  At D = 1 a thread takes one
16-byte vector of scores, at D > 1 a block takes a tile of whole rows; a
ragged E needs no padding.  ``launches`` counts the kernel launches of this
process (the plain version in ``ref.py`` does not count).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib():
    lib = build.load("segment_softmax")
    if lib.repro_segment_normalize.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.repro_segment_normalize.argtypes = [p, p, p, p, i, i, i,
                                                ctypes.c_float, i, p]
        lib.repro_segment_normalize.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check_table(table: torch.Tensor, d: int) -> None:
    """Raise unless ``table`` is what the kernel gathers from: a contiguous
    (N >= 1, d, 2) float32 tensor whose data starts on 8 bytes (one float2
    per entry).  The device is checked by the caller."""
    if table.dtype != torch.float32 or table.dim() != 3 \
            or table.shape[1:] != (d, 2) or table.shape[0] < 1:
        raise ValueError(f"table: need float32 of shape (N >= 1, {d}, 2), got "
                         f"{table.dtype} {tuple(table.shape)}")
    if not table.is_contiguous() or table.data_ptr() % 8:
        raise ValueError("table: need a contiguous tensor starting on 8 bytes "
                         f"(strides {table.stride()}, storage offset "
                         f"{table.storage_offset()})")


def segment_normalize(scores: torch.Tensor, segment_ids: torch.Tensor,
                      table: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """``exp(scores - table[s, :, 0]) / (table[s, :, 1] + eps)`` with ``s``
    the segment id clipped to ``[0, N)``, in the scores' dtype.  ``scores``
    (E, D) float32 or bfloat16, ``segment_ids`` (E,) int32, ``table``
    (N, D, 2) float32 (see :func:`check_table`): contiguous, on one CUDA
    device."""
    global launches
    if scores.dtype not in _DTYPES or scores.dim() != 2 \
            or not scores.is_contiguous():
        raise ValueError("scores: need a contiguous 2-D float32 or bfloat16 "
                         f"tensor, got {scores.dtype} {tuple(scores.shape)}")
    e, d = scores.shape
    check_table(table, d)
    if not (scores.is_cuda and segment_ids.is_cuda and table.is_cuda):
        raise ValueError("segment_normalize: need CUDA tensors, got "
                         f"{scores.device}, {segment_ids.device}, {table.device}")
    build.check_i32("segment_ids", segment_ids, 1)
    if segment_ids.shape[0] != e:
        raise ValueError(f"segment_ids: need {e} ids, got {segment_ids.shape[0]}")
    if e * d > 2**31 - 1:
        raise ValueError(f"segment_normalize: {e} x {d} elements exceed the "
                         "int32 grid")
    if not (scores.device == segment_ids.device == table.device):
        raise ValueError("all tensors must lie on one device")
    out = torch.empty_like(scores)
    if e == 0 or d == 0:
        return out
    lib = _lib()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_segment_normalize(
            scores.data_ptr(), segment_ids.data_ptr(), table.data_ptr(),
            out.data_ptr(), e, d, table.shape[0], float(eps),
            _DTYPES[scores.dtype], stream)
    if err != 0:
        raise RuntimeError("segment_normalize launch failed: "
                           + lib.repro_error_string(err).decode())
    launches += 1
    return out
