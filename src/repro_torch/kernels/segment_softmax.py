"""Binding of the CUDA kernel ``csrc/segment_softmax.cu``: the fused
normalize pass of the segment softmax, the GNN substrate's edge softmax.

Replaces the TPU kernel ``repro/kernels/segment_softmax.py``
(``segment_softmax``, body ``_norm_kernel``).  One thread per (e, d)
element; a ragged E needs no padding.  The segment max and sum tables
come from ``ref.segment_tables`` (PyTorch reductions), as they came from
XLA segment ops outside the Pallas call.  ``launches`` counts the kernel
launches of this process (the plain version in ``ref.py`` does not
count).
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
        lib.repro_segment_normalize.argtypes = [p, p, p, p, p, i, i, i,
                                                ctypes.c_float, i, p]
        lib.repro_segment_normalize.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def _check_f32_table(name: str, t: torch.Tensor, shape: tuple) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor of "
                         f"shape {shape}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def segment_normalize(scores: torch.Tensor, segment_ids: torch.Tensor,
                      mx: torch.Tensor, den: torch.Tensor,
                      eps: float = 1e-9) -> torch.Tensor:
    """``exp(scores - mx[s]) / (den[s] + eps)`` with ``s`` the segment id
    clipped to ``[0, N)``, in the scores' dtype.  ``scores`` (E, D)
    float32 or bfloat16, ``segment_ids`` (E,) int32, ``mx``/``den``
    (N, D) float32: contiguous, on one CUDA device."""
    global launches
    if not scores.is_cuda or scores.dtype not in _DTYPES or scores.dim() != 2 \
            or not scores.is_contiguous():
        raise ValueError("scores: need a contiguous 2-D float32 or bfloat16 "
                         f"CUDA tensor, got {scores.dtype} "
                         f"{tuple(scores.shape)} on {scores.device}")
    e, d = scores.shape
    build.check_i32("segment_ids", segment_ids, 1)
    if segment_ids.shape[0] != e:
        raise ValueError(f"segment_ids: need {e} ids, got {segment_ids.shape[0]}")
    n_seg = mx.shape[0] if mx.dim() == 2 else 0
    _check_f32_table("mx", mx, (n_seg, d))
    _check_f32_table("den", den, (n_seg, d))
    if n_seg < 1:
        raise ValueError("segment_normalize needs at least one segment")
    if e * d > 2**31 - 1:
        raise ValueError(f"segment_normalize: {e} x {d} elements exceed the "
                         "int32 grid")
    if not (scores.device == segment_ids.device == mx.device == den.device):
        raise ValueError("all tensors must lie on one device")
    out = torch.empty_like(scores)
    if e == 0 or d == 0:
        return out
    lib = _lib()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_segment_normalize(
            scores.data_ptr(), segment_ids.data_ptr(), mx.data_ptr(),
            den.data_ptr(), out.data_ptr(), e * d, d, n_seg, float(eps),
            _DTYPES[scores.dtype], stream)
    if err != 0:
        raise RuntimeError("segment_normalize launch failed: "
                           + lib.repro_error_string(err).decode())
    launches += 1
    return out
