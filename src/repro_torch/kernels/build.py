"""Builds the CUDA kernels of ``csrc/`` with ``nvcc`` for Hopper
(``sm_90a``) and loads each as a shared library through ``ctypes``.

Each source exports plain C launch functions, so the compile includes no
PyTorch header and takes seconds (a source that includes PyTorch's
headers takes minutes).  Libraries go to ``build/repro_torch_ext/`` at
the repository root, named by a hash of their source and flags, so a
changed source is rebuilt and an unchanged one is reused.  Nothing is
built when this module is imported: the first CUDA launch, or an
explicit :func:`build_all`, builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"
SOURCES = ("sorted_intersect", "expand_join", "fingerprint", "segment_softmax",
           "lane_compact")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_LANES = 65535  # grid.y limit: one block row per lane

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError("nvcc not found: the CUDA kernels need the CUDA "
                            "toolkit to build")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {name: compiler output (ptxas register and shared
    memory report)} for the sources compiled now.  Raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check_i32(name: str, x: torch.Tensor, ndim: int) -> None:
    """Raise unless ``x`` is what a launch function takes: a contiguous
    int32 CUDA tensor of ``ndim`` dimensions."""
    if not x.is_cuda or x.dtype != torch.int32 or x.dim() != ndim \
            or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-D int32 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
