"""Roofline inputs of one card from a cell's step: the twin of the
reference's ``roofline/collect.py``.

The reference reads a compiled XLA executable (``cost_analysis``,
``memory_analysis``, the optimized HLO's collectives).  The port has no
HLO: :func:`analyze_step` runs the cell's step once on the meta device
under ``op_cost`` and writes the reference's record keys from what it
counts.  ``_shape_bytes`` and :func:`collective_bytes` are the
reference's string functions, unchanged; :func:`roofline_terms` is the
reference's model with the card's constants.

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power
limit, NVIDIA's data sheet — 989 TFLOP/s dense bfloat16, 3.35 TB/s HBM,
NVLink 4 at 450 GB/s each way (no collective on one card: the term is 0).
"""

from __future__ import annotations

import re

from .op_cost import analyze

PEAK_FLOPS = 989e12  # dense bfloat16, one H100 SXM
HBM_BW = 3.35e12  # bytes/s, its HBM3
ICI_BW = 450e9  # bytes/s, NVLink 4 each way (unused on one card)
CARD_BYTES = 80 * 2**30  # the card's device memory, as a cell must fit it

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# e.g.  f32[128,256]{1,0}  or  bf16[64,4096,6144]
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")

_COLLECTIVE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*"
    r"((?:\([^)]*\)|[\w\[\],{}\s]+?))\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(",
    re.MULTILINE,
)


def _shape_bytes(shape_str: str) -> int:
    """Total bytes of a shape string like 'bf16[64,128]' or a tuple
    '(f32[2], bf16[4,4])'."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Sum output-shape bytes per collective kind from optimized HLO.

    Counted once per instruction (start/done pairs deduped by counting
    only ``-start`` or the fused form, never ``-done``)."""
    out: dict[str, int] = {}
    counts: dict[str, int] = {}
    for m in _COLLECTIVE_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        line = m.group(0)
        if "-done(" in line:
            continue
        b = _shape_bytes(shape_str)
        out[kind] = out.get(kind, 0) + b
        counts[kind] = counts.get(kind, 0) + 1
    return {"bytes_by_kind": out, "counts_by_kind": counts,
            "total_bytes": sum(out.values())}


def analyze_step(cell) -> dict:
    """Everything the roofline needs from one run of ``cell``'s step
    (a ``launch.steps.Cell``, usually on the meta device), in the
    reference's record keys, JSON-serializable."""
    cost = analyze(cell.fn, cell.args, cell.device)
    live = cost["peak_bytes"]
    return {
        "n_devices": 1,
        "mesh_shape": dict(cell.mesh_shape),
        "total_flops": cost["flops"],
        "hlo_bytes": cost["traffic_bytes"],
        "n_ops": cost["n_ops"],
        "scan_flops": cost["flops"],
        "scan_traffic_bytes": cost["traffic_bytes"],
        "collectives": cost["collectives"],
        "loops": cost["loops"],
        "argument_size_in_bytes": cost["argument_bytes"],
        "output_size_in_bytes": cost["output_bytes"],
        "temp_size_in_bytes": cost["temp_bytes"],
        "alias_size_in_bytes": cost["alias_bytes"],
        "per_device_hbm_bytes": int(live),
        "per_device_hbm_gb": round(live / 2**30, 3),
        "fits_card": live <= CARD_BYTES,
    }


def roofline_terms(rec: dict, model_flops: float | None = None) -> dict:
    """The three-term roofline (seconds) from a dry-run record.

    All numerators are one card's (``op_cost`` counts the step that
    card runs); ``scan_flops``/``scan_traffic_bytes`` are read first, as
    in the reference, and equal ``total_flops``/``hlo_bytes`` here."""
    n = rec["n_devices"]
    flops = rec.get("scan_flops") or rec.get("total_flops", 0.0)
    bytes_hbm = rec.get("scan_traffic_bytes") or rec.get("hlo_bytes", 0.0)
    coll = rec.get("collectives", {}).get("total_bytes", 0)
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_hbm / HBM_BW
    t_coll = coll / ICI_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]
    out = {
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flop_frac"] = (model_flops / n) / max(flops, 1.0)
    return out
