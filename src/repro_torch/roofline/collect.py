"""Roofline inputs of one device from a cell's step: the twin of the
reference's ``roofline/collect.py``.

The reference reads a compiled XLA executable (``cost_analysis``,
``memory_analysis``, the optimized HLO's collectives).  The port has no
HLO: :func:`analyze_step` runs the cell's step once on the meta device
under ``op_cost`` and writes the reference's record keys from what it
counts: on a mesh one rank's (``n_devices``, ``mesh_shape``), with its
collectives by kind and by mesh axis.  ``_shape_bytes`` and
:func:`collective_bytes` are the reference's string functions,
unchanged; :func:`roofline_terms` is the reference's model with the
card's constants, each collective priced by the slowest link its axis
spans.

Hardware constants, NVIDIA's data sheets, not measurements: one NVIDIA
H100 80GB HBM3 (SXM) at its 700 W power limit — 989 TFLOP/s dense
bfloat16, 3.35 TB/s HBM; NVLink 4 at 450 GB/s each way between the 8
cards of a node; across nodes one 400 Gb/s NDR InfiniBand port a card
(50 GB/s).  Ranks fill nodes in row-major mesh order, so an axis whose
stride times size exceeds 8 (the 16-way "model" axis, "data", "pod" of
the production meshes) spans nodes and is priced at NDR.  A group over
several axes (a mesh flattened: the GNN and engine cells' collectives)
is filed under its axes joined with ``+`` and priced at the slowest link
any of them spans.
"""

from __future__ import annotations

import re

import torch.distributed as dist

from .op_cost import analyze

PEAK_FLOPS = 989e12  # dense bfloat16, one H100 SXM
HBM_BW = 3.35e12  # bytes/s, its HBM3
ICI_BW = 450e9  # bytes/s, NVLink 4 each way, within a node
NDR_BW = 50e9  # bytes/s, 400 Gb/s NDR InfiniBand a card, across nodes
CARDS_PER_NODE = 8
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


def analyze_step(cell, in_place_backward: bool = True) -> dict:
    """Everything the roofline needs from one run of ``cell``'s step
    (a ``launch.steps.Cell``, usually on the meta device), in the
    reference's record keys, JSON-serializable.  ``in_place_backward``:
    see ``op_cost.OpCost``."""
    cost = analyze(cell.fn, cell.args, cell.device, in_place_backward)
    live = cost["peak_bytes"]
    coll = dict(cost["collectives"])
    by_axis: dict = {}
    for group, n in coll.pop("bytes_by_group").items():
        axis = _axis_of(cell, group)
        by_axis[axis] = by_axis.get(axis, 0) + n
    coll["bytes_by_axis"] = by_axis
    return {
        "n_devices": cell.n_devices,
        "mesh_shape": dict(cell.mesh_shape),
        "total_flops": cost["flops"],
        "hlo_bytes": cost["traffic_bytes"],
        "n_ops": cost["n_ops"],
        "scan_flops": cost["flops"],
        "scan_traffic_bytes": cost["traffic_bytes"],
        "collectives": coll,
        "loops": cost["loops"],
        "argument_size_in_bytes": cost["argument_bytes"],
        "output_size_in_bytes": cost["output_bytes"],
        "temp_size_in_bytes": cost["temp_bytes"],
        "alias_size_in_bytes": cost["alias_bytes"],
        "per_device_hbm_bytes": int(live),
        "per_device_hbm_gb": round(live / 2**30, 3),
        "fits_card": live <= CARD_BYTES,
    }


def _axis_of(cell, group) -> str:
    """The axis a collective's group spans: the cell's name for it, the
    mesh's axes joined with ``+`` for the default group of a mesh as large
    as the world (a whole mesh flattened is that group), else the group's
    own name."""
    if group in cell.axis_of_group:
        return cell.axis_of_group[group]
    if (len(cell.mesh_shape) > 1 and dist.is_initialized()
            and group == dist.group.WORLD.group_name
            and cell.n_devices == dist.get_world_size()):
        return "+".join(cell.mesh_shape)
    return str(group)


def link_bw(mesh_shape: dict, axis: str) -> float:
    """Bytes/s of the slowest link a collective over ``axis`` (one mesh
    axis, or several joined with ``+``) crosses: NVLink within a node,
    NDR across nodes."""
    names, sizes = list(mesh_shape), list(mesh_shape.values())
    spanned = axis.split("+") if axis is not None else []
    if not spanned or any(a not in mesh_shape for a in spanned):
        return ICI_BW
    reach = 1  # the farthest any of the axes reaches, in ranks
    for a in spanned:
        i = names.index(a)
        stride = 1
        for n in sizes[i + 1:]:
            stride *= n
        reach = max(reach, stride * sizes[i])
    return ICI_BW if reach <= CARDS_PER_NODE else NDR_BW


def roofline_terms(rec: dict, model_flops: float | None = None) -> dict:
    """The three-term roofline (seconds) from a dry-run record.

    All numerators are one device's (``op_cost`` counts the step that
    device runs); ``scan_flops``/``scan_traffic_bytes`` are read first,
    as in the reference, and equal ``total_flops``/``hlo_bytes`` here.
    Each axis's collective bytes go over its slowest link
    (:func:`link_bw`)."""
    n = rec["n_devices"]
    flops = rec.get("scan_flops") or rec.get("total_flops", 0.0)
    bytes_hbm = rec.get("scan_traffic_bytes") or rec.get("hlo_bytes", 0.0)
    coll = rec.get("collectives", {})
    by_axis = coll.get("bytes_by_axis")
    if by_axis is None:
        by_axis = {None: coll.get("total_bytes", 0)}
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_hbm / HBM_BW
    t_coll = sum(b / link_bw(rec.get("mesh_shape", {}), a)
                 for a, b in by_axis.items())
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
