"""Architecture registry of the port: one module per architecture with
its published config, a reduced smoke config and its input-shape set —
the reference's ``repro/configs``.

``get_arch`` resolves every id of the reference: the five LM ids, the
four GNN ids, ``bst`` and ``cpqx-engine`` (the engine's cells).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

ARCH_IDS = [
    # LM family (5)
    "grok-1-314b",
    "granite-moe-3b-a800m",
    "gemma2-2b",
    "minicpm-2b",
    "mistral-nemo-12b",
    # GNN family (4)
    "mace",
    "egnn",
    "gatedgcn",
    "graphcast",
    # recsys (1)
    "bst",
    # the paper's own engine as a distributed workload (bonus cell)
    "cpqx-engine",
]
GNN_ARCH_IDS = ["mace", "egnn", "gatedgcn", "graphcast"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell for an architecture."""

    name: str
    kind: str  # train | prefill | decode | serve | retrieval | full_graph | sampled | batched_graphs | engine
    dims: dict
    skip: str | None = None  # non-None => documented skip (reason)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | engine
    config: Any
    smoke: Any  # reduced config for CPU smoke tests
    shapes: tuple  # tuple[ShapeSpec]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name}")


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.SPEC


def all_archs() -> list:
    return [get_arch(a) for a in ARCH_IDS]


# ---------------------------------------------------------------------- #
# the shared LM shape set (seq_len x global_batch per assignment)
# ---------------------------------------------------------------------- #


def lm_shapes(long_ok: bool, arch: str) -> tuple:
    skip = (
        None
        if long_ok
        else (
            f"{arch} is pure full attention; a 524k-token KV cache has no "
            "sub-quadratic path — skipped per assignment (see DESIGN.md)"
        )
    )
    return (
        ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
        ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
        ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1},
                  skip=skip),
    )


def gnn_shapes() -> tuple:
    return (
        ShapeSpec("full_graph_sm", "full_graph",
                  {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
        ShapeSpec("minibatch_lg", "sampled",
                  {"n_nodes": 232_965, "n_edges": 114_615_892,
                   "batch_nodes": 1024, "fanout": (15, 10), "d_feat": 602,
                   # padded subgraph sizes the sampler guarantees
                   "pad_nodes": 1024 + 1024 * 15 + 1024 * 150,
                   "pad_edges": 1024 * 15 + 1024 * 15 * 10}),
        ShapeSpec("ogb_products", "full_graph",
                  {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
        ShapeSpec("molecule", "batched_graphs",
                  {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 32}),
    )


def recsys_shapes() -> tuple:
    return (
        ShapeSpec("train_batch", "train", {"batch": 65_536}),
        ShapeSpec("serve_p99", "serve", {"batch": 512}),
        ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
        ShapeSpec("retrieval_cand", "retrieval",
                  {"batch": 1, "n_candidates": 1_000_000}),
    )
