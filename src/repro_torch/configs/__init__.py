"""Architecture registry of the port: one module per architecture with
its published config, a reduced smoke config and its input-shape set —
the reference's ``repro/configs`` for the four GNN architectures.

``get_arch`` resolves the GNN ids; the LM, recsys and engine ids of the
reference wait for ROADMAP Queue 1 item 14(b) and raise.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

GNN_ARCH_IDS = ["mace", "egnn", "gatedgcn", "graphcast"]
# the reference's other ids, not ported yet
PENDING_ARCH_IDS = ["grok-1-314b", "granite-moe-3b-a800m", "gemma2-2b",
                    "minicpm-2b", "mistral-nemo-12b", "bst", "cpqx-engine"]


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
    if arch_id in PENDING_ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: it waits for ROADMAP Queue 1 "
            "item 14(b)")
    if arch_id not in GNN_ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.SPEC


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
