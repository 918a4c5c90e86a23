"""The paper's own engine as a distributed workload: a CPQx level join
and a conjunction-heavy query step over a sharded pair table.  Shapes
model the paper's largest interest-aware settings (the reference's
``repro/configs/cpqx_engine.py``)."""

import dataclasses

from repro_torch.configs import ArchSpec, ShapeSpec


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    name: str = "cpqx-engine"
    k: int = 2
    n_labels: int = 8


CONFIG = EngineConfig()
SMOKE = EngineConfig(n_labels=3)

SPEC = ArchSpec(
    arch_id="cpqx-engine", family="engine", config=CONFIG, smoke=SMOKE,
    shapes=(
        ShapeSpec("build_64m", "engine",
                  {"n_pairs": 64 * 2**20, "n_edges": 16 * 2**20,
                   "n_classes": 2**20, "n_seqs": 2**14}),
        ShapeSpec("query_s", "engine",
                  {"n_pairs": 64 * 2**20, "n_classes": 2**20,
                   "lookup_classes": 2**16, "join_cap": 2**22}),
    ),
    notes="pair tables sharded over the mesh's shards; distributed join by "
          "hash repartitioning (core/distributed.py).",
)
