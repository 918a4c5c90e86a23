"""Drives the PyTorch/CUDA port of the CPQx engine once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. device      — the card's name, and its name and power limit from nvidia-smi;
2. build       — nvcc builds the CUDA kernels of src/repro_torch/kernels/csrc;
3. parity      — each CUDA kernel against its plain PyTorch version on the
                 card: the three integer kernels bit for bit (the CPU tests'
                 shapes, SENTINEL, -1, INT_MIN and empty cases, several
                 lanes; sorted_member_mask on both sides of its shared-memory
                 budget, up to a haystack of 131 072 ids; the two query-path
                 kernels at every block size the autotuner sweeps, 128, 256,
                 512 and 1 024 threads), segment_softmax on
                 the packed (N, D, 2) table bit for bit in float32 and
                 bfloat16 (each of its three kernels, a misaligned base and
                 a ragged E at D = 1 included), the packed table held to two
                 separate reductions;
                 small CPQx and iaCPQx builds (gmark_citation(500)) held bit
                 for bit against the CPU;
4. index       — CPQx for gmark_citation(20_000, avg_degree=6, seed=3) at k=2
                 on the card;
5. queries     — the 12 templates with seeded labels through Engine.execute and
                 Engine.execute_batch (16 same-template queries a batch), every
                 answer checked against a scipy.sparse reference written here;
                 each plan runs as a CUDA graph captured once per key, and
                 every replay of the first pass is held bit for bit to the
                 eager walker (run_plan_ops called directly on the same
                 inputs), with one key replayed for other lookup ranges and
                 two batches of one key in flight at once; the same draws
                 through an eager engine give the same-run yardstick;
6. iacpqx      — iaCPQx of the same graph over six seeded 2-sequences, and the
                 same queries through it;
7. maintenance — the lazily maintained host mirror of CPQx: three rounds of
                 100 mixed updates, each applied, flushed to the card and
                 rebound (the old backend's graphs dropped), its answers
                 checked, beside a full rebuild; then one interest round on an
                 iaCPQx mirror;
8. serving     — a QueryService (union dispatch, admission control) over the
                 CPQx engine of phase 4, fed phase 5's draws by two tenants in
                 bursts past its queue bound; then a second service with the
                 write path and the adaptation loop over phase 7's iaCPQx
                 mirror, fed a drifting two-tenant stream and one batch of 100
                 updates; answers held to the scipy reference and every
                 replay to the eager walker; the write-path service is
                 checkpointed (it is kept for phase 12);
9. rpq         — the RPQ benchmark's seven Cypher texts, lowered by the port,
                 through Engine.execute_rpq (or execute) and the service,
                 held to a boolean scipy.sparse fixpoint written here;
10. baselines  — the paper's language-unaware Path index and iaPath of the
                 phase-4 graph (phase 4's build caps, phase 6's interests),
                 phase 5's draws through PathEngine.execute beside CPQx's
                 times, and the index-free BFS on one draw a template;
11. calibrate  — costmodel.calibrate (each operator timed as replays of its
                 CUDA graph) and the block-size autotuner at the ladder rungs
                 of the phase-4 engine, a calibrated Engine over phase 5's
                 draws (replays held to the eager walker), online refinement,
                 SLO shedding of the phase-8 read stream, the table's JSON
                 round trip;
12. lifecycle  — the phase-4 index saved and restored (every field equal),
                 the write-path service checkpointed with the calibrated
                 table and restored as a cold replica (epoch, mirror,
                 adapter and answers equal), one update batch applied to
                 donor and replica alike;
13. sharded    — the phase-4 index through shard_index at 1 and 4 shards
                 (gather_index gives it back), phase 5's draws through
                 Engine(index, mesh=<4 in-process shards>) equal to the local
                 engine and the reference, one batch, one overflow retry from
                 small caps, a sharded save restored at 2 shards equal to a
                 live reshard;
14. edge_softmax — the GNN substrate's edge softmax at the repository's graph
                 shapes, float32 and bfloat16;
15. cluster    — the phase-4 index served by Engine(index, cluster=2): two
                 worker processes on the card (each PROMOTE reply must name
                 it), phase 5's draws through execute equal to the local
                 engine and the reference, one batch, a QueryService read
                 pass (DISPATCH / HARVEST), one rebind (one FLUSH_REBIND),
                 a service checkpoint (the CHECKPOINT barrier and the respawn
                 base), a crash mid-round and a hard kill with every answer
                 checked after each, resize to 4 workers and back;
   then the kernels again, on the built index's own arrays and on the inputs
   the paths gave them, with their times.

Each path (phases 4-5, 6, 7, 8's two services, 9 to 15) is driven with the
launch counts set to 0 just before it and read just after; a path that never
launched one of its kernels fails.  A graph replay adds the launches its
capture recorded, so the counts are the kernels that ran.  The cluster's
kernels run in its worker processes, which report their launches at each
CHECKPOINT barrier; phase 15 sums those reports.  The last two lines are
the kernels' JSON record and {"ok": true, "device": {...}}.  Any failure
exits non-zero; without a CUDA card, or outside a checkout of the
repository, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_VERTICES = 20_000
MAINT_VERTICES = 20_000  # the maintenance phase's graph (the host mirror's size)
MAINT_ROUNDS = 3
MAINT_OPS = 100
N_INTERESTS = 6
K = 2
SEED = 3
BATCH = 16
SHARDS = 4  # in-process shards of the sharded phase
MAX_ANSWER = 4_194_304  # drop a draw whose reference answer is larger
MAX_REF_FLOPS = 64_000_000  # ... or whose reference product costs more
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT_OPS_PER_S = 67e12  # CUDA-core rate (float32 peak) used for int32 work
SERVE_BURST = 48  # requests a burst; the read service admits 32 at a time
DRIFT_PER_PHASE = 96  # requests per phase of the drifting write-path stream
# benchmarks/common.py ADAPTIVE_PHASES: the adaptive benchmark's two phases
# of hot (template, labels)
ADAPTIVE_PHASES = [
    [("T", (0, 0, 1)), ("S", (0, 0, 2, 3))],
    [("T", (6, 6, 7)), ("S", (6, 6, 9, 8))],
]
# benchmarks/bench_rpq.py WORKLOAD: Cypher over positional types
RPQ_TEXTS = [
    "MATCH (a)-[:l0*]->(b) RETURN a, b",
    "MATCH (a)-[:l0*0..]->(b) RETURN a, b",
    "MATCH (a)-[:l0|l1*]->(b) RETURN a, b",
    "MATCH (a)<-[:l0*1..3]-(b) RETURN a, b",
    "MATCH (a)-[:l0]->(b)-[:l1*0..]->(c) RETURN a, c",
    "MATCH (a)-[:l0*2..3]->(b)-[:l1]->(c) RETURN a, c",
    "MATCH (a)-[:l0]->(b)-[:l1]->(c) RETURN a, c",
]
PIN_TRIES = 5  # sources tried when a star must be pinned
PATH_ROUNDS = 4  # PathEngine passes over phase 5's draws (the first warms up)
SLO_DISPATCHES = 12  # the SLO budget, in requests of median predicted cost
# src/repro/configs/__init__.py gnn_shapes at the repository's GatedGCN width
# (configs/gatedgcn.py d_hidden=70): (name, E, D, N)
SOFTMAX_CASES = [
    ("full_graph_sm", 10_556, 1, 2_708),
    ("minibatch_lg", 168_960, 70, 169_984),
    ("ogb_products", 61_859_140, 1, 2_449_029),
    ("bench_kernels", 16_384, 8, 1_024),
]
SOFTMAX_TOL = {"float32": 1e-6, "bfloat16": 2e-2}  # rtol = atol, phase 10 only
TEMPLATES = ["C2", "C4", "C2i", "T", "Ti", "S", "Si", "TT", "St",
             "TC", "SC", "ST"]
KERNELS = {
    "sorted_member_mask": ("src/repro_torch/kernels/csrc/sorted_intersect.cu",
                           "src/repro/kernels/sorted_intersect.py:57"),
    "expand_join_gather": ("src/repro_torch/kernels/csrc/expand_join.cu",
                           "src/repro/kernels/expand_join.py:69"),
    "fingerprint_rows": ("src/repro_torch/kernels/csrc/fingerprint.cu",
                         "src/repro/kernels/fingerprint.py:53"),
    "segment_softmax": ("src/repro_torch/kernels/csrc/segment_softmax.cu",
                        "src/repro/kernels/segment_softmax.py:40"),
}
INDEX_KERNELS = ("sorted_member_mask", "expand_join_gather", "fingerprint_rows")


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def say(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------- #
# timing
# ---------------------------------------------------------------------- #


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one ``fn`` call between CUDA events over ``iters``
    back-to-back calls: the host's launch overhead included wherever the
    host is slower than the device."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    """Device time (us) of a profiler event that ran on the card."""
    from torch.autograd import DeviceType

    if evt.device_type != DeviceType.CUDA:
        return 0.0
    return float(getattr(evt, "self_device_time_total", 0)
                 or getattr(evt, "self_cuda_time_total", 0))


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn`` call — every kernel, copy and fill it
    launched — from the profiler's trace of ``iters`` calls.  Host gaps
    between launches are not counted.  Falls back to :func:`cuda_ms` (and
    says so) where the profiler sees no device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in prof.key_averages())
    if total <= 0:  # no device trace: fall back to event timing
        say("[kernels] the profiler recorded no device time; CUDA events used")
        return cuda_ms(fn, iters, warmup)
    return total / iters / 1e3


def busy_share(fn, match: str = ""):
    """(wall ms, device-busy ms, top-5 kernels by device time, device ms of
    the kernels whose name contains ``match``) of one ``fn`` call, from a
    profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    evts = sorted(prof.key_averages(), key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in evts) / 1e3
    top = [(e.key[:40], round(_device_us(e) / 1e3, 4), e.count)
           for e in evts[:5] if _device_us(e) > 0]
    matched = sum(_device_us(e) for e in evts if match and match in e.key) / 1e3
    return wall, busy, top, matched


# ---------------------------------------------------------------------- #
# the plain reference of the answers: boolean scipy.sparse algebra
# ---------------------------------------------------------------------- #


class SparseReference:
    """One boolean CSR matrix per label of the closed alphabet; a join is a
    matrix product, a conjunction an elementwise product, id the diagonal."""

    def __init__(self, g):
        import scipy.sparse as sp

        self.sp = sp
        n = g.n_vertices
        self.n = n
        self.mats = {}
        for lbl in range(g.alphabet_size):
            m = g.lbl == lbl
            data = np.ones(int(m.sum()), dtype=bool)
            self.mats[lbl] = sp.csr_matrix((data, (g.src[m], g.dst[m])),
                                           shape=(n, n), dtype=bool)

    def eval(self, q, max_flops=MAX_REF_FLOPS):
        """The answer as a CSR matrix, or None when a product would cost
        more than ``max_flops`` multiply-adds (None: no limit)."""
        from repro_torch.core.query import Conj, Edge, Identity, Join

        if isinstance(q, Edge):
            return self.mats[q.label]
        if isinstance(q, Identity):
            return self.sp.identity(self.n, dtype=bool, format="csr")
        a = self.eval(q.lhs, max_flops)
        if a is None:
            return None
        b = self.eval(q.rhs, max_flops)
        if b is None:
            return None
        if isinstance(q, Conj):
            return a.multiply(b).tocsr()
        assert isinstance(q, Join)
        flops = int((np.diff(a.tocsc().indptr).astype(np.int64)
                     * np.diff(b.indptr).astype(np.int64)).sum())
        if max_flops is not None and flops > max_flops:
            return None
        return (a @ b).astype(bool).tocsr()

    @staticmethod
    def rows(m) -> np.ndarray:
        """Sorted distinct (v, u) pairs of a boolean matrix."""
        m = m.tocsr()
        m.eliminate_zeros()
        m.sort_indices()
        v = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
        return np.stack([v, m.indices], axis=1).astype(np.int32)


# ---------------------------------------------------------------------- #
# workloads: template draws, interest sets, update batches
# ---------------------------------------------------------------------- #


def draw_queries(g, refm, per_template: int, seed: int):
    """``per_template`` seeded draws of each template whose reference
    answer is at most MAX_ANSWER pairs and costs at most MAX_REF_FLOPS.
    Returns ({template: [(query, expected rows)]}, dropped draws)."""
    from repro_torch.data.graphs import random_queries_for_graph

    drops = []
    out = {}
    for name in TEMPLATES:
        accepted = []
        tries = 0
        while len(accepted) < per_template and tries < 8 * per_template:
            tries += 1
            seed += 1
            (_, q), = random_queries_for_graph(g, [name], 1, seed=seed)
            m = refm.eval(q)
            if m is None or m.nnz > MAX_ANSWER:
                drops.append((name, repr(q), "flops" if m is None else m.nnz))
                continue
            accepted.append((q, refm.rows(m)))
        if not accepted:
            fail(f"template {name}: no draw with a reference answer "
                 f"<= {MAX_ANSWER} pairs in {tries} draws")
        out[name] = accepted
    return out, drops


def interests_for(g, n: int = N_INTERESTS, seed: int = 0) -> list:
    """The interest set of the paper's iaCPQx runs: ``n`` 2-sequences drawn
    from the labels present in ``g`` (the rule of the repository's query
    benchmark)."""
    rng = np.random.default_rng(seed)
    present = np.unique(g.lbl)
    return [tuple(int(x) for x in rng.choice(present, 2)) for _ in range(n)]


def update_batch(g, rng, n_ops: int) -> list:
    """A mixed batch of base-edge updates (the rule of the repository's
    update benchmark): 50 % inserts, 30 % deletes of existing edges, 20 %
    relabels."""
    base = g._base_edges()
    ops = []
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.5 or base.shape[0] == 0:
            ops.append(("insert_edge", int(rng.integers(0, g.n_vertices)),
                        int(rng.integers(0, g.n_vertices)),
                        int(rng.integers(0, g.n_labels))))
        elif roll < 0.8:
            e = base[int(rng.integers(0, base.shape[0]))]
            ops.append(("delete_edge", int(e[0]), int(e[1]), int(e[2])))
        else:
            e = base[int(rng.integers(0, base.shape[0]))]
            ops.append(("change_label", int(e[0]), int(e[1]), int(e[2]),
                        (int(e[2]) + 1) % g.n_labels))
    return ops


def tenant_report(what, stats, accepted, wall: float) -> None:
    """Per tenant: latency p50/p99 of its accepted requests, q/s over the
    replay's wall time, drain rounds that completed its requests, cache
    hits and sheds."""
    for t, ts in sorted(stats.tenants.items()):
        mine = [r for r in accepted if r.tenant == t]
        lat = [1e3 * r.latency for r in mine] or [0.0]
        rounds = len({r.t_done for r in mine if not r.from_cache})
        say(f"[{what}] tenant {t}: submitted {ts.submitted}, served "
            f"{ts.served}, shed {ts.shed} {ts.shed_reasons}, cache hits "
            f"{ts.cache_hits}, rounds {rounds}; latency p50 "
            f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} "
            f"ms; {ts.served / wall:.1f} q/s")


def dir_bytes(path) -> int:
    """Bytes of every file under ``path``."""
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def check_answers(engine, g, queries, what: str) -> None:
    """One ``execute`` per query, held to a scipy reference built on ``g``
    now (no cost limit: the draws were cheap on the graph they came from)."""
    refm = SparseReference(g)
    for q in queries:
        exp = refm.rows(refm.eval(q, max_flops=None))
        got = engine.execute(q)
        if not np.array_equal(got, exp):
            fail(f"{what}: {q!r} answer ({len(got)} pairs) differs from the "
                 f"reference ({len(exp)} pairs)")


# ---------------------------------------------------------------------- #
# captured executables against the eager walker
# ---------------------------------------------------------------------- #


def eager_launches(fn):
    """``fn()`` with the kernel launches it makes taken back out of the
    counts: a comparison, not the path."""
    from repro_torch.kernels import ops as kops

    before = kops.launch_counts()
    out = fn()
    after = kops.launch_counts()
    kops.add_launches({k: before[k] - after[k] for k in after})
    return out


def hold_to_eager(engine, tally: dict) -> None:
    """While ``tally["on"]``, every dispatch of ``engine``'s backend (and of
    each backend a rebind puts in its place) also runs the eager walker —
    ``run_plan_ops`` or ``run_union_batch`` called directly on the same
    inputs — and its harvest must equal the eager result lane for lane,
    flags and rows, bit for bit.  ``tally`` counts the dispatches and lanes
    held."""
    import torch
    from repro_torch.core import backend as B

    def wrap(backend):
        run_async = backend.run_batch_async
        union_async = backend.run_union_batch_async
        harvest = backend.harvest_batch

        def up(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=backend.device)

        def plan_held(shape, caps, ranges):
            handle = run_async(shape, caps, ranges)
            if not tally["on"]:
                return handle
            ref = eager_launches(lambda: B.run_plan_ops(backend.ops, shape, caps,
                                                        up(ranges)))
            return ("held", handle, ref)

        def union_held(opcodes, caps, stack_size, step_ranges):
            handle = union_async(opcodes, caps, stack_size, step_ranges)
            if not tally["on"]:
                return handle
            ref = eager_launches(lambda: B.run_union_batch(
                backend.ops, caps, stack_size, up(opcodes), up(step_ranges)))
            return ("held", handle, ref)

        def harvest_held(handle):
            if handle[0] != "held":
                return harvest(handle)
            _, inner, (rel, overflow) = handle
            rows, flags = harvest(inner)
            exp_rows, exp_flags = B.CapturedBackend.harvest_batch(
                backend, ("lanes", rel, overflow))
            if not np.array_equal(flags, exp_flags):
                fail("a replayed executable's overflow flags differ from the "
                     "eager walker's")
            for lane, (a, b) in enumerate(zip(rows, exp_rows)):
                if (a is None) != (b is None) or (
                        a is not None and not np.array_equal(a, b)):
                    fail(f"a replayed executable's lane {lane} differs from "
                         "the eager walker's")
            tally["dispatches"] += 1
            tally["lanes"] += len(rows)
            return rows, flags

        backend.run_batch_async = plan_held
        backend.run_union_batch_async = union_held
        backend.harvest_batch = harvest_held

    wrap(engine.backend)
    rebind = engine.rebind

    def rebind_held(index, stats=None):
        rebind(index, stats)
        wrap(engine.backend)

    engine.rebind = rebind_held


def cache_line(what: str, engine) -> str:
    """The engine's executable cache: graphs, bytes, captures and replays."""
    st = engine.backend.executables.stats()
    return (f"[graphs] {what}: {st['graphs']} graphs cached, "
            f"{st['bytes'] / 2**20:.1f} MiB of a {st['max_bytes'] / 2**30:.1f} "
            f"GiB bound; {st['captures']} captures in {st['capture_s']:.2f} s "
            f"(warm-ups included, "
            f"{1e3 * st['capture_s'] / max(1, st['captures']):.1f} ms each), "
            f"{st['replays']} replays, {st['evictions']} evictions")


def eager_engine(index):
    """An Engine whose backend runs the walker eagerly on the card (the
    port's backend on the card only replays graphs): the same-run
    yardstick of the replayed times."""
    import torch
    from repro_torch.core.backend import LocalBackend
    from repro_torch.core.engine import Engine

    class EagerBackend(LocalBackend):
        def _launch(self, key, fn, host_inputs):
            return fn(*(torch.from_numpy(np.ascontiguousarray(h, np.int32))
                        .pin_memory().to(self.device, non_blocking=True)
                        for h in host_inputs))

    engine = Engine(index)
    engine.backend = EagerBackend(index.arrays, index.n_vertices)
    return engine


# ---------------------------------------------------------------------- #
# kernel parity cases
# ---------------------------------------------------------------------- #


def member_cases(rng, dev):
    """(hay, count, queries) on the card: the CPU tests' shapes, SENTINEL
    queries, empty haystacks, several lanes."""
    import torch

    S = 2**31 - 1
    out = []
    for lanes in (1, 3):
        for n_hay in (1, 7, 128, 1000):
            for n_q in (1, 64, 1024, 1500):
                hay = np.sort(np.stack([rng.choice(5 * n_hay, n_hay, replace=False)
                                        for _ in range(lanes)]), axis=1)
                cnt = rng.integers(0, n_hay + 1, lanes)
                q = rng.integers(0, 5 * n_hay, (lanes, n_q))
                q[rng.random((lanes, n_q)) < 0.05] = S
                out.append((hay, cnt, q))
    out.append((np.array([[1, 5, 9, S]]), np.array([3]), np.array([[5, S, 9, S]])))
    out.append((np.full((2, 8), S), np.array([0, 0]), rng.integers(0, 9, (2, 8))))
    return [tuple(torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)
                  for x in c) for c in out]


def budget_cases(rng, dev):
    """(hay, count, queries) on the card on both sides of
    sorted_intersect.SHARED_BUDGET, each with the path launch_plan must
    give it: rows that start off 16 bytes (1 001 ids), 4 096 ids, the
    largest haystack that is staged (6 144 ids, 24 KB), the smallest that
    is searched in device memory, 12 288 ids (the most the kernel could
    stage) and 131 072 ids; full and partial counts, 5 % SENTINEL
    queries, a query block per 256 queries."""
    import torch

    S = 2**31 - 1
    out = []
    for lanes, n_hay, n_q, path in ((3, 1_001, 777, "shared"),
                                    (16, 4_096, 4_096, "shared"),
                                    (16, 6_144, 4_096, "shared"),
                                    (16, 6_145, 4_096, "global"),
                                    (16, 12_288, 4_096, "global"),
                                    (2, 131_072, 8_192, "global")):
        hay = np.sort(np.stack([rng.choice(4 * n_hay, n_hay, replace=False)
                                for _ in range(lanes)]), axis=1)
        cnt = np.full(lanes, n_hay)
        cnt[1:] = rng.integers(0, n_hay + 1, lanes - 1)
        q = rng.integers(0, 4 * n_hay, (lanes, n_q))
        q[rng.random((lanes, n_q)) < 0.05] = S
        out.append((path, tuple(torch.as_tensor(x, dtype=torch.int32, device=dev)
                                for x in (hay, cnt, q))))
    return out


def join_cases(rng, dev):
    """(ends, lo, a_payload, b_v, b_u, total, out_capacity) on the card:
    random CSR joins against a shared sorted build side, empty totals,
    several lanes."""
    import torch

    out = []
    for lanes in (1, 3, 16):
        for _ in range(8):
            n_b = int(rng.integers(1, 400))
            b = rng.integers(0, 60, (n_b, 2))
            b = b[np.lexsort((b[:, 1], b[:, 0]))]
            n_a = int(rng.integers(1, 300))
            a = rng.integers(0, 60, (lanes, n_a, 2))
            lo = np.searchsorted(b[:, 0], a[..., 1], "left")
            hi = np.searchsorted(b[:, 0], a[..., 1], "right")
            ends = np.cumsum(hi - lo, axis=1)
            total = ends[:, -1].copy()
            if lanes > 1:
                total[0] = 0  # an empty lane
            cap = max(8, 1 << max(0, int(total.max()) - 1).bit_length())
            out.append((ends, lo, a[..., 0], b[:, 0], b[:, 1], total, cap))
    return [tuple(torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32,
                                  device=dev) for x in c[:6]) + (c[6],)
            for c in out]


def fingerprint_cases(rng, dev):
    """(cols, salt) on the card: n in {1, 7, 2048, 4101, 2^22}, 1-5 columns,
    three salts; -1 (sequence padding), SENTINEL and INT_MIN mixed in."""
    import torch

    out = []
    for n in (1, 7, 2048, 4101, 1 << 22):
        for k in (1, 2, 3, 5):
            for salt in (0, 1, 77):
                cols = []
                for _ in range(k):
                    c = rng.integers(-5, 1 << 20, n).astype(np.int32)
                    roll = rng.random(n)
                    c[roll < 0.05] = -1
                    c[(roll >= 0.05) & (roll < 0.08)] = 2**31 - 1
                    c[(roll >= 0.08) & (roll < 0.1)] = -(2**31)
                    cols.append(torch.as_tensor(c, device=dev))
                out.append((tuple(cols), salt))
    return out


def index_member_cases(index, dev, rng, lanes: int = 16):
    """Haystacks and queries taken from the built index: real l2c class
    lists of the largest sequences, padded with SENTINEL."""
    import torch

    S = 2**31 - 1
    l2c = index.arrays.l2c_cls.cpu().numpy()
    spans = sorted(index.seq_ranges.values(), key=lambda r: r[0] - r[1])
    cap = 1 << max(1, max(e - s for s, e in spans[: 4 * lanes]) - 1).bit_length()
    hay = np.full((lanes, cap), S, np.int64)
    q = np.full((lanes, cap), S, np.int64)
    cnt = np.zeros(lanes, np.int64)
    pick = rng.permutation(min(len(spans), 4 * lanes))[: 2 * lanes]
    for b in range(lanes):
        s, e = spans[pick[2 * b]]
        hay[b, : e - s] = l2c[s:e]
        cnt[b] = e - s
        s, e = spans[pick[2 * b + 1]]
        q[b, : e - s] = l2c[s:e]
    return [tuple(torch.as_tensor(x, dtype=torch.int32, device=dev)
                  for x in (hay, cnt, q))]


def index_join_cases(index, dev, lanes: int = 16):
    """Materialization of real class lists through the index's own
    class_starts / c2p_v / c2p_u."""
    import torch

    a = index.arrays
    starts = a.class_starts.cpu().numpy().astype(np.int64)
    l2c = a.l2c_cls.cpu().numpy()
    spans = sorted(index.seq_ranges.values(), key=lambda r: r[0] - r[1])[:lanes]
    n_a = max(e - s for s, e in spans)
    cls = np.full((lanes, n_a), 2**31 - 1, np.int64)
    for b, (s, e) in enumerate(spans):
        cls[b, : e - s] = l2c[s:e]
    cid = np.clip(cls, 0, starts.shape[0] - 2)
    lo = starts[cid]
    cnt = np.where(cls < 2**31 - 1, starts[cid + 1] - lo, 0)
    ends = np.cumsum(cnt, axis=1)
    total = ends[:, -1]
    cap = 1 << max(1, int(total.max()) - 1).bit_length()
    t = [torch.as_tensor(x, dtype=torch.int32, device=dev)
         for x in (ends, lo, cls)]
    return [(t[0], t[1], t[2], a.c2p_v, a.c2p_u,
             torch.as_tensor(total, dtype=torch.int32, device=dev), cap)]


def check_parity(name, kernel, plain, cases) -> int:
    """Kernel vs plain version on every case, bit for bit; returns the
    largest absolute difference (0)."""
    import torch

    worst = 0
    for args in cases:
        got = kernel(*args)
        exp = plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        exp = exp if isinstance(exp, tuple) else (exp,)
        for g, e in zip(got, exp):
            if g.shape != e.shape or g.dtype != e.dtype:
                fail(f"{name}: shape/type {tuple(g.shape)} {g.dtype} vs "
                     f"{tuple(e.shape)} {e.dtype}")
            if g.numel():
                diff = int((g.long() - e.long()).abs().max())
                worst = max(worst, diff)
    if worst != 0:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {worst})")
    return worst


# ---------------------------------------------------------------------- #
# the plain reference of RPQ answers: a boolean scipy.sparse fixpoint
# ---------------------------------------------------------------------- #


class TooCostly(Exception):
    """A reference evaluation passed MAX_REF_FLOPS or MAX_ANSWER."""


def rpq_reference(refm, q, srcs=None):
    """The answer of the (normalized) RPQ ``q`` as a boolean CSR matrix
    whose rows are the sources (every vertex, or ``srcs`` in order): a
    symbol is a product with its label's matrix, an alternation a sum, a
    star iterates from the frontier until no pair is new.  Raises
    TooCostly once the products' multiply-adds pass MAX_REF_FLOPS or an
    intermediate passes MAX_ANSWER pairs."""
    from repro_torch.core.rpq import RAlt, RConcat, ROpt, RPlus, RStar, RSym

    sp = refm.sp
    if srcs is None:
        front = sp.identity(refm.n, dtype=bool, format="csr")
    else:
        front = sp.csr_matrix((np.ones(len(srcs), bool),
                               (np.arange(len(srcs)), np.asarray(srcs))),
                              shape=(len(srcs), refm.n), dtype=bool)
    budget = [MAX_REF_FLOPS]

    def bounded(m):
        if m.nnz > MAX_ANSWER:
            raise TooCostly(f"{m.nnz} pairs")
        return m

    def ev(node, f):
        if isinstance(node, RSym):
            m = refm.mats[node.label]
            budget[0] -= int(np.diff(m.indptr)[f.indices].sum())
            if budget[0] < 0:
                raise TooCostly("flops")
            return bounded((f @ m).astype(bool).tocsr())
        if isinstance(node, RConcat):
            return ev(node.rhs, ev(node.lhs, f))
        if isinstance(node, RAlt):
            return bounded((ev(node.lhs, f) + ev(node.rhs, f)).tocsr())
        if isinstance(node, ROpt):
            return bounded((f + ev(node.inner, f)).tocsr())
        if isinstance(node, RPlus):
            return ev(RStar(node.inner), ev(node.inner, f))
        if isinstance(node, RStar):
            reached, delta = f, f
            while delta.nnz:
                delta = (ev(node.inner, delta) > reached).tocsr()
                reached = bounded((reached + delta).tocsr())
            return reached
        raise TypeError(node)

    return ev(q, front)


def rpq_pairs(m, srcs=None) -> np.ndarray:
    """Sorted (v, u) pairs of a reference answer matrix."""
    rows = SparseReference.rows(m)
    if srcs is not None:
        rows[:, 0] = np.asarray(srcs)[rows[:, 0]]
        rows = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    return rows


def pin_candidates(g, parsed, n_labels: int) -> list:
    """Sources for a pinned star: the vertices with the most edges of the
    chain's first hop (its types, inverted for ``<-``), most first."""
    from repro_torch.core.cypher import _resolve_type
    from repro_torch.core.graph import inverse_label

    rel = parsed.rels[0]
    labels = [_resolve_type(t, None, n_labels) for t in rel.types]
    if rel.back:
        labels = [int(inverse_label(l, n_labels)) for l in labels]
    deg = np.bincount(g.src[np.isin(g.lbl, labels)], minlength=g.n_vertices)
    return [int(v) for v in np.argsort(-deg, kind="stable")[:PIN_TRIES]]


# ---------------------------------------------------------------------- #
# segment_softmax parity and shapes
# ---------------------------------------------------------------------- #


def softmax_cases(rng, dev):
    """(scores, ids, N) on the card, float32 and bfloat16: the CPU tests'
    shapes, empty segments, negative and >= N ids, unsorted ids, one edge,
    ragged E.  The kernel picks one of three by E * D against one wave of
    resident threads (132 SMs x 2048 = 270 336 on the H100), and by D:
    below the wave the one-element kernel (every case of up to 8 192
    elements, 4 099 x 1 misaligned included); above it at D = 1 the vector
    kernel, on its vector path with a ragged tail (1 000 003 ids, not a
    multiple of 4 or 8) and on its scalar path when scores and ids start
    off 16 bytes (a slice from row 1); above it at D > 1 the row-tile
    kernel: D = 2 (512-row tiles, the shared array full, a stride of whole
    rows), D = 8 (whole-row stride), D = 70, D = 300 (a stride within one
    row) and D = 1 100 (one row a tile), each with a ragged last tile."""
    import torch

    out = []
    shapes = [(512, 1, 16, True), (1024, 8, 64, True), (2048, 4, 100, True),
              (512, 4, 64, "empty"), (1024, 2, 32, "out_of_range"),
              (1024, 3, 50, False), (1000, 5, 30, False), (1, 1, 1, True),
              (70_001, 70, 4_096, False), (7, 1, 3, False),
              (1_000_003, 1, 5_000, False), (1_000_003, 1, 5_000, "misaligned"),
              (4_099, 1, 64, "misaligned"), (200_003, 2, 50_000, False),
              (40_001, 8, 4_096, False), (1_001, 300, 64, False),
              (300, 1_100, 16, False)]
    for e, d, n, kind in shapes:
        skip = 1 if kind == "misaligned" else 0
        x = rng.normal(0, 3, (e + skip, d)).astype(np.float32)
        if kind == "empty":  # only every third segment is used
            seg = np.sort(rng.integers(0, n // 3, e)) * 3
        elif kind == "out_of_range":
            seg = rng.integers(-5, n + 8, e)
        else:
            seg = rng.integers(0, n, e + skip)
            if kind is True:
                seg = np.sort(seg)
        for dtype in (torch.float32, torch.bfloat16):
            out.append((torch.as_tensor(x, device=dev).to(dtype)[skip:],
                        torch.as_tensor(seg.astype(np.int32), device=dev)[skip:],
                        n))
    return out


def separate_tables(x, seg, n):
    """The segment max and sum as two separate contiguous (N, D) float32
    reductions: what ref.segment_tables packs into one table."""
    import torch

    d = x.shape[1]
    idx = seg.long()
    spare = torch.where((idx >= 0) & (idx < n), idx, n)
    mx = torch.full((n + 1, d), float("-inf"), device=x.device)
    mx.scatter_reduce_(0, spare[:, None].expand(-1, d), x.float(), "amax",
                       include_self=False)
    mx = torch.where(torch.isfinite(mx[:n]), mx[:n], 0.0)
    den = torch.zeros((n + 1, d), device=x.device)
    den.index_add_(0, spare, torch.exp(x.float() - mx[idx.clamp(0, n - 1)]))
    return mx, den[:n]


def check_softmax_parity(kernel, plain, tables, cases) -> dict:
    """The kernel against its plain version on the same packed (N, D, 2)
    table, bit for bit in both dtypes; returns {dtype: max abs err}.  The
    table's sums come from index_add_'s atomics, whose order changes from
    run to run, so both sides read one table and the run-to-run difference
    of the sums does not enter the comparison.  The packed table itself is
    held to two separate reductions: the max exactly, the sum within
    1e-6."""
    import torch

    worst = {}
    for x, seg, n in cases:
        table = tables(x, seg, n)
        mx, den = separate_tables(x, seg, n)
        if table.shape != (n, x.shape[1], 2) or not table.is_contiguous() \
                or not torch.equal(table[..., 0], mx) \
                or not torch.allclose(table[..., 1], den, rtol=1e-6, atol=1e-6):
            fail(f"segment_tables E={x.shape[0]} D={x.shape[1]} N={n}: the "
                 "packed table differs from the two separate reductions")
        got = kernel(x, seg, table)
        exp = plain(x, seg, table)
        torch.cuda.synchronize()
        name = str(x.dtype).replace("torch.", "")
        if got.shape != exp.shape or got.dtype != exp.dtype:
            fail(f"segment_softmax: shape/type {tuple(got.shape)} {got.dtype} "
                 f"vs {tuple(exp.shape)} {exp.dtype}")
        g32, e32 = got.float(), exp.float()
        err = float((g32 - e32).abs().max()) if x.numel() else 0.0
        if not torch.equal(got, exp):
            fail(f"segment_softmax {name} E={x.shape[0]} D={x.shape[1]} N={n}: "
                 f"kernel differs from its plain version on the same table "
                 f"(max abs err {err})")
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


# ---------------------------------------------------------------------- #
# phase 15: the cluster runtime (worker processes on the card)
# ---------------------------------------------------------------------- #


def cluster_phase(index, rebuild, per_template, engine, kind, ckpt_dir,
                  who) -> dict:
    """``Engine(index, cluster=2)`` on the index's device: phase 5's draws
    through execute (held to the reference and the local ``engine``), one
    batch, a QueryService read pass (DISPATCH/HARVEST), one rebind to
    ``rebuild()``, a service checkpoint, a crash mid-round and a hard kill
    (respawn from the checkpoint), resize to 4 and back.  Every worker
    must report the device named ``kind``.  Returns the kernel launches
    the workers reported at their CHECKPOINT barriers."""
    from repro_torch.core import cluster as ccl
    from repro_torch.core.engine import Engine
    from repro_torch.core.service import QueryService

    draws = [(name, q, exp) for name in TEMPLATES
             for q, exp in per_template[name]]
    worker_counts = {name: 0 for name in KERNELS}
    peaks = {}

    def barrier(runtime):
        reports = runtime.checkpoint_barrier(0)
        for rank, rep in reports.items():
            if rep["device"] != kind:
                fail(f"cluster: worker {rank} reports device "
                     f"{rep['device']!r}, not {kind!r}")
            for name, n in rep["launches"].items():
                worker_counts[name] += n
            peaks[rank] = max(peaks.get(rank, 0), rep["max_memory_allocated"])
        return reports

    def check_promoted(runtime, what):
        for rank, rep in sorted(runtime.promoted.items()):
            if rep["device"] != kind:
                fail(f"cluster {what}: worker {rank}'s PROMOTE reply names "
                     f"{rep['device']!r}, not {kind!r}")

    def check_all(cl_engine, what):
        """Every draw through the cluster, equal to the reference and the
        local engine; returns per-template medians (ms) of the cluster's
        execute and of the local engine's, timed in turns."""
        lat, loc = {}, {}
        for name, q, exp in draws:
            t0 = time.perf_counter()
            got = cl_engine.execute(q)
            lat.setdefault(name, []).append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            local = engine.execute(q)
            loc.setdefault(name, []).append(time.perf_counter() - t0)
            if not np.array_equal(got, exp) or not np.array_equal(got, local):
                fail(f"cluster {what} {name} {q!r}: answer ({len(got)} "
                     f"pairs) differs from the reference or the local engine")
        return ({n: 1e3 * float(np.median(v)) for n, v in lat.items()},
                {n: 1e3 * float(np.median(v)) for n, v in loc.items()})

    def time_to_answer(cl_engine, t_fault):
        _name, q, exp = draws[0]
        got = cl_engine.execute(q)
        dt = time.perf_counter() - t_fault
        if not np.array_equal(got, exp):
            fail(f"cluster: first answer after a fault differs ({q!r})")
        return dt

    t_phase = time.perf_counter()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    runtime = ccl.ClusterRuntime(index, 2, max_workers=4, reply_timeout=300,
                                 spawn_timeout=300)
    try:
        cl_engine = Engine(index, cluster=runtime, device=index.device)
        t_start = time.perf_counter() - t0
        check_promoted(runtime, "start")
        say(f"[cluster] Engine(index, cluster=2) on {kind}: started in "
            f"{t_start:.2f} s (make_slices, spawn, PROMOTE); spawn to "
            f"PROMOTE a worker " + ", ".join(
                f"rank {r} {s:.2f} s" for r, s in
                sorted(runtime.promote_seconds.items()))
            + "; every PROMOTE reply names the card (" + ", ".join(
                f"rank {r}: {p['device']}, {p['devices']} card(s)"
                for r, p in sorted(runtime.promoted.items())) + ")")
        for name in TEMPLATES:  # each worker's first walk of each template
            q, exp = per_template[name][0]
            if not np.array_equal(cl_engine.execute(q), exp):
                fail(f"cluster warm-up {name} {q!r}: answer differs")
        barrier(runtime)
        cl_ms2, loc_ms = check_all(cl_engine, "2 workers")
        reps = barrier(runtime)
        n_ex = sum(r["exchanges"] for r in reps.values())
        n_bytes = sum(r["sent_bytes"] for r in reps.values())
        say(f"[cluster] {len(draws)} draws of phase 5 through execute at 2 "
            f"workers: every answer np.array_equal to the local engine's "
            f"and the scipy.sparse reference; {n_ex / len(draws):.1f} "
            f"exchanges a query (summed over the workers), "
            f"{n_bytes / len(draws):.0f} bytes a query through the fabric")
        batch_qs = per_template["T"]
        t0 = time.perf_counter()
        batch = cl_engine.execute_batch([q for q, _ in batch_qs])
        t_batch = time.perf_counter() - t0
        for (q, exp), got in zip(batch_qs, batch):
            if not np.array_equal(got, exp):
                fail(f"cluster batch: {q!r} differs from the reference")
        say(f"[cluster] one batch of {len(batch_qs)} T queries through "
            f"execute_batch (lane-batched walks): {t_batch:.3f} s, equal to "
            f"the reference")

        dispatches = runtime.instructions[ccl.DISPATCH]
        harvests = runtime.instructions[ccl.HARVEST]
        svc = QueryService(cl_engine, max_batch=64, max_queue=256,
                           auto_flush=False)
        accepted = []
        t0 = time.perf_counter()
        for i, (_name, q, exp) in enumerate(draws):
            req = svc.submit(q, tenant=who[i % len(who)])
            if not req.shed:
                accepted.append((req, exp))
        svc.flush()
        wall = time.perf_counter() - t0
        for req, exp in accepted:
            if not req.done or req.result is None:
                fail(f"cluster service: accepted request {req.rid} lost")
            if not np.array_equal(req.result, exp):
                fail(f"cluster service: {req.query!r} answer differs")
        used = (runtime.instructions[ccl.DISPATCH] - dispatches,
                runtime.instructions[ccl.HARVEST] - harvests)
        if used[0] == 0 or used[1] < used[0]:
            fail(f"cluster service: DISPATCH/HARVEST {used} not used")
        say(f"[cluster] QueryService read pass over the {len(draws)} draws: "
            f"{len(accepted)} accepted, none lost, all equal to the "
            f"reference; {used[0]} DISPATCH / {used[1]} HARVEST; {wall:.2f} s")

        new_index = rebuild()
        rebinds = runtime.instructions[ccl.FLUSH_REBIND]
        t0 = time.perf_counter()
        cl_engine.rebind(new_index)
        t_rebind = time.perf_counter() - t0
        if runtime.instructions[ccl.FLUSH_REBIND] != rebinds + 1:
            fail("cluster: rebind did not broadcast exactly one FLUSH_REBIND")
        check_all(cl_engine, "after rebind")
        say(f"[cluster] rebind to a rebuild of the phase-4 graph: one "
            f"FLUSH_REBIND broadcast in {t_rebind:.3f} s (make_slices "
            f"included); every answer equal again")

        t0 = time.perf_counter()
        step = QueryService(cl_engine).checkpoint(str(ckpt_dir))
        t_ckpt = time.perf_counter() - t0
        if runtime._ckpt != (str(ckpt_dir), step):
            fail("cluster: the checkpoint was not recorded as respawn base")
        say(f"[cluster] QueryService.checkpoint: CHECKPOINT barrier + save "
            f"in {t_ckpt:.2f} s ({dir_bytes(ckpt_dir)} bytes), recorded as "
            f"the respawn base")

        recoveries = runtime.recoveries
        t0 = time.perf_counter()
        runtime.inject_crash(0)
        t_crash = time_to_answer(cl_engine, t0)
        check_all(cl_engine, "after a crash mid-round")
        t0 = time.perf_counter()
        runtime._workers[1].proc.kill()
        t_kill = time_to_answer(cl_engine, t0)
        check_all(cl_engine, "after a kill")
        if runtime.recoveries < recoveries + 2:
            fail(f"cluster: recoveries {recoveries} -> {runtime.recoveries} "
                 "after two faults")
        check_promoted(runtime, "respawn")
        say(f"[cluster] inject_crash(0) mid-round: fault to next answer "
            f"{t_crash:.2f} s; proc.kill() of rank 1: {t_kill:.2f} s "
            f"(respawn from the checkpoint: load_state + make_slices in the "
            f"worker); recoveries {recoveries} -> {runtime.recoveries}; "
            f"every answer equal after each")

        t0 = time.perf_counter()
        cl_engine.backend.resize(4)
        t_up = time.perf_counter() - t0
        cl_ms4, loc_ms4 = check_all(cl_engine, "4 workers")
        if sorted(barrier(runtime)) != [0, 1, 2, 3]:
            fail("cluster: the barrier at 4 workers did not hear 4 ranks")
        t0 = time.perf_counter()
        cl_engine.backend.resize(2)
        t_down = time.perf_counter() - t0
        check_all(cl_engine, "back at 2 workers")
        barrier(runtime)
        say(f"[cluster] resize 2 -> 4 in {t_up:.2f} s, 4 -> 2 in "
            f"{t_down:.2f} s (RESHARD broadcast, make_slices included); "
            f"every answer equal at 4 and back at 2; every rank reported "
            f"the card at the barriers")
        say("[cluster] execute median ms per template, 2 workers / 4 workers "
            "/ local replayed engine (its medians in the same two passes): "
            + ", ".join(f"{n} {cl_ms2[n]:.3f} / {cl_ms4[n]:.3f} / "
                        f"{loc_ms[n]:.3f}, {loc_ms4[n]:.3f}"
                        for n in TEMPLATES))
        say("[cluster] peak device memory a worker: " + ", ".join(
            f"rank {r} {p / 2**30:.3f} GiB" for r, p in sorted(peaks.items()))
            + f"; instructions {dict(runtime.instructions)}")
    finally:
        runtime.shutdown()
    say(f"[cluster] phase {time.perf_counter() - t_phase:.1f} s; kernel "
        f"launches in the workers {worker_counts}")
    for name in ("sorted_member_mask", "expand_join_gather"):
        if worker_counts[name] == 0:
            fail(f"the cluster path never launched {name} in a worker")
    return worker_counts


# ---------------------------------------------------------------------- #
# main
# ---------------------------------------------------------------------- #


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch
        import repro_torch  # noqa: F401
    except ImportError as err:
        fail(f"cannot import the port ({err}); run from a checkout", 3)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card", 2)

    from repro_torch.core import index as cindex
    from repro_torch.core import interest
    from repro_torch.core.capacity import estimate_build_caps, graph_stats
    from repro_torch.core.engine import Engine
    from repro_torch.core.maintenance import MaintainableIndex
    from repro_torch.data.graphs import gmark_citation
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import (autotune, expand_join, fingerprint, ops,
                                     ref, segment_softmax, sorted_intersect)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    # ---- 1. device --------------------------------------------------- #
    kind = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        smi_line = (smi.stdout.strip().splitlines() or [smi.stderr.strip()])[0]
    except (OSError, subprocess.TimeoutExpired) as err:
        smi_line = f"nvidia-smi unavailable: {err}"
    say(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"[device] nvidia-smi: {smi_line}")

    # ---- 2. kernel build --------------------------------------------- #
    t0 = time.perf_counter()
    logs = kbuild.build_all()
    say(f"[build] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(kbuild.SOURCES)}) into {kbuild.BUILD_DIR.relative_to(ROOT)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[build] {name}: {line.strip()}")

    # ---- 3. kernel parity on the card -------------------------------- #
    rng = np.random.default_rng(SEED)
    kernel_fns = {"sorted_member_mask": sorted_intersect.sorted_member_mask,
                  "expand_join_gather": expand_join.expand_join_gather,
                  "fingerprint_rows": fingerprint.fingerprint_rows,
                  "segment_softmax": segment_softmax.segment_normalize}
    plain_fns = {"sorted_member_mask": ref.sorted_member_mask,
                 "expand_join_gather": ref.expand_join_gather,
                 "fingerprint_rows": ref.fingerprint_rows,
                 "segment_softmax": ref.segment_normalize}
    m_cases, j_cases = member_cases(rng, dev), join_cases(rng, dev)
    err = {
        "sorted_member_mask": check_parity(
            "sorted_member_mask", sorted_intersect.sorted_member_mask,
            ref.sorted_member_mask, m_cases),
        "expand_join_gather": check_parity(
            "expand_join_gather", expand_join.expand_join_gather,
            ref.expand_join_gather, j_cases),
        "fingerprint_rows": check_parity(
            "fingerprint_rows", fingerprint.fingerprint_rows,
            ref.fingerprint_rows, fingerprint_cases(rng, dev)),
    }
    say("[parity] test shapes, SENTINEL, -1, INT_MIN, empty and multi-lane "
        "cases: the three integer kernels equal their plain versions "
        "(tolerance 0: integer outputs, bit-exact)")
    member_budget = budget_cases(rng, dev)
    for path, (hay, cnt, q) in member_budget:
        if sorted_intersect.launch_plan(hay.shape[1])[0] != path:
            fail(f"sorted_member_mask: a haystack of {hay.shape[1]} ids should "
                 f"take the {path} path, the plan says "
                 f"{sorted_intersect.launch_plan(hay.shape[1])}")
    err["sorted_member_mask"] = max(err["sorted_member_mask"], check_parity(
        "sorted_member_mask", sorted_intersect.sorted_member_mask,
        ref.sorted_member_mask, [c for _, c in member_budget]))
    say("[parity] sorted_member_mask on both sides of its shared-memory budget "
        f"({sorted_intersect.SHARED_BUDGET} bytes): "
        + ", ".join(f"B={h.shape[0]} n_hay={h.shape[1]} n_q={q.shape[1]} "
                    f"{path}" for path, (h, _, q) in member_budget)
        + ": bit-exact (tolerance 0)")
    for t in autotune.CANDIDATES:  # every block size the autotuner sweeps
        err["sorted_member_mask"] = max(err["sorted_member_mask"], check_parity(
            f"sorted_member_mask threads={t}",
            lambda *a, t=t: sorted_intersect.sorted_member_mask(*a, threads=t),
            ref.sorted_member_mask, m_cases + [c for _, c in member_budget]))
        err["expand_join_gather"] = max(err["expand_join_gather"], check_parity(
            f"expand_join_gather threads={t}",
            lambda *a, t=t: expand_join.expand_join_gather(*a, threads=t),
            ref.expand_join_gather, j_cases))
    say(f"[parity] sorted_member_mask (the test cases and both sides of the "
        f"budget) and expand_join_gather at threads {autotune.CANDIDATES} a "
        f"block: bit-exact (tolerance 0); without a table both launch "
        f"{sorted_intersect.DEFAULT_THREADS} / {expand_join.DEFAULT_THREADS}")
    softmax_err = check_softmax_parity(
        segment_softmax.segment_normalize, ref.segment_normalize,
        ref.segment_tables, softmax_cases(rng, dev))
    err["segment_softmax"] = max(softmax_err.values())
    say(f"[parity] segment_softmax on the test shapes, empty segments, negative "
        f"and >= N ids, unsorted ids, E=1, ragged E, misaligned D=1 bases, "
        f"row tiles at D = 2, 8, 70, 300 and 1 100: packed table equal to the "
        f"separate reductions; kernel bit-exact against its plain version on "
        f"the same table (tolerance 0); max abs err {softmax_err}")

    # small builds on the card held bit for bit against the CPU builds
    g_small = gmark_citation(500, avg_degree=6, seed=SEED)
    small_ints = interests_for(g_small)
    for what, make in (
            ("CPQx", lambda d: cindex.build(g_small, K, device=d)),
            ("iaCPQx", lambda d: interest.build_interest(g_small, K, small_ints,
                                                         device=d))):
        on_card, on_cpu = make(None), make("cpu")
        for f in on_card.arrays._fields:
            if not torch.equal(getattr(on_card.arrays, f).cpu(),
                               getattr(on_cpu.arrays, f)):
                fail(f"small {what} build: field {f} differs between card and CPU")
        if on_card.seq_ranges != on_cpu.seq_ranges:
            fail(f"small {what} build: seq_ranges differ between card and CPU")
        say(f"[index] gmark_citation(500) k={K} {what}: all 17 fields "
            "bit-identical card vs CPU")

    # ---- the paths: spies record each kernel's largest input ---------- #
    recorded = {name: None for name in KERNELS}
    recording = [True]
    real = {"sorted_member_mask": ops.sorted_member_mask,
            "expand_join_gather": ops.expand_join_gather,
            "fingerprint_rows": ops.fingerprint_rows}
    counters = {"sorted_member_mask": sorted_intersect,
                "expand_join_gather": expand_join,
                "fingerprint_rows": fingerprint,
                "segment_softmax": segment_softmax}

    def record(name, args, work):
        if not recording[0]:  # the calibration's synthetic inputs
            return
        best = recorded[name]
        if best is None or work > best[0]:  # as the kernel receives them
            recorded[name] = (work, tuple(
                a.contiguous() if torch.is_tensor(a) else a for a in args))

    def mask_spy(hay, hay_count, queries):
        record("sorted_member_mask", (hay, hay_count, queries), queries.numel())
        return real["sorted_member_mask"](hay, hay_count, queries)

    def gather_spy(ends, lo, a_payload, b_v, b_u, total, out_capacity):
        record("expand_join_gather", (ends, lo, a_payload, b_v, b_u, total,
                                      out_capacity), ends.shape[0] * out_capacity)
        return real["expand_join_gather"](ends, lo, a_payload, b_v, b_u, total,
                                           out_capacity)

    def fingerprint_spy(cols, salt=0):
        cols = tuple(c.contiguous() for c in cols)
        record("fingerprint_rows", (cols, salt), cols[0].numel() * len(cols))
        return real["fingerprint_rows"](cols, salt)

    ops.sorted_member_mask, ops.expand_join_gather, ops.fingerprint_rows = (
        mask_spy, gather_spy, fingerprint_spy)

    def zero_counts():
        for mod in counters.values():
            mod.launches = 0

    def read_counts(path, needed):
        counts = {name: mod.launches for name, mod in counters.items()}
        say(f"[{path}] kernel launches {counts}")
        for name in needed:
            if counts[name] == 0:
                fail(f"the {path} path never launched {name}")
        return counts

    path_counts = {}

    # ---- 4. build at full size (counts to 0 just before) ------------- #
    zero_counts()
    g = gmark_citation(N_VERTICES, avg_degree=6, seed=SEED)
    t0 = time.perf_counter()
    caps = estimate_build_caps(g, K)
    t_caps = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    index = cindex.build(g, K, caps=caps)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - resident
    fp_build = fingerprint.launches
    say(f"[index] gmark_citation({N_VERTICES}, avg_degree=6, seed={SEED}) k={K}: "
        f"{g.n_edges} edges with inverses, caps level_rows={caps.level_rows} "
        f"pair_cap={caps.pair_cap}")
    say(f"[index] host capacity estimate {t_caps:.2f} s; device build "
        f"{t_build:.3f} s; n_classes={index.n_classes}; |P<=2|={index.n_pairs}; "
        f"size_entries={index.size_entries()}; peak device memory of the "
        f"build {peak / 2**30:.3f} GiB (above {resident / 2**30:.3f} GiB "
        f"resident before it); fingerprint_rows launches {fp_build}")
    if fp_build == 0:
        fail("the CPQx build never launched fingerprint_rows")
    t0 = time.perf_counter()
    gstats = graph_stats(g, K)
    say(f"[index] graph_stats (the paper's Table IV; host numpy, "
        f"{time.perf_counter() - t0:.2f} s): |P<={K}|={gstats['n_pairs']}, "
        f"sequence incidences {gstats['seq_incidences']}, gamma "
        f"{gstats['gamma']:.4f}, max out-degree {gstats['max_out_degree']}, "
        f"level rows {gstats['level_rows']}")

    # ---- 5. queries -------------------------------------------------- #
    engine = Engine(index)
    refm = SparseReference(g)
    per_template, drops = draw_queries(g, refm, BATCH, SEED)
    say(f"[queries] {sum(len(v) for v in per_template.values())} queries kept; "
        f"{len(drops)} draws dropped (reference answer > {MAX_ANSWER} pairs, "
        f"or a reference product > {MAX_REF_FLOPS} multiply-adds), e.g. "
        f"{drops[:3]}")

    def run_templates(engine, what, tally=None):
        """Two passes over the draws, every answer held to the reference.
        The first executes each draw once and runs each template's batch
        once (new keys are captured here; with a ``tally`` every dispatch
        is also held to the eager walker); the second times execute per
        draw and execute_batch twice per template, on warm executables and
        with nothing held.  Returns (per-template record, evaluations)."""
        n_queries = 0
        results = {}
        for name, accepted in per_template.items():
            qs = [q for q, _ in accepted]
            if tally is not None:
                tally["on"] = True
            first = []
            for q, exp in accepted:
                t0 = time.perf_counter()
                got = engine.execute(q)
                first.append(time.perf_counter() - t0)
                if not np.array_equal(got, exp):
                    fail(f"{what} {name} {q!r}: execute answer ({len(got)} "
                         f"pairs) differs from the reference ({len(exp)} pairs)")
            batch = engine.execute_batch(qs)
            for (q, exp), got in zip(accepted, batch):
                if not np.array_equal(got, exp):
                    fail(f"{what} {name} {q!r}: execute_batch answer "
                         f"differs from the reference")
            if tally is not None:
                tally["on"] = False
            lat = []
            for q, exp in accepted:
                t0 = time.perf_counter()
                got = engine.execute(q)
                lat.append(time.perf_counter() - t0)
                if not np.array_equal(got, exp):
                    fail(f"{what} {name} {q!r}: a second execute differs")
            bt = []
            for _ in range(2):
                t0 = time.perf_counter()
                batch = engine.execute_batch(qs)
                bt.append(time.perf_counter() - t0)
                for (q, exp), got in zip(accepted, batch):
                    if not np.array_equal(got, exp):
                        fail(f"{what} {name} {q!r}: execute_batch answer "
                             f"differs from the reference")
            n_queries += 2 * len(qs) + 3 * len(qs)
            results[name] = dict(
                n=len(qs), execute_ms_median=1e3 * float(np.median(lat)),
                execute_ms_first=1e3 * float(np.median(first)),
                batch_qps=len(qs) / float(np.median(bt)),
                max_answer=max(len(e) for _, e in accepted))
        for name, r in results.items():
            say(f"[{what}] {name:4s} n={r['n']:2d} execute median "
                f"{r['execute_ms_median']:.3f} ms (first pass "
                f"{r['execute_ms_first']:.3f} ms, captures included) batch "
                f"{r['batch_qps']:.1f} q/s  largest answer {r['max_answer']}")
        say(f"[{what}] all answers equal the scipy.sparse reference; "
            f"{n_queries} query evaluations; telemetry {engine.telemetry}")
        return results, n_queries

    held = {"on": False, "dispatches": 0, "lanes": 0}
    hold_to_eager(engine, held)
    t0 = time.perf_counter()
    cpqx_results, _ = run_templates(engine, "queries", held)
    t_queries = time.perf_counter() - t0
    held["on"] = True  # the traps below are held too
    say(f"[graphs] phase 5: {held['dispatches']} dispatches ({held['lanes']} "
        f"lanes) replayed from captured graphs, each equal to the eager walker "
        f"(run_plan_ops called directly on the same inputs) bit for bit, "
        f"flags and rows; {t_queries:.1f} s")
    say(cache_line("phase 5 engine", engine))

    # the static-buffer trap: one key replayed with other lookup ranges
    from repro_torch.core.query import plan_shape
    cache = engine.backend.executables
    trap = None
    for name in TEMPLATES:
        by_key = {}
        for q, exp in per_template[name]:
            plan = engine.plan(q)
            ranges = engine.lookup_ranges(plan)
            key = (plan_shape(plan), engine.estimate_caps(
                ranges, plan_shape(plan), plan))
            by_key.setdefault(key, []).append((q, exp, ranges.tobytes()))
        for key, members in by_key.items():
            if len({r for _, _, r in members}) >= 2:
                trap = (name, key, members)
                break
        if trap:
            break
    if trap is None:
        fail("graphs: no key of phase 5 has two draws with other ranges")
    name, key, members = trap
    captures = cache.captures
    for q, exp, _ in members:
        if not np.array_equal(engine.execute(q), exp):
            fail(f"graphs: {q!r} replayed with its own ranges differs")
    if cache.captures != captures:
        fail("graphs: a replay of a cached key captured again")
    say(f"[graphs] static inputs: template {name} key caps {key[1]} replayed "
        f"for {len(members)} draws with {len({r for _, _, r in members})} "
        f"different lookup ranges, no new capture, each answer equal to the "
        f"eager walker and the reference")

    # two batches of one key dispatched before either is harvested
    pair = None
    for name in TEMPLATES:
        by_shape = {}
        for q, exp in per_template[name]:
            by_shape.setdefault(plan_shape(engine.plan(q)), []).append((q, exp))
        best = max(by_shape.values(), key=len)
        if len(best) >= 4:
            pair = (name, best)
            break
    if pair is None:
        fail("graphs: no template has four draws of one plan shape")
    name, same = pair
    half = len(same) // 2
    caps_t = None
    for q, _ in same[: 2 * half]:
        plan = engine.plan(q)
        c = engine.estimate_caps(engine.lookup_ranges(plan), plan_shape(plan),
                                 plan)
        caps_t = c if caps_t is None else type(c)(
            max(c.class_cap, caps_t.class_cap), max(c.pair_cap, caps_t.pair_cap),
            max(c.join_cap, caps_t.join_cap))
    captures, replays = cache.captures, cache.replays
    h1 = engine.dispatch_batch([q for q, _ in same[:half]], caps=caps_t)
    h2 = engine.dispatch_batch([q for q, _ in same[half: 2 * half]],
                               caps=caps_t)
    got2, got1 = engine.harvest_batch(h2), engine.harvest_batch(h1)
    for part, got in ((same[:half], got1), (same[half: 2 * half], got2)):
        for (q, exp), rows in zip(part, got):
            if not np.array_equal(rows, exp):
                fail(f"graphs: two batches in flight: {q!r} differs")
    if cache.captures - captures > 1 or cache.replays - replays < 2:
        fail("graphs: the two batches in flight did not share one key")
    say(f"[graphs] two batches of {half} {name} queries of one plan shape at "
        f"caps {caps_t} (one key) dispatched before either was harvested: "
        f"{cache.captures - captures} capture(s), {cache.replays - replays} "
        f"replays; each batch's answers equal the reference and the eager "
        f"walker")

    # the same draws eagerly on the card: the same-run yardstick
    eager = eager_engine(index)
    eager_ms = {}
    for name in TEMPLATES:
        lat = []
        for q, exp in per_template[name]:
            eager_launches(lambda: eager.execute(q))  # warm
            t0 = time.perf_counter()
            got = eager_launches(lambda: eager.execute(q))
            lat.append(time.perf_counter() - t0)
            if not np.array_equal(got, exp):
                fail(f"eager engine {name} {q!r}: answer differs")
        eager_ms[name] = 1e3 * float(np.median(lat))
    say("[queries] execute median, replayed graphs vs the eager walker in "
        "this run: " + ", ".join(
            f"{n} {cpqx_results[n]['execute_ms_median']:.3f} / "
            f"{eager_ms[n]:.3f} ms" for n in TEMPLATES))
    held["on"] = False
    path_counts["cpqx"] = read_counts("main path (CPQx build + queries)",
                                      INDEX_KERNELS)

    # ---- 6. iaCPQx at full size (counts to 0 just before) ------------ #
    zero_counts()
    ints = interests_for(g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ia_resident = torch.cuda.memory_allocated()  # the CPQx index and engine
    t0 = time.perf_counter()
    ia_index = interest.build_interest(g, K, ints, caps=caps)
    torch.cuda.synchronize()
    t_ia = time.perf_counter() - t0
    ia_peak = torch.cuda.max_memory_allocated() - ia_resident
    say(f"[iacpqx] interests {ints} (+ every length-1 sequence)")
    say(f"[iacpqx] device build {t_ia:.3f} s (host estimate shared with "
        f"CPQx); n_classes={ia_index.n_classes} (CPQx {index.n_classes}); "
        f"size_entries={ia_index.size_entries()} (CPQx {index.size_entries()}); "
        f"peak device memory of the build {ia_peak / 2**30:.3f} GiB above "
        f"{ia_resident / 2**30:.3f} GiB resident (CPQx {peak / 2**30:.3f})")
    run_templates(Engine(ia_index), "iacpqx")
    path_counts["iacpqx"] = read_counts("iaCPQx build + queries", INDEX_KERNELS)

    # ---- 7. lazy maintenance (counts to 0 just before) --------------- #
    zero_counts()
    maint_kernels = ("sorted_member_mask", "expand_join_gather")
    g_m = g if MAINT_VERTICES == N_VERTICES else gmark_citation(
        MAINT_VERTICES, avg_degree=6, seed=SEED)
    probe, _ = draw_queries(g_m, SparseReference(g_m), 1, 10_000)
    probes = [acc[0][0] for acc in probe.values()]  # one query per template
    t0 = time.perf_counter()
    mi = MaintainableIndex.build(g_m, K)
    t_mirror = time.perf_counter() - t0
    size0 = sum(mi.size_entries())
    t0 = time.perf_counter()
    flushed = mi.flush()
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    m_engine = Engine(flushed)
    check_answers(m_engine, mi.g, probes, "maintenance (pristine flush)")
    say(f"[maintenance] gmark_citation({MAINT_VERTICES}) k={K}: host mirror "
        f"build {t_mirror:.2f} s; first flush {t_flush:.3f} s; "
        f"n_classes={flushed.n_classes}; size_entries={mi.size_entries()}; "
        f"caps {flushed.caps}")
    urng = np.random.default_rng(7)
    rebuild_fp = 0
    stale_checked = 0
    for r in range(MAINT_ROUNDS):
        batch = update_batch(mi.g, urng, MAINT_OPS)
        t0 = time.perf_counter()
        affected = mi.apply_updates(batch)
        t_apply = time.perf_counter() - t0
        t0 = time.perf_counter()
        flushed = mi.flush()
        torch.cuda.synchronize()
        t_flush = time.perf_counter() - t0
        old_backend = m_engine.backend
        t0 = time.perf_counter()
        m_engine.rebind(flushed)
        t_rebind = time.perf_counter() - t0
        if len(old_backend.executables) or old_backend.executables.bytes:
            fail("maintenance: the old backend kept its graphs after rebind")
        check_answers(m_engine, mi.g, probes, f"maintenance round {r}")
        stale_checked += 1
        # the paper's alternative: a full rebuild of the updated graph
        before = fingerprint.launches
        t0 = time.perf_counter()
        rcaps = estimate_build_caps(mi.g, K)
        t_rcaps = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rebuilt = cindex.build(mi.g, K, caps=rcaps)
        torch.cuda.synchronize()
        t_rbuild = time.perf_counter() - t0
        rebuild_fp += fingerprint.launches - before
        check_answers(Engine(rebuilt), mi.g, probes, f"rebuild round {r}")
        say(f"[maintenance] round {r}: {len(batch)} ops, {len(affected)} "
            f"affected pairs; apply {t_apply:.3f} s, flush {t_flush:.3f} s, "
            f"rebind {t_rebind:.3f} s; n_splits={mi.n_splits}; size ratio "
            f"{sum(mi.size_entries()) / max(size0, 1):.4f}; n_classes "
            f"{flushed.n_classes} (rebuild {rebuilt.n_classes}); full rebuild: "
            f"host estimate {t_rcaps:.2f} s + device build {t_rbuild:.3f} s")
    del rebuilt, mi, m_engine, flushed  # the mirror holds gigabytes at 20k

    # one interest round on an iaCPQx mirror
    ints_m = ints if g_m is g else interests_for(g_m)
    t0 = time.perf_counter()
    mia = MaintainableIndex.build(g_m, K, interests=ints_m)
    t_ia_mirror = time.perf_counter() - t0
    ia_engine = Engine(mia.flush())
    check_answers(ia_engine, mia.g, probes, "iaCPQx mirror (pristine flush)")
    t0 = time.perf_counter()
    mia.delete_interest(ints_m[0])
    t_del = time.perf_counter() - t0
    t0 = time.perf_counter()
    mia.insert_interest(ints_m[0])
    t_ins = time.perf_counter() - t0
    t0 = time.perf_counter()
    flushed = mia.flush()
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    ia_engine.rebind(flushed)
    check_answers(ia_engine, mia.g, probes, "iaCPQx mirror interest round")
    say(f"[maintenance] iaCPQx mirror of gmark_citation({MAINT_VERTICES}): "
        f"build {t_ia_mirror:.2f} s; delete_interest{ints_m[0]} {t_del:.3f} s, "
        f"insert_interest{ints_m[0]} {t_ins:.3f} s, flush {t_flush:.3f} s; "
        f"n_splits={mia.n_splits}; n_classes {flushed.n_classes}")
    say(f"[graphs] maintenance: after each of {stale_checked} flush + "
        f"rebind rounds the old backend's graphs were dropped and the new "
        f"backend's answers equal the reference")
    m_counts = read_counts("maintenance (flush + rebind + queries, and the "
                           "rebuilds)", maint_kernels)
    say(f"[maintenance] of which the rebuilds' fingerprint_rows launches: "
        f"{rebuild_fp}; every answer equals the scipy.sparse reference")
    path_counts["maintenance"] = m_counts

    # ---- 8. serving: the read path (counts to 0 just before) --------- #
    from repro_torch.core.cypher import lower_cypher, parse_cypher
    from repro_torch.core.query import CPQ as Query
    from repro_torch.core.rpq import FixpointInfo
    from repro_torch.core.service import QueryService
    from repro_torch.core.workload import AdaptationConfig, AdaptationController
    from repro_torch.data.graphs import drifting_workload
    from repro_torch.models.gnn import edge_softmax

    zero_counts()
    held.update(on=True, dispatches=0, lanes=0)
    draws = [per_template[name] for name in TEMPLATES]
    stream = [d[i] for i in range(max(len(d) for d in draws))
              for d in draws if i < len(d)]  # every round mixes shapes
    who = ("alpha", "alpha", "alpha", "beta")  # alpha sends 3x beta's traffic
    svc = QueryService(engine, union=True, max_batch=64, max_queue=32,
                       auto_flush=False)
    lanes_before = engine.telemetry.union_lanes
    accepted = []
    t0 = time.perf_counter()
    for off in range(0, len(stream), SERVE_BURST):
        for i, (q, exp) in enumerate(stream[off: off + SERVE_BURST], off):
            req = svc.submit(q, tenant=who[i % len(who)])
            if not req.shed:
                accepted.append((req, exp))
        svc.flush()
    wall = time.perf_counter() - t0
    for req, exp in accepted:
        if not req.done or req.result is None:
            fail(f"serving: accepted request {req.rid} never completed")
        if not np.array_equal(req.result, exp):
            fail(f"serving: {req.query!r} answer ({len(req.result)} pairs) "
                 f"differs from the reference ({len(exp)} pairs)")
    union_lanes = engine.telemetry.union_lanes - lanes_before
    say(f"[serving] read path: {len(stream)} requests of phase 5's draws in "
        f"bursts of {SERVE_BURST}, union dispatch, max_queue 32: "
        f"{len(accepted)} accepted, all answers equal the scipy.sparse "
        f"reference; {svc.stats.shed} shed; {svc.stats.drain_rounds} rounds; "
        f"union lanes {union_lanes}; {wall:.2f} s")
    tenant_report("serving", svc.stats, [r for r, _ in accepted], wall)
    if svc.stats.shed == 0:
        fail("serving: bursts past max_queue shed nothing")
    if union_lanes == 0:
        fail("serving: no lane went through the union executable")
    held["on"] = False
    say(f"[graphs] serving read path: {held['dispatches']} dispatches "
        f"({held['lanes']} lanes, union and shaped) replayed, each equal to "
        f"the eager walker; the latencies above include those eager runs "
        f"and the captures")
    # the same stream again on warm graphs, nothing held: serving latency
    svc2 = QueryService(engine, union=True, max_batch=64, max_queue=32,
                        auto_flush=False)
    accepted2 = []
    t0 = time.perf_counter()
    for off in range(0, len(stream), SERVE_BURST):
        for i, (q, exp) in enumerate(stream[off: off + SERVE_BURST], off):
            req = svc2.submit(q, tenant=who[i % len(who)])
            if not req.shed:
                accepted2.append((req, exp))
        svc2.flush()
    wall2 = time.perf_counter() - t0
    for req, exp in accepted2:
        if not req.done or not np.array_equal(req.result, exp):
            fail(f"serving (warm): {req.query!r} answer differs")
    say(f"[serving] read path again on warm graphs, nothing held: "
        f"{len(accepted2)} accepted, {svc2.stats.shed} shed, all answers "
        f"equal the reference; {wall2:.2f} s")
    tenant_report("serving", svc2.stats, [r for r, _ in accepted2], wall2)
    say(cache_line("read-path service engine", engine))
    path_counts["serving"] = read_counts(
        "serving read path (QueryService over CPQx)",
        ("sorted_member_mask", "expand_join_gather"))

    # ---- 8. serving: write path + adaptation over phase 7's mirror ---- #
    zero_counts()
    held.update(on=True, dispatches=0, lanes=0)
    hold_to_eager(ia_engine, held)
    adapter = AdaptationController(K, config=AdaptationConfig(
        budget=2, min_count=3.0, dwell=1, swap_margin=2.0, decay=0.5))
    wsvc = QueryService(ia_engine, maintainer=mia, adapter=adapter,
                        adapt_interval=48, max_batch=16, max_queue=32,
                        auto_flush=False, union=True)
    drift = {"alpha": ([ADAPTIVE_PHASES[0], ADAPTIVE_PHASES[1]], 3.0),
             "beta": ([ADAPTIVE_PHASES[1], ADAPTIVE_PHASES[0]], 1.0)}
    wstream = drifting_workload(mia.g, None, DRIFT_PER_PHASE, seed=11,
                                tenants=drift)
    ref_now = [mia.g, SparseReference(mia.g)]  # the reference of the live graph
    probes, waccepted, unprobed = [], [], 0
    wrng = np.random.default_rng(11)
    updated = False
    t0 = time.perf_counter()
    for slot in wstream:
        for off in range(0, len(slot), SERVE_BURST):
            for i, (tenant, q) in enumerate(slot[off: off + SERVE_BURST]):
                req = wsvc.submit(q, tenant=tenant)
                if req.shed:
                    continue
                waccepted.append(req)
                # probe only where the request sees the graph as it is now
                if wsvc.pending_updates == 0 and i % 7 == 0:
                    if ref_now[0] is not mia.g:
                        ref_now[:] = [mia.g, SparseReference(mia.g)]
                    m = ref_now[1].eval(q)
                    if m is None or m.nnz > MAX_ANSWER:
                        unprobed += 1
                    else:
                        probes.append((req, ref_now[1].rows(m)))
            wsvc.flush()
            if not updated:  # one batch of updates between the bursts
                wsvc.apply_updates(update_batch(mia.g, wrng, MAINT_OPS))
                updated = True
        wsvc.adapt()  # a round at each phase's end, beside the interval's
        wsvc.flush()
    wall = time.perf_counter() - t0
    for req in waccepted:
        if not req.done or req.result is None:
            fail(f"write path: accepted request {req.rid} never completed")
    for req, exp in probes:
        if not np.array_equal(req.result, exp):
            fail(f"write path: {req.query!r} answer ({len(req.result)} pairs) "
                 f"differs from the reference at submit time ({len(exp)})")
    st = wsvc.stats
    adapted = st.interests_inserted + st.interests_deleted
    say(f"[serving] write path: {sum(len(x) for x in wstream)} requests of a "
        f"drifting two-tenant stream over the iaCPQx mirror, one batch of "
        f"{MAINT_OPS} updates: {len(waccepted)} accepted, {st.shed} shed, "
        f"{len(probes)} probes equal the reference at submit time "
        f"({unprobed} probes over the reference's limits skipped); "
        f"{st.update_batches} update drains ({st.updates_applied} ops), "
        f"{st.adapt_rounds} adaptation rounds, interests +{st.interests_inserted}"
        f" -{st.interests_deleted}; mined now "
        f"{sorted(s for s in mia.index.interests if len(s) >= 2)}; {wall:.2f} s")
    tenant_report("serving", st, waccepted, wall)
    if adapted == 0:
        fail("write path: no adaptation op was applied")
    if not probes:
        fail("write path: no probe was checked")
    if held["dispatches"] == 0:
        fail("write path: no replay was held to the eager walker")
    held["on"] = False
    say(f"[graphs] serving write path: {held['dispatches']} dispatches "
        f"({held['lanes']} lanes) replayed across {st.update_batches} "
        f"flush + rebind drains, each equal to the eager walker")
    path_counts["serving_write"] = read_counts(
        "serving write path (updates + adaptation over the iaCPQx mirror)",
        ("expand_join_gather",))
    # the write-path state, checkpointed here; phase 12 restores a replica
    # from it and keeps driving the donor, so the donor lives until then
    ckpt_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    svc_dir = str(ckpt_root / "service")
    t0 = time.perf_counter()
    step0 = wsvc.checkpoint(svc_dir)
    t_ck0 = time.perf_counter() - t0
    say(f"[serving] write-path service checkpointed as step {step0} in "
        f"{t_ck0:.2f} s ({dir_bytes(svc_dir)} bytes on disk); kept for "
        f"phase 12")

    # ---- 9. RPQ and Cypher (counts to 0 just before) ----------------- #
    zero_counts()
    label_ids = {name: i for i, name in enumerate(g.label_names)}

    def reference(ast, srcs):
        if not isinstance(ast, Query):
            return rpq_reference(refm, ast, srcs)
        m = refm.eval(ast)
        if m is None or m.nnz > MAX_ANSWER:
            raise TooCostly("flops" if m is None else f"{m.nnz} pairs")
        return m if srcs is None else m[srcs]

    rsvc = QueryService(engine, max_batch=len(RPQ_TEXTS))
    rpq_drops, served, star_iters = [], [], 0
    for text in RPQ_TEXTS:
        low = lower_cypher(parse_cypher(text), label_ids, g.n_labels)
        pins = m = None
        try:
            m = reference(low.ast, None)
        except TooCostly as why:
            rpq_drops.append((text, str(why)))
            for v in pin_candidates(g, parse_cypher(text), g.n_labels):
                ptext = text.replace(" RETURN", f" WHERE a = {v} RETURN")
                plow = lower_cypher(parse_cypher(ptext), label_ids, g.n_labels)
                try:
                    m = reference(plow.ast, [plow.src])
                except TooCostly as why2:
                    rpq_drops.append((ptext, str(why2)))
                    continue
                text, low, pins = ptext, plow, [plow.src]
                break
        if m is None:
            continue
        exp = rpq_pairs(m, pins)
        info = FixpointInfo()
        t0 = time.perf_counter()
        if low.is_cpq:
            got = engine.execute(low.ast)
            if pins is not None:
                got = got[np.isin(got[:, 0], pins)]
        else:
            got = engine.execute_rpq(low.ast, srcs=pins, info=info)
        ms = 1e3 * (time.perf_counter() - t0)
        if not np.array_equal(got, exp):
            fail(f"rpq: {text}: answer ({len(got)} pairs) differs from the "
                 f"reference ({len(exp)} pairs)")
        if pins is None:
            served.append((text, rsvc.submit(low.ast), exp))
        is_star = "*]" in text or "*0..]" in text
        if is_star and not low.is_cpq:
            star_iters = max(star_iters, info.iterations)
        say(f"[rpq] {text}: {'cpq' if low.is_cpq else 'rpq'}, {len(exp)} pairs "
            f"equal the reference; iterations {info.iterations}, lookups "
            f"{info.lookups}, rounds {info.lookup_batches}, states "
            f"{info.states}, macro-edges {info.macro_edges}; {ms:.1f} ms")
    rsvc.flush()
    for text, req, exp in served:
        if not np.array_equal(req.result, exp):
            fail(f"rpq: {text}: the service's answer differs from the reference")
    say(f"[rpq] dropped (reference over {MAX_REF_FLOPS} multiply-adds or "
        f"{MAX_ANSWER} pairs): {rpq_drops}")
    say(f"[rpq] through the service too (unpinned only: it takes no pins): "
        f"{len(served)} queries, answers equal; star fixpoint iterations "
        f"{star_iters}")
    if star_iters <= 1:
        fail("rpq: no star query kept whose fixpoint ran more than one "
             "iteration")
    path_counts["rpq"] = read_counts("RPQ + Cypher (execute_rpq and the service)",
                                     ("expand_join_gather",))

    # ---- 10. baselines: Path index, iaPath, BFS (counts to 0 just before) #
    from repro_torch.core.baselines import PathEngine, build_path
    from repro_torch.core.oracle import bfs_eval

    zero_counts()
    builds = {}
    for what, make in (
            ("Path", lambda: build_path(g, K, caps=caps)),
            ("iaPath", lambda: build_path(g, K, interests=ints, caps=caps))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pidx = make()
        torch.cuda.synchronize()
        builds[what] = (pidx, time.perf_counter() - t0,
                        torch.cuda.max_memory_allocated() - before)
    (path_idx, t_p, p_peak), (ia_path, t_iap, iap_peak) = builds.values()
    say(f"[baselines] Path index of gmark_citation({N_VERTICES}) k={K} (phase "
        f"4's build caps): device build {t_p:.3f} s, peak device memory "
        f"{p_peak / 2**30:.3f} GiB, size_entries {path_idx.size_entries()} "
        f"(CPQx: {t_build:.3f} s, {peak / 2**30:.3f} GiB, size_entries "
        f"{index.size_entries()})")
    say(f"[baselines] iaPath over {ints}: device build {t_iap:.3f} s, peak "
        f"{iap_peak / 2**30:.3f} GiB, size_entries {ia_path.size_entries()} "
        f"(iaCPQx: {t_ia:.3f} s, {ia_peak / 2**30:.3f} GiB, size_entries "
        f"{ia_index.size_entries()})")
    del ia_path
    pe = PathEngine(path_idx)
    say(f"[baselines] PathEngine default caps {pe.default_caps}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    q_before = torch.cuda.memory_allocated()
    path_ms, n_path = {}, 0
    for name, accepted in per_template.items():
        lat = []
        for rnd in range(PATH_ROUNDS):  # round 0 warms up, not timed
            for q, exp in accepted:
                t0 = time.perf_counter()
                got = pe.execute(q)
                if rnd:
                    lat.append(time.perf_counter() - t0)
                n_path += 1
                if not np.array_equal(got, exp):
                    fail(f"PathEngine {name} {q!r}: answer ({len(got)} pairs) "
                         f"differs from the reference ({len(exp)} pairs)")
        path_ms[name] = 1e3 * float(np.median(lat))
    q_peak = torch.cuda.max_memory_allocated() - q_before
    for name in TEMPLATES:
        cq = cpqx_results[name]["execute_ms_median"]
        say(f"[baselines] {name:4s} PathEngine.execute median "
            f"{path_ms[name]:.3f} ms, CPQx {cq:.3f} ms (phase 5): Path / CPQx "
            f"{path_ms[name] / cq:.2f}")
    say(f"[baselines] {n_path} PathEngine evaluations ({PATH_ROUNDS} rounds "
        f"of phase 5's draws, the first a warm-up), all equal to the "
        f"scipy.sparse reference; peak device memory of the queries "
        f"{q_peak / 2**30:.3f} GiB above {q_before / 2**30:.3f} GiB resident")
    bfs_s = {}
    for name, accepted in per_template.items():
        q, exp = accepted[0]
        t0 = time.perf_counter()
        got = bfs_eval(g, q)
        bfs_s[name] = time.perf_counter() - t0
        rows = np.array(sorted(got), np.int32).reshape(-1, 2)
        if not np.array_equal(rows, exp):
            fail(f"bfs_eval {name} {q!r}: differs from the reference")
    say(f"[baselines] index-free BFS (oracle.bfs_eval, host Python) on "
        f"gmark_citation({N_VERTICES}), one draw a template, answers equal "
        f"the reference: " + ", ".join(f"{n} {1e3 * t:.1f} ms"
                                       for n, t in bfs_s.items())
        + f"; {sum(bfs_s.values()):.2f} s in all")
    del pe, path_idx
    # the Path index shares the path enumeration, not the bisim hash, and
    # evaluates in pair space: no kernel of the four is on this path
    path_counts["baselines"] = read_counts(
        "baselines (Path / iaPath builds + PathEngine + BFS)", ())

    # ---- 11. cost model calibration + autotune (counts to 0 just before) #
    from repro_torch.core import costmodel

    zero_counts()
    cal_probes = [per_template[name][0][0] for name in TEMPLATES]
    rungs = costmodel.ladder_rungs(engine, cal_probes)
    recording[0] = False  # the paths' largest calls stay the queries'
    t0 = time.perf_counter()
    cost_table = costmodel.calibrate(rungs)
    t_cal = time.perf_counter() - t0
    say(f"[calibrate] costmodel.calibrate at the phase-4 engine's ladder "
        f"rungs {rungs} on {cost_table.device_kind}: {t_cal:.2f} s")
    for op in costmodel.OPERATORS:
        c = cost_table.ops[op]
        say(f"[calibrate] {op}: fixed {c.fixed_ns:.0f} ns + "
            f"{c.per_row_ns:.5f} ns a row; measured (rows, ns) "
            f"{[(int(r), round(t)) for r, t in cost_table.samples[op]]}")
    t0 = time.perf_counter()
    cost_table.block_q, cost_table.block_t, raw = autotune.autotune(
        rungs, repeats=5)
    t_tune = time.perf_counter() - t0
    recording[0] = True
    for block, winners in (("block_q", cost_table.block_q),
                           ("block_t", cost_table.block_t)):
        for rung, win in sorted(winners.items()):
            times = ", ".join(f"{b}: {ns / 1e3:.3f} us"
                              for (k2, r2, b), ns in sorted(raw.items())
                              if k2 == block and r2 == rung)
            say(f"[calibrate] autotune {block} rung {rung}: winner {win} "
                f"threads; {times}")
    say(f"[calibrate] autotune {t_tune:.2f} s; every candidate's output "
        f"bit-equal to the first's")
    costmodel.activate(cost_table)
    cal_engine = Engine(index, cost_table=cost_table)
    held.update(dispatches=0, lanes=0)
    hold_to_eager(cal_engine, held)
    run_templates(cal_engine, "calibrate", held)
    scale = costmodel.refine_with_engine(cost_table, cal_engine, cal_probes)
    say(f"[calibrate] refine_with_engine over {len(cal_probes)} probes: "
        f"scale {scale:.4f}, dispatch floor "
        f"{cost_table.dispatch_floor_ns:.0f} ns")
    preds = [cal_engine.predict_cost_ns(cal_engine.plan(q)) for q, _ in stream]
    budget = SLO_DISPATCHES * float(np.median(preds))
    ssvc = QueryService(cal_engine, union=True, max_batch=64, slo_ns=budget,
                        auto_flush=False)
    held["on"] = True
    s_accepted = []
    for off in range(0, len(stream), SERVE_BURST):
        for i, (q, exp) in enumerate(stream[off: off + SERVE_BURST], off):
            req = ssvc.submit(q, tenant=who[i % len(who)])
            if not req.shed:
                s_accepted.append((req, exp))
        ssvc.flush()
    for req, exp in s_accepted:
        if not req.done or req.result is None:
            fail(f"SLO service: accepted request {req.rid} never completed")
        if not np.array_equal(req.result, exp):
            fail(f"SLO service: {req.query!r} answer differs from the "
                 "reference")
    slo_shed = sum(ts.shed_reasons.get("slo", 0)
                   for ts in ssvc.stats.tenants.values())
    say(f"[calibrate] SLO service over the calibrated engine: predicted cost "
        f"of phase 8's read stream median {np.median(preds):.0f} ns (min "
        f"{min(preds):.0f}, max {max(preds):.0f}); budget slo_ns "
        f"{budget:.0f} ns ({SLO_DISPATCHES} median requests); "
        f"{len(stream)} requests: {len(s_accepted)} accepted, all answers "
        f"equal the reference; {ssvc.stats.shed} shed, {slo_shed} of them by "
        f"the SLO")
    if slo_shed == 0:
        fail("SLO service: nothing was shed by the SLO gate")
    held["on"] = False
    say(f"[graphs] calibrate: {held['dispatches']} dispatches "
        f"({held['lanes']} lanes) of the calibrated engine and the SLO "
        f"service replayed at the tuned block sizes, each equal to the eager "
        f"walker")
    say(cache_line("calibrated engine", cal_engine))
    ckpt_root.mkdir(parents=True, exist_ok=True)
    table_path = str(ckpt_root / "costtable.json")
    cost_table.save(table_path)
    if costmodel.DeviceCostTable.load(table_path).to_json() \
            != cost_table.to_json():
        fail("cost table: the JSON round trip changed the table")
    say(f"[calibrate] the table's JSON round trip is equal "
        f"({Path(table_path).stat().st_size} bytes)")
    path_counts["calibrate"] = read_counts(
        "calibrate (calibrate + autotune + calibrated engine + SLO service)",
        ("sorted_member_mask", "expand_join_gather"))

    # ---- 12. lifecycle: save / restore / promote (counts to 0 before) -- #
    from repro_torch.checkpoint import committed_steps
    from repro_torch.core.index import CPQxIndex
    from repro_torch.core.lifecycle import restore_service

    zero_counts()
    idx_dir = str(ckpt_root / "index")
    t0 = time.perf_counter()
    index.save(idx_dir)
    t_isave = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = CPQxIndex.restore(idx_dir)
    torch.cuda.synchronize()
    t_iload = time.perf_counter() - t0
    for f in index.arrays._fields:
        if not torch.equal(getattr(restored.arrays, f), getattr(index.arrays, f)):
            fail(f"restored index: field {f} differs from the live index")
    if restored.seq_ranges != index.seq_ranges or restored.caps != index.caps:
        fail("restored index: seq_ranges or caps differ from the live index")
    r_engine = Engine(restored)
    for name in TEMPLATES:
        q, exp = per_template[name][0]
        got = r_engine.execute(q)
        if not np.array_equal(got, engine.execute(q)) \
                or not np.array_equal(got, exp):
            fail(f"restored index: {q!r} answer differs")
    say(f"[lifecycle] CPQx index: save {t_isave:.3f} s "
        f"({dir_bytes(idx_dir)} bytes on disk), CPQxIndex.restore on the card "
        f"{t_iload:.3f} s; all {len(index.arrays._fields)} fields torch.equal "
        f"to the live index; {len(TEMPLATES)} probes equal the live engine "
        f"and the reference (rebuild, phase 4: host estimate {t_caps:.2f} s "
        f"+ device {t_build:.3f} s)")
    del r_engine, restored
    wsvc.engine.cost_table = cost_table
    t0 = time.perf_counter()
    step1 = wsvc.checkpoint(svc_dir)
    t_ssave = time.perf_counter() - t0
    donor_mirror = wsvc.maintainer.export_state()
    donor_adapter = wsvc.adapter.export_state()
    t0 = time.perf_counter()
    replica = restore_service(svc_dir, union=True, max_batch=16,
                              auto_flush=False)
    torch.cuda.synchronize()
    t_sload = time.perf_counter() - t0
    if committed_steps(svc_dir) != [step0, step1]:
        fail(f"service checkpoint: committed steps {committed_steps(svc_dir)}")
    if replica.graph_epoch != wsvc.graph_epoch + 1:
        fail(f"replica epoch {replica.graph_epoch}, donor {wsvc.graph_epoch}")
    if replica.engine.cost_table is None \
            or replica.engine.cost_table.to_json() != cost_table.to_json():
        fail("replica: the calibrated table did not come over")
    for what, mine, theirs in (("mirror", replica.maintainer.export_state(),
                                donor_mirror),
                               ("adapter", replica.adapter.export_state(),
                                donor_adapter)):
        if mine.keys() != theirs.keys() or not all(
                np.array_equal(mine[k], theirs[k]) for k in mine):
            fail(f"replica: the {what} state differs from the donor's")
    check_answers(replica.engine, replica.maintainer.g, cal_probes,
                  "promoted replica")
    say(f"[lifecycle] write-path service: checkpoint with the calibrated "
        f"table as step {step1} in {t_ssave:.2f} s ({dir_bytes(svc_dir)} "
        f"bytes on disk for steps {committed_steps(svc_dir)}); "
        f"restore_service of a cold replica {t_sload:.2f} s (the mirror's "
        f"rebuild, phase 7: iaCPQx mirror {t_ia_mirror:.2f} s + a flush); "
        f"epoch {replica.graph_epoch} = donor's + 1; mirror and adapter "
        f"export_state equal the donor's; probes equal the reference")
    batch = update_batch(wsvc.maintainer.g, np.random.default_rng(13), MAINT_OPS)
    upd = {}
    for what, svc_ in (("donor", wsvc), ("replica", replica)):
        t0 = time.perf_counter()
        svc_.apply_updates(batch)
        svc_.flush()
        torch.cuda.synchronize()
        upd[what] = time.perf_counter() - t0
    if replica.maintainer.g.n_edges != wsvc.maintainer.g.n_edges:
        fail("replica and donor graphs differ after the update batch")
    for q in cal_probes:
        if not np.array_equal(replica.engine.execute(q), wsvc.engine.execute(q)):
            fail(f"after the update batch: {q!r} differs between replica "
                 "and donor")
    check_answers(replica.engine, replica.maintainer.g, cal_probes,
                  "promoted replica after the update batch")
    say(f"[lifecycle] one batch of {len(batch)} updates on donor and replica "
        f"(apply + flush: donor {upd['donor']:.2f} s, replica "
        f"{upd['replica']:.2f} s): flushed answers equal each other and the "
        f"reference")
    path_counts["lifecycle"] = read_counts(
        "lifecycle (restored index + promoted replica + update batch)",
        ("sorted_member_mask", "expand_join_gather"))
    costmodel.activate(None)
    del replica, wsvc, mia, ia_engine, ssvc, cal_engine  # mirrors: gigabytes

    # ---- 13. sharded: the phase-4 index on in-process shards ---------- #
    from repro_torch.core.backend import QueryCaps
    from repro_torch.core.distributed import ShardedBackend, make_mesh
    from repro_torch.core.sharded_index import gather_index, shard_index

    zero_counts()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sh_resident = torch.cuda.memory_allocated()
    t_sharded = time.perf_counter()
    for n in (1, SHARDS):
        t0 = time.perf_counter()
        sh = shard_index(index, n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        back = gather_index(sh, pair_cap=int(index.arrays.c2p_v.shape[0]))
        for f in back._fields:
            if not torch.equal(getattr(back, f), getattr(index.arrays, f)):
                fail(f"sharded: gather_index of {n} shards: field {f} differs "
                     "from the index")
        say(f"[sharded] shard_index at {n} shard(s): {dt:.2f} s; pair shard "
            f"cap {sh.pair_v.shape[1]}, c2p shard cap {sh.c2p_v.shape[1]}; "
            f"pair rows a shard {sh.pair_counts.tolist()}, I_c2p rows a shard "
            f"{sh.c2p_counts.tolist()}; gather_index gives back all 17 fields "
            f"torch.equal")
    del sh, back
    mesh = make_mesh(SHARDS)
    sh_engine = Engine(index, mesh=mesh)
    sh_ms = {}
    for name in TEMPLATES:
        for q, exp in per_template[name]:  # first pass: captures
            got = sh_engine.execute(q)
            if not np.array_equal(got, exp) \
                    or not np.array_equal(got, engine.execute(q)):
                fail(f"sharded {name} {q!r}: answer differs from the local "
                     "engine's or the reference")
        lat = []
        for q, exp in per_template[name]:
            t0 = time.perf_counter()
            got = sh_engine.execute(q)
            lat.append(time.perf_counter() - t0)
            if not np.array_equal(got, exp):
                fail(f"sharded {name} {q!r}: a second execute differs")
        sh_ms[name] = 1e3 * float(np.median(lat))
    say(f"[sharded] {sum(len(v) for v in per_template.values())} draws of "
        f"phase 5 through Engine(index, mesh=make_mesh({SHARDS})), twice: "
        f"every answer np.array_equal to the local engine's and the "
        f"scipy.sparse reference; execute median " + ", ".join(
            f"{n} {sh_ms[n]:.3f} ms (local "
            f"{cpqx_results[n]['execute_ms_median']:.3f})" for n in TEMPLATES))
    accepted = per_template["T"]
    t0 = time.perf_counter()
    batch = sh_engine.execute_batch([q for q, _ in accepted])
    t_batch = time.perf_counter() - t0
    for (q, exp), got in zip(accepted, batch):
        if not np.array_equal(got, exp):
            fail(f"sharded batch: {q!r} differs from the reference")
    retry_q, retry_exp = max(  # the largest answer, then the most classes
        (d for name in TEMPLATES for d in per_template[name]),
        key=lambda d: (len(d[1]), int(sh_engine.lookup_ranges(
            sh_engine.plan(d[0]))[:, 1].max(initial=0))))
    rungs_before = sh_engine.telemetry.retry_rungs
    got = sh_engine.execute(retry_q, caps=QueryCaps(2, 2, 4))
    climbed = sh_engine.telemetry.retry_rungs - rungs_before
    if not np.array_equal(got, retry_exp) or climbed == 0:
        fail(f"sharded overflow retry: {retry_q!r} climbed {climbed} rungs "
             "or answered wrongly")
    say(f"[sharded] one batch of {len(accepted)} T queries {t_batch:.3f} s, "
        f"equal to the reference; from caps (2, 2, 4) the largest answer "
        f"({len(retry_exp)} pairs) climbed {climbed} rungs to the exact "
        f"answer; telemetry {sh_engine.telemetry}")
    say(cache_line(f"sharded engine ({SHARDS} shards)", sh_engine))
    sh_dir = str(ckpt_root / "sharded")
    ckpt_root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    sh_engine.backend.save(sh_dir)
    t_shsave = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = ShardedBackend.restore(sh_dir, make_mesh(2))
    torch.cuda.synchronize()
    t_shload = time.perf_counter() - t0
    gathered = gather_index(sh_engine.backend.sharded)
    live = shard_index(CPQxIndex(
        k=index.k, n_vertices=index.n_vertices, arrays=gathered,
        seq_ranges=index.seq_ranges, caps=index.caps), 2)
    for f in live._fields:
        if not torch.equal(getattr(two.sharded, f), getattr(live, f)):
            fail(f"sharded restore at 2 shards: leaf {f} differs from a live "
                 "reshard")
    same_as_index = all(torch.equal(a, b) for a, b in
                        zip(two.sharded, shard_index(index, 2)))
    two_engine = Engine(index, mesh=two.mesh)
    two_engine.backend = two
    for name in TEMPLATES:
        q, exp = per_template[name][0]
        if not np.array_equal(two_engine.execute(q), exp):
            fail(f"sharded restore at 2 shards: {q!r} answer differs")
    say(f"[sharded] save of the {SHARDS}-shard backend {t_shsave:.3f} s "
        f"({dir_bytes(sh_dir)} bytes on disk); restore at 2 shards "
        f"{t_shload:.3f} s: every leaf torch.equal to a live reshard "
        f"(gather_index -> shard_index at 2)"
        f"{' and to shard_index(index, 2)' if same_as_index else ''}; "
        f"one draw a template through it equal to the reference")
    torch.cuda.synchronize()
    say(f"[sharded] peak device memory of the phase "
        f"{(torch.cuda.max_memory_allocated() - sh_resident) / 2**30:.3f} GiB "
        f"above {sh_resident / 2**30:.3f} GiB resident; "
        f"{time.perf_counter() - t_sharded:.1f} s")
    path_counts["sharded"] = read_counts(
        f"sharded (shard_index, {SHARDS}-shard engine, batch, retry, restore)",
        ("sorted_member_mask", "expand_join_gather"))
    del sh_engine, two_engine, two, live, gathered
    shutil.rmtree(ckpt_root)
    torch.cuda.empty_cache()

    # ---- 14. edge_softmax at the GNN shapes (counts to 0 just before) -- #
    zero_counts()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    sm_inputs = []
    for name, e, d, n in SOFTMAX_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (3 * torch.randn(e, d, generator=gen, device=dev)).to(dtype)
            seg = torch.randint(0, n, (e,), generator=gen, device=dev,
                                dtype=torch.int32)
            got = edge_softmax(x, seg, n)
            exp = ref.segment_softmax(x, seg, n)
            torch.cuda.synchronize()
            tol = SOFTMAX_TOL[str(dtype).replace("torch.", "")]
            # the sums' atomics differ run to run in the last bits: the
            # tolerance covers it
            if got.shape != x.shape or got.dtype != dtype \
                    or not bool(torch.isfinite(got).all()) \
                    or not torch.allclose(got.float(), exp.float(), rtol=tol,
                                          atol=tol):
                fail(f"edge_softmax {name} {dtype}: wrong shape/type, not "
                     f"finite, or off its plain version beyond {tol}")
            sm_inputs.append((name, x, seg, n))
    say(f"[edge_softmax] {len(sm_inputs)} calls at {SOFTMAX_CASES} "
        f"(float32, bfloat16): finite, within {SOFTMAX_TOL} of the plain "
        f"version")
    path_counts["edge_softmax"] = read_counts("edge_softmax (GNN substrate)",
                                              ("segment_softmax",))

    # ---- 15. cluster: worker processes on the card ------------------- #
    # The cluster path's launches are the workers', reported at each
    # CHECKPOINT barrier (cluster_phase); the coordinator's counts are set
    # to 0 too, its local-engine comparisons are not the path.
    zero_counts()
    path_counts["cluster"] = cluster_phase(
        index, lambda: cindex.build(g, K, caps=caps), per_template, engine,
        kind, ckpt_root / "cluster", who)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    for name, fn in real.items():
        setattr(ops, name, fn)
    counts = {name: sum(c[name] for c in path_counts.values()) for name in KERNELS}
    say(f"[paths] kernel launches summed over the paths: {counts}")

    # ---- kernels on the index's arrays and on the paths' inputs ------- #
    err["sorted_member_mask"] = max(err["sorted_member_mask"], check_parity(
        "sorted_member_mask", sorted_intersect.sorted_member_mask,
        ref.sorted_member_mask,
        index_member_cases(index, dev, rng) + [recorded["sorted_member_mask"][1]]))
    err["expand_join_gather"] = max(err["expand_join_gather"], check_parity(
        "expand_join_gather", expand_join.expand_join_gather,
        ref.expand_join_gather,
        index_join_cases(index, dev) + [recorded["expand_join_gather"][1]]))
    err["fingerprint_rows"] = max(err["fingerprint_rows"], check_parity(
        "fingerprint_rows", fingerprint.fingerprint_rows, ref.fingerprint_rows,
        [recorded["fingerprint_rows"][1]]))
    say("[parity] on the built index's l2c/class_starts/c2p arrays and on the "
        "paths' largest inputs: bit-exact (tolerance 0)")
    softmax_err = check_softmax_parity(
        segment_softmax.segment_normalize, ref.segment_normalize,
        ref.segment_tables, [(x, seg, n) for _, x, seg, n in sm_inputs])
    err["segment_softmax"] = max(err["segment_softmax"], *softmax_err.values())
    say(f"[parity] segment_softmax on the edge_softmax path's inputs, on the "
        f"same table: bit-exact (tolerance 0), max abs err {softmax_err}")

    def member_work(hay, cnt, q):
        lanes, n_hay = hay.shape
        n_q = q.shape[1]
        # the same function as one library call: lane-tagged int64 keys
        tag = torch.arange(lanes, device=dev, dtype=torch.int64)[:, None] << 32
        live = torch.arange(n_hay, device=dev)[None, :] < cnt[:, None]
        hay_keys = torch.where(live, tag + hay.long(), -1).reshape(-1)
        q_keys = (tag + q.long()).reshape(-1)
        lib = torch.isin(q_keys, hay_keys).reshape(lanes, n_q).int()
        if not torch.equal(lib, ref.sorted_member_mask(hay, cnt, q)):
            fail("torch.isin yardstick disagrees with sorted_member_mask")
        bytes_ = 4 * (lanes * n_hay + lanes + 2 * lanes * n_q)
        ops_ = lanes * n_q * 4 * max(1, n_hay.bit_length())
        return (bytes_, ops_, lambda: torch.isin(q_keys, hay_keys),
                f"B={lanes} n_hay={n_hay} n_q={n_q}")

    def gather_work(ends, lo, pay, b_v, b_u, total, cap):
        lanes, n_a = ends.shape
        rows = int(total.clamp(max=cap).sum())  # build rows this data reads
        bytes_ = 4 * (3 * lanes * n_a + lanes + 2 * rows + 3 * lanes * cap)
        ops_ = lanes * cap * 4 * max(1, n_a.bit_length())
        return (bytes_, ops_, None, f"B={lanes} n_a={n_a} n_b={b_v.shape[0]} "
                f"out_capacity={cap} rows={rows}")

    def fingerprint_work(cols, salt):
        n, k = cols[0].shape[0], len(cols)
        bytes_ = 4 * k * n + 16 * n  # k int32 columns in, two int64 lanes out
        ops_ = n * k * 2 * 12  # per column and lane: ~12 uint32 operations
        return (bytes_, ops_, None, f"n={n} k={k} salt={salt}")

    def softmax_work(x, seg, table, eps):
        e, d = x.shape
        n = table.shape[0]
        # scores in, out written, one id a row, the (N, D, 2) float32 table
        bytes_ = 2 * x.numel() * x.element_size() + 4 * e + 2 * 4 * n * d
        ops_ = 20 * e * d  # subtract, exp, add, divide: ~20 float operations
        return (bytes_, ops_, None,
                f"E={e} D={d} N={n} {str(x.dtype).replace('torch.', '')}")

    work_of = {"sorted_member_mask": member_work,
               "expand_join_gather": gather_work,
               "fingerprint_rows": fingerprint_work,
               "segment_softmax": softmax_work}

    def timed(name, args, where):
        bytes_, ops_, lib_fn, shape = work_of[name](*args)
        ms = device_ms(lambda: kernel_fns[name](*args))
        plain_ms = device_ms(lambda: plain_fns[name](*args))
        lib_ms = device_ms(lib_fn) if lib_fn is not None else None
        call_ms = cuda_ms(lambda: kernel_fns[name](*args))
        t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
        t_ops = 1e3 * ops_ / INT_OPS_PER_S
        if ms < max(t_bytes, t_ops):  # below the bound: a lossy trace
            say(f"[kernels] {name} at {where}: the profiler's {ms:.5f} ms is "
                f"below the bound, so it lost events; the time a call between "
                f"CUDA events, host included, is kept instead")
            ms = call_ms
        say(f"[kernels] {name} at {where} {shape}: kernel {ms:.5f} ms on the "
            f"device ({call_ms:.4f} ms a call, host included), plain "
            f"{plain_ms:.5f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'}, bound "
            f"{max(t_bytes, t_ops):.5f} ms ({bytes_} bytes, {ops_} operations)")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms)

    softmax_rec = None
    for name, x, seg, n in sm_inputs:
        table = ref.segment_tables(x, seg, n)
        rec = timed("segment_softmax", (x, seg, table, 1e-9), name)
        whole_dev = device_ms(lambda: ops.segment_softmax(x, seg, n))
        whole_call = cuda_ms(lambda: ops.segment_softmax(x, seg, n))
        tables_dev = device_ms(lambda: ref.segment_tables(x, seg, n))
        say(f"[kernels] segment_softmax at {name}: the whole function "
            f"(reductions into the packed table + kernel) {whole_dev:.5f} ms "
            f"on the device, {whole_call:.4f} ms a call; the reductions alone "
            f"{tables_dev:.5f} ms (they write the packed table in place: no "
            f"packing pass)")
        if softmax_rec is None or x.numel() * x.element_size() > softmax_rec[0]:
            softmax_rec = (x.numel() * x.element_size(), rec)
        del table

    out = []
    for name, (src, replaces) in KERNELS.items():
        if name == "segment_softmax":  # its path's largest call, timed above
            rec = softmax_rec[1]
        else:
            rec = timed(name, recorded[name][1], "the paths' largest call")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[name],
                    "max_abs_err": err[name], **rec})
    for name, block, fn in (
            ("sorted_member_mask", "block_q", sorted_intersect.sorted_member_mask),
            ("expand_join_gather", "block_t", expand_join.expand_join_gather)):
        args = recorded[name][1]
        n = args[2].shape[1] if name == "sorted_member_mask" else args[6]
        win = ops._threads(getattr(cost_table, block), n, 256)
        t_win = device_ms(lambda: fn(*args, threads=win))
        t_256 = device_ms(lambda: fn(*args))
        say(f"[kernels] {name} at the paths' largest call: the calibrated "
            f"table's {block} gives {win} threads a block at this call's "
            f"rung: {t_win:.5f} ms; at 256 threads {t_256:.5f} ms")
    timed("sorted_member_mask", index_member_cases(index, dev, rng)[0],
          "the index's 16 largest class lists")
    for where, (hay, cnt, q) in [("the paths' largest call",
                                  recorded["sorted_member_mask"][1])] + [
            (f"the budget's {path} side", c) for path, c in member_budget[1:]]:
        if where != "the paths' largest call":
            timed("sorted_member_mask", (hay, cnt, q), where)
        both = {}
        for path, nbytes in (("staged", 4 * hay.shape[1]), ("in place", 0)):
            if nbytes <= 48 * 1024:  # the most the kernel stages
                flags = torch.empty_like(q)
                both[path] = device_ms(lambda: sorted_intersect.launch(
                    hay, cnt, q, flags, nbytes))
                if not torch.equal(flags, ref.sorted_member_mask(hay, cnt, q)):
                    fail(f"sorted_member_mask {path} at {where}: differs from "
                         "its plain version")
        say(f"[kernels] sorted_member_mask at {where} B={hay.shape[0]} "
            f"n_hay={hay.shape[1]} n_q={q.shape[1]}, both paths of the kernel "
            f"on the same input (the plan takes "
            f"{sorted_intersect.launch_plan(hay.shape[1])[0]}): "
            + ", ".join(f"{k} {v:.5f} ms" for k, v in both.items()))
    timed("expand_join_gather", index_join_cases(index, dev)[0],
          "the index's 16 largest class lists")

    # where a query's time goes: device busy share of execute, replayed
    # graphs and the eager walker in turns
    for name in ("T", "C4"):
        qs = [q for q, _ in per_template[name]]
        for what, eng in (("replayed", engine), ("eager", eager),
                          ("replayed", engine)):
            wall, busy, top, _ = busy_share(
                lambda: eager_launches(lambda: [eng.execute(q) for q in qs])
                if eng is eager else [eng.execute(q) for q in qs])
            say(f"[profile] execute x{len(qs)} {name} ({what}): wall "
                f"{wall / len(qs):.3f} ms a query, device busy "
                f"{busy / len(qs):.3f} ms a query ({100 * busy / wall:.1f}%); "
                f"top kernels {top}")

    # where a build's device time goes (capacities given: no host estimate)
    for what, fn in (
            ("CPQx", lambda: cindex.build(g, K, caps=caps)),
            ("iaCPQx", lambda: interest.build_interest(g, K, ints, caps=caps))):
        wall, busy, top, fp_ms = busy_share(fn, match="fingerprint")
        say(f"[profile] {what} build of gmark_citation({N_VERTICES}): wall "
            f"{wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / wall:.1f}%), "
            f"fingerprint_rows {fp_ms:.4f} ms; top kernels {top}")

    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(smi_line)
    say(json.dumps({"kernels": out}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
