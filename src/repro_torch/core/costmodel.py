"""Self-calibrating device cost model — the pricing half of the
pricing-to-silicon loop, on the port's operators and CUDA kernels.

The host half (:class:`OpCost`, :func:`fit_affine`, :class:`DeviceCostTable`
with its pricing, refinement and JSON / uint8-leaf codecs, and
:func:`ladder_rungs`) is a copy of the reference package's
``core/costmodel.py``, so one table format serves both packages: a table
written by either loads in the other.  The device half times the port's
``LocalOps`` operators on the card (:func:`calibrate`) and installs the
block winners of ``kernels.autotune`` into ``kernels/ops.py``
(:func:`activate`).

The optimizer's row-count objective (``core.optimizer``) is exact about
*sizes* but silent about what the device actually charges: every plan
stage — a LOOKUP, a materialization, a join — pays a fixed dispatch/
launch constant on top of its per-row work, and at CI scale those
constants dominate (ROADMAP's ``C4`` case: the 3-leaf split that wins on
rows loses 0.3–0.6x on wall-clock to per-stage overhead).  PathFinder
(arxiv 2306.02194) makes the same observation for vectorized RPQ
engines: cardinality-optimal plans lose to operator-constant-aware ones.

This module closes the loop with a :class:`DeviceCostTable` — a small
versioned JSON artifact holding

* **per-operator affine stage constants** ``cost_ns(op, rows) = fixed +
  per_row * rows`` for every :class:`~repro_torch.core.backend.PlanOps`
  operator (lookup / materialize / conjoin / join / identity) plus the
  union executable's per-step overhead, fitted by least squares from the
  micro-calibration harness (:func:`calibrate`) which times each
  operator at a grid of capacity rungs;
* **autotuned kernel block sizes** per capacity rung — the winners of
  :mod:`repro_torch.kernels.autotune`'s sweep (threads a CUDA block),
  read back by ``kernels/ops.py`` once the table is :func:`activate`\\ d;
* a **global calibration scale** corrected online: real traffic
  (:func:`refine_with_engine`, driven by ``Engine.telemetry``) and the
  CI ``BENCH_*.json`` trajectory (:func:`DeviceCostTable.
  refine_from_trajectory` — calibrated bench rows carry their
  ``predicted_ns``) both blend measured-vs-predicted ratios into the
  synthetic fit, so every bench run is training data for the next one.

The table is *advisory by construction*: the optimizer only consults it
through :meth:`DeviceCostTable.stage_ns`, and with no table present the
row-count model is the exact fallback — plans are byte-identical to the
pre-table golden snapshots, and a wrong table can only change
capacities/plan choice, never answers (the overflow ladder's contract,
see ``core.backend``).

Consumers: ``optimizer.estimate_plan``/``optimize_query`` (cost_ns
channel), ``Engine.estimate_caps`` (minimal expected-cost rung
selection), ``kernels/ops.py`` (tuned block sizes), and
``core.lifecycle`` (the table rides service checkpoints as one uint8
leaf).  The port has no VMEM-style size ceiling: ``vmem_words`` is only
carried through the codecs, and :func:`calibrate` writes None there.

The table itself is numpy + json only; torch is imported inside the
calibration harness.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re

import numpy as np

#: JSON artifact format version — bumped on incompatible layout changes;
#: :meth:`DeviceCostTable.from_json` rejects unknown majors.
FORMAT_VERSION = 1

#: The plan-stage operators the calibration grid times.  ``union_step``
#: prices ONE step of the union executable's opcode program (every step
#: evaluates all candidate operators — see ``core.backend``).
OPERATORS = ("lookup", "materialize", "conjoin", "join", "identity",
             "union_step")


def _pow2(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


# ---------------------------------------------------------------------- #
# affine stage constants
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class OpCost:
    """One operator's affine cost: fixed dispatch/launch constant plus a
    per-row slope, both in nanoseconds (rows = the operator's *capacity*
    — relations are capacity-padded, so device work scales with the
    rung, not the live row count)."""

    fixed_ns: float
    per_row_ns: float

    def ns(self, rows: float) -> float:
        return self.fixed_ns + self.per_row_ns * max(0.0, float(rows))


def fit_affine(rows, times_ns) -> OpCost:
    """Least-squares affine fit ``t = a + b * rows`` with both
    coefficients clamped non-negative (a negative dispatch constant or
    slope is always measurement noise, and would let the optimizer
    price work below zero)."""
    r = np.asarray(rows, np.float64).ravel()
    t = np.asarray(times_ns, np.float64).ravel()
    if r.size == 0:
        return OpCost(0.0, 0.0)
    if r.size == 1 or np.ptp(r) == 0:
        return OpCost(float(max(0.0, t.mean())), 0.0)
    design = np.stack([np.ones_like(r), r], axis=1)
    (a, b), *_ = np.linalg.lstsq(design, t, rcond=None)
    if b < 0.0:  # slope noise: all mass into the constant
        return OpCost(float(max(0.0, t.mean())), 0.0)
    if a < 0.0:  # constant noise: pure per-row fit through the origin
        b = float((r @ t) / (r @ r))
        return OpCost(0.0, max(0.0, b))
    return OpCost(float(a), float(b))


# ---------------------------------------------------------------------- #
# the device cost table
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class DeviceCostTable:
    """Fitted stage constants + autotuned kernel block sizes for ONE
    device kind — the shared artifact the optimizer, the capacity
    estimator and the kernels all read.

    ``scale`` is the online-refinement knob: synthetic micro-benchmarks
    overstate fused in-plan stage costs (each is timed as its own
    dispatch), so measured-vs-predicted ratios from real traffic blend
    into this single multiplier (geometric EMA) instead of re-fitting
    every constant from sparse data.
    """

    device_kind: str = "cpu"
    version: int = FORMAT_VERSION
    scale: float = 1.0
    dispatch_floor_ns: float = 0.0  # telemetry-refined per-dispatch floor
    ops: dict = dataclasses.field(default_factory=dict)  # name -> OpCost
    block_q: dict = dataclasses.field(default_factory=dict)  # rung -> block
    block_t: dict = dataclasses.field(default_factory=dict)  # rung -> block
    vmem_words: int | None = None
    samples: dict = dataclasses.field(default_factory=dict)  # name -> [[rows, ns]]

    # ---- pricing (what the optimizer calls) ---- #

    def stage_ns(self, op: str, rows: float) -> float:
        """Price one plan stage: ``scale * (fixed + per_row * rows)``.
        Unknown operators price as zero — an old table stays usable when
        a new operator kind appears."""
        c = self.ops.get(op)
        if c is None:
            return 0.0
        return self.scale * c.ns(rows)

    def plan_dispatch_ns(self, cap: int) -> float:
        """Rough cost of one whole-plan dispatch at pair capacity
        ``cap`` — the capacity-proportional work of the dominant pair-
        space stages plus the telemetry-refined floor.  Used only to
        *compare rungs* in ``Engine.estimate_caps``, so the absolute
        level cancels; the shape (fixed + linear-in-cap) is what
        matters."""
        return max(self.dispatch_floor_ns,
                   self.stage_ns("join", cap) + self.stage_ns("materialize", cap))

    def expected_dispatch_ns(self, cap: int, est_rows: float,
                             risky: bool) -> float:
        """Expected cost of *starting* the ladder at ``cap``: the run at
        this rung plus the overflow-risk-weighted retry at the next.
        Risk decays with headroom (cap / estimate); join-bearing plans
        (``risky``) carry estimate error, conjunction bounds are sound,
        so their risk constants differ (mirroring the headroom split the
        stats-only estimator uses)."""
        risk0 = 1.0 if risky else 0.25
        p = min(1.0, risk0 * max(1.0, float(est_rows)) / max(1, cap))
        return self.plan_dispatch_ns(cap) + p * self.plan_dispatch_ns(2 * cap)

    # ---- autotuned kernel blocks ---- #

    def tuned_block(self, kind: str, rung: int) -> int | None:
        """Winner block for ``kind`` in {"block_q", "block_t"} at the
        smallest tuned rung >= ``rung`` (capacities quantize onto the
        pow2 ladder, so the next rung up is the right neighbor); None
        when nothing relevant was tuned."""
        table = self.block_q if kind == "block_q" else self.block_t
        if not table:
            return None
        geq = [r for r in table if r >= rung]
        return table[min(geq)] if geq else table[max(table)]

    # ---- online refinement ---- #

    def observe(self, op: str, rows: float, ns: float) -> None:
        """Append one real measurement to the operator's sample set (the
        raw training data every calibration run extends)."""
        self.samples.setdefault(op, []).append([float(rows), float(ns)])

    def refit(self, op: str) -> OpCost:
        """Re-fit one operator's constants from its full sample set."""
        pts = np.asarray(self.samples.get(op, []), np.float64).reshape(-1, 2)
        cost = fit_affine(pts[:, 0], pts[:, 1])
        self.ops[op] = cost
        return cost

    def refine_scale(self, measured_ns: float, predicted_ns: float,
                     weight: float = 0.5) -> float:
        """Blend one measured-vs-predicted ratio into the global scale
        (geometric EMA — ratios are multiplicative).  Non-positive
        inputs are ignored; the scale is clamped to [1/64, 64] so one
        corrupt bench row cannot zero the model."""
        if measured_ns <= 0.0 or predicted_ns <= 0.0:
            return self.scale
        ratio = measured_ns / predicted_ns
        new = self.scale * math.exp(weight * math.log(ratio))
        self.scale = float(min(64.0, max(1.0 / 64.0, new)))
        return self.scale

    def refine_from_telemetry(self, telemetry, elapsed_ns: float,
                              weight: float = 0.5) -> float:
        """Correct the per-dispatch floor from an engine's lifetime
        counters: ``elapsed_ns / dispatches`` is the average real
        dispatch (retry rungs included — they are real traffic too).
        ``telemetry`` is any object with a ``dispatches`` attribute
        (an :class:`~repro_torch.core.engine.LadderTelemetry` or a snapshot)."""
        n = int(getattr(telemetry, "dispatches", 0))
        if n <= 0 or elapsed_ns <= 0.0:
            return self.dispatch_floor_ns
        avg = elapsed_ns / n
        self.dispatch_floor_ns = float(
            (1.0 - weight) * self.dispatch_floor_ns + weight * avg)
        return self.dispatch_floor_ns

    def refine_from_trajectory(self, payloads, weight: float = 0.25) -> int:
        """Consume CI ``BENCH_*.json`` payloads: every row whose
        ``derived`` carries a ``predicted_ns=...`` tag (the calibrated
        bench legs emit them) contributes its measured ``us_per_call``
        against that prediction.  Returns the number of rows consumed.

        This is the trajectory half of the refinement loop: the table
        that planned run N is corrected by run N's measurements before
        pricing run N+1."""
        used = 0
        for payload in payloads:
            for row in payload.get("rows", []):
                m = re.search(r"predicted_ns=([0-9.eE+\-]+)",
                              row.get("derived", ""))
                if not m:
                    continue
                predicted = float(m.group(1))
                measured = float(row.get("us_per_call", 0.0)) * 1e3
                self.refine_scale(measured, predicted, weight=weight)
                used += 1
        return used

    # ---- JSON artifact codec ---- #

    def to_json(self) -> dict:
        return {
            "format": "cpqx-cost-table",
            "version": self.version,
            "device_kind": self.device_kind,
            "scale": self.scale,
            "dispatch_floor_ns": self.dispatch_floor_ns,
            "ops": {k: [v.fixed_ns, v.per_row_ns]
                    for k, v in sorted(self.ops.items())},
            "block_q": {str(r): b for r, b in sorted(self.block_q.items())},
            "block_t": {str(r): b for r, b in sorted(self.block_t.items())},
            "vmem_words": self.vmem_words,
            "samples": {k: v for k, v in sorted(self.samples.items())},
        }

    @classmethod
    def from_json(cls, payload: dict) -> "DeviceCostTable":
        if payload.get("format") != "cpqx-cost-table":
            raise ValueError(f"not a cost table: {payload.get('format')!r}")
        if int(payload.get("version", -1)) > FORMAT_VERSION:
            raise ValueError(f"cost table version {payload['version']} is "
                             f"newer than supported {FORMAT_VERSION}")
        return cls(
            device_kind=str(payload.get("device_kind", "cpu")),
            version=int(payload.get("version", FORMAT_VERSION)),
            scale=float(payload.get("scale", 1.0)),
            dispatch_floor_ns=float(payload.get("dispatch_floor_ns", 0.0)),
            ops={k: OpCost(float(a), float(b))
                 for k, (a, b) in payload.get("ops", {}).items()},
            block_q={int(r): int(b)
                     for r, b in payload.get("block_q", {}).items()},
            block_t={int(r): int(b)
                     for r, b in payload.get("block_t", {}).items()},
            vmem_words=(None if payload.get("vmem_words") is None
                        else int(payload["vmem_words"])),
            samples={k: [[float(r), float(t)] for r, t in v]
                     for k, v in payload.get("samples", {}).items()},
        )

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "DeviceCostTable":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    # ---- checkpoint codec (core.lifecycle) ---- #

    def export_state(self) -> np.ndarray:
        """The table as ONE uint8 leaf (UTF-8 JSON) — checkpoints are
        flat pytrees of numpy arrays, and the table is small."""
        blob = json.dumps(self.to_json(), sort_keys=True).encode("utf-8")
        return np.frombuffer(blob, dtype=np.uint8).copy()

    @classmethod
    def from_state(cls, leaf: np.ndarray) -> "DeviceCostTable":
        blob = np.asarray(leaf, np.uint8).tobytes().decode("utf-8")
        return cls.from_json(json.loads(blob))


def activate(table: DeviceCostTable | None) -> None:
    """Install (or, with None, uninstall) the table's kernel-facing half
    — the tuned block sizes — into ``repro_torch.kernels.ops``.  Pricing
    stays explicit (tables are passed to engines); the kernels are called
    from inside the plan walker, so their tuning rides a process-wide
    registry.  Raises on a winner that no CUDA block can take."""
    from ..kernels import ops as kops

    if table is None:
        kops.set_tuned_blocks(None, None)
        return
    kops.set_tuned_blocks(dict(table.block_q), dict(table.block_t))


# ---------------------------------------------------------------------- #
# micro-calibration harness (torch; times the port's device operators)
# ---------------------------------------------------------------------- #

#: Default capacity-rung grid for the synthetic fit; callers pass the
#: engine's real caps-ladder rungs when they have one (``ladder_rungs``).
DEFAULT_RUNGS = (256, 1024, 4096)


def ladder_rungs(engine, queries=(), max_rungs: int = 4) -> list[int]:
    """The pow2 capacity rungs this engine actually starts plans at:
    the estimated ``pair_cap`` of each probe query plus the worst-case
    default — the grid the calibration and the block-size sweeps key
    on, so the table prices the rungs real traffic dispatches."""
    from .query import plan_shape

    rungs = {int(engine._default_caps.pair_cap)}
    for q in queries:
        plan = engine.plan(q)
        caps = engine.estimate_caps(engine.lookup_ranges(plan),
                                    plan_shape(plan),
                                    plan if engine.optimize else None)
        rungs.add(int(caps.pair_cap))
    out = sorted(rungs)
    if len(out) > max_rungs:  # keep the extremes, thin the middle
        step = max(1, len(out) // max_rungs)
        middle = sorted(set(out[::step]) - {out[0], out[-1]})
        # the reference cuts sorted(keep)[:max_rungs], which can drop the
        # largest rung (the worst-case default); the port keeps it
        out = [out[0]] + middle[: max(0, max_rungs - 2)] + [out[-1]]
    return out


def _time_ns(fn, repeats: int, warmup: int = 1) -> float:
    """Median host wall-clock nanoseconds of ``fn`` (which synchronizes
    the device itself): launch included, on purpose."""
    import time

    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e9)
    return float(np.median(ts))


def calibrate(rungs=None, repeats: int = 3, n_vertices: int = 1 << 16,
              device_kind: str | None = None,
              device=None) -> DeviceCostTable:
    """Time every :class:`~repro_torch.core.backend.PlanOps` operator at a
    grid of capacity rungs against synthetic rung-sized index arrays and
    fit the per-operator affine stage constants, on the CUDA card unless
    ``device`` names another.

    Synthetic arrays (one pair per class, ids ascending) make every
    operator's input exactly rung-sized, so the fit sees a clean
    (capacity -> wall-clock) signal; what the constants *mean* on real
    plans is corrected afterwards by the refinement passes
    (:func:`refine_with_engine` / :meth:`DeviceCostTable.
    refine_from_trajectory`).  On the card each operator is captured in
    a CUDA graph, as the engine's executables are, and a timing is the
    host wall clock around one replay ended by ``torch.cuda.synchronize()``
    — the counterpart of the reference's timing of one ``jax.jit`` call,
    dispatch included on purpose, since the dispatch is exactly what the
    row-count model cannot see.  On the CPU the operator runs eagerly.
    The union step is priced by differencing a 6-step and a 2-step
    program, each one executable.  ``device_kind`` defaults to
    ``torch.cuda.get_device_name`` (``"cpu"`` on the CPU)."""
    import torch

    from . import relational as R
    from .backend import (OP_CONJ_ID, OP_LOOKUP, LocalOps, QueryCaps,
                          run_union_batch, union_tables)
    from .executables import CapturedGraph
    from .index import DeviceIndexArrays, resolve_device

    dev = resolve_device(device)
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else dev.type)
    table = DeviceCostTable(device_kind=device_kind, vmem_words=None)
    rungs = sorted(int(r) for r in (rungs or DEFAULT_RUNGS))

    def time_ns(fn, inputs) -> float:
        """Median ns of one ``fn(*inputs)``: a replay of its graph on the
        card (in a pool of its own, freed with it), the eager call on the
        CPU."""
        if dev.type == "cuda":
            graph = CapturedGraph(fn, inputs)
            return _time_ns(lambda: (graph.replay(),
                                     torch.cuda.synchronize(dev)), repeats)
        return _time_ns(lambda: fn(*inputs), repeats)

    def arrays_for(r: int) -> DeviceIndexArrays:
        """Synthetic index: r classes of one pair each, sorted ids."""
        ar = torch.arange(r, dtype=R.I32, device=dev)
        fields = dict.fromkeys(DeviceIndexArrays._fields)
        fields.update(
            l2c_cls=ar, class_starts=torch.arange(r + 1, dtype=R.I32,
                                                  device=dev),
            c2p_v=ar, c2p_u=ar,
            class_cyclic=torch.ones((r,), dtype=R.I32, device=dev))
        for f, v in fields.items():
            if v is None:  # leaves the walker never touches
                fields[f] = torch.zeros((1,), dtype=R.I32, device=dev)
        return DeviceIndexArrays(**fields)

    def i32(x):
        return torch.full((1,), x, dtype=R.I32, device=dev)

    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    tables = union_tables(dev)
    for r in rungs:
        ops = LocalOps(arrays_for(r), min(n_vertices, r))
        ids = torch.arange(r, dtype=R.I32, device=dev)[None]
        count, start = i32(r), i32(0)
        timed = {
            "lookup": (lambda s, n, _o=ops, _r=r:
                       (_o.lookup_classes(s, n, _r).cols[0],), (start, count)),
            "materialize": (lambda a, n, _o=ops, _r=r: (_o.materialize(
                R.Relation((a,), n, no), _r).cols[0],), (ids, count)),
            "conjoin": (lambda a, n, _o=ops: (_o.conj_classes(
                R.Relation((a,), n, no), R.Relation((a,), n, no)).cols[0],),
                (ids, count)),
            "join": (lambda a, n, _o=ops, _r=r: (_o.join_pairs(
                R.Relation((a, a), n, no), R.Relation((a, a), n, no),
                2 * _r, _r).cols[0],), (ids, count)),
            "identity": (lambda n, _o=ops, _r=r:
                         (_o.identity_pairs(_r, 1).cols[0],), (count,)),
        }
        for op, (fn, inputs) in timed.items():
            table.observe(op, r, time_ns(fn, inputs))

        # union-program step overhead: a T-step vs T'-step program of the
        # same shape isolates the per-step price (every step evaluates
        # all candidate operators — see core.backend)
        caps = QueryCaps(class_cap=_pow2(r), pair_cap=_pow2(r),
                         join_cap=2 * _pow2(r))
        union_ops = LocalOps(arrays_for(_pow2(r)), min(n_vertices, r))
        per_lane = {}
        for steps in (2, 6):
            opc = np.full((1, steps), OP_CONJ_ID, np.int32)
            opc[0, 0] = OP_LOOKUP
            rng_rows = np.zeros((1, steps, 2), np.int32)
            rng_rows[0, 0] = (0, r)
            per_lane[steps] = time_ns(
                lambda o, g, _u=union_ops, _c=caps: (run_union_batch(
                    _u, _c, 2, o, g, tables)[0].cols[0],),
                (torch.as_tensor(opc, device=dev),
                 torch.as_tensor(rng_rows, device=dev)))
        per_step = max(0.0, (per_lane[6] - per_lane[2]) / 4.0)
        table.observe("union_step", r, per_step)

    for op in OPERATORS:
        table.refit(op)
    return table


def refine_with_engine(table: DeviceCostTable, engine, queries,
                       repeats: int = 3, weight: float = 0.5) -> float:
    """Online refinement against REAL plans: execute each probe query on
    ``engine``, compare measured wall-clock to the table's predicted
    ``cost_ns``, and blend the ratios into ``table.scale``; the engine's
    :class:`~repro_torch.core.engine.LadderTelemetry` corrects the
    dispatch floor from the same traffic.  Returns the refined scale.
    (``Engine.execute`` returns host arrays, so each measurement ends
    with the device idle.)

    Synthetic micro-benchmarks time each operator as its own dispatch,
    which overstates fused in-plan stage costs — one multiplicative
    correction from end-to-end measurements fixes the level while the
    fitted *ratios* between operators (the part that orders plans) keep
    their synthetic precision."""
    from .optimizer import estimate_plan

    total_ns = 0.0
    before = engine.telemetry.snapshot()
    for q in queries:
        plan = engine.plan(q)
        predicted = estimate_plan(plan, engine.stats, cost_table=table).cost_ns
        measured = _time_ns(lambda _q=q: engine.execute(_q), repeats)
        total_ns += measured * repeats
        if predicted > 0.0:
            table.refine_scale(measured, predicted, weight=weight)
    after = engine.telemetry.snapshot()
    delta = dataclasses.replace(
        after, dispatches=after.dispatches - before.dispatches)
    table.refine_from_telemetry(delta, total_ns)
    return table.scale
