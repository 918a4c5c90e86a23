"""Workload-driven interest mining — the adaptive half of iaCPQx.

The paper's interest-aware index (Sec. V) assumes the interest set L_q
is *given*; this module closes the loop from the traffic the serving
layer actually sees back to that set, so an iaCPQx deployment tunes
itself: hot label sequences get indexed (one LOOKUP instead of an
expansion-join chain), cold ones get dropped (the index stays a fraction
of full CPQx).  Workload-adaptivity is where path indexes meet practice
— engines evaluate whatever path shapes traffic sends (PathFinder,
arXiv:2306.02194) — and every moving part it needs already exists:
``QueryService`` sees every AST, ``MaintainableIndex`` applies live
interest updates, and the optimizer's cost model prices a sequence's
evaluation with and without its index entry.  Three pieces:

* :class:`WorkloadSketch` — a bounded heavy-hitter summary (Space-Saving
  [Metwally et al. 2005]) over the label sequences harvested from every
  planned query.  ``harvest_sequences`` credits a query's *indexable
  segments*: every contiguous window of length 2..k of every maximal
  label run (length-1 sequences are always indexed, so they carry no
  signal).  A long chain therefore votes for each sequence that could
  serve one of its segments — no unbounded query log, O(capacity) state,
  and the classic Space-Saving guarantee (any sequence with true count
  > N/capacity is present).
* :class:`BenefitModel` — scores a candidate sequence by
  ``frequency x cost saved``, reusing the optimizer's cost model
  (:func:`repro_torch.core.optimizer.estimate_plan` over
  :class:`~repro_torch.core.stats.IndexStats`): cost saved is the estimated
  evaluation of the sequence as singleton-label expansion joins minus
  its evaluation as one indexed LOOKUP.  The same model prices the
  *size* of admitting a sequence (its estimated pair count) for the
  controller's budget.
* :class:`AdaptationController` — turns sketch + benefit into coalesced
  ``("insert_interest", seq)`` / ``("delete_interest", seq)`` update
  batches under a size budget, with **hysteresis** so the interest set
  cannot thrash: a challenger must beat a resident's benefit by
  ``swap_margin``, freshly-admitted interests are dwell-protected for a
  few rounds, and the sketch decays geometrically each round so a
  drifted-away workload releases its slots.

The controller is **multi-tenant**: every tenant gets its own
Space-Saving sketch (one tenant's burst cannot evict another tenant's
counters) and its own ``cfg.budget`` of mined interests, while
``cfg.pair_budget`` stays one *global* footprint cap.  :meth:`propose`
arbitrates round-robin across tenants in deterministic (sorted-name)
order, one admission per tenant per pass, so a hot tenant cannot claim
the whole pair budget before a cold tenant's first candidate is even
considered.  A single-tenant deployment (everything funnels through
``DEFAULT_TENANT``) behaves exactly as before.

The controller never touches the index itself — it only *proposes* ops;
``QueryService`` drains them through its existing write path, so an
adaptation round shares one mirror batch + one flush/rebind + one epoch
bump with any queued graph updates.  Misjudged proposals
can never change answers (Sec. V-C: any interest set is
answer-preserving; only pruning power and index size move).

Host-side only: no torch import.  A copy of the reference package's
``core/workload.py`` without its checkpoint codec (``export_state`` /
``from_state``), which waits for the port of ``core/lifecycle.py``.
"""

from __future__ import annotations

import dataclasses

from .optimizer import estimate_plan
from .query import CPQ, Conj, Edge, Identity, Join, _flatten_join
from .stats import IndexStats

#: the tenant every untagged request is accounted to.
DEFAULT_TENANT = "default"


# ---------------------------------------------------------------------- #
# harvesting — AST -> candidate interest sequences
# ---------------------------------------------------------------------- #


def harvest_sequences(q: CPQ, k: int) -> list:
    """The candidate interest sequences one query votes for: every
    contiguous window of length 2..k of every maximal label run, over
    all join chains of the AST (conjunction operands recurse).

    Windows — not just maximal runs — because the planner may serve a
    long chain from *any* valid <= k segmentation: a hot ``a.b.c.d``
    workload at k=2 is evidence for (a,b), (b,c) and (c,d) alike, and
    the benefit model decides which segmentation is worth indexing.

    RPQ queries vote too: their maximal concatenation label runs (star
    and plus bodies included — a hot ``(a.b)*`` fixpoint hits the
    ``(a, b)`` lookup every iteration) go through the same window
    expansion."""
    from .rpq import RPQ, rpq_label_runs

    if isinstance(q, RPQ):
        runs = [list(r) for r in rpq_label_runs(q)]
        return _expand_windows(runs, k)
    runs: list[list[int]] = []

    def walk(node: CPQ) -> None:
        if isinstance(node, Edge):
            runs.append([node.label])
            return
        if isinstance(node, Identity):
            return
        if isinstance(node, Conj):
            walk(node.lhs)
            walk(node.rhs)
            return
        if isinstance(node, Join):
            run: list[int] = []
            for leaf in _flatten_join(node):
                if isinstance(leaf, Edge):
                    run.append(leaf.label)
                else:
                    if run:
                        runs.append(run)
                        run = []
                    if not isinstance(leaf, Identity):
                        walk(leaf)
            if run:
                runs.append(run)
            return
        raise TypeError(node)

    walk(q)
    return _expand_windows(runs, k)


def _expand_windows(runs: list, k: int) -> list:
    out: list = []
    for run in runs:
        for w in range(2, k + 1):
            for i in range(len(run) - w + 1):
                out.append(tuple(run[i: i + w]))
    return out


# ---------------------------------------------------------------------- #
# WorkloadSketch — bounded heavy hitters (Space-Saving)
# ---------------------------------------------------------------------- #


class WorkloadSketch:
    """Space-Saving heavy-hitter sketch over hashable items.

    At most ``capacity`` counters; an unmonitored arrival evicts the
    minimum counter and inherits its count (recorded as the new entry's
    ``error``, so ``count - error`` is a guaranteed lower bound on the
    true frequency).  ``decay`` scales every counter — called once per
    adaptation round, it turns the sketch into an exponentially-weighted
    view so drifted-away traffic fades instead of squatting."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.counts: dict = {}
        self.errors: dict = {}
        self.observed = 0.0  # total weight ever observed (pre-decay)

    def __len__(self) -> int:
        return len(self.counts)

    def observe(self, item, weight: float = 1.0) -> None:
        self.observed += weight
        if item in self.counts:
            self.counts[item] += weight
            return
        if len(self.counts) < self.capacity:
            self.counts[item] = weight
            self.errors[item] = 0.0
            return
        # evict the oldest minimum counter (dict order is insertion
        # order, so the tie-break is deterministic without touching
        # every key's repr on the serving hot path)
        floor = min(self.counts.values())
        victim = next(k for k, c in self.counts.items() if c == floor)
        self.counts.pop(victim)
        self.errors.pop(victim)
        self.counts[item] = floor + weight
        self.errors[item] = floor

    def observe_query(self, q: CPQ, k: int, weight: float = 1.0) -> int:
        """Harvest and record one query's candidate sequences with the
        given weight (the service passes the number of folded duplicate
        requests); returns how many sequence occurrences were
        credited."""
        seqs = harvest_sequences(q, k)
        for s in seqs:
            self.observe(s, weight)
        return len(seqs)

    def count(self, item) -> float:
        """Upper-bound frequency estimate (0 for unmonitored items)."""
        return self.counts.get(item, 0.0)

    def guaranteed(self, item) -> float:
        """Lower-bound frequency (count minus inherited error)."""
        return self.counts.get(item, 0.0) - self.errors.get(item, 0.0)

    def decay(self, factor: float, drop_below: float = 0.5) -> None:
        """Scale every counter by ``factor`` (and drop entries fading
        below ``drop_below`` — they are indistinguishable from noise and
        their slots should go to fresh traffic)."""
        if not 0.0 <= factor <= 1.0:
            raise ValueError("decay factor must be in [0, 1]")
        for item in list(self.counts):
            c = self.counts[item] * factor
            if c < drop_below:
                del self.counts[item]
                del self.errors[item]
            else:
                self.counts[item] = c
                self.errors[item] *= factor

    def heavy_hitters(self, min_count: float = 0.0) -> list:
        """(item, count, error) rows, heaviest first, ties broken
        deterministically by item repr."""
        rows = [(item, c, self.errors[item])
                for item, c in self.counts.items() if c >= min_count]
        rows.sort(key=lambda r: (-r[1], repr(r[0])))
        return rows


# ---------------------------------------------------------------------- #
# BenefitModel — frequency x estimated cost saved
# ---------------------------------------------------------------------- #


class BenefitModel:
    """Prices candidate interest sequences against one statistics
    snapshot, reusing the optimizer's cost model end to end."""

    def __init__(self, stats: IndexStats):
        self.stats = stats

    def split_cost(self, seq: tuple) -> float:
        """Estimated cost of serving the sequence WITHOUT its index
        entry: singleton-label lookups folded through expansion joins —
        the exact plan the engine runs when the segment is absent."""
        plan = ("lookup", [(l,) for l in seq])
        return estimate_plan(plan, self.stats).cost

    def indexed_cost(self, seq: tuple) -> float:
        """Estimated cost WITH the entry: one LOOKUP whose
        materialization is the answer.  For a sequence the index already
        holds this is exact; otherwise its cardinality is estimated from
        the same join chain the split would run."""
        seq = tuple(seq)
        if self.stats.has_seq(seq):
            return estimate_plan(("lookup", [seq]), self.stats).cost
        return self.est_pairs(seq)

    def est_pairs(self, seq: tuple) -> float:
        """Estimated pair count of the sequence — its index footprint
        (the size-budget currency), exact when already indexed."""
        seq = tuple(seq)
        if self.stats.has_seq(seq):
            return float(self.stats.seq_pairs(seq))
        plan = ("lookup", [(l,) for l in seq])
        return estimate_plan(plan, self.stats).pairs

    def saved(self, seq: tuple) -> float:
        """Estimated evaluation cost saved per query touching ``seq``."""
        return max(0.0, self.split_cost(seq) - self.indexed_cost(seq))

    def benefit(self, seq: tuple, frequency: float) -> float:
        return frequency * self.saved(seq)


# ---------------------------------------------------------------------- #
# AdaptationController — hysteresis + budget -> coalesced interest ops
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class AdaptationConfig:
    """Knobs of the adaptation loop.

    ``budget``       — max resident mined (length >= 2) interests;
    ``pair_budget``  — cap on the summed estimated pair footprint of the
                       mined interests (None = count budget only);
    ``min_count``    — sketch frequency floor before a sequence is even
                       considered (guards against one-off queries);
    ``min_benefit``  — absolute benefit floor for admission, and the
                       eviction threshold for residents whose traffic
                       faded (a resident below this is dropped even
                       unchallenged);
    ``swap_margin``  — hysteresis: a challenger must beat a resident's
                       benefit by this factor to take its slot;
    ``dwell``        — adaptation rounds a fresh admission is protected
                       from eviction (prevents insert/delete churn while
                       the sketch stabilizes);
    ``decay``        — per-round geometric decay of the sketch.
    """

    budget: int = 8
    pair_budget: float | None = None
    min_count: float = 4.0
    min_benefit: float = 1.0
    swap_margin: float = 2.0
    dwell: int = 2
    decay: float = 0.5


class AdaptationController:
    """Turns observed traffic into coalesced interest-update batches.

    Stateless about the index itself: every :meth:`propose` call reads
    the *current* interest set and statistics, so the controller is
    correct under concurrent graph maintenance (a graph update changes
    the statistics; the next round simply re-prices).

    Sketches are per tenant (created lazily on first observe); the
    legacy ``.sketch`` attribute remains the :data:`DEFAULT_TENANT`
    view, so single-tenant callers and tests are unaffected."""

    def __init__(self, k: int, sketch_capacity: int = 256,
                 config: AdaptationConfig | None = None):
        self.k = k
        self.cfg = config or AdaptationConfig()
        self.sketch_capacity = sketch_capacity
        self.sketches: dict = {}  # tenant -> WorkloadSketch
        self.rounds = 0
        self._dwell: dict = {}  # seq -> protected-until round

    @property
    def sketch(self) -> WorkloadSketch:
        return self.sketch_for(DEFAULT_TENANT)

    @sketch.setter
    def sketch(self, sk: WorkloadSketch) -> None:
        self.sketches[DEFAULT_TENANT] = sk

    def sketch_for(self, tenant: str) -> WorkloadSketch:
        sk = self.sketches.get(tenant)
        if sk is None:
            sk = self.sketches[tenant] = WorkloadSketch(self.sketch_capacity)
        return sk

    # -------------------------- recording --------------------------- #

    def observe(self, q: CPQ, weight: float = 1.0,
                tenant: str = DEFAULT_TENANT) -> int:
        """Record one served query against its tenant's sketch
        (``weight`` > 1 credits folded duplicate requests); returns
        sequences credited."""
        return self.sketch_for(tenant).observe_query(q, self.k, weight)

    # -------------------------- proposing --------------------------- #

    def propose(self, stats: IndexStats, current_interests) -> list:
        """One adaptation round: returns a (possibly empty) list of
        ``("insert_interest", seq)`` / ``("delete_interest", seq)`` ops
        moving the mined interest set toward the current workload's
        top-benefit sequences, under the budget and hysteresis rules.

        Budgeting is per tenant for counts (each tenant may hold up to
        ``cfg.budget`` mined interests) and global for the pair
        footprint: admission round-robins across tenants in sorted-name
        order, one admission per tenant per pass, each tenant offering
        its own benefit-ranked candidates, until every tenant is out of
        budget, candidates, or global pair headroom.  A sequence two
        tenants both want is admitted once and charged to whichever
        tenant's turn came first — the others benefit free of charge.

        ``current_interests`` is the live interest set (length-1
        sequences are implicit in iaCPQx and ignored here)."""
        cfg = self.cfg
        self.rounds += 1
        model = BenefitModel(stats)
        resident = {tuple(s) for s in current_interests if len(s) >= 2}
        if not self.sketches:
            self.sketch_for(DEFAULT_TENANT)
        tenants = sorted(self.sketches)

        scored_by_tenant: dict = {}
        for tenant in tenants:
            sk = self.sketches[tenant]
            scored: dict = {}
            for seq, cnt, err in sk.heavy_hitters(cfg.min_count):
                if len(seq) < 2 or len(seq) > self.k:
                    continue
                if cnt - err < cfg.min_count:  # Space-Saving precision
                    continue  # guard: the count may be inherited, not earned
                scored[seq] = model.benefit(seq, cnt)
            for seq in resident:  # faded residents still get priced
                if seq not in scored:
                    scored[seq] = model.benefit(seq, sk.count(seq))
            scored_by_tenant[tenant] = scored

        protected = {s for s in resident
                     if self._dwell.get(s, -1) >= self.rounds}

        def eligible_for(tenant):
            sk = self.sketches[tenant]
            scored = scored_by_tenant[tenant]

            # hysteresis: residents defend their slot with a swap_margin
            # premium; challengers must clear both floors
            def rank(seq):
                bonus = cfg.swap_margin if seq in resident else 1.0
                return (-scored[seq] * bonus, repr(seq))

            elig = [s for s, b in scored.items()
                    if s not in protected
                    and b >= cfg.min_benefit
                    and (s in resident
                         or sk.guaranteed(s) >= cfg.min_count)]
            elig.sort(key=rank)
            return elig

        # dwell-protected residents keep their slots unconditionally,
        # charged to the tenant that drives them hardest
        desired: set = set()
        pair_spend = 0.0
        spent = {t: 0 for t in tenants}
        for s in sorted(protected, key=repr):
            payer = max(tenants, key=lambda t: self.sketches[t].count(s))
            desired.add(s)
            pair_spend += model.est_pairs(s)
            spent[payer] += 1

        elig = {t: eligible_for(t) for t in tenants}
        cursor = {t: 0 for t in tenants}
        progressed = True
        while progressed:
            progressed = False
            for t in tenants:
                if spent[t] >= cfg.budget:
                    continue
                lst, i = elig[t], cursor[t]
                while i < len(lst):
                    seq = lst[i]
                    i += 1
                    if seq in desired:
                        continue
                    cost = model.est_pairs(seq)
                    if (cfg.pair_budget is not None
                            and pair_spend + cost > cfg.pair_budget):
                        continue
                    desired.add(seq)
                    pair_spend += cost
                    spent[t] += 1
                    progressed = True
                    break
                cursor[t] = i

        ops = [("delete_interest", s)
               for s in sorted(resident - desired, key=repr)]
        inserts = sorted(desired - resident, key=repr)
        ops += [("insert_interest", s) for s in inserts]
        for s in inserts:
            self._dwell[s] = self.rounds + cfg.dwell
        for s in resident - desired:
            self._dwell.pop(s, None)
        for sk in self.sketches.values():
            sk.decay(cfg.decay)
        return ops
