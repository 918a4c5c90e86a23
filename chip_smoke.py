"""Drives the PyTorch/CUDA port of the CPQx engine once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. device    — the card's name, and its name and power limit from nvidia-smi;
2. build     — nvcc builds the CUDA kernels of src/repro_torch/kernels/csrc;
3. parity    — each CUDA kernel against its plain PyTorch version on the card,
               bit for bit: the CPU tests' shapes, SENTINEL and empty cases,
               several lanes;
4. index     — CPQx for gmark_citation(20_000, avg_degree=6, seed=3) at k=2 on
               the card (and a small build held bit for bit against the CPU);
5. queries   — the 12 templates with seeded labels through Engine.execute and
               Engine.execute_batch (16 same-template queries a batch), every
               answer checked against a scipy.sparse reference written here;
   then the kernels again, on the built index's own arrays and on the inputs
   the main path gave them, with their times.

The launch counts are set to 0 just before phases 4-5 (the main path) and read
just after.  The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  Any failure exits non-zero; without a CUDA
card, or outside a checkout of the repository, the script exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_VERTICES = 20_000
K = 2
SEED = 3
BATCH = 16
MAX_ANSWER = 4_194_304  # drop a draw whose reference answer is larger
MAX_REF_FLOPS = 64_000_000  # ... or whose reference product costs more
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT_OPS_PER_S = 67e12  # CUDA-core rate (float32 peak) used for int32 work
TEMPLATES = ["C2", "C4", "C2i", "T", "Ti", "S", "Si", "TT", "St",
             "TC", "SC", "ST"]
KERNELS = {
    "sorted_member_mask": ("src/repro_torch/kernels/csrc/sorted_intersect.cu",
                           "src/repro/kernels/sorted_intersect.py:57"),
    "expand_join_gather": ("src/repro_torch/kernels/csrc/expand_join.cu",
                           "src/repro/kernels/expand_join.py:69"),
}


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


def busy_share(fn):
    """(wall ms, device-busy ms, top-5 kernels by device time) of one
    ``fn`` call, from a profiler trace."""
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
    return wall, busy, top


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

    def eval(self, q):
        """The answer as a CSR matrix, or None when a product would cost
        more than MAX_REF_FLOPS multiply-adds."""
        from repro_torch.core.query import Conj, Edge, Identity, Join

        if isinstance(q, Edge):
            return self.mats[q.label]
        if isinstance(q, Identity):
            return self.sp.identity(self.n, dtype=bool, format="csr")
        a = self.eval(q.lhs)
        if a is None:
            return None
        b = self.eval(q.rhs)
        if b is None:
            return None
        if isinstance(q, Conj):
            return a.multiply(b).tocsr()
        assert isinstance(q, Join)
        flops = int((np.diff(a.tocsc().indptr).astype(np.int64)
                     * np.diff(b.indptr).astype(np.int64)).sum())
        if flops > MAX_REF_FLOPS:
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
    from repro_torch.core.capacity import estimate_build_caps
    from repro_torch.core.engine import Engine
    from repro_torch.data.graphs import gmark_citation, random_queries_for_graph
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import expand_join, ops, ref, sorted_intersect

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
    err = {
        "sorted_member_mask": check_parity(
            "sorted_member_mask", sorted_intersect.sorted_member_mask,
            ref.sorted_member_mask, member_cases(rng, dev)),
        "expand_join_gather": check_parity(
            "expand_join_gather", expand_join.expand_join_gather,
            ref.expand_join_gather, join_cases(rng, dev)),
    }
    say("[parity] test shapes, SENTINEL, empty and multi-lane cases: both "
        "kernels equal their plain versions (tolerance 0: integer outputs, "
        "bit-exact)")

    # small build on the card held bit for bit against the CPU build
    g_small = gmark_citation(500, avg_degree=6, seed=SEED)
    on_card = cindex.build(g_small, K)
    on_cpu = cindex.build(g_small, K, device="cpu")
    for f in on_card.arrays._fields:
        if not torch.equal(getattr(on_card.arrays, f).cpu(), getattr(on_cpu.arrays, f)):
            fail(f"small build: field {f} differs between card and CPU")
    say("[index] gmark_citation(500) k=2: all 17 fields bit-identical card vs CPU")

    # ---- main path: counts to 0, build, queries, counts read --------- #
    recorded = {"sorted_member_mask": None, "expand_join_gather": None}
    real_mask, real_gather = ops.sorted_member_mask, ops.expand_join_gather

    def record(name, args, work):
        best = recorded[name]
        if best is None or work > best[0]:  # as the kernel receives them
            recorded[name] = (work, tuple(
                a.contiguous() if torch.is_tensor(a) else a for a in args))

    def mask_spy(hay, hay_count, queries):
        record("sorted_member_mask", (hay, hay_count, queries), queries.numel())
        return real_mask(hay, hay_count, queries)

    def gather_spy(ends, lo, a_payload, b_v, b_u, total, out_capacity):
        record("expand_join_gather", (ends, lo, a_payload, b_v, b_u, total,
                                      out_capacity), ends.shape[0] * out_capacity)
        return real_gather(ends, lo, a_payload, b_v, b_u, total, out_capacity)

    ops.sorted_member_mask, ops.expand_join_gather = mask_spy, gather_spy
    sorted_intersect.launches = 0
    expand_join.launches = 0

    # ---- 4. build at full size --------------------------------------- #
    g = gmark_citation(N_VERTICES, avg_degree=6, seed=SEED)
    t0 = time.perf_counter()
    caps = estimate_build_caps(g, K)
    t_caps = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = cindex.build(g, K, caps=caps)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    say(f"[index] gmark_citation({N_VERTICES}, avg_degree=6, seed={SEED}) k={K}: "
        f"{g.n_edges} edges with inverses, caps level_rows={caps.level_rows} "
        f"pair_cap={caps.pair_cap}")
    say(f"[index] host capacity estimate {t_caps:.2f} s; device build "
        f"{t_build:.3f} s; n_classes={index.n_classes}; |P<=2|={index.n_pairs}; "
        f"size_entries={index.size_entries()}; peak device memory "
        f"{peak / 2**30:.3f} GiB")

    # ---- 5. queries -------------------------------------------------- #
    engine = Engine(index)
    refm = SparseReference(g)
    drops = []
    per_template = {}
    draw_seed = SEED
    for name in TEMPLATES:
        accepted = []
        tries = 0
        while len(accepted) < BATCH and tries < 8 * BATCH:
            tries += 1
            draw_seed += 1
            (_, q), = random_queries_for_graph(g, [name], 1, seed=draw_seed)
            m = refm.eval(q)
            if m is None or m.nnz > MAX_ANSWER:
                drops.append((name, repr(q), "flops" if m is None else m.nnz))
                continue
            accepted.append((q, refm.rows(m)))
        if not accepted:
            fail(f"template {name}: no draw with a reference answer "
                 f"<= {MAX_ANSWER} pairs in {tries} draws")
        per_template[name] = accepted
    say(f"[queries] {sum(len(v) for v in per_template.values())} queries kept; "
        f"{len(drops)} draws dropped (reference answer > {MAX_ANSWER} pairs, "
        f"or a reference product > {MAX_REF_FLOPS} multiply-adds), e.g. "
        f"{drops[:3]}")

    n_queries = 0
    results = {}
    for name, accepted in per_template.items():
        lat = []
        for q, exp in accepted:
            t0 = time.perf_counter()
            got = engine.execute(q)
            lat.append(time.perf_counter() - t0)
            n_queries += 1
            if not np.array_equal(got, exp):
                fail(f"{name} {q!r}: execute answer ({len(got)} pairs) differs "
                     f"from the reference ({len(exp)} pairs)")
        qs = [q for q, _ in accepted]
        bt = []
        for _ in range(3):
            t0 = time.perf_counter()
            batch = engine.execute_batch(qs)
            bt.append(time.perf_counter() - t0)
            n_queries += len(qs)
            for (q, exp), got in zip(accepted, batch):
                if not np.array_equal(got, exp):
                    fail(f"{name} {q!r}: execute_batch answer differs from "
                         f"the reference")
        results[name] = dict(
            n=len(qs), execute_ms_median=1e3 * float(np.median(lat[1:] or lat)),
            execute_ms_first=1e3 * lat[0],
            batch_qps=len(qs) / float(np.median(bt[1:])),
            max_answer=max(len(e) for _, e in accepted))
    counts = {"sorted_member_mask": sorted_intersect.launches,
              "expand_join_gather": expand_join.launches}
    ops.sorted_member_mask, ops.expand_join_gather = real_mask, real_gather
    for name, r in results.items():
        say(f"[queries] {name:4s} n={r['n']:2d} execute median "
            f"{r['execute_ms_median']:.3f} ms (first {r['execute_ms_first']:.1f} ms) "
            f"batch {r['batch_qps']:.1f} q/s  largest answer {r['max_answer']}")
    say(f"[queries] all answers equal the scipy.sparse reference; "
        f"{n_queries} query evaluations; telemetry {engine.telemetry}")
    say(f"[main path] kernel launches {counts} over {n_queries} queries")
    for name, c in counts.items():
        if c == 0:
            fail(f"the main path never launched {name}")

    # ---- kernels on the index's arrays and on the main path's inputs -- #
    err["sorted_member_mask"] = max(err["sorted_member_mask"], check_parity(
        "sorted_member_mask", sorted_intersect.sorted_member_mask,
        ref.sorted_member_mask,
        index_member_cases(index, dev, rng) + [recorded["sorted_member_mask"][1]]))
    err["expand_join_gather"] = max(err["expand_join_gather"], check_parity(
        "expand_join_gather", expand_join.expand_join_gather,
        ref.expand_join_gather,
        index_join_cases(index, dev) + [recorded["expand_join_gather"][1]]))
    say("[parity] on the built index's l2c/class_starts/c2p arrays and on the "
        "main path's largest inputs: bit-exact (tolerance 0)")

    kernel_fns = {"sorted_member_mask": sorted_intersect.sorted_member_mask,
                  "expand_join_gather": expand_join.expand_join_gather}
    plain_fns = {"sorted_member_mask": ref.sorted_member_mask,
                 "expand_join_gather": ref.expand_join_gather}

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

    work_of = {"sorted_member_mask": member_work,
               "expand_join_gather": gather_work}

    def timed(name, args, where):
        bytes_, ops_, lib_fn, shape = work_of[name](*args)
        ms = device_ms(lambda: kernel_fns[name](*args))
        plain_ms = device_ms(lambda: plain_fns[name](*args))
        lib_ms = device_ms(lib_fn) if lib_fn is not None else None
        call_ms = cuda_ms(lambda: kernel_fns[name](*args))
        t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
        t_ops = 1e3 * ops_ / INT_OPS_PER_S
        say(f"[kernels] {name} at {where} {shape}: kernel {ms:.5f} ms on the "
            f"device ({call_ms:.4f} ms a call, host included), plain "
            f"{plain_ms:.5f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'}, bound "
            f"{max(t_bytes, t_ops):.5f} ms ({bytes_} bytes, {ops_} int ops)")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms)

    out = []
    for name, (src, replaces) in KERNELS.items():
        rec = timed(name, recorded[name][1], "the main path's largest call")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[name],
                    "max_abs_err": err[name], **rec})
    timed("sorted_member_mask", index_member_cases(index, dev, rng)[0],
          "the index's 16 largest class lists")
    timed("expand_join_gather", index_join_cases(index, dev)[0],
          "the index's 16 largest class lists")

    # where a query's time goes: device busy share of execute
    for name in ("T", "C4"):
        qs = [q for q, _ in per_template[name]]
        wall, busy, top = busy_share(lambda: [engine.execute(q) for q in qs])
        say(f"[profile] execute x{len(qs)} {name}: wall {wall / len(qs):.3f} ms "
            f"a query, device busy {busy / len(qs):.3f} ms a query "
            f"({100 * busy / wall:.1f}%); top kernels {top}")

    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(smi_line)
    say(json.dumps({"kernels": out}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
