"""Runs one cell of the benchmark once and prints its result line.

    python3 cpqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  The run
generates the configuration's graph and the traffic's query pools from
``--seed``, works out the plain reference's answer of every query drawn
(not counted as set-up), hands the graph to the program (index build,
engine), warms up on the cell's own traffic, measures for ``--seconds``,
holds every answer of the window to the reference's, and prints one JSON
object as the last line of standard output.  With ``--trace 1`` it
reports the cell's per-layer metrics from a traced slice of the window
instead of its end-to-end metrics.  A run whose answers differ from the
reference's prints ``"correct": false``.  It needs as many CUDA devices
as the cell asks for, and exits non-zero without a result when they are
missing, when the program cannot be imported, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "cpqbench"  # kernel caches, fixed, in the checkout
TRACE_SECONDS = 3.0  # the traced slice of a --trace 1 window


def fail(msg: str, code: int = 1):
    print(f"cpqbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def say(msg: str) -> None:
    print(f"[cpqbench] {msg}", file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def use_checkout() -> None:
    """The program from the checkout's ``src``, its kernel caches at fixed
    paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device=None, t_start: float | None = None,
             root: Path = ROOT) -> dict:
    """One run of a cell: its data from the seed, set-up, window, check.
    Returns the result object.  ``device`` None runs on the CUDA card
    (the benchmark's path); tests pass "cpu"."""
    import gc

    import torch

    from bench import check, pools, spec, system
    from bench.trace import DeviceTrace, Spans

    t_start = T_START if t_start is None else t_start
    _, cfg, mix = spec.cell(bench, workload, root)
    folder = root / bench["paths"][0]
    on_card = device is None
    data = pools.prepare(cfg, mix, seed, spec.plugin(
        "generators", cfg["graph"]["generator"], folder))
    graph, pool = data["graph"], data["pool"]
    say(f"graph {cfg['graph']} from seed {seed}: {len(graph['edges'])} base "
        f"edges in {data['gen_s']:.3f} s; pools and their reference answers "
        f"in {data['ref_s']:.3f} s (not set-up)")
    for name, n, dropped in data["report"]:
        say(f"pool {name}: {n} queries; draws dropped for an answer over "
            f"{pools.MAX_ANSWER} pairs: {sum(dropped.values())} {dropped}")
    if data["interests"] is not None:
        say(f"interests: {len(data['interests'])} 2-label sequences "
            f"{data['interests']}")
    gc.collect()
    try:
        built = system.build(cfg, graph, data["interests"],
                             spec.plugin("indexes", cfg["index"], folder),
                             device=device)
    except ImportError as e:
        fail(f"the program repro_torch cannot be imported from "
             f"{root / 'src'}: {e}")
    engine = built["engine"]
    spans = Spans()
    t0 = time.perf_counter()
    loop = spec.plugin("drivers", mix["driver"], folder).make(
        engine, system.queries(pool), mix, pools.rng_for(seed, "order"),
        spans)
    say(f"warm-up: graphs captured in each cycle of the traffic "
        f"{loop.warm()}")
    tracer = None
    if trace:
        tracer = DeviceTrace(spans)
        tracer.start()  # the profiler's own first start, outside the window
        tracer.stop()
    if on_card:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start - data["ref_s"]
    ex = getattr(engine.backend, "executables", None)
    say(f"set-up {setup_s:.3f} s: graph {built['seconds']['graph_s']:.3f} s, "
        f"index {built['seconds']['index_s']:.3f} s, engine "
        f"{built['seconds']['engine_s']:.3f} s, warm-up {warm_s:.3f} s"
        + ("" if ex is None else f"; {ex.captures} graphs captured in "
           f"{ex.capture_s:.3f} s, {ex.bytes / 2**20:.1f} MiB held, "
           f"{ex.evictions} evicted"))

    win = loop.run(seconds, tracer, TRACE_SECONDS)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    say(f"window {seconds} s: {len(win.answers)} answers ({win.in_window} in "
        f"hand by the close); {win.captures} graphs captured inside it; "
        f"counters {win.counters}")
    del loop, engine, built
    if on_card:
        torch.cuda.empty_cache()

    res = check.compare(pool, win.answers, data["expected"])
    say(f"reference: {res['queries_checked']} distinct pool entries, "
        f"{res['answers_checked']} answers checked")
    if res["first_wrong"]:
        say(f"first wrong answer: {res['first_wrong']}")

    bad = res["wrong_answers"] + res["missing_answers"]
    run = types.SimpleNamespace(
        setup_s=setup_s, window_s=seconds,
        counters=win.counters, spans=win.spans, trace=win.trace,
        correct_in_window=sum(1 for pos, (_, _, t) in enumerate(win.answers)
                              if t <= win.t_end and pos not in res["bad"]),
        traced_queries=(win.in_hand_between(tracer.t0, tracer.t1)
                        if win.trace else 0))
    kind_of_metrics = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, workload, kind_of_metrics):
        value = spec.reader(m["name"], folder)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bad == 0 and res["answers_checked"] > 0,
           "attempted": res["answers_checked"], "failed": bad,
           "metrics": metrics, "device": dev}
    if win.trace:
        tr = win.trace
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        say(f"trace: {tr['window_s']:.3f} s traced, device busy "
            f"{tr['busy_s']:.6f} s over {tr['device_ops']} operations, "
            f"{run.traced_queries} answers in hand inside it")
        top = sorted(tr["device_s_by_name"].items(), key=lambda kv: -kv[1])
        gaps = sorted(tr["idle_by_span"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [[n[:120], s] for n, s in top[:10]],
                            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
    checks = {"wrong_answers": {"value": res["wrong_answers"], "limit": 0},
              "missing_answers": {"value": res["missing_answers"],
                                  "limit": 0}}
    out["checks"] = checks
    for name, c in checks.items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    return out


def main(argv=None) -> None:
    args = parse(argv)
    use_checkout()
    from bench import spec

    try:
        bench = spec.load_benchmark(ROOT)
        w, _, _ = spec.cell(bench, args.workload, ROOT)
    except (spec.SpecError, OSError, KeyError, ValueError) as e:
        fail(str(e))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the program on the card",
             2)
    if torch.cuda.device_count() < w["chips"]:
        fail(f"the cell needs {w['chips']} CUDA devices, "
             f"{torch.cuda.device_count()} present", 2)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    from bench import check

    loaded = check.forbidden_modules()
    if loaded:
        fail(f"modules of JAX or the JAX package were loaded: {loaded}", 3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
