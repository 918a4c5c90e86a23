"""The control of the comparison that decides ``correct``.

The configuration states one guarantee: exact answers.  The control puts
the reference in the program's place and breaks that guarantee the way a
tempting shortcut would: every answer is cut to ``CONTROL_CAP`` pairs, as
a fixed relation capacity without the overflow ladder leaves it.  The
same comparison as a run's then has to find wrong answers.

    python3 cpqbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

It draws the graph and pools a run with that seed would draw, answers
one cycle of the requests that run would send, prints each seed's
readings, and exits non-zero if any seed's control came out correct.  It
needs no card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from bench import check, pools, spec  # noqa: E402

CONTROL_CAP = 65_536  # pairs a relation holds when nothing retries


def control(bench: dict, workload: str, seed: int, root: Path,
            cap: int = CONTROL_CAP) -> dict:
    _, cfg, mix = spec.cell(bench, workload, root)
    folder = root / bench["paths"][0]
    data = pools.prepare(cfg, mix, seed, spec.plugin(
        "generators", cfg["graph"]["generator"], folder))
    pool, expected = data["pool"], data["expected"]
    loop = spec.plugin("drivers", mix["driver"], folder).make(
        None, [None] * len(pool), mix, pools.rng_for(seed, "order"), None)
    answers = [(int(j), expected[int(j)][:cap], 0.0)
               for j in loop.requests()]
    res = check.compare(pool, answers, expected)
    res["correct"] = res["wrong_answers"] + res["missing_answers"] == 0
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args()
    root = HERE.parent
    bench = spec.load_benchmark(root)
    passed = []
    for seed in args.seed:
        res = control(bench, args.workload, seed, root)
        print(f"control {args.workload} seed {seed}: wrong_answers "
              f"{res['wrong_answers']} (limit 0) of {res['answers_checked']} "
              f"answers, {res['queries_checked']} distinct pool entries; "
              f"correct {res['correct']}", flush=True)
        if res["correct"]:
            passed.append(seed)
    if passed:
        print(f"the control came out correct on seeds {passed}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
