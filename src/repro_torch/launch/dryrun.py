"""Dry run on one NVIDIA H100 — the twin of the reference's
``launch/dryrun.py``.

For every (architecture x input shape) cell, the cell's own step is run
once on the **meta device** (``launch.steps.build_cell``): no tensor is
allocated and no card is needed, so a cell far too big for the card is
still reckoned.  ``roofline.collect.analyze_step`` counts its FLOPs, the
bytes its ops move and its live-bytes high-water mark (the step's inputs
and what it makes; a table the model caches once per device, RoPE's, is
made with the inputs and not counted); each record says whether that peak
fits the card's 80 GiB (``fits_card``).  A cell that
does not fit is still ``ok``; a traceback is a failure.  Records are
JSON under ``--out`` for ``roofline.analysis``.

The reference lowers each cell on a 16x16 (``single``) or 2x16x16
(``multi``) mesh of forced host devices.  Here ``--mesh single`` is one
H100; a multi-card mesh waits for ROADMAP item 15(c).

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out /tmp/dr
    python -m repro_torch.launch.dryrun --all --skip-existing
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

MESH = "single"  # one H100


def record_path(out_dir: str, arch_id: str, shape_name: str) -> str:
    return os.path.join(out_dir, f"{arch_id}__{shape_name}__{MESH}.json")


def run_cell(arch_id: str, shape_name: str,
             out_dir: str = "experiments/dryrun_torch", **reduce) -> dict:
    """The record of one cell, reduced by ``reduce`` (see
    ``launch.steps.build_cell``), written as JSON under ``out_dir`` (the
    only file it writes) and returned.  A failure raises."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline.collect import analyze_step

    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": MESH,
        "kind": shape.kind, "dims": {k: (list(v) if isinstance(v, tuple) else v)
                                     for k, v in shape.dims.items()},
        "status": "pending",
    }
    if shape.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = shape.skip
        return _write(rec, out_dir)
    t0 = time.time()
    cell = build_cell(spec, shape, "meta", **reduce)
    rec.update(analyze_step(cell))
    rec["status"] = "ok"
    rec["trace_s"] = round(time.time() - t0, 2)
    rec["description"] = cell.description
    if reduce:
        rec["reduced"] = dict(reduce)
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    with open(record_path(out_dir, rec["arch"], rec["shape"]), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        ap.error("--mesh single is one H100; a multi-card mesh waits for "
                 "ROADMAP item 15(c)")

    from repro_torch.configs import ARCH_IDS, get_arch

    if args.all:
        cells = [(aid, sh.name) for aid in ARCH_IDS
                 for sh in get_arch(aid).shapes]
    else:
        if not args.arch:
            ap.error("--arch required without --all")
        spec = get_arch(args.arch)
        shapes = [args.shape] if args.shape else [s.name for s in spec.shapes]
        cells = [(args.arch, s) for s in shapes]

    n_ok = n_fail = n_skip = 0
    t_all = time.time()
    for aid, sname in cells:
        if args.skip_existing and os.path.exists(
                record_path(args.out, aid, sname)):
            print(f"[skip existing] {aid} {sname} {MESH}")
            continue
        try:
            rec = run_cell(aid, sname, args.out)
            if rec["status"] == "skipped":
                n_skip += 1
                print(f"[SKIP] {aid} {sname} {MESH}: "
                      f"{rec['skip_reason'][:60]}...")
            else:
                n_ok += 1
                print(f"[ok] {aid} {sname} {MESH}: trace {rec['trace_s']}s, "
                      f"{rec['per_device_hbm_gb']} GiB "
                      f"({'fits' if rec['fits_card'] else 'does not fit'} "
                      f"one H100), {rec['total_flops']:.3e} flops")
        except Exception as e:  # noqa: BLE001 — record and continue
            n_fail += 1
            rec = {"arch": aid, "shape": sname, "mesh": MESH,
                   "status": "fail", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"[FAIL] {aid} {sname} {MESH}: {e}")
            _write(rec, args.out)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed in "
          f"{time.time() - t_all:.1f} s")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
