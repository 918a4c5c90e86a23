"""Dry run of every cell — the twin of the reference's ``launch/dryrun.py``.

For every (architecture x input shape) cell, the cell's own step is run
once on the **meta device** (``launch.steps.build_cell``): no tensor is
allocated and no card is needed, so a cell far too big for a card is
still reckoned.  ``roofline.collect.analyze_step`` counts one device's
FLOPs, the bytes its ops move, its collectives and its live-bytes
high-water mark (the step's inputs and what it makes; a table the model
caches once per device, RoPE's, is made with the inputs and not counted);
each record says whether that peak fits one H100's 80 GiB
(``fits_card``).  A cell that does not fit is still ``ok``; a traceback
is a failure.  Records are JSON under ``--out`` for ``roofline.analysis``.

``--mesh``:

* ``card`` (the default): one unsharded H100, records
  ``<arch>__<shape>__card.json``;
* ``single`` / ``multi`` / ``both``: the reference's meshes — the 16x16
  pod (256 devices) and the 2x16x16 multi-pod (512) — records
  ``<arch>__<shape>__single.json`` / ``__multi.json``.  Every cell is
  laid out by the reference's sharding rules over a fake process group of
  the mesh's size (``launch.mesh.reckoning_mesh``) and one rank's step is
  reckoned: the LM and BST cells' parameters, state and batches as
  DTensors, the GNN cells' node and edge rows over every axis, the engine
  cells one shard a rank over the flattened mesh
  (``launch.steps.build_cell``).

The summary line keeps its ``waits`` count, 0 since every family is
reckoned on a mesh.  The run exits 1 only if a traced cell fails.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out /tmp/dr
    python -m repro_torch.launch.dryrun --all --skip-existing
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

MESHES = {"card": (None,), "single": (False,), "multi": (True,),
          "both": (False, True)}  # --mesh -> multi_pod per record


def mesh_name(multi_pod) -> str:
    return {None: "card", False: "single", True: "multi"}[multi_pod]


def record_path(out_dir: str, arch_id: str, shape_name: str,
                mesh: str = "card") -> str:
    return os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh}.json")


def run_cell(arch_id: str, shape_name: str,
             out_dir: str = "experiments/dryrun_torch", multi_pod=None,
             **reduce) -> dict:
    """The record of one cell on one H100 (``multi_pod`` None), the 16x16
    pod (False) or the 2x16x16 multi-pod (True), reduced by ``reduce``
    (see ``launch.steps.build_cell``), written as JSON under ``out_dir``
    (the only file it writes) and returned.  A failure raises."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import reckoning_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline.collect import analyze_step

    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    mesh = mesh_name(multi_pod)
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh,
        "kind": shape.kind, "dims": {k: (list(v) if isinstance(v, tuple) else v)
                                     for k, v in shape.dims.items()},
        "status": "pending",
    }
    if shape.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = shape.skip
        return _write(rec, out_dir)
    t0 = time.time()
    with (contextlib.nullcontext() if multi_pod is None
          else reckoning_mesh(multi_pod=multi_pod)) as m:
        cell = build_cell(spec, shape, "meta", mesh=m, **reduce)
        rec.update(analyze_step(cell))
    rec["status"] = "ok"
    rec["trace_s"] = round(time.time() - t0, 2)
    rec["description"] = cell.description
    if reduce:
        rec["reduced"] = dict(reduce)
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    with open(record_path(out_dir, rec["arch"], rec["shape"], rec["mesh"]),
              "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=list(MESHES), default="card")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

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

    n = {"ok": 0, "skipped": 0, "waits": 0, "failed": 0}
    t_all = time.time()
    for aid, sname in cells:
        for multi in MESHES[args.mesh]:
            mesh = mesh_name(multi)
            if args.skip_existing and os.path.exists(
                    record_path(args.out, aid, sname, mesh)):
                print(f"[skip existing] {aid} {sname} {mesh}")
                continue
            try:
                rec = run_cell(aid, sname, args.out, multi_pod=multi)
            except Exception as e:  # noqa: BLE001 — record and continue
                n["failed"] += 1
                _write({"arch": aid, "shape": sname, "mesh": mesh,
                        "status": "fail", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:]},
                       args.out)
                print(f"[FAIL] {aid} {sname} {mesh}: {e}")
                continue
            n[rec["status"]] += 1
            if rec["status"] == "skipped":
                print(f"[SKIP] {aid} {sname} {mesh}: "
                      f"{rec['skip_reason'][:60]}...")
            else:
                print(f"[ok] {aid} {sname} {mesh}: trace {rec['trace_s']}s, "
                      f"{rec['per_device_hbm_gb']} GiB a device "
                      f"({'fits' if rec['fits_card'] else 'does not fit'} "
                      f"one H100), {rec['total_flops']:.3e} flops, "
                      f"{rec['collectives']['total_bytes']:.3e} collective "
                      f"bytes")
    print(f"\ndry-run: {n['ok']} ok, {n['skipped']} skipped, {n['waits']} "
          f"waits, {n['failed']} failed in {time.time() - t_all:.1f} s")
    if n["failed"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
