"""Worker-process entrypoint for the cluster runtime (``core.cluster``).

``worker_main`` is the ``spawn`` target of every persistent worker: it
starts the heartbeat *before* the heavy imports (so the coordinator sees
liveness while torch initializes), builds one :class:`WorkerState` — the
owner of this rank's slice on its device (the CUDA card unless the
runtime was given another) — and then loops on the instruction queue
forever: receive ``(seq, kind, payload)``, execute, reply ``(rank, seq,
status, payload)`` on the shared result queue.

Status protocol: ``ok`` (instruction done, payload is the result),
``aborted`` (the coordinator's abort event interrupted an exchange —
the round is void and will be re-issued), ``error`` (the instruction
raised; payload is the traceback).  Every instruction gets exactly one
reply — the coordinator's quiesce protocol counts on it.  A worker whose
state cannot be built (no card) answers every instruction with that
error, so the coordinator raises instead of serving elsewhere.

Run as a module for a self-contained demo of the fleet, on the card:

    PYTHONPATH=src python -m repro_torch.launch.workers --workers 2

or on the CPU with ``--device cpu``.
"""

from __future__ import annotations


def worker_main(rank, iq, rq, inboxes, outboxes, hb, abort,
                device="cuda") -> None:
    """Body of one persistent worker process.

    Parameters are the coordinator's plumbing: ``iq`` the FIFO
    instruction queue (the total order this worker observes), ``rq`` the
    shared reply queue, ``inboxes``/``outboxes`` this rank's row of the
    peer exchange matrix, ``hb`` the shared heartbeat double, ``abort``
    the fleet-wide round-abort event, ``device`` where the slice lives."""
    import os
    import threading
    import time
    import traceback

    def _beat() -> None:
        while True:
            hb.value = time.time()
            time.sleep(0.2)

    threading.Thread(target=_beat, daemon=True, name="heartbeat").start()

    # heavy imports only after the heartbeat is live
    import torch

    from repro_torch.core import cluster as C

    if str(device) == "cpu":
        torch.set_num_threads(1)  # several workers share the host's cores
    try:
        state = C.WorkerState(rank, inboxes, outboxes, abort, device)
        broken = None
    except Exception:  # noqa: BLE001 — every reply carries it upstream
        state, broken = None, traceback.format_exc()
    while True:
        seq, kind, payload = iq.get()
        if kind == C.SHUTDOWN:
            rq.put((rank, seq, "ok", None))
            return
        if kind == C.CRASH:  # test-only fault injection: die, hard
            os._exit(int(payload.get("code", 3)))
        if broken is not None:
            rq.put((rank, seq, "error", broken))
            continue
        try:
            out = state.handle(seq, kind, payload)
        except C.RoundAborted:
            rq.put((rank, seq, "aborted", None))
        except Exception:  # noqa: BLE001 — ship the traceback upstream
            rq.put((rank, seq, "error", traceback.format_exc()))
        else:
            rq.put((rank, seq, "ok", out))


def main(argv=None) -> None:
    """Demo: serve the example graph from a persistent-worker fleet."""
    import argparse

    parser = argparse.ArgumentParser(
        description="CPQx cluster demo: QueryService over worker processes")
    parser.add_argument("--workers", type=int, default=2,
                        help="number of persistent worker processes")
    parser.add_argument("--k", type=int, default=2,
                        help="CPQx index diameter")
    parser.add_argument("--queries", type=int, default=12,
                        help="number of demo queries to serve")
    parser.add_argument("--device", default=None,
                        help="where the index and the workers live (the "
                             "CUDA card unless given, e.g. 'cpu')")
    args = parser.parse_args(argv)

    import numpy as np

    from repro_torch.core import index as cindex
    from repro_torch.core.engine import Engine
    from repro_torch.core.graph import example_graph
    from repro_torch.core.query import (TEMPLATE_ARITY, TEMPLATES,
                                        instantiate_template)
    from repro_torch.core.service import QueryService

    g = example_graph()
    index = cindex.build(g, args.k, device=args.device)
    engine = Engine(index, cluster=args.workers, device=args.device)
    service = QueryService(engine)
    rng = np.random.default_rng(0)
    names = sorted(TEMPLATES)
    try:
        for i in range(args.queries):
            name = names[i % len(names)]
            labels = rng.integers(0, g.alphabet_size,
                                  TEMPLATE_ARITY[name]).tolist()
            rows = service.query(instantiate_template(name, labels))
            print(f"  {name:>3}: {rows.shape[0]} answer pairs")
        runtime = engine.backend.runtime
        devices = sorted({p["device"] for p in runtime.promoted.values()})
        print(f"served {args.queries} queries over {runtime.n_shards} "
              f"workers on {devices}; instruction counts: "
              f"{dict(runtime.instructions)}")
    finally:
        engine.backend.shutdown()


if __name__ == "__main__":
    main()
