"""answer_fill_share.batch: the share of the capacity-padded answer
lanes that answers fill, in %: pairs of every lane answered in the
window over the pair cap of the rung that answered it
(``LadderTelemetry.answer_rows`` / ``answer_cap_rows`` deltas, read by
the ``batch_loop_counted`` driver)."""


def read(run):
    cap = run.counters.get("answer_cap_rows", 0)
    if not cap or "answer_rows" not in run.counters:
        return None
    return 100.0 * run.counters["answer_rows"] / cap
