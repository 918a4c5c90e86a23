"""class_fill_share.batch: the share of the capacity-padded class lists
that lookups fill, in %: class-list entries every lane's lookups cover
over its lookups times its group's class cap
(``LadderTelemetry.class_rows`` / ``class_cap_rows`` deltas, read by the
``batch_loop_counted`` driver)."""


def read(run):
    cap = run.counters.get("class_cap_rows", 0)
    if not cap or "class_rows" not in run.counters:
        return None
    return 100.0 * run.counters["class_rows"] / cap
