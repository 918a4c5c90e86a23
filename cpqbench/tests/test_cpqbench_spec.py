"""The harness finds every configuration, traffic mix, generator, index
kind, driver and metric reader by its name, refuses a name it does not
know, and BENCHMARK.json keeps the contract's shape."""

import json
import re

import pytest

from cpqbench_small import BENCH_DIR, REPO

from bench import pools, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    w, cfg, mix = spec.cell(BENCH, cell, REPO)
    assert cfg["name"] == w["config"]
    for kind, name in (("generators", cfg["graph"]["generator"]),
                       ("indexes", cfg["index"]),
                       ("drivers", mix["driver"])):
        assert spec.plugin(kind, name, BENCH_DIR).__file__.endswith(
            f"{kind}/{name}.py")
    sizes = [sum(pools.counts_of(p).values()) for p in mix["pools"]]
    assert all(sizes) and sum(sizes) % mix["batch"] == 0
    kinds = {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert spec.metrics_of(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end",
                                                        "per_layer")
                                    for m in BENCH[k]])
def test_metric_reader_found(metric):
    assert callable(spec.reader(metric, BENCH_DIR))


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(spec.SpecError):
        spec.cell(BENCH, "no-such-cell", REPO)
    with pytest.raises(spec.SpecError):
        spec.traffic("no-such-mix", BENCH_DIR)
    for kind in spec.KINDS:
        with pytest.raises(spec.SpecError):
            spec.plugin(kind, "no_such_" + kind, BENCH_DIR)
    with pytest.raises(spec.SpecError):
        spec.plugin("configs", "gmark-citation-6k-cpqx", BENCH_DIR)
    # a configuration naming a generator the benchmark lacks is refused,
    # and does not run another graph
    c = BENCH["configs"][0]
    doc = json.loads((REPO / c["file"]).read_text())
    doc["graph"]["generator"] = "snap_powerlaw"
    (tmp_path / "cpqbench" / "configs").mkdir(parents=True)
    (tmp_path / c["file"]).write_text(json.dumps(doc))
    (tmp_path / "cpqbench" / "traffic").symlink_to(BENCH_DIR / "traffic")
    (tmp_path / "cpqbench" / "generators").symlink_to(BENCH_DIR /
                                                      "generators")
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["config"] == c["name"])
    with pytest.raises(spec.SpecError, match="snap_powerlaw"):
        spec.cell(BENCH, cell, tmp_path)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cpqbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cpqbench/")
        doc = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) <= set(doc["reduced"])
        assert set(c["reduced"]) <= set(doc["graph"])
        assert isinstance(doc["graph"]["seed"], int)  # the structure
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    end_to_end = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in end_to_end
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in end_to_end
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
    assert len(json.dumps(BENCH)) < 64 * 1024
