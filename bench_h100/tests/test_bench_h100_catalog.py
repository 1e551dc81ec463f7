"""Discovery by name, and BENCHMARK.json against the files it names."""
import re

import pytest

from bench_h100 import catalog

BENCH = catalog.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = catalog.cell(name)
    assert cell.config["name"] == name.split(".")[0]
    assert cell.traffic["name"] == name.split(".")[1]
    assert cell.route["engine"] == cell.traffic["route"]
    e2e = {m["name"] for m, _ in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m, _ in cell.end_to_end:
        assert "workloads" not in m or name in m["workloads"]
    assert cell.per_layer, "every cell reports a per-layer metric"
    catalog.generator(cell.config["kind"])
    catalog.reference(cell.config["kind"])


def test_unknown_workload_named():
    with pytest.raises(KeyError, match="no workload"):
        catalog.cell("no_such.cell")
    with pytest.raises(KeyError, match="no configuration"):
        catalog.config("no_such")


def test_split_metric_read_by_its_first_part():
    assert catalog.metric("solve_ms.history").__name__ == \
        "bench_h100.metrics.solve_ms"
    with pytest.raises(FileNotFoundError):
        catalog.metric("no_such.history")


def test_metric_reported_only_where_listed():
    bench = dict(BENCH, per_layer=[dict(BENCH["per_layer"][0],
                                        workloads=[CELLS[0]])])
    assert catalog.cell(CELLS[0], bench).per_layer
    assert not catalog.cell(CELLS[1], bench).per_layer


@pytest.mark.parametrize("spec", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda s: s["name"])
def test_metric_file_agrees(spec):
    mod = catalog.metric(spec["name"])
    assert mod.UNIT == spec["unit"] and UNIT.match(spec["unit"])
    assert mod.BETTER == spec["better"] and mod.SOURCE == spec["source"]
    # A quantity split by cells moves the part of the same cells.
    split = spec["name"][len(mod.__name__.rsplit(".", 1)[1]):]
    if "layer" in spec:
        assert mod.LAYER == spec["layer"]
        assert mod.MOVES + split == spec["moves"] or (
            not split and mod.MOVES == spec["moves"])
        assert spec["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        e2e = next(m for m in BENCH["end_to_end"] if m["name"] == spec["moves"])
        assert set(spec["workloads"]) <= set(e2e.get("workloads", CELLS))
        for w in spec.get("workloads", []):
            assert w in CELLS
    else:
        assert spec["source"] in ("host_clock", "device_trace")
        assert 0.0 < spec["bound"] <= 0.25


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(1 <= len(c[k]) <= 200 for k in ("source", "why"))
        assert c["file"].startswith("bench_h100/configs/")
        assert catalog.config(c["name"])["name"] == c["name"]
        assert catalog.config(c["name"])["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    every = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in every)
    assert len(set(every)) == len(every)
