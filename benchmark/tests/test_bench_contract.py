"""BENCHMARK.json against the contract the benchmark is checked by: names,
units, the files each entry names, and which cells report which metric."""

import json
import os
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits(bench_json):
    assert set(bench_json) == {"command", "paths", "run_seconds", "configs", "workloads",
                               "end_to_end", "per_layer"}
    assert bench_json["paths"] == ["benchmark"]
    assert 1 <= bench_json["run_seconds"] <= 51 and isinstance(bench_json["run_seconds"], int)
    assert all(LINE.match(w) for w in bench_json["command"])
    assert len(json.dumps(bench_json)) < 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters(bench_json):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench_json[key]]
    names += [w["config"] for w in bench_json["workloads"]] + [w["traffic"] for w in bench_json["workloads"]]
    names += [k for c in bench_json["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in bench_json[key]}) == len(bench_json[key])
    metrics = bench_json["end_to_end"] + bench_json["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    texts = [c["why"] for c in bench_json["configs"]] + [w["why"] for w in bench_json["workloads"]]
    texts += [c["source"] for c in bench_json["configs"]] + [m["layer"] for m in bench_json["per_layer"]]
    assert all(LINE.match(t) for t in texts)


def test_entries_have_just_their_keys(bench_json):
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in bench_json["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in bench_json["workloads"])
    e2e = {"name", "unit", "better", "bound", "source"}
    assert all(set(m) - {"workloads"} == e2e for m in bench_json["end_to_end"])
    layer = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(set(m) - {"workloads"} == layer for m in bench_json["per_layer"])


def test_bounds_sources_and_chips(bench_json):
    for m in bench_json["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    setup = [m for m in bench_json["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    sources = ("device_trace", "program_span", "program_counter", "host_clock")
    assert all(m["source"] in sources for m in bench_json["per_layer"])
    assert all(w["chips"] == 1 for w in bench_json["workloads"])


def test_every_file_a_cell_needs_is_there(bench_json):
    configs = {c["name"]: c for c in bench_json["configs"]}
    for w in bench_json["workloads"]:
        cfg = configs[w["config"]]
        assert cfg["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, cfg["file"])) as f:
            data = json.load(f)
        assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
        assert os.path.isfile(os.path.join(BENCH, "families", data["family"] + ".py"))
        assert os.path.isfile(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
    used = {w["config"] for w in bench_json["workloads"]}
    assert used == set(configs)
    assert len({(w["config"], w["traffic"]) for w in bench_json["workloads"]}) == len(bench_json["workloads"])


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report(bench_json):
    cells = {w["name"] for w in bench_json["workloads"]}
    reported = {c: {m["name"] for m in bench_json["end_to_end"] if c in m.get("workloads", cells)}
                for c in cells}
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2
    for m in bench_json["per_layer"]:
        for c in m.get("workloads", [c for c in cells if m["moves"] in reported[c]]):
            assert c in cells and m["moves"] in reported[c], (m["name"], c)
    for c in cells:
        assert any(c in m.get("workloads", [c]) for m in bench_json["per_layer"])
    layers = {}
    for m in bench_json["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["source"])
    assert all(layers)


def test_every_compared_number_has_a_limit(bench_json):
    for c in bench_json["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            limits = json.load(f)["limits"]
        assert {"loss_gap", "grad_gap", "update_gap"} <= set(limits)
        assert all(v > 0 for v in limits.values())
