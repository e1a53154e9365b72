"""Cells are found by name from files; a missing file fails loudly; the
benchmark's file keeps to its contract's shape."""

import json
import re

import pytest

from benchmark.harness import cells
from benchmark.tests.helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_from_its_files(name):
    cell = cells.find(name)
    w = [w for w in BENCH["workloads"] if w["name"] == name][0]
    assert cell.chips == w["chips"] == 1
    assert cell.config["name"] == w["config"]
    assert cell.traffic["batch"] > 0 and cell.traffic["pool_batches"] > 0
    for attr in ("receive", "failed", "compare", "transport_blocks", "OUTPUTS", "LIMITS"):
        assert hasattr(cell.path, attr)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "tti_per_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))


def test_configurations_name_their_files_and_sources():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] == []
        assert c["file"].startswith(BENCH["paths"][0] + "/")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"entry and graphs", "front end", "control", "data", "kernels",
                           "device"}


def _bench_with(tmp_path, **change):
    bench = json.loads(json.dumps(BENCH))
    for k, v in change.items():
        section, key = k.split("__")
        bench[section][0][key] = v
    f = tmp_path / "BENCHMARK.json"
    f.write_text(json.dumps(bench))
    return f


@pytest.mark.parametrize("change, message", [
    ({"configs__file": "benchmark/configs/no_such_config.json"}, "configuration"),
    ({"workloads__traffic": "no_such_mix"}, "traffic mix 'no_such_mix'"),
])
def test_a_missing_file_fails_loudly(tmp_path, change, message):
    f = _bench_with(tmp_path, **change)
    with pytest.raises(FileNotFoundError, match=message):
        cells.find(BENCH["workloads"][0]["name"], f)


def test_a_missing_path_or_reader_fails_loudly():
    with pytest.raises(FileNotFoundError, match="path 'no_such_path'"):
        cells.path("no_such_path")
    with pytest.raises(FileNotFoundError, match="per-layer metric 'no_such_metric'"):
        cells.reader("no_such_metric")


def test_an_unknown_cell_fails_loudly():
    with pytest.raises(KeyError, match="no cell named"):
        cells.find("no.such.cell")
