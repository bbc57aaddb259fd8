"""A cell added by data files alone is found by name, and so is a new
metric's reader."""

import json
import shutil

import pytest

from bench_h100 import spec


@pytest.mark.parametrize("base", ["app_steady", "app_steady_int8"])
def test_cell_added_from_files(tmp_path, base):
    here = tmp_path / "bench_h100"
    shutil.copytree(spec.HERE / "configs", here / "configs")
    shutil.copytree(spec.HERE / "traffic", here / "traffic")
    shutil.copytree(spec.HERE / "limits", here / "limits")
    shutil.copytree(spec.HERE / "metrics", here / "metrics")
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    # the new files: a traffic mix, its cell's limits, a metric reader
    m = spec.load_json(here / "traffic" / f"{base}.json")
    m["generate"] = {"dist": "uniform", "min": 2048, "max": 3072}
    (here / "traffic" / "app_long.json").write_text(json.dumps(m))
    (here / "limits" / "tv2o-large.app_long.json").write_text(
        json.dumps(spec.load_json(here / "limits" / "tv2o-large.app_saturated.json")))
    (here / "metrics" / "sessions.count.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    bench["workloads"].append({"name": "tv2o-large.app_long", "config": "tv2o-large",
                               "traffic": "app_long", "chips": 1, "why": "long outputs"})
    bench["per_layer"].append({"name": "sessions.count", "unit": "sessions", "better": "higher",
                               "source": "program_counter", "layer": "service",
                               "moves": "chunk_gap_mean_ms", "workloads": ["tv2o-large.app_long"]})
    for m in bench["end_to_end"]:
        if m["name"] == "chunk_gap_mean_ms":
            m["workloads"].append("tv2o-large.app_long")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell("tv2o-large.app_long", tmp_path, here=here)
    assert cell.config["net_config"]["num_hidden_layers"] == 24
    assert cell.traffic["generate"]["min"] == 2048
    assert cell.traffic["deployment"]["kv_int8"] == (base == "app_steady_int8")
    assert cell.arch is spec.architecture(cell.config)
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "chunk_gap_mean_ms"]
    assert [m["name"] for m in cell.per_layer] == ["sessions.count"]

    class Run:
        records = [1, 2, 3]
        setup_s = 4.5

    got = spec.read_metrics(cell.per_layer + cell.end_to_end[:1], Run(), here)
    assert got == {"sessions.count": {"value": 3.0, "unit": "sessions"},
                   "setup_s": {"value": 4.5, "unit": "s"}}


def test_every_listed_metric_has_a_reader():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"])), m["name"]
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.limits["limits"], w["name"]
        moved = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in moved and len(moved) >= 2
        assert all(m["moves"] in moved for m in cell.per_layer), w["name"]
