"""The benchmark's data is found by name: every configuration, traffic mix,
limits file and metric reader that BENCHMARK.json names, and files added to a
copy of the benchmark without an edit to any file there."""
import json
import os
import shutil

import pytest

from benchmark.harness import spec


def test_every_named_file_is_found():
    s = spec.load_spec()
    for w in s["workloads"]:
        c = spec.cell(w["name"])
        assert c["config"]["task"] and c["traffic"]["num_envs"] > 0
        assert c["limits"]["limits"], f"{w['name']} has no limits"
        assert {m["name"] for m in c["end_to_end"]} >= {"setup_s", "train_env_steps_per_s"}
    for c in s["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))


@pytest.mark.parametrize("name", [m["name"] for m in spec.load_spec()["per_layer"]])
def test_metric_reader_matches_its_entry(name):
    entry = {m["name"]: m for m in spec.load_spec()["per_layer"]}[name]
    mod = spec.metric_reader(name)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"], entry["moves"])
    assert mod.read({}) is None        # a reader that finds nothing returns nothing


def test_added_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    # a new configuration, traffic mix, cell and per-layer metric: files and entries
    conf = json.loads((bench / "configs" / "shadowhand.json").read_text())
    (bench / "configs" / "newhand.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "shadowhand-ppo.json").read_text())
    traffic["num_envs"] = 4096
    (bench / "traffic" / "newhand-ppo.json").write_text(json.dumps(traffic))
    (bench / "limits" / "newhand-ppo.json").write_text(json.dumps({"limits": {"q_gap": 1.0}}))
    (bench / "metrics" / "new.metric.py").write_text(
        'LAYER = "Device"\nUNIT = "ms"\nMOVES = "train_env_steps_per_s"\n\n\n'
        'def read(record):\n    return record.get("x")\n')
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append(dict(s["configs"][0], name="newhand", file="benchmark/configs/newhand.json"))
    s["workloads"].append(dict(name="newhand-ppo", config="newhand", traffic="newhand-ppo",
                               chips=1, why="a test cell"))
    s["per_layer"].append(dict(name="new.metric", unit="ms", better="lower",
                               source="program_span", layer="Device",
                               moves="train_env_steps_per_s", workloads=["newhand-ppo"]))
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    c = spec.cell("newhand-ppo", root=str(root), bench=str(bench))
    assert c["traffic"]["num_envs"] == 4096 and c["limits"]["limits"] == {"q_gap": 1.0}
    assert "new.metric" in [m["name"] for m in c["per_layer"]]
    assert "new.metric" not in [m["name"] for m in spec.cell("shadowhand-ppo", root=str(root),
                                                              bench=str(bench))["per_layer"]]
    assert spec.metric_reader("new.metric", bench=str(bench)).read({"x": 2.0}) == 2.0
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_held_cells_are_found_by_name():
    listed = {w["name"] for w in spec.load_spec()["workloads"]}
    for w in spec.held()["workloads"]:
        assert w["name"] not in listed
        c = spec.cell(w["name"])
        assert c["traffic"]["num_envs"] > 0 and c["limits"]["limits"]
