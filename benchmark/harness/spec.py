"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout lists the cells, configurations and metrics; each configuration is
the JSON file its entry names, each traffic mix ``traffic/<traffic>.json``,
each cell's correctness limits ``limits/<cell>.json`` and each per-layer
metric a reader ``metrics/<metric>.py``. Adding a cell, a configuration or
a metric adds files and entries and edits none."""
from __future__ import annotations

import copy
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # benchmark/
ROOT = os.path.dirname(HERE)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def deep_merge(base: dict, over: dict) -> dict:
    """`base` with `over`'s keys set, nested dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = deep_merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) \
            else copy.deepcopy(v)
    return out


def held(bench: str = HERE) -> dict:
    """``held.json``: cells held out of BENCHMARK.json with their entries."""
    path = os.path.join(bench, "held.json")
    return _json(path) if os.path.exists(path) else dict(configs=[], workloads=[])


def cell(name: str, root: str = ROOT, bench: str = HERE) -> dict:
    """Everything one cell needs: its workload entry, configuration,
    traffic, limits, end-to-end metric entries and per-layer metric entries
    (those that list it, or list no cells). A cell that BENCHMARK.json does
    not list is looked up in ``held.json``."""
    spec = load_spec(root)
    out = held(bench)
    work = {w["name"]: w for w in out["workloads"] + spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    confs = {c["name"]: c for c in out["configs"] + spec["configs"]}
    conf_entry = confs[w["config"]]
    config = _json(os.path.join(root, conf_entry["file"]))
    traffic = _json(os.path.join(bench, "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(bench, "limits", f"{name}.json"))

    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(
        name=name, workload=w, config_entry=conf_entry, config=config, traffic=traffic,
        limits=limits, chips=int(w["chips"]), run_seconds=int(spec["run_seconds"]),
        end_to_end=[m for m in spec["end_to_end"] if listed(m)],
        per_layer=[m for m in spec["per_layer"] if listed(m)])


def task_cfg(c: dict) -> dict:
    """The cell's task config: the configuration's, with the traffic's
    task overrides merged in."""
    return deep_merge(c["config"]["cfg"], c["traffic"].get("task_overrides", {}))


def metric_reader(name: str, bench: str = HERE):
    """The module ``metrics/<name>.py``: LAYER, UNIT, MOVES and
    ``read(record)``, which returns a number or None."""
    path = os.path.join(bench, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
