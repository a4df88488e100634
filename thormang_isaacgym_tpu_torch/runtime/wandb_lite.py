"""Experiment-tracking sink, the reference's wandb integration (wandb.init
with project, group, entity, name and config; run.finish() at exit). The
port's own copy of ``thormang_isaacgym_tpu/runtime/wandb_lite.py``.

Uses the real ``wandb`` package where it is installed; otherwise an
API-compatible offline writer with wandb's offline layout,
``wandb/run-<ts>-<id>/files/{config.yaml, wandb-history.jsonl,
wandb-summary.json}``, which ``wandb sync`` can upload later."""
from __future__ import annotations

import json
import os
import time


def init(project=None, group=None, entity=None, name=None, config=None,
         dir=None, **kw):
    try:
        import wandb  # noqa: F401  (real package, if installed)
        return wandb.init(project=project, group=group, entity=entity,
                          name=name, config=config, dir=dir, **kw)
    except ImportError:
        return _OfflineRun(project, group, entity, name, config, dir)


class _OfflineRun:
    def __init__(self, project, group, entity, name, config, base_dir):
        ts = time.strftime("%Y%m%d_%H%M%S")
        rid = f"{os.getpid():x}"
        self.dir = os.path.join(base_dir or ".", "wandb",
                                f"run-{ts}-{rid}", "files")
        os.makedirs(self.dir, exist_ok=True)
        self.name = name
        self._summary = {}
        self._step = 0
        meta = {"project": project, "group": group, "entity": entity,
                "name": name, "mode": "offline", "start_time": ts}
        with open(os.path.join(self.dir, "wandb-metadata.json"), "w") as f:
            json.dump(meta, f, indent=1)
        if config is not None:
            import yaml
            with open(os.path.join(self.dir, "config.yaml"), "w") as f:
                yaml.safe_dump(_plain(config), f)
        self._hist = open(
            os.path.join(self.dir, "wandb-history.jsonl"), "a")

    def log(self, data: dict, step: int | None = None):
        row = {k: _num(v) for k, v in data.items()}
        row["_step"] = self._step if step is None else int(step)
        row["_timestamp"] = time.time()
        self._hist.write(json.dumps(row) + "\n")
        self._hist.flush()
        self._summary.update(row)
        self._step = row["_step"] + 1

    def finish(self):
        self._hist.close()
        with open(os.path.join(self.dir, "wandb-summary.json"), "w") as f:
            json.dump(self._summary, f, indent=1)


def _num(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def _plain(x):
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return str(x)
