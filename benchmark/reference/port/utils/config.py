"""YAML config composition, the reference's hydra scheme without hydra. The
port's own copy of ``thormang_isaacgym_tpu/utils/config.py``.

A root config (``cfg/config.yaml``) picks ``task=<X>`` and
``train=<X>PPO``; task configs live in ``cfg/task/*.yaml``, train configs
in ``cfg/train/*.yaml``, in the reference's file shapes. CLI overrides use
``a.b.c=value``. ``${...}`` interpolation is not replicated: values the
reference interpolates are resolved in code. The port reads the same
``cfg/`` directory as the JAX package.
"""
from __future__ import annotations

import os
from typing import Any

import yaml

CFG_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "..", "cfg")


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def deep_update(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = v
    return out


def set_by_path(cfg: dict, dotted: str, value: Any):
    keys = dotted.split(".")
    d = cfg
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def parse_value(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def load_config(argv: list[str] | None = None, cfg_root: str | None = None) -> dict:
    """Compose root + task + train configs with CLI overrides.

    argv entries are `key=value` (task=Gogoro, num_envs=512,
    train.params.config.horizon_length=32).
    """
    cfg_root = cfg_root or CFG_ROOT
    cfg = load_yaml(os.path.join(cfg_root, "config.yaml"))
    overrides = {}
    for arg in argv or []:
        if "=" not in arg:
            raise ValueError(f"override must be key=value: {arg!r}")
        k, v = arg.split("=", 1)
        overrides[k] = parse_value(v)

    task_name = overrides.pop("task", cfg.get("task", "Gogoro"))
    train_name = overrides.pop("train", cfg.get("train", f"{task_name}PPO"))

    task_path = os.path.join(cfg_root, "task", f"{task_name}.yaml")
    train_path = os.path.join(cfg_root, "train", f"{train_name}.yaml")
    cfg["task"] = load_yaml(task_path) if os.path.exists(task_path) else {"name": task_name}
    cfg["train"] = load_yaml(train_path) if os.path.exists(train_path) else {}
    cfg["task_name"] = task_name
    cfg["train_name"] = train_name

    # top-level convenience overrides matching reference config.yaml keys
    for k, v in overrides.items():
        set_by_path(cfg, k, v)
    return cfg
