"""The reference env, step by step on a sample of envs: the frozen copy of
the task, the env framework and the plain physics step
(``port/``) takes each recorded env state of the program (its rows of the
sample) and the action the program stepped it with, and computes the next
state itself. Its model parameters it carries itself from its own reset,
so domain randomisation is drawn again too. The start (the reset and the
first observations) is checked on its own."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from benchmark.reference.port.engine.env import EnvState
from benchmark.reference.port.tasks import make

PKG = "benchmark.reference.port"


def from_plain(x, device):
    """Plain data (``harness.program.to_plain``) as the reference's own
    dataclasses and tensors on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict) and "__dc__" in x:
        mod, name = x["__dc__"]
        cls = getattr(importlib.import_module(f"{PKG}.{mod}"), name)
        return cls(**{k: from_plain(v, device) for k, v in x.items() if k != "__dc__"})
    if isinstance(x, tuple):
        return tuple(from_plain(v, device) for v in x)
    if isinstance(x, dict):
        return {k: from_plain(v, device) for k, v in x.items()}
    return x


def build(task: str, task_cfg: dict, seed: int, ids: torch.Tensor, device):
    """The reference env over the sampled envs `ids` (global env ids)."""
    env = make(task, num_envs=len(ids), seed=seed, cfg=task_cfg, device=device)
    env.env_id0 = ids.to(device)
    return env


def start(env, seed: int) -> EnvState:
    """The reference's own reset of the sampled envs."""
    return env.reset(seed)


def step_rows(env, pre: dict, action: torch.Tensor, ids: torch.Tensor, device) -> EnvState:
    """One env step of the envs `ids` (as many as `env` was built for) from
    the program's recorded state `pre`, its model parameters included: the
    rows the masked reset restarts, which the reference's own sample need
    not hold."""
    env.env_id0 = ids.to(device)
    state = dataclasses.replace(from_plain(pre, device), env_id0=env.env_id0)
    return env.step_fn(state, action.to(device))


def step(env, pre: dict, action: torch.Tensor, params, device) -> EnvState:
    """One env step from the program's recorded state `pre` with the
    reference's own `params`."""
    state = from_plain(pre, device)
    state = dataclasses.replace(state, params=params, env_id0=env.env_id0)
    return env.step_fn(state, action.to(device))
