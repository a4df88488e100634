"""Faults planted under a run, for the checks that ``correct`` catches them
(``control.py`` on the card, ``tests/`` on the CPU). The benchmark's own
runs plant none. Each wraps a call on the instances:

- ``frozen_update``: the optimizer step returns the parameters unchanged;
- ``half_batch``: the loss of each minibatch over its first half only;
- ``altered_answer``: the task's observations and rewards altered where
  they are produced (first observation + 0.01, reward + 1 %);
- ``frozen_physics``: the physics step returns the state it was given;
- ``skip_reset``: the env step skips its masked reset (it steps the state
  with done cleared);
- ``flip_done``: the task's done comes out flipped."""
from __future__ import annotations

import dataclasses

import torch

FAULTS = ("frozen_update", "half_batch", "altered_answer", "frozen_physics", "skip_reset",
          "flip_done")


def plant(name: str, env, ppo) -> None:
    if name == "frozen_update":
        def apply_grads(ts, grads):
            return None
        ppo._apply_grads = apply_grads
    elif name == "half_batch":
        key = "_loss_rnn" if ppo.is_rnn else "_loss"
        loss = getattr(ppo, key)

        def half(ts, batch):
            n = batch["obs"].shape[0] // 2
            return loss(ts, {k: v[:n] for k, v in batch.items()})
        ppo.__dict__[key] = half
    elif name == "altered_answer":
        task = env.task
        post = task.post_physics

        def altered(state, prev_task):
            obs, reward, done, t, metrics = post(state, prev_task)
            obs = obs.clone()
            obs[..., 0] += 0.01
            return obs, reward * 1.01, done, t, metrics
        task.post_physics = altered
    elif name == "frozen_physics":
        def frozen(params, q, qd, ctrl, wrench):
            return q, qd, q.new_zeros(q.shape[0], env.model.nb, 6)
        env.physics_step = frozen
    elif name == "skip_reset":
        step_fn = env.step_fn

        def no_reset(state, actions):
            return step_fn(dataclasses.replace(state, done=torch.zeros_like(state.done)), actions)
        env.step_fn = no_reset
    elif name == "flip_done":
        task = env.task
        post = task.post_physics

        def flipped(state, prev_task):
            obs, reward, done, t, metrics = post(state, prev_task)
            return obs, reward, 1.0 - done, t, metrics
        task.post_physics = flipped
    else:
        raise ValueError(f"unknown fault {name!r}; have {FAULTS}")
