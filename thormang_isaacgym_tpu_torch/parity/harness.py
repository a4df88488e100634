"""The port's side of the golden-trajectory replay. Port of
``thormang_isaacgym_tpu/parity/harness.py``.

The goldens in ``tests/goldens/`` are the JAX package's: fixed-seed
random-action rollouts (``record_trajectory``) of obs, reward, done and the
final q / qd. The port never records one. It replays a golden's action
stream from the JAX reset state, carried across, and the caller compares.
The two packages' reset streams differ by design, so an env that resets
inside the window is comparable only up to its first done.
"""
from __future__ import annotations

import os

import numpy as np
import torch

GOLDEN_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                          "tests", "goldens"))


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, f"{name}.npz")


def load_golden(name: str):
    """The golden's arrays (obs, reward, done, final_q, final_qd), or None
    when it is not there."""
    path = golden_path(name)
    if not os.path.exists(path):
        return None
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


@torch.no_grad()
def replay(env, reset_state, actions) -> dict:
    """Step `env` from `reset_state` (an EnvState) through `actions` (T, B,
    A); numpy obs (T, B, num_obs), reward (T, B), done (T, B), final_q and
    final_qd, the arrays a golden holds."""
    state = reset_state
    obs, reward, done = [], [], []
    for a in actions:
        state = env.step_fn(state, torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                                   device=env.device))
        obs.append(state.obs.cpu().numpy())
        reward.append(state.reward.cpu().numpy())
        done.append(state.done.cpu().numpy())
    return dict(obs=np.stack(obs), reward=np.stack(reward), done=np.stack(done),
                final_q=state.q.cpu().numpy(), final_qd=state.qd.cpu().numpy())
