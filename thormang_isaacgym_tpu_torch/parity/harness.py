"""The port's side of the golden-trajectory replay. Port of
``thormang_isaacgym_tpu/parity/harness.py``.

The goldens in ``tests/goldens/`` are the JAX package's: fixed-seed
random-action rollouts (``record_trajectory``) of obs, reward, done and the
final q / qd. The port replays a golden's action stream from the JAX reset
state, carried across (``replay``), and the caller compares. The two
packages' reset streams differ by design, so an env that resets inside the
window is comparable only up to its first done.

``record_trajectory``, ``save_golden`` and ``check_or_record`` are the JAX
package's recorder in the port's streams (the reset's EnvRandom, the
actions U(-1, 1) of a ``torch.Generator`` seeded `seed` + 7): a golden the
port records holds the port to itself, not to the JAX package. Each takes
``root`` (default ``tests/goldens/``), so a port golden need not sit beside
the JAX ones.
"""
from __future__ import annotations

import os

import numpy as np
import torch

GOLDEN_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                          "tests", "goldens"))


def golden_path(name: str, root: str = GOLDEN_DIR) -> str:
    return os.path.join(root, f"{name}.npz")


def load_golden(name: str, root: str = GOLDEN_DIR):
    """The golden's arrays (obs, reward, done, final_q, final_qd), or None
    when it is not there."""
    path = golden_path(name, root)
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


@torch.no_grad()
def record_trajectory(env, *, steps: int, seed: int = 1234) -> dict:
    """A fixed-seed random-action rollout from ``env.reset(seed)``: the
    arrays of ``replay``."""
    gen = torch.Generator(device=env.device).manual_seed(int(seed) + 7)
    actions = torch.rand((steps, env.num_envs, env.num_actions), generator=gen,
                         device=env.device) * 2.0 - 1.0
    return replay(env, env.reset(seed), actions)


def save_golden(name: str, traj: dict, root: str = GOLDEN_DIR) -> None:
    os.makedirs(root, exist_ok=True)
    np.savez_compressed(golden_path(name, root), **traj)


def check_or_record(name: str, env, *, steps: int, seed: int = 1234, atol: float = 2e-3,
                    root: str = GOLDEN_DIR) -> str:
    """Compare a fresh ``record_trajectory`` with the golden `name`; record
    it if absent (or if REGEN_GOLDENS=1). Returns 'recorded' or 'matched';
    raises AssertionError on a mismatch of reward, done or final_q beyond
    `atol`."""
    traj = record_trajectory(env, steps=steps, seed=seed)
    golden = load_golden(name, root)
    if golden is None or os.environ.get("REGEN_GOLDENS") == "1":
        save_golden(name, traj, root)
        return "recorded"
    for k in ("reward", "done", "final_q"):
        np.testing.assert_allclose(traj[k], golden[k], atol=atol,
                                   err_msg=f"golden-trajectory drift in {name}:{k}")
    return "matched"
