"""The JAX goldens replayed in the port (parity/harness.py).

``tests/goldens/cartpole_8env_50step.npz`` and ``ant_4env_30step.npz`` are
the JAX package's fixed-seed random-action rollouts
(``parity/harness.py:record_trajectory``, seed 1234, tests/test_parity.py's
envs). The JAX reset state and the action stream (``fold_in(key, 7)``, one
``split`` per step) are regenerated in JAX; the port steps from that reset
state, carried across, through those actions with its plain physics (the
JAX task's own dt and substeps: ``make`` without a cfg). Reward, done and obs
are compared at the harness's atol 2e-3, each env up to and including its
first done, because the two packages' reset streams differ by design.
Ant's reward is compared at 2e-3 plus two float32 spacings of its ~6e4
potentials (2 x 3.9e-3): its progress term is a difference of two of them,
so positions that differ by 3e-5 m in the 1000 m to the target move it by a
whole spacing. final_q and final_qd are compared for the envs that never
reset (Ant's four; every Cartpole env resets inside its window). Each golden
must give a nonzero number of compared env-steps."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import thormang_isaacgym_tpu as tgx
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.parity import harness

ATOL = 2e-3
# the reward of a task whose progress term is a difference of float32 potentials ~6e4
REWARD_ATOL = {"Cartpole": ATOL, "Ant": ATOL + 2 * float(np.spacing(np.float32(6e4)))}
GOLDENS = [("cartpole_8env_50step", "Cartpole", 8, 50), ("ant_4env_30step", "Ant", 4, 30)]


def _jax_reset_and_actions(jenv, steps, seed=1234):
    """The reset state and the actions of JAX ``record_trajectory``."""
    key = jax.random.key(seed)
    state = jenv.reset(key)
    k = jax.random.fold_in(key, 7)
    actions = []
    for _ in range(steps):
        k, sub = jax.random.split(k)
        actions.append(np.asarray(jax.random.uniform(
            sub, (jenv.num_envs, jenv.num_actions), minval=-1.0, maxval=1.0)))
    return state, np.stack(actions)


def _port_state(env, js):
    """The port EnvState holding JAX state `js`."""
    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype)

    ts = env.init_fn(0)
    task = ts.task
    if dataclasses.is_dataclass(task):
        task = dataclasses.replace(task, **{f.name: t(getattr(js.task, f.name))
                                            for f in dataclasses.fields(task)})
    return dataclasses.replace(
        ts, q=t(js.q), qd=t(js.qd), obs=t(js.obs), reward=t(js.reward), done=t(js.done),
        timeout=t(js.timeout), progress=t(js.progress, torch.int64),
        net_contact=t(js.net_contact), net_torque=t(js.net_torque),
        episode=t(js.episode, torch.int64), episode_return=t(js.episode_return),
        last_episode_return=t(js.last_episode_return), task=task)


@pytest.mark.parametrize("name, task, B, steps", GOLDENS)
def test_golden_replay(name, task, B, steps):
    golden = harness.load_golden(name)
    assert golden is not None, harness.golden_path(name)
    jenv = tgx.make(task, num_envs=B, seed=0)
    env = tgt.make(task, num_envs=B, seed=0, device="cpu")
    js, actions = _jax_reset_and_actions(jenv, steps)
    assert actions.shape == (steps, B, env.num_actions)
    got = harness.replay(env, _port_state(env, js), actions)
    done = golden["done"] > 0.5
    first = np.where(done.any(0), done.argmax(0), steps)      # each env's first done
    compared = 0
    for b in range(B):
        n = min(int(first[b]) + 1, steps)
        for k in ("reward", "done", "obs"):
            np.testing.assert_allclose(got[k][:n, b], golden[k][:n, b], rtol=0,
                                       atol=REWARD_ATOL[task] if k == "reward" else ATOL,
                                       err_msg=f"{name}: {k} of env {b}")
        compared += n
    assert compared > 0
    kept = ~done[:-1].any(0)                                  # never reset inside the window
    assert kept.any() == (task == "Ant")
    for k in ("final_q", "final_qd"):
        np.testing.assert_allclose(got[k][kept], golden[k][kept], atol=ATOL, rtol=0,
                                   err_msg=f"{name}: {k}")
