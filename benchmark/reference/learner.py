"""The reference learner: the frozen copy of the port's PPO
(``port/learn/ppo.py``) follows the program's first iterations on the env
outputs the program's rollouts recorded (observations, privileged states,
rewards, dones, timeouts). Everything the learner computes itself it
computes again from the seed: the initial weights, the action noise and
minibatch permutations (the same seeded generator), the policy's outputs,
GAE, the normalisers, the losses, the gradients and Adam's steps."""
from __future__ import annotations

import types

import torch

from benchmark.reference.port.learn.ppo import PPO, PPOConfig

B1 = 0.9


class ReplayEnv:
    """Stands in for the env: each ``step_fn`` returns the next recorded
    env output and keeps the action it was given."""

    def __init__(self, num_envs, num_obs, num_actions, num_states, device):
        self.device = torch.device(device)
        self.num_envs, self.num_obs, self.num_actions = num_envs, num_obs, num_actions
        self.task = types.SimpleNamespace(num_agents=1, num_states=num_states)
        self.actions, self._next = [], iter(())

    def load(self, rec: dict):
        """The first state of recorded iteration `rec`; its steps follow."""
        dev, T = self.device, rec["reward"].shape[0]
        zero = torch.zeros(self.num_envs, device=dev)

        def state(obs, states, done, reward=None, timeout=None):
            return types.SimpleNamespace(
                obs=obs.to(dev), states=None if states is None else states.to(dev),
                done=done.to(dev), reward=None if reward is None else reward.to(dev),
                timeout=None if timeout is None else timeout.to(dev),
                last_episode_return=zero)

        first, last = rec["first"], rec["last"]
        states = rec.get("states")
        steps = []
        for t in range(T):
            if t + 1 < T:
                obs, st = rec["obs"][t + 1], None if states is None else states[t + 1]
            else:
                obs, st = last["obs"], last["states"] if states is not None else None
            steps.append(state(obs, st, rec["done"][t], rec["reward"][t], rec["timeout"][t]))
        self._next = iter(steps)
        return state(first["obs"], first["states"] if states is not None else None,
                     first["done"])

    def step_fn(self, state, action):
        self.actions.append(action)
        return next(self._next)


def follow(train_cfg: dict, dims: dict, seed: int, iters: list, device) -> dict:
    """Run the reference learner over the recorded iterations: its
    parameters before and after, each optimizer step's loss, the first
    gradient as Adam holds it after one step, and its actions (``horizon``
    steps an iteration)."""
    cfg = PPOConfig.from_rlgames(train_cfg)
    env = ReplayEnv(dims["num_envs"], dims["num_obs"], dims["num_actions"],
                    dims["num_states"], device)
    ppo = PPO(env, cfg, device=device)
    losses, grad1 = [], []
    objective, apply_grads = ppo._objective, ppo._apply_grads

    def obj(ts, mu, log_std, value, batch):
        total, aux = objective(ts, mu, log_std, value, batch)
        losses.append(total.detach())
        return total, aux

    def grads(ts, g):
        apply_grads(ts, g)
        if not grad1:
            grad1.extend(m.detach().cpu() / (1.0 - B1) for m in ts.adam_m)

    ppo._objective, ppo._apply_grads = obj, grads
    ts = ppo.init(seed)
    params0 = [p.detach().cpu().clone() for p in ts.parameters()]
    for rec in iters:
        ts, _, _ = ppo.train_iteration(ts, env.load(rec))
    params3 = [p.detach().cpu().clone() for p in ts.parameters()]
    actions = torch.stack([a.cpu() for a in env.actions])
    return dict(params0=params0, params3=params3, losses=[float(x) for x in losses],
                grad1=grad1, actions=actions, horizon=int(iters[0]["reward"].shape[0]))
