"""Multi-task training: one PPO learner per task, stepped together each
epoch. Port of ``thormang_isaacgym_tpu/learn/multitask.py``.

Each task keeps its own env, policy, optimizer and normalizers; an epoch
runs one ``train_iteration`` of every task, in sorted name order. Each task
takes its own init and env seeds, derived from the run's seed and the
task's index (``task_seeds``; the JAX package folds the index into its key).

The JAX package traces every task's iteration into one compiled XLA program
and can shard each task's env axis over a device mesh. The port has no
program to compile: it loops over the tasks in Python, each iteration's
kernels queued on the device in turn, and claims no speed from running them
together. ``mesh`` (a process group, or True for every rank) makes each
task's learner data parallel over it (``parallel/mesh.py shard_ppo``): each
rank steps its own share of every task's envs and the gradients are averaged
task by task.
"""
from __future__ import annotations

import numpy as np

from thormang_isaacgym_tpu_torch.learn.ppo import PPO
from thormang_isaacgym_tpu_torch.utils.trace import span


def task_seeds(seed: int, index: int) -> tuple:
    """(init seed, env seed) of the task at `index` of a run seeded `seed`:
    two 32-bit words of numpy's SeedSequence over (seed, index)."""
    a, b = np.random.SeedSequence([int(seed), int(index)]).generate_state(2)
    return int(a), int(b)


class MultiTaskPPO:
    """N independent PPO learners stepped once each per epoch.

    envs: {task_name: VecEnv}; cfgs: {task_name: PPOConfig}."""

    def __init__(self, envs: dict, cfgs: dict, mesh=None, device=None):
        if set(envs) != set(cfgs) or not envs:
            raise ValueError("envs and cfgs must name the same, non-empty set of tasks")
        self.names = sorted(envs)
        self.algos = {n: PPO(envs[n], cfgs[n], device=device) for n in self.names}
        self._init = {n: None for n in self.names}
        if mesh is not None:
            from thormang_isaacgym_tpu_torch.parallel.mesh import make_mesh, shard_ppo
            group = make_mesh() if mesh is True else mesh
            for n in self.names:
                self._init[n] = shard_ppo(self.algos[n], group)[1]

    def init(self, seed: int):
        """({name: TrainState}, {name: EnvState}), each task from its own
        seeds (``task_seeds``)."""
        tss, ess = {}, {}
        for i, name in enumerate(self.names):
            init_seed, env_seed = task_seeds(seed, i)
            if self._init[name] is not None:
                tss[name], ess[name] = self._init[name](init_seed, env_seed)
            else:
                tss[name] = self.algos[name].init(init_seed)
                ess[name] = self.algos[name].env.reset(env_seed)
        return tss, ess

    def train_iteration(self, tss: dict, env_states: dict):
        """One epoch over every task: (tss, env_states, {name: metrics})."""
        out_ts, out_es, mets = {}, {}, {}
        with span("learn.iteration"):
            for name in self.names:
                out_ts[name], out_es[name], mets[name] = self.algos[name].train_iteration(
                    tss[name], env_states[name])
        return out_ts, out_es, mets

    def train(self, num_epochs: int, seed: int = 42, log_every: int = 10, callback=None):
        """`num_epochs` epochs from ``init(seed)``; a row of every task's
        metrics each `log_every` epochs and at the last, passed to
        ``callback(epoch, tss, row)``."""
        tss, ess = self.init(seed)
        history = []
        for epoch in range(num_epochs):
            tss, ess, mets = self.train_iteration(tss, ess)
            if epoch % log_every == 0 or epoch == num_epochs - 1:
                row = {"epoch": epoch}
                for n in self.names:
                    row[n] = {k: float(v) for k, v in mets[n].items()}
                history.append(row)
                if callback:
                    callback(epoch, tss, row)
        return tss, ess, history
