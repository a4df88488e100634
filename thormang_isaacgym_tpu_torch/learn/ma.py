"""Multi-agent PPO: parameter-shared independent PPO over the agent axis.
Port of ``thormang_isaacgym_tpu/learn/ma.py``.

One policy is shared by the task's ``num_agents`` agents, and the agent axis
rides along as a trailing batch axis: obs (B, A, O) -> actions (B, A, act),
rewards (B, A). The env's done and timeout are per env (the reference's
multi_vec_task resets a whole env), so the rollout broadcasts them onto the
agent axis before GAE (the JAX package overrides the rollout for that; the
port overrides the rollout's record of a step). The rest is PPO's,
unchanged:

- the batch flattens (T, B, A, ...) into (T B, A, ...), so a minibatch
  counts env transitions, each with its A agents:
  ``mb = min(minibatch_size, T B)``
- the losses reduce over (mb, A); the advantages are normalised over
  T B A; ``obs_rms`` and ``value_rms`` update over every agent

The JAX MAPPO overrides only the MLP rollout and passes no LSTM carry or
privileged states, so an LSTM or asymmetric config has no JAX path to port
and raises here.
"""
from __future__ import annotations

from thormang_isaacgym_tpu_torch.engine.env import EnvState, VecEnv
from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig


class MAPPO(PPO):
    """PPO with a shared policy over ``task.num_agents`` agents."""

    multi_agent = True

    def __init__(self, env: VecEnv, config: PPOConfig, device=None):
        super().__init__(env, config, device)
        self.num_agents = int(getattr(env.task, "num_agents", 1))
        if self.num_agents < 2:
            raise ValueError("MAPPO takes a multi-agent task (num_agents > 1); "
                             "use PPO for a single-agent one")
        if self.is_rnn or self.asymmetric:
            raise NotImplementedError("MAPPO with an LSTM policy or an asymmetric critic: the "
                                      "JAX MAPPO has no such path to port")

    def _record(self, traj: dict, env_state: EnvState, **kv) -> None:
        """PPO's record of one rollout step, the per-env done and timeout
        broadcast to (B, A)."""
        super()._record(traj, env_state, **kv)
        for k in ("done", "timeout"):
            traj[k][-1] = traj[k][-1][:, None].expand(-1, self.num_agents)
