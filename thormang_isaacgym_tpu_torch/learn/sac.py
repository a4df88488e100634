"""Soft Actor-Critic (rl_games' ``sac`` agent as the reference's
``cfg/train/AntSAC.yaml`` and ``HumanoidSAC.yaml`` configure it). Port of
``thormang_isaacgym_tpu/learn/sac.py``:

- twin Q critics (``DoubleQ``: ``q1_i``, ``q1_out``, ``q2_i``, ``q2_out``
  over [obs, action]) and a polyak-averaged target copy
- a squashed-Gaussian actor (``SquashedActor``: ``a_i``, ``mu`` and a
  ``log_std`` head squashed into ``log_std_bounds``); the log-probability
  clips 1 - a^2 at 1e-6
- a learnable temperature alpha (``log_alpha``) against the target entropy
  -num_actions
- one Adam each (b1 0.9, b2 0.999, eps 1e-8) for the actor, the critic and
  log_alpha
- a uniform replay ring on the device, ``(slots, B, ...)`` tensors with
  ``slots = max(2, replay_buffer_size // B)``; ``not_done`` is
  1 - clip(done - timeout, 0, 1), so a timeout bootstraps

One ``train_iteration`` collects ``steps_per_iteration`` env steps, then,
once ``num_seed_steps`` iterations have only collected, runs ``grad_steps``
gradient steps, each in the JAX package's order: the target from the
pre-update alpha and the target critic; the critic's Adam step; the actor's
loss through the updated critic (which gets no gradient from it); the
temperature's loss on the actor loss's log-probabilities, detached; polyak
averaging last.

Randomness (init, action noise, batch indices, reparameterisation noise)
comes from the train state's ``torch.Generator``, through ``noise`` and
``indices``; the tests feed the JAX package's draws through those two.
The JAX CLI does not dispatch SAC, so neither does the port's: the entry is
``SAC.train`` (or ``init`` and ``train_iteration``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from thormang_isaacgym_tpu_torch.engine.env import EnvState, VecEnv, resolve_device
from thormang_isaacgym_tpu_torch.learn.networks import _init_linears, _mlp
from thormang_isaacgym_tpu_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """Field names follow the rl_games SAC config keys (AntSAC.yaml)."""
    gamma: float = 0.99
    critic_tau: float = 0.005
    batch_size: int = 4096
    init_alpha: float = 1.0
    learnable_temperature: bool = True
    replay_buffer_size: int = 1_000_000
    num_seed_steps: int = 5           # collection-only iterations at start
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 5e-3
    units: tuple = (512, 256)
    steps_per_iteration: int = 16     # env steps collected per iteration
    grad_steps: int = 16              # gradient steps per iteration
    log_std_bounds: tuple = (-5.0, 2.0)


class DoubleQ(nn.Module):
    """Two ReLU MLPs over [obs, action], each to one Q value."""

    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int], seed: int = 0):
        super().__init__()
        dims = [num_obs + num_actions, *units]
        self.q1 = _mlp(dims)
        self.q1_out = nn.Linear(dims[-1], 1)
        self.q2 = _mlp(dims)
        self.q2_out = nn.Linear(dims[-1], 1)
        _init_linears(self, seed)

    @staticmethod
    def _q(layers, out, x):
        for layer in layers:
            x = torch.relu(layer(x))
        return out(x)[..., 0]

    def forward(self, obs: torch.Tensor, action: torch.Tensor):
        x = torch.cat([obs, action], dim=-1)
        return self._q(self.q1, self.q1_out, x), self._q(self.q2, self.q2_out, x)


class SquashedActor(nn.Module):
    """A ReLU MLP to mu and log_std; log_std squashed into its bounds."""

    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int],
                 log_std_bounds: tuple = (-5.0, 2.0), seed: int = 0):
        super().__init__()
        self.trunk = _mlp([num_obs, *units])
        width = units[-1] if units else num_obs
        self.mu = nn.Linear(width, num_actions)
        self.log_std = nn.Linear(width, num_actions)
        self.log_std_bounds = tuple(float(b) for b in log_std_bounds)
        _init_linears(self, seed)

    def forward(self, obs: torch.Tensor):
        x = obs
        for layer in self.trunk:
            x = torch.relu(layer(x))
        lo, hi = self.log_std_bounds
        log_std = lo + 0.5 * (hi - lo) * (torch.tanh(self.log_std(x)) + 1.0)
        return self.mu(x), log_std


def squashed_sample(mu: torch.Tensor, log_std: torch.Tensor, eps: torch.Tensor):
    """a = tanh(mu + std eps) and its log-probability (the tanh Jacobian's
    1 - a^2 clipped at 1e-6)."""
    a = torch.tanh(mu + torch.exp(log_std) * eps)
    logp = torch.sum(-0.5 * eps ** 2 - log_std - 0.5 * math.log(2 * math.pi)
                     - torch.log(torch.clamp(1 - a ** 2, min=1e-6)), dim=-1)
    return a, logp


@dataclasses.dataclass
class Adam:
    """Adam moments and step count of a list of parameters."""
    m: list
    v: list
    count: int = 0

    @staticmethod
    def like(params: list) -> "Adam":
        return Adam([torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: list, grads: list, lr: float) -> None:
        """optax.adam: bias-corrected moments, update -lr m / (sqrt(v) + eps)."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.count += 1
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))


@dataclasses.dataclass
class SACTrainState:
    actor: SquashedActor
    critic: DoubleQ
    target_critic: DoubleQ
    log_alpha: torch.Tensor   # () float32, trained as a parameter
    actor_opt: Adam
    critic_opt: Adam
    alpha_opt: Adam
    buffer: dict              # obs, action, reward, next_obs, not_done: (slots, B, ...)
    buffer_pos: int           # transitions written per env
    buffer_full: bool
    step: int                 # train iterations done
    gen: torch.Generator      # action noise, batch indices, reparameterisation noise

    @property
    def buffer_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.buffer.values())


class SAC:
    """Binds a VecEnv and a SACConfig to SAC's train iteration. Runs on
    `device` (default CUDA); the env must live on the same device."""

    def __init__(self, env: VecEnv, config: SACConfig, device=None):
        self.env = env
        self.cfg = config
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, SAC on {self.device}")
        self.target_entropy = -float(env.num_actions)
        # per-env slots: capacity in transitions, stored as (slots, B, ...)
        self.slots = max(2, config.replay_buffer_size // env.num_envs)

    def init(self, seed: int = 0) -> SACTrainState:
        cfg, dev = self.cfg, self.device
        n_obs, n_act, B = self.env.num_obs, self.env.num_actions, self.env.num_envs
        actor = SquashedActor(n_obs, n_act, cfg.units, cfg.log_std_bounds, seed=seed).to(dev)
        critic = DoubleQ(n_obs, n_act, cfg.units, seed=seed + 1).to(dev)
        target = DoubleQ(n_obs, n_act, cfg.units, seed=seed + 1).to(dev)
        target.load_state_dict(critic.state_dict())
        target.requires_grad_(False)
        log_alpha = torch.tensor(math.log(cfg.init_alpha), dtype=torch.float32, device=dev)
        buffer = dict(
            obs=torch.zeros(self.slots, B, n_obs, device=dev),
            action=torch.zeros(self.slots, B, n_act, device=dev),
            reward=torch.zeros(self.slots, B, device=dev),
            next_obs=torch.zeros(self.slots, B, n_obs, device=dev),
            not_done=torch.ones(self.slots, B, device=dev))
        return SACTrainState(
            actor=actor, critic=critic, target_critic=target, log_alpha=log_alpha,
            actor_opt=Adam.like(list(actor.parameters())),
            critic_opt=Adam.like(list(critic.parameters())),
            alpha_opt=Adam.like([log_alpha]), buffer=buffer, buffer_pos=0, buffer_full=False,
            step=0, gen=torch.Generator(device=dev).manual_seed(int(seed) + 2))

    # ---- the draws (the tests feed the JAX package's through these) ----
    def noise(self, ts: SACTrainState, shape: tuple) -> torch.Tensor:
        """N(0, 1) reparameterisation noise."""
        return torch.randn(shape, generator=ts.gen, device=self.device)

    def indices(self, ts: SACTrainState, n_valid: int):
        """(slot, env) indices of one batch, uniform over the valid slots."""
        bs, B = self.cfg.batch_size, self.env.num_envs
        slot = torch.randint(0, n_valid, (bs,), generator=ts.gen, device=self.device)
        env = torch.randint(0, B, (bs,), generator=ts.gen, device=self.device)
        return slot, env

    # ------------------------------------------------------------------
    @torch.no_grad()
    def collect(self, ts: SACTrainState, env_state: EnvState) -> EnvState:
        """One env step on the actor's sample; the transition into the ring."""
        obs = env_state.obs
        mu, log_std = ts.actor(obs)
        action, _ = squashed_sample(mu, log_std, self.noise(ts, tuple(mu.shape)))
        env_state = self.env.step_fn(env_state, action)
        not_done = 1.0 - torch.clamp(env_state.done - env_state.timeout, 0.0, 1.0)
        slot = ts.buffer_pos % self.slots
        for k, v in (("obs", obs), ("action", action), ("reward", env_state.reward),
                     ("next_obs", env_state.obs), ("not_done", not_done)):
            ts.buffer[k][slot] = v
        ts.buffer_pos += 1
        ts.buffer_full = ts.buffer_full or ts.buffer_pos >= self.slots
        return env_state

    def grad_step(self, ts: SACTrainState, n_valid: int) -> dict:
        cfg = self.cfg
        slot, env = self.indices(ts, n_valid)
        batch = {k: v[slot, env] for k, v in ts.buffer.items()}
        alpha = torch.exp(ts.log_alpha).detach()
        n_act = self.env.num_actions
        eps_next = self.noise(ts, (cfg.batch_size, n_act))
        eps = self.noise(ts, (cfg.batch_size, n_act))

        # the critic: target from the pre-update alpha and the target critic
        with torch.no_grad():
            mu_n, ls_n = ts.actor(batch["next_obs"])
            a_n, logp_n = squashed_sample(mu_n, ls_n, eps_next)
            q1_t, q2_t = ts.target_critic(batch["next_obs"], a_n)
            target = batch["reward"] + cfg.gamma * batch["not_done"] * (
                torch.minimum(q1_t, q2_t) - alpha * logp_n)
        critic_params = list(ts.critic.parameters())
        q1, q2 = ts.critic(batch["obs"], batch["action"])
        closs = ((q1 - target) ** 2 + (q2 - target) ** 2).mean()
        ts.critic_opt.step(critic_params, torch.autograd.grad(closs, critic_params),
                           cfg.critic_lr)

        # the actor, through the updated critic (no gradient reaches it)
        actor_params = list(ts.actor.parameters())
        mu, ls = ts.actor(batch["obs"])
        a, logp = squashed_sample(mu, ls, eps)
        q1, q2 = ts.critic(batch["obs"], a)
        aloss = (alpha * logp - torch.minimum(q1, q2)).mean()
        ts.actor_opt.step(actor_params, torch.autograd.grad(aloss, actor_params), cfg.actor_lr)

        # the temperature, on the actor loss's log-probabilities
        if cfg.learnable_temperature:
            g = torch.exp(ts.log_alpha) * (-logp.detach() - self.target_entropy).mean()
            ts.alpha_opt.step([ts.log_alpha], [g], cfg.alpha_lr)

        # polyak averaging of the target critic
        with torch.no_grad():
            tau = cfg.critic_tau
            for t, s in zip(ts.target_critic.parameters(), critic_params):
                t.mul_(1.0 - tau).add_(s, alpha=tau)
        return dict(critic_loss=closs.detach(), actor_loss=aloss.detach(),
                    alpha=torch.exp(ts.log_alpha))

    def train_iteration(self, ts: SACTrainState, env_state: EnvState):
        """steps_per_iteration env steps, then (after num_seed_steps
        collection-only iterations) grad_steps gradient steps. Returns
        (ts, env_state, metrics of 0-d tensors)."""
        with span("learn.iteration"):
            cfg = self.cfg
            for _ in range(cfg.steps_per_iteration):
                env_state = self.collect(ts, env_state)
            if ts.step >= cfg.num_seed_steps:
                n_valid = self.slots if ts.buffer_full else max(ts.buffer_pos, 1)
                aux = [self.grad_step(ts, n_valid) for _ in range(cfg.grad_steps)]
                critic_loss = torch.stack([x["critic_loss"] for x in aux]).mean()
                actor_loss = torch.stack([x["actor_loss"] for x in aux]).mean()
                alpha = aux[-1]["alpha"]
            else:
                critic_loss = actor_loss = torch.zeros((), device=self.device)
                alpha = torch.exp(ts.log_alpha)
            ts.step += 1
            metrics = dict(reward_mean=env_state.reward.mean(),
                           episode_return_mean=env_state.last_episode_return.mean(),
                           critic_loss=critic_loss, actor_loss=actor_loss, alpha=alpha.detach())
            return ts, env_state, metrics

    def train(self, num_iterations: int, seed: int = 42, log_every: int = 10):
        """init, reset and `num_iterations` train iterations; the history of
        every `log_every`-th iteration's metrics (and the last's)."""
        ts = self.init(seed)
        env_state = self.env.reset(seed)
        history = []
        for it in range(num_iterations):
            ts, env_state, metrics = self.train_iteration(ts, env_state)
            if it % log_every == 0 or it == num_iterations - 1:
                history.append({k: float(v) for k, v in metrics.items()} | {"iter": it})
        return ts, env_state, history
