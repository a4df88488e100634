"""PPO actor-learner (rl_games ``a2c_continuous``) on the MLP path. Port of
``thormang_isaacgym_tpu/learn/ppo.py``:

- synchronous on-policy: roll out ``horizon_length`` steps, then
  ``mini_epochs`` x minibatch updates
- GAE(gamma, tau) with the value bootstrap on timeouts, advantage
  normalization, clipped surrogate, clipped value loss, bounds loss (soft
  bound 1.1), grad-norm clipping (``truncate_grads``), Adam (eps 1e-8)
- adaptive-KL learning rate, once per mini-epoch on its mean KL; a
  non-finite KL counts as too high
- running obs / value normalization
- bf16 autocast around the MLP when ``mixed_precision`` holds on CUDA

Randomness (init, action noise, minibatch permutations) comes from explicit
``torch.Generator``s seeded from the config. LSTM and asymmetric-critic
training wait for a later slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from thormang_isaacgym_tpu_torch.engine.env import EnvState, VecEnv, resolve_device
from thormang_isaacgym_tpu_torch.learn.networks import ActorCritic
from thormang_isaacgym_tpu_torch.learn.normalize import (
    RMSState, rms_denormalize, rms_normalize, rms_update,
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Field names follow the rl_games config keys."""
    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 1e-4
    lr_schedule: str = "adaptive"
    kl_threshold: float = 0.002
    e_clip: float = 0.2
    clip_value: bool = True
    critic_coef: float = 2.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 0.01
    grad_norm: float = 1.0
    truncate_grads: bool = True
    horizon_length: int = 64
    minibatch_size: int = 32768
    mini_epochs: int = 5
    reward_shaper_scale: float = 0.1
    normalize_input: bool = False
    normalize_value: bool = False
    normalize_advantage: bool = True
    value_bootstrap: bool = False
    max_epochs: int = 1000
    units: tuple = (512, 512, 512)
    activation: str = "elu"
    separate: bool = False
    fixed_sigma: bool = True
    sigma_init: float = 0.0
    mixed_precision: bool = True
    seed: int = 42
    rnn_units: int = 0

    @staticmethod
    def from_rlgames(cfg: dict) -> "PPOConfig":
        """Build from a reference-style train YAML dict (params.config +
        params.network)."""
        c = cfg.get("params", cfg)
        conf = c.get("config", {})
        net = c.get("network", {})
        mlp = net.get("mlp", {})
        space = net.get("space", {}).get("continuous", {})
        keys = ("gamma", "tau", "learning_rate", "lr_schedule", "kl_threshold", "e_clip",
                "clip_value", "critic_coef", "entropy_coef", "bounds_loss_coef",
                "grad_norm", "truncate_grads", "horizon_length", "minibatch_size",
                "mini_epochs", "normalize_input", "normalize_value",
                "normalize_advantage", "value_bootstrap", "max_epochs", "mixed_precision")
        kw = {k: conf[k] for k in keys if k in conf}
        if "reward_shaper" in conf:
            kw["reward_shaper_scale"] = conf["reward_shaper"].get("scale_value", 1.0)
        if "units" in mlp:
            kw["units"] = tuple(mlp["units"])
        if "activation" in mlp:
            kw["activation"] = mlp["activation"]
        if "separate" in net:
            kw["separate"] = net["separate"]
        if "fixed_sigma" in space:
            kw["fixed_sigma"] = space["fixed_sigma"]
        si = space.get("sigma_init")
        if isinstance(si, dict):
            si = si.get("val")
        if si is not None:
            kw["sigma_init"] = float(si)
        rnn = net.get("rnn")
        if rnn:
            kw["rnn_units"] = int(rnn.get("units", 256))
        if isinstance(kw.get("learning_rate"), str):
            kw["learning_rate"] = float(kw["learning_rate"])
        return PPOConfig(**kw)


@dataclasses.dataclass
class TrainState:
    model: ActorCritic        # the policy / value network (its parameters are the weights)
    adam_m: list              # Adam first moments, one per parameter
    adam_v: list              # Adam second moments
    adam_step: int
    lr: torch.Tensor          # () current learning rate
    obs_rms: RMSState
    value_rms: RMSState
    epoch: int
    gen: torch.Generator      # action noise + minibatch permutations


def gaussian_logprob(mu, log_std, action):
    std = torch.exp(log_std)
    return torch.sum(-0.5 * ((action - mu) / std) ** 2 - log_std
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)


def gaussian_kl(mu0, log_std0, mu1, log_std1):
    """KL(old || new), rl_games' policy_kl formulation."""
    std0, std1 = torch.exp(log_std0), torch.exp(log_std1)
    kl = log_std1 - log_std0 + (std0 ** 2 + (mu0 - mu1) ** 2) / (2.0 * std1 ** 2) - 0.5
    return torch.sum(kl, dim=-1)


class PPO:
    """Binds a VecEnv + PPOConfig to a train iteration. Runs on `device`
    (default CUDA); the env must live on the same device."""

    def __init__(self, env: VecEnv, config: PPOConfig, device=None):
        self.env = env
        self.cfg = config
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, PPO on {self.device}")
        if config.rnn_units > 0:
            raise NotImplementedError("LSTM policies are not ported yet")
        if not config.fixed_sigma:
            raise NotImplementedError("a state-dependent sigma head is not ported yet")
        if int(getattr(env.task, "num_states", 0) or 0) > 0:
            raise NotImplementedError("asymmetric critics are not ported yet")
        if getattr(env.task, "num_agents", 1) > 1:
            raise NotImplementedError("multi-agent tasks are not ported yet")
        self.use_bf16 = bool(config.mixed_precision) and self.device.type == "cuda"

    # ------------------------------------------------------------------
    def init(self, seed: int | None = None) -> TrainState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        model = ActorCritic(self.env.num_obs, self.env.num_actions, units=cfg.units,
                            activation=cfg.activation, separate=cfg.separate,
                            sigma_init=cfg.sigma_init, seed=seed).to(self.device)
        params = list(model.parameters())
        dev = self.device
        return TrainState(
            model=model,
            adam_m=[torch.zeros_like(p) for p in params],
            adam_v=[torch.zeros_like(p) for p in params],
            adam_step=0,
            lr=torch.tensor(float(cfg.learning_rate), device=dev),
            obs_rms=RMSState.create((self.env.num_obs,), dev),
            value_rms=RMSState.create((), dev),
            epoch=0,
            gen=torch.Generator(device=dev).manual_seed(int(seed) + 1))

    # ------------------------------------------------------------------
    def _apply(self, ts: TrainState, obs):
        with torch.autocast(device_type=self.device.type, dtype=torch.bfloat16,
                            enabled=self.use_bf16):
            return ts.model(obs)

    def _policy(self, ts: TrainState, obs):
        if self.cfg.normalize_input:
            obs = rms_normalize(ts.obs_rms, obs)
        mu, log_std, value = self._apply(ts, obs)
        if self.cfg.normalize_value:
            value = rms_denormalize(ts.value_rms, value)
        return mu, log_std, value

    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, ts: TrainState, env_state: EnvState):
        """horizon_length env steps; returns (env_state, traj of (T, B, ...))."""
        keys = ("obs", "action", "logp", "value", "reward", "done", "timeout", "mu", "log_std")
        traj = {k: [] for k in keys}
        for _ in range(self.cfg.horizon_length):
            obs = env_state.obs
            mu, log_std, value = self._policy(ts, obs)
            noise = torch.randn(mu.shape, generator=ts.gen, device=mu.device)
            action = mu + torch.exp(log_std) * noise
            logp = gaussian_logprob(mu, log_std, action)
            env_state = self.env.step_fn(env_state, action)
            for k, v in (("obs", obs), ("action", action), ("logp", logp), ("value", value),
                         ("reward", env_state.reward), ("done", env_state.done),
                         ("timeout", env_state.timeout), ("mu", mu), ("log_std", log_std)):
                traj[k].append(v)
        return env_state, {k: torch.stack(v) for k, v in traj.items()}

    # ------------------------------------------------------------------
    def compute_gae(self, traj, last_value):
        cfg = self.cfg
        reward = traj["reward"] * cfg.reward_shaper_scale
        if cfg.value_bootstrap:
            reward = reward + cfg.gamma * traj["value"] * traj["timeout"]
        not_done = 1.0 - traj["done"]
        value = traj["value"]
        adv = torch.zeros_like(value)
        gae = torch.zeros_like(last_value)
        next_value = last_value
        for t in range(value.shape[0] - 1, -1, -1):
            delta = reward[t] + cfg.gamma * next_value * not_done[t] - value[t]
            gae = delta + cfg.gamma * cfg.tau * not_done[t] * gae
            adv[t] = gae
            next_value = value[t]
        return adv, adv + value

    # ------------------------------------------------------------------
    def _loss(self, ts: TrainState, batch):
        cfg = self.cfg
        obs = batch["obs"]
        if cfg.normalize_input:
            obs = rms_normalize(ts.obs_rms, obs)
        mu, log_std, value = self._apply(ts, obs)
        logp = gaussian_logprob(mu, log_std, batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip) * adv
        a_loss = -torch.minimum(surr1, surr2).mean()

        ret, old_value = batch["ret"], batch["value"]
        if cfg.normalize_value:
            ret = rms_normalize(ts.value_rms, ret)
            old_value = rms_normalize(ts.value_rms, old_value)
        if cfg.clip_value:
            v_clipped = old_value + torch.clamp(value - old_value, -cfg.e_clip, cfg.e_clip)
            v_loss = torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).mean()
        else:
            v_loss = ((value - ret) ** 2).mean()
        entropy = gaussian_entropy(log_std).mean()
        sb = 1.1
        b_loss = (torch.clamp(mu - sb, min=0.0) ** 2
                  + torch.clamp(-sb - mu, min=0.0) ** 2).sum(-1).mean()
        total = (a_loss + 0.5 * v_loss * cfg.critic_coef
                 - cfg.entropy_coef * entropy + cfg.bounds_loss_coef * b_loss)
        kl = gaussian_kl(batch["mu"], batch["log_std"], mu, log_std).mean()
        return total, dict(a_loss=a_loss, v_loss=v_loss, entropy=entropy, b_loss=b_loss, kl=kl)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _apply_grads(self, ts: TrainState, grads) -> None:
        """Optional global-norm clip, then Adam (b1 0.9, b2 0.999, eps 1e-8)
        scaled by the learning-rate tensor."""
        cfg = self.cfg
        if cfg.truncate_grads:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < cfg.grad_norm, torch.ones_like(norm), cfg.grad_norm / norm)
            grads = [g * scale for g in grads]
        ts.adam_step += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1.0 - b1 ** ts.adam_step, 1.0 - b2 ** ts.adam_step
        for p, g, m, v in zip(ts.model.parameters(), grads, ts.adam_m, ts.adam_v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(ts.lr * (m / c1) / (torch.sqrt(v / c2) + eps))

    def _adaptive_lr(self, lr, kl):
        cfg = self.cfg
        if cfg.lr_schedule != "adaptive":
            return lr
        kl = torch.where(torch.isfinite(kl), kl, torch.full_like(kl, 10.0 * cfg.kl_threshold))
        lr = torch.where(kl > 2.0 * cfg.kl_threshold, lr / 1.5, lr)
        lr = torch.where(kl < 0.5 * cfg.kl_threshold, lr * 1.5, lr)
        return torch.clamp(lr, 1e-6, 1e-2)

    # ------------------------------------------------------------------
    def train_iteration(self, ts: TrainState, env_state: EnvState):
        """One epoch: rollout + mini_epochs of minibatch updates. Returns
        (ts, env_state, metrics of () tensors); nothing waits for the device."""
        cfg = self.cfg
        env_state, traj = self.rollout(ts, env_state)
        with torch.no_grad():
            _, _, last_value = self._policy(ts, env_state.obs)
            advantages, returns = self.compute_gae(traj, last_value)
        batch = {k: traj[k].reshape((-1,) + traj[k].shape[2:])
                 for k in ("obs", "action", "logp", "value", "mu", "log_std")}
        batch["adv"] = advantages.reshape(-1)
        batch["ret"] = returns.reshape(-1)
        if cfg.normalize_advantage:
            adv = batch["adv"]
            batch["adv"] = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
        if cfg.normalize_input:
            ts.obs_rms = rms_update(ts.obs_rms, batch["obs"])
        if cfg.normalize_value:
            ts.value_rms = rms_update(ts.value_rms, batch["ret"])

        N = batch["obs"].shape[0]
        mb = min(cfg.minibatch_size, N)
        nmb = N // mb
        params = list(ts.model.parameters())
        auxs = {k: [] for k in ("a_loss", "v_loss", "entropy", "b_loss", "kl")}
        last_kl = None
        for _ in range(cfg.mini_epochs):
            perm = torch.randperm(N, generator=ts.gen, device=self.device)
            kls = []
            for i in range(nmb):
                idx = perm[i * mb:(i + 1) * mb]
                loss, aux = self._loss(ts, {k: v[idx] for k, v in batch.items()})
                grads = torch.autograd.grad(loss, params)
                self._apply_grads(ts, grads)
                for k in auxs:
                    auxs[k].append(aux[k].detach())
                kls.append(aux["kl"].detach())
            last_kl = torch.stack(kls).mean()
            ts.lr = self._adaptive_lr(ts.lr, last_kl)
        ts.epoch += 1
        metrics = dict(
            reward_mean=traj["reward"].mean(),
            episode_return_mean=env_state.last_episode_return.mean(),
            episode_done_frac=traj["done"].mean(),
            kl=last_kl,
            a_loss=torch.stack(auxs["a_loss"]).mean(),
            v_loss=torch.stack(auxs["v_loss"]).mean(),
            entropy=torch.stack(auxs["entropy"]).mean(),
            lr=ts.lr)
        return ts, env_state, metrics
