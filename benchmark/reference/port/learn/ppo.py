"""PPO actor-learner (rl_games ``a2c_continuous``), MLP or LSTM policy, shared or
central critic. Port of ``thormang_isaacgym_tpu/learn/ppo.py``:

- synchronous on-policy: roll out ``horizon_length`` steps, then
  ``mini_epochs`` x minibatch updates
- GAE(gamma, tau) with the value bootstrap on timeouts, advantage
  normalization, clipped surrogate, clipped value loss, bounds loss (soft
  bound 1.1), grad-norm clipping (``truncate_grads``), Adam (eps 1e-8)
- adaptive-KL learning rate, once per mini-epoch on its mean KL; a
  non-finite KL counts as too high
- running obs / value normalization
- bf16 autocast around the networks when ``mixed_precision`` holds on CUDA
- asymmetric actor-critic: where the task has privileged states
  (``num_states > 0``), the value comes from a central ``ValueNet`` over
  them, normalised by ``states_rms``; one Adam step and one global-norm clip
  cover the actor and the critic together, as optax's chain over
  ``{"ac", "cv"}`` does
- LSTM policies (the rl_games ``rnn:`` block and ``seq_len``): the rollout
  threads the carry, masked by the previous step's done before each step,
  and stores each step's input carry; the minibatches are sequences of
  ``seq_len`` steps, each re-run from its stored carry (truncated BPTT),
  masked inside the sequence by the previous step's done. As in the JAX
  package, and unlike rl_games, the carry starts at zero every iteration.

Randomness (init, action noise, minibatch permutations) comes from explicit
``torch.Generator``s seeded from the config.

The copy keeps what the benchmark's cells reach: one process, no data
parallel (the port's ``reduce`` is the identity there), no play mode, no
host training loop.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference.port.engine.env import EnvState, VecEnv, resolve_device
from benchmark.reference.port.learn.networks import ActorCritic, ActorCriticRNN, ValueNet
from benchmark.reference.port.learn.normalize import (
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
    # the rl_games rnn block and seq_len; rnn_units 0 is the MLP
    rnn_units: int = 0
    rnn_layers: int = 1
    rnn_before_mlp: bool = False
    rnn_concat_input: bool = False
    rnn_layer_norm: bool = False
    seq_len: int = 4

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
        if rnn and rnn.get("name", "lstm") == "lstm":
            kw["rnn_units"] = int(rnn.get("units", 256))
            kw["rnn_layers"] = int(rnn.get("layers", 1))
            kw["rnn_before_mlp"] = bool(rnn.get("before_mlp", False))
            kw["rnn_concat_input"] = bool(rnn.get("concat_input", False))
            kw["rnn_layer_norm"] = bool(rnn.get("layer_norm", False))
        for key in ("seq_length", "seq_len"):
            if key in conf:
                kw["seq_len"] = int(conf[key])
        if isinstance(kw.get("learning_rate"), str):
            kw["learning_rate"] = float(kw["learning_rate"])
        return PPOConfig(**kw)


@dataclasses.dataclass
class TrainState:
    model: ActorCritic | ActorCriticRNN   # the policy (and, symmetric, value) network
    value_net: ValueNet | None            # the asymmetric critic, else None
    adam_m: list              # Adam first moments, one per parameter (``parameters()``)
    adam_v: list              # Adam second moments
    adam_step: int
    lr: torch.Tensor          # () current learning rate
    obs_rms: RMSState
    value_rms: RMSState
    states_rms: RMSState      # (max(num_states, 1),) privileged-state normalizer
    epoch: int
    gen: torch.Generator      # action noise + minibatch permutations

    def parameters(self) -> list:
        """The trained parameters: the model's, then the value net's."""
        extra = list(self.value_net.parameters()) if self.value_net is not None else []
        return list(self.model.parameters()) + extra


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

    # a learner that takes a task with num_agents > 1 (learn/ma.py MAPPO)
    multi_agent = False

    def __init__(self, env: VecEnv, config: PPOConfig, device=None):
        self.env = env
        self.cfg = config
        self.device = resolve_device(device)
        if torch.device(env.device) != self.device:
            raise ValueError(f"env is on {env.device}, PPO on {self.device}")
        if getattr(env.task, "num_agents", 1) > 1 and not self.multi_agent:
            raise ValueError("a multi-agent task (num_agents > 1) trains with "
                             "learn/ma.py MAPPO, not PPO")
        self.num_states = int(getattr(env.task, "num_states", 0) or 0)
        self.asymmetric = self.num_states > 0
        self.is_rnn = config.rnn_units > 0
        if self.is_rnn and config.horizon_length % config.seq_len:
            raise ValueError(f"horizon_length {config.horizon_length} is not a multiple of "
                             f"seq_len {config.seq_len}")
        self.use_bf16 = bool(config.mixed_precision) and self.device.type == "cuda"

    # ------------------------------------------------------------------
    def init(self, seed: int | None = None) -> TrainState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        n_obs, n_act = self.env.num_obs, self.env.num_actions
        if self.is_rnn:
            model = ActorCriticRNN(n_obs, n_act, units=cfg.units, rnn_units=cfg.rnn_units,
                                   rnn_layers=cfg.rnn_layers, before_mlp=cfg.rnn_before_mlp,
                                   concat_input=cfg.rnn_concat_input,
                                   layer_norm=cfg.rnn_layer_norm, activation=cfg.activation,
                                   fixed_sigma=cfg.fixed_sigma, sigma_init=cfg.sigma_init,
                                   seed=seed)
        else:
            model = ActorCritic(n_obs, n_act, units=cfg.units, activation=cfg.activation,
                                separate=cfg.separate, fixed_sigma=cfg.fixed_sigma,
                                sigma_init=cfg.sigma_init, seed=seed)
        value_net = ValueNet(self.num_states, units=cfg.units, activation=cfg.activation,
                             seed=int(seed) + 2).to(self.device) if self.asymmetric else None
        dev = self.device
        ts = TrainState(
            model=model.to(dev), value_net=value_net, adam_m=[], adam_v=[], adam_step=0,
            lr=torch.tensor(float(cfg.learning_rate), device=dev),
            obs_rms=RMSState.create((self.env.num_obs,), dev),
            value_rms=RMSState.create((), dev),
            states_rms=RMSState.create((max(self.num_states, 1),), dev),
            epoch=0,
            gen=torch.Generator(device=dev).manual_seed(int(seed) + 1))
        ts.adam_m = [torch.zeros_like(p) for p in ts.parameters()]
        ts.adam_v = [torch.zeros_like(p) for p in ts.parameters()]
        return ts

    # ------------------------------------------------------------------
    def _autocast(self):
        return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16,
                              enabled=self.use_bf16)

    def _critic(self, ts: TrainState, states):
        """The central value of the (normalised) privileged states."""
        if self.cfg.normalize_input:
            states = rms_normalize(ts.states_rms, states)
        with self._autocast():
            return ts.value_net(states)

    def _apply(self, ts: TrainState, obs, states=None):
        """(mu, log_std, value) on normalised obs; the value from the
        central net where asymmetric."""
        with self._autocast():
            mu, log_std, value = ts.model(obs)
        if self.asymmetric:
            value = self._critic(ts, states)
        return mu, log_std, value

    def _apply_rnn(self, ts: TrainState, obs, carry, states=None):
        with self._autocast():
            mu, log_std, value, carry = ts.model(obs, carry)
        if self.asymmetric:
            value = self._critic(ts, states)
        return mu, log_std, value, carry

    def _policy(self, ts: TrainState, obs, states=None):
        if self.cfg.normalize_input:
            obs = rms_normalize(ts.obs_rms, obs)
        mu, log_std, value = self._apply(ts, obs, states)
        if self.cfg.normalize_value:
            value = rms_denormalize(ts.value_rms, value)
        return mu, log_std, value

    def _policy_rnn(self, ts: TrainState, obs, carry, states=None):
        if self.cfg.normalize_input:
            obs = rms_normalize(ts.obs_rms, obs)
        mu, log_std, value, carry = self._apply_rnn(ts, obs, carry, states)
        if self.cfg.normalize_value:
            value = rms_denormalize(ts.value_rms, value)
        return mu, log_std, value, carry

    # ------------------------------------------------------------------
    def _sample(self, ts: TrainState, mu, log_std):
        noise = torch.randn(mu.shape, generator=ts.gen, device=mu.device)
        action = mu + torch.exp(log_std) * noise
        return action, gaussian_logprob(mu, log_std, action)

    def _record(self, traj: dict, env_state: EnvState, **kv) -> None:
        kv.update(reward=env_state.reward, done=env_state.done, timeout=env_state.timeout)
        for k, v in kv.items():
            traj.setdefault(k, []).append(v)

    @torch.no_grad()
    def rollout(self, ts: TrainState, env_state: EnvState):
        """horizon_length env steps; returns (env_state, traj of (T, B, ...))."""
        traj = {}
        for _ in range(self.cfg.horizon_length):
            obs, states = env_state.obs, env_state.states
            mu, log_std, value = self._policy(ts, obs, states)
            action, logp = self._sample(ts, mu, log_std)
            env_state = self.env.step_fn(env_state, action)
            extra = dict(states=states) if self.asymmetric else {}
            self._record(traj, env_state, obs=obs, action=action, logp=logp, value=value,
                         mu=mu, log_std=log_std, **extra)
        return env_state, {k: torch.stack(v) for k, v in traj.items()}

    @torch.no_grad()
    def rollout_rnn(self, ts: TrainState, env_state: EnvState):
        """The LSTM rollout: the carry, from zero, masked by the previous
        step's done before each step; each step's input carry is stored
        (traj "carry": (T, layers, 2, B, units)). Returns (env_state, traj,
        the last carry)."""
        B = env_state.obs.shape[0]
        carry = ts.model.zero_carry(B, self.device)
        traj = {}
        for _ in range(self.cfg.horizon_length):
            carry = carry * (1.0 - env_state.done)[:, None]
            obs, states = env_state.obs, env_state.states
            stored = carry
            mu, log_std, value, carry = self._policy_rnn(ts, obs, carry, states)
            action, logp = self._sample(ts, mu, log_std)
            env_state = self.env.step_fn(env_state, action)
            extra = dict(states=states) if self.asymmetric else {}
            self._record(traj, env_state, obs=obs, action=action, logp=logp, value=value,
                         mu=mu, log_std=log_std, carry=stored, **extra)
        return env_state, {k: torch.stack(v) for k, v in traj.items()}, carry

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
    def _objective(self, ts: TrainState, mu, log_std, value, batch):
        """The PPO loss of the outputs (mu, log_std, value) on the flat
        transitions of `batch`."""
        cfg = self.cfg
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

    def _loss(self, ts: TrainState, batch):
        obs = batch["obs"]
        if self.cfg.normalize_input:
            obs = rms_normalize(ts.obs_rms, obs)
        mu, log_std, value = self._apply(ts, obs, batch.get("states"))
        return self._objective(ts, mu, log_std, value, batch)

    def _loss_rnn(self, ts: TrainState, batch):
        """The sequence minibatch's loss: each of the S sequences of L steps
        re-run from its stored carry (batch "carry": (S, layers, 2, units)),
        the carry masked by the previous step's done (zero before the first),
        then the PPO loss over the S x L transitions."""
        S, L = batch["obs"].shape[:2]
        obs = batch["obs"]
        if self.cfg.normalize_input:
            obs = rms_normalize(ts.obs_rms, obs)
        carry = batch["carry"].permute(1, 2, 0, 3)
        prev_done = obs.new_zeros(S)
        outs = []
        for t in range(L):
            carry = carry * (1.0 - prev_done)[:, None]
            with self._autocast():
                mu, log_std, value, carry = ts.model(obs[:, t], carry)
            outs.append((mu, log_std, value))
            prev_done = batch["done"][:, t]
        mu, log_std, value = (torch.stack(x, 1).reshape((S * L,) + x[0].shape[1:])
                              for x in zip(*outs))
        flat = {k: v.reshape((S * L,) + v.shape[2:]) for k, v in batch.items()
                if k not in ("carry", "done", "obs")}
        if self.asymmetric:
            value = self._critic(ts, flat["states"])
        return self._objective(ts, mu, log_std, value, flat)

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
        for p, g, m, v in zip(ts.parameters(), grads, ts.adam_m, ts.adam_v):
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

    @staticmethod
    def grads(loss, params) -> list:
        """d loss / d params, zero for a parameter the loss does not reach
        (the actor's value head under an asymmetric critic)."""
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]

    # ------------------------------------------------------------------
    def make_batch(self, traj, advantages, returns):
        """The update's batch: transitions (T B, ...) or, for an LSTM
        policy, sequences (T/L B, L, ...) with each one's stored input
        carry (T/L B, layers, 2, units); sequence s = chunk x B + env."""
        T = self.cfg.horizon_length
        if self.is_rnn:
            L = self.cfg.seq_len

            def flat(x):
                x = x.reshape((T // L, L) + x.shape[1:]).movedim(2, 1)
                return x.reshape((-1, L) + x.shape[3:])
        else:
            def flat(x):
                return x.reshape((-1,) + x.shape[2:])

        keys = ("obs", "action", "logp", "value", "mu", "log_std") \
            + (("states",) if self.asymmetric else ()) + (("done",) if self.is_rnn else ())
        batch = {k: flat(traj[k]) for k in keys}
        batch["adv"], batch["ret"] = flat(advantages), flat(returns)
        if self.is_rnn:
            starts = traj["carry"][::self.cfg.seq_len].movedim(3, 1)
            batch["carry"] = starts.reshape((-1,) + starts.shape[2:])
        return batch

    def train_iteration(self, ts: TrainState, env_state: EnvState):
        """One epoch: rollout + mini_epochs of minibatch updates. Returns
        (ts, env_state, metrics of () tensors); nothing waits for the device."""
        cfg = self.cfg
        if self.is_rnn:
            env_state, traj, last = self.rollout_rnn(ts, env_state)
            with torch.no_grad():
                last = last * (1.0 - env_state.done)[:, None]
                _, _, last_value, _ = self._policy_rnn(ts, env_state.obs, last, env_state.states)
        else:
            env_state, traj = self.rollout(ts, env_state)
            with torch.no_grad():
                _, _, last_value = self._policy(ts, env_state.obs, env_state.states)
        with torch.no_grad():
            advantages, returns = self.compute_gae(traj, last_value)
        batch = self.make_batch(traj, advantages, returns)
        if cfg.normalize_advantage:
            adv = batch["adv"]
            batch["adv"] = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
        if cfg.normalize_input:
            ts.obs_rms = rms_update(ts.obs_rms, batch["obs"].reshape(-1, self.env.num_obs))
            if self.asymmetric:
                ts.states_rms = rms_update(ts.states_rms,
                                           batch["states"].reshape(-1, self.num_states))
        if cfg.normalize_value:
            ts.value_rms = rms_update(ts.value_rms, batch["ret"].reshape(-1))

        N = batch["obs"].shape[0]
        if self.is_rnn:
            # N counts sequences, minibatch_size transitions
            mb = max(1, min(cfg.minibatch_size, N * cfg.seq_len) // cfg.seq_len)
            loss_fn = self._loss_rnn
        else:
            mb = min(cfg.minibatch_size, N)
            loss_fn = self._loss
        nmb = N // mb
        params = ts.parameters()
        auxs = {k: [] for k in ("a_loss", "v_loss", "entropy", "b_loss", "kl")}
        last_kl = None
        for _ in range(cfg.mini_epochs):
            perm = torch.randperm(N, generator=ts.gen, device=self.device)
            kls = []
            for i in range(nmb):
                idx = perm[i * mb:(i + 1) * mb]
                loss, aux = loss_fn(ts, {k: v[idx] for k, v in batch.items()})
                grads = self.grads(loss, params)
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
