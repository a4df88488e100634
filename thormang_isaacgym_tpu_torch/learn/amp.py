"""AMP (Adversarial Motion Priors): the rl_games ``amp_continuous`` learner.
Port of ``thormang_isaacgym_tpu/learn/amp.py``.

PPO and a discriminator trained to tell demo motion windows from the
policy's:

- style reward  r_d = -log(max(1 - sigmoid(D), 1e-4)) x disc_reward_scale,
  from the discriminator and ``amp_rms`` as they were before the update
- combined      r = task_reward_w x r_task + disc_reward_w x r_d
- disc loss     0.5 (BCE(D(demo), 1) + BCE(D(agent), 0))
                + disc_logit_reg ||W_logits||^2
                + disc_grad_penalty E_demo ||dD/dx||^2 (x the normalised
                  demo window; the penalty's gradient reaches the weights
                  through a second derivative)
                + disc_weight_decay sum ||W||^2 (weight matrices, not biases),
  added to the PPO loss with weight disc_coef; one Adam over the
  actor-critic and the discriminator
- the agent side of each discriminator minibatch is ``amp_mb`` windows of
  the rollout and ``amp_mb`` of the replay ring (of the rollout while the
  ring is empty); the demo side ``amp_mb`` fresh windows
  (``task.fetch_amp_obs_demo``)

Where it differs from ``learn/ppo.py``, it follows the JAX AMP learner: the
adaptive learning rate is applied after every minibatch (PPO's once per
mini-epoch); the normalisers update after the style reward, in the order
obs_rms, value_rms, then amp_rms twice, with the rollout's windows and then
the demo windows; after the update ``replay_insert`` rows of the rollout,
drawn without replacement, go into the ring at its pointer. As in the JAX
package, ``learn_sigma: false`` is not read: log_std stays a trained
parameter. The play uses the actor alone (``PPO.act_deterministic``).

The task must expose ``num_amp_obs``, a task state ``amp_obs`` window and
``fetch_amp_obs_demo(gen, n)`` (``tasks/humanoid_amp.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from thormang_isaacgym_tpu_torch.engine.env import EnvState, VecEnv
from thormang_isaacgym_tpu_torch.learn.networks import AMPDiscriminator
from thormang_isaacgym_tpu_torch.learn.normalize import RMSState, rms_normalize, rms_update
from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig, TrainState
from thormang_isaacgym_tpu_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class AMPConfig(PPOConfig):
    """PPOConfig and the amp_continuous keys (HumanoidAMPPPO.yaml)."""
    amp_minibatch_size: int = 4096
    disc_coef: float = 5.0
    disc_logit_reg: float = 0.05
    disc_grad_penalty: float = 5.0
    disc_reward_scale: float = 2.0
    disc_weight_decay: float = 0.0001
    normalize_amp_input: bool = True
    task_reward_w: float = 0.0
    disc_reward_w: float = 1.0
    amp_replay_buffer_size: int = 65536
    amp_replay_keep_prob: float = 0.01
    disc_units: tuple = (1024, 512)
    disc_activation: str = "relu"

    @staticmethod
    def from_rlgames(cfg: dict) -> "AMPConfig":
        kw = dataclasses.asdict(PPOConfig.from_rlgames(cfg))
        c = cfg.get("params", cfg)
        conf = c.get("config", {})
        disc = c.get("network", {}).get("disc", {})
        for k in ("amp_minibatch_size", "disc_coef", "disc_logit_reg", "disc_grad_penalty",
                  "disc_reward_scale", "disc_weight_decay", "normalize_amp_input",
                  "task_reward_w", "disc_reward_w", "amp_replay_buffer_size",
                  "amp_replay_keep_prob"):
            if k in conf:
                kw[k] = conf[k]
        if "units" in disc:
            kw["disc_units"] = tuple(disc["units"])
        if "activation" in disc:
            kw["disc_activation"] = disc["activation"]
        kw["units"] = tuple(kw["units"])
        return AMPConfig(**kw)


@dataclasses.dataclass
class AMPTrainState(TrainState):
    disc: AMPDiscriminator = None
    amp_rms: RMSState = None
    replay: torch.Tensor = None      # (R, num_amp_obs) ring
    replay_count: int = 0            # valid rows
    replay_ptr: int = 0              # next write position

    def parameters(self) -> list:
        """The actor-critic's parameters, then the discriminator's."""
        return super().parameters() + list(self.disc.parameters())


class AMPPPO(PPO):
    """PPO with an adversarial motion-prior discriminator."""

    def __init__(self, env: VecEnv, config: AMPConfig, device=None):
        super().__init__(env, config, device)
        if self.is_rnn or self.asymmetric:
            raise NotImplementedError("AMP with an LSTM policy or an asymmetric critic: the JAX "
                                      "AMP learner has no such path to port")
        self.num_amp_obs = int(env.task.num_amp_obs)
        n_roll = config.horizon_length * env.num_envs
        self.amp_mb = min(config.amp_minibatch_size, n_roll, config.minibatch_size)
        self.replay_size = config.amp_replay_buffer_size
        self.replay_insert = max(1, int(n_roll * config.amp_replay_keep_prob))

    def init(self, seed: int | None = None) -> AMPTrainState:
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        base = super().init(seed)
        ts = AMPTrainState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(TrainState)},
            disc=AMPDiscriminator(self.num_amp_obs, cfg.disc_units, cfg.disc_activation,
                                  seed=int(seed) + 3).to(self.device),
            amp_rms=RMSState.create((self.num_amp_obs,), self.device),
            replay=torch.zeros(self.replay_size, self.num_amp_obs, device=self.device))
        ts.adam_m = [torch.zeros_like(p) for p in ts.parameters()]
        ts.adam_v = [torch.zeros_like(p) for p in ts.parameters()]
        return ts

    # ------------------------------------------------------------------
    def _amp_norm(self, ts: AMPTrainState, obs):
        return rms_normalize(ts.amp_rms, obs) if self.cfg.normalize_amp_input else obs

    def _disc(self, ts: AMPTrainState, x):
        with self._autocast():
            return ts.disc(x)

    @torch.no_grad()
    def _disc_reward(self, ts: AMPTrainState, amp_obs):
        """The style reward of the current discriminator (rl_games
        ``_calc_disc_rewards``)."""
        prob = torch.sigmoid(self._disc(ts, self._amp_norm(ts, amp_obs)))
        return -torch.log(torch.clamp(1.0 - prob, min=1e-4)) * self.cfg.disc_reward_scale

    def _record(self, traj: dict, env_state: EnvState, **kv) -> None:
        """PPO's record of one rollout step and the post-step AMP window."""
        B = env_state.obs.shape[0]
        super()._record(traj, env_state,
                        amp_obs=env_state.task.amp_obs.reshape(B, self.num_amp_obs), **kv)

    # ------------------------------------------------------------------
    def _loss(self, ts: AMPTrainState, batch):
        cfg = self.cfg
        total, aux = super()._loss(ts, batch)
        agent = self._amp_norm(ts, torch.cat([batch["amp_cur"], batch["amp_replay"]], 0))
        demo = self._amp_norm(ts, batch["amp_demo"]).detach().requires_grad_(True)
        agent_logits = self._disc(ts, agent)
        demo_logits = self._disc(ts, demo)
        # rows are independent: the gradient of the sum is each row's gradient
        demo_grad, = torch.autograd.grad(demo_logits.sum(), demo, create_graph=True)
        pred_loss = 0.5 * (F.softplus(-demo_logits).mean() + F.softplus(agent_logits).mean())
        kernels = ts.disc.kernels()
        logit_reg = torch.sum(kernels[-1] ** 2)
        grad_pen = torch.mean(torch.sum(demo_grad ** 2, dim=-1))
        wd = sum(torch.sum(k ** 2) for k in kernels)
        disc_loss = (pred_loss + cfg.disc_logit_reg * logit_reg
                     + cfg.disc_grad_penalty * grad_pen + cfg.disc_weight_decay * wd)
        aux = dict(aux, disc_loss=pred_loss,
                   disc_agent_acc=(agent_logits < 0.0).float().mean(),
                   disc_demo_acc=(demo_logits > 0.0).float().mean(), disc_grad_pen=grad_pen)
        return total + cfg.disc_coef * disc_loss, aux

    # ------------------------------------------------------------------
    def train_iteration(self, ts: AMPTrainState, env_state: EnvState):
        """One epoch: rollout, style reward, GAE, normalisers, mini_epochs of
        minibatch updates (the adaptive lr after each), the ring's insert.
        Returns (ts, env_state, metrics of () tensors)."""
        with span("learn.iteration"):
            cfg = self.cfg
            dev = self.device
            with span("ppo.rollout"):
                env_state, traj = self.rollout(ts, env_state)
            with torch.no_grad(), span("ppo.policy"):
                _, _, last_value = self._policy(ts, env_state.obs)
            with torch.no_grad(), span("ppo.gae"):
                T, B = traj["reward"].shape
                amp_flat = traj["amp_obs"].reshape(T * B, self.num_amp_obs)
                disc_r = self._disc_reward(ts, amp_flat).reshape(T, B)
                task_r = traj["reward"]
                traj["reward"] = cfg.task_reward_w * task_r + cfg.disc_reward_w * disc_r
                advantages, returns = self.compute_gae(traj, last_value)
            with span("ppo.batch"):
                batch = self.make_batch(traj, advantages, returns)
                if cfg.normalize_advantage:
                    adv = batch["adv"]
                    batch["adv"] = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
                N = batch["obs"].shape[0]
                mb = min(cfg.minibatch_size, N)
                nmb = N // mb
                amp_mb = self.amp_mb

                # demo windows for this iteration, fresh from the motion library
                demo_all = self.env.task.fetch_amp_obs_demo(ts.gen, nmb * amp_mb)
                if cfg.normalize_input:
                    ts.obs_rms = rms_update(ts.obs_rms, batch["obs"])
                if cfg.normalize_value:
                    ts.value_rms = rms_update(ts.value_rms, batch["ret"])
                if cfg.normalize_amp_input:
                    ts.amp_rms = rms_update(rms_update(ts.amp_rms, amp_flat), demo_all)

                # replay rows for every (mini-epoch, minibatch); the rollout's while
                # the ring is empty
                n_rep = cfg.mini_epochs * nmb * amp_mb
                if ts.replay_count > 0:
                    rep_rows = ts.replay[torch.randint(0, ts.replay_count, (n_rep,),
                                                       generator=ts.gen, device=dev)]
                else:
                    rep_rows = amp_flat[torch.randint(0, N, (n_rep,), generator=ts.gen, device=dev)]
                rep_rows = rep_rows.reshape(cfg.mini_epochs, nmb, amp_mb, self.num_amp_obs)
                demo_rows = demo_all.reshape(nmb, amp_mb, self.num_amp_obs)

            params = ts.parameters()
            keys = ("a_loss", "v_loss", "entropy", "kl", "disc_loss", "disc_agent_acc",
                    "disc_demo_acc")
            auxs = {k: [] for k in keys}
            for ep in range(cfg.mini_epochs):
                perm = torch.randperm(N, generator=ts.gen, device=dev)
                for i in range(nmb):
                    with span("ppo.loss"):
                        idx = perm[i * mb:(i + 1) * mb]
                        mb_batch = {k: v[idx] for k, v in batch.items()}
                        mb_batch.update(amp_cur=amp_flat[idx[:amp_mb]], amp_replay=rep_rows[ep, i],
                                        amp_demo=demo_rows[i])
                        loss, aux = self._loss(ts, mb_batch)
                    with span("ppo.backward"):
                        grads = self.grads(loss, params)
                    grads, aux = self.reduce(grads, aux)
                    with span("ppo.adam"):
                        self._apply_grads(ts, grads)
                    ts.lr = self._adaptive_lr(ts.lr, aux["kl"].detach())
                    for k in keys:
                        auxs[k].append(aux[k].detach())

            # a keep-prob subsample of this rollout into the ring
            n_ins = self.replay_insert
            ins = torch.randperm(N, generator=ts.gen, device=dev)[:n_ins]
            pos = (ts.replay_ptr + torch.arange(n_ins, device=dev)) % self.replay_size
            ts.replay[pos] = amp_flat[ins]
            ts.replay_count = min(ts.replay_count + n_ins, self.replay_size)
            ts.replay_ptr = (ts.replay_ptr + n_ins) % self.replay_size
            ts.epoch += 1

            def mean(k):
                return torch.stack(auxs[k]).mean()

            metrics = dict(
                reward_mean=traj["reward"].mean(),
                task_reward_mean=task_r.mean(),
                disc_reward_mean=disc_r.mean(),
                episode_return_mean=env_state.last_episode_return.mean(),
                episode_done_frac=traj["done"].mean(),
                kl=torch.stack(auxs["kl"][-nmb:]).mean(),
                a_loss=mean("a_loss"), v_loss=mean("v_loss"), disc_loss=mean("disc_loss"),
                disc_agent_acc=mean("disc_agent_acc"), disc_demo_acc=mean("disc_demo_acc"),
                entropy=mean("entropy"), lr=ts.lr)
            return ts, env_state, metrics
