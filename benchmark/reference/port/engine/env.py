"""The vectorized env framework: ``VecEnv`` over a ``Task``.

A frozen copy of the port's ``engine/env.py``, the benchmark's reference;
``env_id0`` may also be a tensor of the global ids of the rows. One step is a function of an
:class:`EnvState` and the actions,

  step_fn : (EnvState, actions) -> EnvState'

in the reference's order: masked auto-reset of envs done on the previous
step -> domain randomisation of the envs that are due -> action noise ->
clip(actions) -> pre_physics -> physics x control_freq_inv -> non-finite
quarantine -> post_physics (obs / reward / done) -> timeout bookkeeping ->
observation noise -> clip(obs). Nothing in ``step_fn`` waits for the
device.

Randomness is counter-based: every draw is a hash of (seed, salt, env id,
episode, draw index) (:class:`EnvRandom`), so an env's reset state depends
only on its id and episode count. The streams are deterministic and
replayable; they are not bit-equal to the JAX package's threefry streams.
The salts (``SALT``): the init's reset 0, the stagger 3, the reset 17, the
domain randomisation at init 23 and at an event 29, the correlated noise
101 (observations) and 102 (actions), all keyed on the episode; the action
noise 31, the observation noise 37 and the tasks' noise hooks 41 (actions)
and 43 (observations), keyed on ``global_step`` so they change every step.

Domain randomisation (``engine/dr.py``, ``task.dr_config``) follows the
reference: an env that resets ``frequency`` or more steps after its last
event draws new parameters from the model's defaults and new correlated
noise; ``setup_only`` entries run only at init.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from benchmark.reference.port.engine import dr
from benchmark.reference.port.models.robot import ModelParams, RobotModel
from benchmark.reference.port.ops.sim import SimParams, build_step_fn

_M32 = 0xFFFFFFFF
SALT = dict(init=0, stagger=3, reset=17, dr_setup=23, dr=29, corr_obs=101, corr_act=102,
            act_noise=31, obs_noise=37, act_hook=41, obs_hook=43)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another; raises rather than falling back to the CPU."""
    d = torch.device(device if device is not None else "cuda")
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return d


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding values < 2^32
    (products wrap mod 2^64; the mask keeps their exact low 32 bits)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


class EnvRandom:
    """Per-env uniform draws keyed on (seed, salt, env id, episode).

    The env ids are ``id0 + arange(B)``: a data-parallel rank that owns the
    global envs [id0, id0 + B) draws what one process of all the envs draws
    for those rows. ``uniform(n)`` returns (B, n) floats in [low, high);
    successive calls continue the same streams."""

    def __init__(self, seed: int, episode: torch.Tensor, salt: int, id0: int = 0):
        if isinstance(id0, torch.Tensor):
            # the reference's rows: any set of global env ids
            ids = id0.to(device=episode.device, dtype=torch.int64)
        else:
            ids = torch.arange(int(id0), int(id0) + episode.shape[0], device=episode.device,
                               dtype=torch.int64)
        h = _fmix(torch.full_like(ids, int(seed) & _M32))
        h = _fmix(h ^ (int(salt) & _M32))
        h = _fmix(h ^ ids)
        self._key = _fmix(h ^ (episode.to(torch.int64) & _M32))
        self._count = 0

    def uniform(self, n: int, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        draw = torch.arange(self._count, self._count + n, device=self._key.device)
        self._count += n
        h = _fmix(self._key[:, None] ^ draw[None, :])
        u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
        return low + (high - low) * u

    @staticmethod
    def of_step(state: "EnvState", salt: int) -> "EnvRandom":
        """A stream of this step for every env of `state`, keyed on its
        global_step (a task's per-step draws)."""
        B = state.q.shape[0]
        return EnvRandom(state.seed, state.global_step.expand(B), salt, state.env_id0)


def tree_map(fn, *trees):
    """Map over the tensors of tensors, tuples, dicts and dataclasses (task
    states, ModelParams)."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if isinstance(t0, tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    raise TypeError(f"tree_map: unsupported node {type(t0).__name__}")


def mask_select(mask: torch.Tensor, new, old):
    """Env-axis select: new where mask, else old (any tree of tensors)."""
    return mask_select_with(mask, new, old, mask.shape[0])


def mask_select_with(mask: torch.Tensor, new, old, B: int):
    """Env-axis select over B envs: new where mask, else old (any tree of
    tensors whose leaves lead with the env axis)."""
    def sel(n, o):
        return torch.where(mask.reshape((B,) + (1,) * (n.dim() - 1)), n, o)
    return tree_map(sel, new, old)


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Physics state + episode bookkeeping + task extras, batched over B."""
    q: torch.Tensor            # (B, nq)
    qd: torch.Tensor           # (B, nv)
    params: ModelParams        # batched per-env model params
    obs: torch.Tensor          # (B, num_obs)
    states: torch.Tensor       # (B, num_states) privileged critic obs
    reward: torch.Tensor       # (B,)
    done: torch.Tensor         # (B,) 1.0 where the env resets next step
    timeout: torch.Tensor      # (B,) 1.0 where done came from episode length
    progress: torch.Tensor     # (B,) int64 steps since reset
    net_contact: torch.Tensor  # (B, nb, 3) per-body net contact force
    net_torque: torch.Tensor   # (B, nb, 3) net contact torque (sensor bodies)
    seed: int                  # keys every random stream
    episode: torch.Tensor      # (B,) int64 episode counter
    global_step: torch.Tensor  # () int64 steps since init
    episode_return: torch.Tensor       # (B,)
    last_episode_return: torch.Tensor  # (B,)
    task: Any                  # task-specific state
    metrics: Any               # dict of (B,) per-task metrics
    last_rand: torch.Tensor    # (B,) int64 global_step of the env's last DR event
    # the correlated noise's standard samples, (B, dim) under "obs" / "act",
    # redrawn at an env's DR event; empty without correlated noise
    dr_corr: dict
    env_id0: int = 0           # global id of env 0 (a data-parallel rank's first)


class Task:
    """Base class of task definitions. Subclasses set ``model``,
    ``sim_params``, ``num_obs``, ``num_actions`` and implement the batched
    methods below (the reference's reset_idx / pre_physics_step /
    post_physics_step)."""

    model: RobotModel
    sim_params: SimParams
    num_obs: int
    num_actions: int
    num_states: int = 0
    num_agents: int = 1
    max_episode_length: int = 1000
    clip_actions: float = 1.0
    clip_obs: float = float("inf")
    control_freq_inv: int = 1
    # physics steps per control step folded into one sim step: a YAML whose
    # sim block is the physics step (dt 0.005, decimation 4) gives a control
    # step of dt x decimation made of substeps x decimation substeps
    decimation: int = 1
    dr_config: Optional[dict] = None
    uses_net_torque: bool = False
    net_torque_bodies: Optional[tuple] = None
    # a task whose gravity its YAML's sim block does not set (tasks/__init__.py)
    fixed_gravity: bool = False

    def __init__(self, num_envs: int, seed: int = 42, device=None):
        self.num_envs = num_envs
        self.seed = seed
        self.device = resolve_device(device)

    def set_dt(self, dt: float) -> None:
        """Adopt the control step `dt` (s); tasks recompute what derives
        from it (episode length, push interval)."""
        self.dt = dt

    def default_task_state(self) -> Any:
        return ()

    def reset_fn(self, rng: EnvRandom, params: ModelParams, task: Any):
        """Batched reset of every env: (q, qd, params, task)."""
        raise NotImplementedError

    def pre_physics(self, state: EnvState, actions: torch.Tensor):
        """actions -> (Controls, body_wrench_w (B, nb, 6), task')."""
        raise NotImplementedError

    def post_physics(self, state: EnvState, prev_task: Any):
        """-> (obs, reward, done, task', metrics); done excludes timeouts."""
        raise NotImplementedError

    def compute_states(self, state: EnvState, task_state) -> torch.Tensor:
        return state.q.new_zeros(state.q.shape[0], 0)

    def observation_noise(self, rng: EnvRandom, obs: torch.Tensor, task_state) -> torch.Tensor:
        """A task's own observation noise, before the clip (identity)."""
        return obs

    def action_noise(self, rng: EnvRandom, actions: torch.Tensor) -> torch.Tensor:
        """A task's own action noise, before the clip (identity)."""
        return actions


class VecEnv:
    """Binds a Task to its batched init / step functions.

        env = VecEnv(task)
        state = env.reset(seed)
        state = env.step(state, actions)
    """

    def __init__(self, task: Task, ground_height_fn=None,
                 stagger_episodes: bool = False):
        self.task = task
        self.device = task.device
        self.stagger_episodes = stagger_episodes
        # the global id of this env's row 0; parallel/mesh.py shard_ppo sets
        # a data-parallel rank's (its random streams are those rows')
        self.env_id0 = 0
        self.model = task.model
        dr_cfg = task.dr_config or {}
        self._dr_fn, self._dr_active = dr.make_dr_fn(dr_cfg, task.model)
        self._dr_freq = int(dr_cfg.get("frequency", 600))
        self._obs_noise_fn = dr.make_noise_fn(dr_cfg.get("observations"))
        self._act_noise_fn = dr.make_noise_fn(dr_cfg.get("actions"))
        self._dr_any = (self._dr_active or self._obs_noise_fn is not None
                        or self._act_noise_fn is not None)
        # the correlated noise: (name, noise fn, width) of each channel with
        # a range_correlated
        self._corr = [(name, fn, dim) for name, fn, dim in (
            ("obs", self._obs_noise_fn, task.num_obs), ("act", self._act_noise_fn, task.num_actions))
            if fn is not None and "range_correlated" in fn.spec]
        self._base = {}
        tq_bodies = getattr(task, "net_torque_bodies", None)
        if tq_bodies is not None:
            need_torque = tuple(int(b) for b in tq_bodies)
        else:
            need_torque = bool(getattr(task, "uses_net_torque", False))
        self.physics_step = build_step_fn(task.model, task.sim_params,
                                          ground_height_fn=ground_height_fn,
                                          attractors=getattr(task, "attractors", None),
                                          need_torque=need_torque)
        self.num_envs = task.num_envs
        self.num_obs = task.num_obs
        self.num_actions = task.num_actions

    def init_fn(self, seed: int) -> EnvState:
        task, dev = self.task, self.device
        B, nb = task.num_envs, task.model.nb
        params0 = task.model.default_params(dev).batch(B)
        task_state = task.default_task_state()
        episode = torch.zeros(B, dtype=torch.int64, device=dev)
        id0 = self.env_id0
        q, qd, params, task_state = task.reset_fn(EnvRandom(seed, episode, SALT["init"], id0),
                                                  params0, task_state)
        progress0 = torch.zeros(B, dtype=torch.int64, device=dev)
        if self.stagger_episodes:
            u = EnvRandom(seed, episode, SALT["stagger"], id0).uniform(1)[:, 0]
            span = max(int(task.max_episode_length) - 1, 1)
            progress0 = torch.clamp((u * span).to(torch.int64), max=span - 1)
        zero_step = torch.zeros((), dtype=torch.int64, device=dev)
        if self._dr_active:
            base = self.base_params(dev, B)
            rng = EnvRandom(seed, episode, SALT["dr_setup"], id0)
            params = self._dr_fn.apply(self.dr_draws(rng, base, setup=True), params, base,
                                       zero_step, setup=True)
        zf = torch.zeros(B, device=dev)
        A = getattr(task, "num_agents", 1)
        state = EnvState(
            q=q, qd=qd, params=params,
            obs=torch.zeros((B, A, task.num_obs) if A > 1 else (B, task.num_obs), device=dev),
            states=torch.zeros(B, task.num_states, device=dev),
            reward=torch.zeros((B, A) if A > 1 else (B,), device=dev),
            done=zf, timeout=zf, progress=progress0,
            net_contact=torch.zeros(B, nb, 3, device=dev),
            net_torque=torch.zeros(B, nb, 3, device=dev),
            seed=int(seed), episode=episode, global_step=zero_step,
            episode_return=zf, last_episode_return=zf,
            task=task_state, metrics={},
            last_rand=torch.zeros(B, dtype=torch.int64, device=dev),
            dr_corr=self.corr_draws(seed, episode), env_id0=id0)
        obs, _, _, task_state, metrics = task.post_physics(state, task_state)
        states = task.compute_states(state, task_state) if task.num_states else state.states
        return dataclasses.replace(state, obs=torch.clamp(obs, -task.clip_obs, task.clip_obs),
                                   states=states, task=task_state, metrics=metrics)

    def step_fn(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        task = self.task

        # ---- 1. masked auto-reset of envs done on the previous step ----
        do_reset = state.done > 0
        episode = state.episode + do_reset.to(torch.int64)
        q_r, qd_r, params_r, task_r = task.reset_fn(
            EnvRandom(state.seed, episode, SALT["reset"], state.env_id0), state.params,
            state.task)
        q = mask_select(do_reset, q_r, state.q)
        qd = mask_select(do_reset, qd_r, state.qd)
        params = mask_select(do_reset, params_r, state.params)
        task_state = mask_select(do_reset, task_r, state.task)
        # a non-finite carried state takes the fresh reset state, so the
        # quarantine below always has a finite anchor
        bad_pre = ~(torch.isfinite(q).all(-1) & torch.isfinite(qd).all(-1))
        q = torch.where(bad_pre[:, None], q_r, q)
        qd = torch.where(bad_pre[:, None], qd_r, qd)
        progress = torch.where(do_reset | bad_pre, torch.zeros_like(state.progress),
                               state.progress)
        episode_return = torch.where(do_reset, torch.zeros_like(state.episode_return),
                                     state.episode_return)

        # frequency-gated domain randomisation at the reset (vec_task.py:547-566);
        # `due` and the schedule read global_step before the increment
        last_rand, dr_corr = state.last_rand, state.dr_corr
        if self._dr_any:
            gs = state.global_step
            due = do_reset & (gs - state.last_rand >= self._dr_freq)
            if self._dr_active:
                base = self.base_params(q.device, q.shape[0])
                rng = EnvRandom(state.seed, episode, SALT["dr"], state.env_id0)
                params_dr = self._dr_fn.apply(self.dr_draws(rng, base, setup=False), params,
                                              base, gs, setup=False)
                params = mask_select(due, params_dr, params)
            if dr_corr:
                dr_corr = mask_select(due, self.corr_draws(state.seed, episode), dr_corr)
            last_rand = torch.where(due, gs, state.last_rand)

        state = dataclasses.replace(
            state, q=q, qd=qd, params=params, task=task_state, progress=progress,
            episode=episode, episode_return=episode_return, last_rand=last_rand,
            dr_corr=dr_corr, global_step=state.global_step + 1)

        # ---- 2. action noise + clip (vec_task.py:324-327) ----
        gs = state.global_step
        if type(task).action_noise is not Task.action_noise:
            actions = task.action_noise(self.step_random(state, "act_hook"), actions)
        if self._act_noise_fn is not None:
            std = self.noise_draw("act", self.step_random(state, "act_noise"), actions)
            actions = self._act_noise_fn.apply(std, actions, dr_corr.get("act"), gs)
        actions = torch.clamp(actions, -task.clip_actions, task.clip_actions)

        # ---- 3. pre-physics + physics ----
        ctrl, wrench, task_state = task.pre_physics(state, actions)
        state = dataclasses.replace(state, task=task_state)
        q_pre, qd_pre = state.q, state.qd
        q, qd = q_pre, qd_pre
        for _ in range(task.control_freq_inv):
            q, qd, net = self.physics_step(state.params, q, qd, ctrl, wrench)
        # quarantine: a non-finite env rolls back to its pre-step state, is
        # force-reset, and its reward is zeroed below
        blown = ~(torch.isfinite(q).all(-1) & torch.isfinite(qd).all(-1))
        q = torch.where(blown[:, None], q_pre, q)
        qd = torch.where(blown[:, None], torch.zeros_like(qd), qd)
        net = torch.where(blown[:, None, None], torch.zeros_like(net), net)
        progress = state.progress + 1
        state = dataclasses.replace(state, q=q, qd=qd, progress=progress,
                                    net_contact=net[..., 0:3], net_torque=net[..., 3:6])

        # ---- 4. post-physics: obs / reward / done ----
        obs, reward, done_task, task_state, metrics = task.post_physics(state, task_state)
        zero = torch.zeros_like(reward)
        reward = torch.where(blown if reward.dim() == 1 else blown[:, None], zero, reward)
        done_task = torch.where(blown, torch.ones_like(done_task), done_task.to(torch.float32))
        timeout = progress >= task.max_episode_length - 1
        done = torch.where(timeout, torch.ones_like(done_task), done_task)

        # ---- 5. observation noise + clip (vec_task.py:353-357) ----
        if type(task).observation_noise is not Task.observation_noise:
            obs = task.observation_noise(self.step_random(state, "obs_hook"), obs, task_state)
        if self._obs_noise_fn is not None:
            std = self.noise_draw("obs", self.step_random(state, "obs_noise"), obs)
            obs = self._obs_noise_fn.apply(std, obs, dr_corr.get("obs"), gs)
        obs = torch.clamp(obs, -task.clip_obs, task.clip_obs)
        states = task.compute_states(dataclasses.replace(state, task=task_state), task_state) \
            if task.num_states else state.states
        episode_return = state.episode_return + (reward.mean(-1) if reward.dim() == 2 else reward)
        last_episode_return = torch.where(done > 0, episode_return, state.last_episode_return)
        return dataclasses.replace(
            state, obs=obs, states=states, reward=reward, done=done,
            timeout=(timeout & (done_task < 0.5)).to(torch.float32),
            episode_return=episode_return, last_episode_return=last_episode_return,
            task=task_state, metrics=metrics)

    def base_params(self, device, B: int) -> ModelParams:
        """The model's default parameters batched over B, which every DR
        event scales from (built once per device and width)."""
        key = (torch.device(device), B)
        if key not in self._base:
            self._base[key] = self.task.model.default_params(device).batch(B)
        return self._base[key]

    # ---- the random draws of domain randomisation (the tests feed the JAX
    # package's draws through these) ----
    def dr_draws(self, rng: EnvRandom, base: ModelParams, setup: bool) -> dict:
        """The standard samples of one DR event, {entry index: (B, ...)}."""
        return self._dr_fn.draw(rng, base, setup)

    def corr_draws(self, seed: int, episode: torch.Tensor) -> dict:
        """Fresh correlated-noise standard samples, {"obs" / "act": (B, dim)},
        keyed on the episode with fixed salts."""
        return {name: dr.standard_draw(fn.dist, EnvRandom(seed, episode, SALT[f"corr_{name}"],
                                                          self.env_id0), (dim,))
                for name, fn, dim in self._corr}

    def noise_draw(self, name: str, rng: EnvRandom, x: torch.Tensor) -> torch.Tensor:
        """The per-step noise's standard samples shaped like `x`."""
        fn = self._obs_noise_fn if name == "obs" else self._act_noise_fn
        return fn.draw(rng, x)

    @staticmethod
    def step_random(state: EnvState, salt: str) -> EnvRandom:
        """A stream of this step: keyed on global_step (after the increment)."""
        return EnvRandom.of_step(state, SALT[salt])

    def reset(self, seed: int) -> EnvState:
        return self.init_fn(seed)

    def step(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        return self.step_fn(state, actions)
