"""Task registry: ``make`` and ``apply_cfg_env`` over the reference-shaped
``cfg/task/*.yaml`` files. Port of ``thormang_isaacgym_tpu/tasks/__init__.py``.

Only the tasks of the slices so far are registered; the other entries of
the JAX package's registry wait for later slices. Tasks import lazily.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np

TASK_MAP = {
    "Cartpole": ("thormang_isaacgym_tpu_torch.tasks.cartpole", "Cartpole"),
    "Ant": ("thormang_isaacgym_tpu_torch.tasks.ant", "Ant"),
    "Anymal": ("thormang_isaacgym_tpu_torch.tasks.anymal", "Anymal"),
    "AnymalTerrain": ("thormang_isaacgym_tpu_torch.tasks.anymal_terrain", "AnymalTerrain"),
    "BallBalance": ("thormang_isaacgym_tpu_torch.tasks.ball_balance", "BallBalance"),
    "AllegroHand": ("thormang_isaacgym_tpu_torch.tasks.allegro_hand", "AllegroHand"),
    "ShadowHand": ("thormang_isaacgym_tpu_torch.tasks.shadow_hand", "ShadowHand"),
}


def get_task_class(name: str):
    if name not in TASK_MAP:
        raise KeyError(f"unknown or not yet ported task {name!r}; ported: {sorted(TASK_MAP)}")
    module, cls = TASK_MAP[name]
    return getattr(importlib.import_module(module), cls)


# reference env-block keys -> constructor kwargs (they shape the model or the
# obs space, so they must reach __init__; the JAX registry's AMP and
# controlType keys come with the slices that port those tasks)
_CTOR_KEYS = {
    "observationType": "obs_type",
    "asymmetric_observations": "asymmetric_obs",
}
# reference env-block keys -> Task attribute names that don't follow plain
# camelCase -> snake_case (only the keys of the registered tasks' YAMLs; the
# JAX registry's AMP keys come with the slice that ports them).
# BallBalance's actionSpeedScale needs none: it maps to action_speed_scale.
_ATTR_ALIASES = {
    "episodeLength": "max_episode_length",
    "clipObservations": "clip_obs",
    "clipActions": "clip_actions",
    "controlFrequencyInv": "control_freq_inv",
    # Ant.yaml cost weights (attributes of tasks/ant.py)
    "actionsCost": "actions_cost_scale",
    "energyCost": "energy_cost_scale",
    "jointsAtLimitCost": "joints_at_limit_cost_scale",
    # ShadowHand / AllegroHand env-block keys (tasks/shadow_hand.py reads
    # these under other snake-case names than camel -> snake gives)
    "fallDistance": "fall_dist",
    "fallPenalty": "fall_penalty",
    "actionsMovingAverage": "act_moving_average",
    "resetPositionNoise": "reset_position_noise",
    "resetDofPosRandomInterval": "reset_dof_pos_noise",
    "resetDofVelRandomInterval": "reset_dof_vel_noise",
    "dofSpeedScale": "dof_speed_scale",
    "successTolerance": "success_tolerance",
    "reachGoalBonus": "reach_goal_bonus",
    "rotRewardScale": "rot_reward_scale",
    "distRewardScale": "dist_reward_scale",
    "actionPenaltyScale": "action_penalty_scale",
    "rotEps": "rot_eps",
    "maxConsecutiveSuccesses": "max_consecutive_successes",
    "averFactor": "av_factor",
    "useRelativeControl": "use_relative_control",
    "forceScale": "force_scale",
}


def _camel_to_snake(s: str) -> str:
    import re
    return re.sub(r"(?<!^)(?=[A-Z])", "_", s).lower()


# env-block keys legitimately consumed elsewhere (constructor, engine, sim
# construction) — not attribute targets, so no drift warning for them
_CONSUMED_KEYS = {"numEnvs", "envSpacing", "enableDebugVis", "aggregateMode",
                  *_CTOR_KEYS}


def apply_cfg_env(task, env_cfg: dict, *, warn_unknown: bool = True):
    """Drive task attributes from a reference-shaped task YAML env block
    (`cfg/task/<X>.yaml: env:`): every key maps to the camelCase->snake_case
    attribute when the task defines it (distRewardScale -> dist_reward_scale,
    ...), plus the alias table above. Keys that match nothing are WARNED
    about (config drift is otherwise invisible — a typo'd YAML key silently
    no-ops)."""
    import warnings
    for k, v in (env_cfg or {}).items():
        if isinstance(v, dict) or k in _CONSUMED_KEYS:
            continue
        attr = _ATTR_ALIASES.get(k, _camel_to_snake(k))
        if hasattr(task, attr) and not callable(getattr(task, attr)):
            setattr(task, attr, v)
        elif warn_unknown:
            warnings.warn(
                f"task config key {k!r} (-> {attr!r}) matches no attribute "
                f"of {type(task).__name__}; ignored", stacklevel=2)
    return task


def apply_cfg_sim(task, sim_cfg: dict):
    """Apply a task YAML's ``sim`` block (dt, substeps, gravity) to the task
    before its env is built. The block is the physics step: the control step
    is ``dt x task.decimation`` made of ``substeps x task.decimation``
    substeps (AnymalTerrain: 0.005 x 4 = 0.02 s, 4 substeps), and the task
    re-derives what depends on dt (``task.set_dt``). The JAX package's
    ``make`` leaves the task's own sim parameters in place; the port follows
    the YAML."""
    if not sim_cfg:
        return task
    dec = int(getattr(task, "decimation", 1))
    kw = {}
    if "dt" in sim_cfg:
        kw["dt"] = float(sim_cfg["dt"]) * dec
    if "substeps" in sim_cfg:
        kw["substeps"] = int(sim_cfg["substeps"]) * dec
    if "gravity" in sim_cfg:
        kw["gravity"] = tuple(float(g) for g in sim_cfg["gravity"])
        task.model._defaults["gravity"] = np.asarray(kw["gravity"], np.float32)
    task.sim_params = dataclasses.replace(task.sim_params, **kw)
    task.set_dt(task.sim_params.dt)
    return task


def make(task_name: str, num_envs: int | None = None, seed: int = 42,
         cfg: dict | None = None, device=None, **overrides):
    """Instantiate a task and wrap it in a VecEnv on `device` (default CUDA;
    raises when there is none and the caller did not pass device="cpu").

    `cfg` is a reference-shaped task config dict (cfg/task/<X>.yaml): its
    env block drives task parameters and its sim block dt/substeps/gravity.
    A task's ground (``task.ground_height_fn()``, e.g. AnymalTerrain's
    heightfield) goes to the env. Domain randomization (task.randomize) is
    not ported yet and raises."""
    from thormang_isaacgym_tpu_torch.engine.env import VecEnv, resolve_device

    device = resolve_device(device)
    cls = get_task_class(task_name)
    kwargs = dict(overrides)
    stagger = bool(kwargs.pop("stagger_episodes", False))
    cfg = cfg or {}
    env_cfg = cfg.get("env", {}) or {}
    task_blk = cfg.get("task", {})
    if (isinstance(task_blk, dict) and task_blk.get("randomize")) or kwargs.get("randomize"):
        raise NotImplementedError("domain randomization (randomize: true) is not ported yet")
    kwargs.pop("randomize", None)
    for ykey, ckey in _CTOR_KEYS.items():
        if ykey in env_cfg and ckey not in kwargs:
            kwargs[ckey] = env_cfg[ykey]
    if num_envs is not None:
        kwargs["num_envs"] = num_envs
    elif "numEnvs" in env_cfg:
        kwargs["num_envs"] = int(env_cfg["numEnvs"])
    task = cls(seed=seed, device=device, **kwargs)
    if env_cfg:
        apply_cfg_env(task, env_cfg)
    apply_cfg_sim(task, cfg.get("sim"))
    ground = task.ground_height_fn() if hasattr(task, "ground_height_fn") else None
    return VecEnv(task, ground_height_fn=ground, stagger_episodes=stagger)
