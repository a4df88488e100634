"""Task registry: ``make`` and ``apply_cfg_env`` over the reference-shaped
``cfg/task/*.yaml`` files. Port of ``thormang_isaacgym_tpu/tasks/__init__.py``.

Every entry of the JAX package's registry is registered. Tasks import
lazily. The Gogoro tasks need the reference's URDFs, which the repository
does not hold: they take ``asset_path=`` and raise FileNotFoundError naming
a missing file.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np

TASK_MAP = {
    "Gogoro": ("thormang_isaacgym_tpu_torch.tasks.gogoro", "Gogoro"),
    "GogoroPaper": ("thormang_isaacgym_tpu_torch.tasks.gogoro_paper", "GogoroPaper"),
    "GogoroCombined": ("thormang_isaacgym_tpu_torch.tasks.gogoro_combined", "GogoroCombined"),
    "Cartpole": ("thormang_isaacgym_tpu_torch.tasks.cartpole", "Cartpole"),
    "Ant": ("thormang_isaacgym_tpu_torch.tasks.ant", "Ant"),
    "Humanoid": ("thormang_isaacgym_tpu_torch.tasks.humanoid", "Humanoid"),
    "HumanoidMJCF": ("thormang_isaacgym_tpu_torch.tasks.humanoid", "HumanoidMJCF"),
    "Anymal": ("thormang_isaacgym_tpu_torch.tasks.anymal", "Anymal"),
    "AnymalTerrain": ("thormang_isaacgym_tpu_torch.tasks.anymal_terrain", "AnymalTerrain"),
    "BallBalance": ("thormang_isaacgym_tpu_torch.tasks.ball_balance", "BallBalance"),
    "AllegroHand": ("thormang_isaacgym_tpu_torch.tasks.allegro_hand", "AllegroHand"),
    "ShadowHand": ("thormang_isaacgym_tpu_torch.tasks.shadow_hand", "ShadowHand"),
    "FrankaCabinet": ("thormang_isaacgym_tpu_torch.tasks.franka_cabinet", "FrankaCabinet"),
    "FrankaCubeStack": ("thormang_isaacgym_tpu_torch.tasks.franka_cube_stack", "FrankaCubeStack"),
    "FactoryTaskNutBoltPick": ("thormang_isaacgym_tpu_torch.tasks.factory",
                               "FactoryTaskNutBoltPick"),
    "FactoryTaskNutBoltPlace": ("thormang_isaacgym_tpu_torch.tasks.factory",
                                "FactoryTaskNutBoltPlace"),
    "FactoryTaskNutBoltScrew": ("thormang_isaacgym_tpu_torch.tasks.factory",
                                "FactoryTaskNutBoltScrew"),
    "FactoryTaskInsertion": ("thormang_isaacgym_tpu_torch.tasks.factory", "FactoryTaskInsertion"),
    "FactoryTaskGears": ("thormang_isaacgym_tpu_torch.tasks.factory", "FactoryTaskGears"),
    "Ingenuity": ("thormang_isaacgym_tpu_torch.tasks.ingenuity", "Ingenuity"),
    "Quadcopter": ("thormang_isaacgym_tpu_torch.tasks.quadcopter", "Quadcopter"),
    "Trifinger": ("thormang_isaacgym_tpu_torch.tasks.trifinger", "Trifinger"),
    "MA_OP3": ("thormang_isaacgym_tpu_torch.tasks.ma_op3", "MA_OP3"),
    "HumanoidAMP": ("thormang_isaacgym_tpu_torch.tasks.humanoid_amp", "HumanoidAMP"),
}


# tasks whose reference config files carry another name: HumanoidMJCF is the
# reference's Humanoid task (cfg/task/Humanoid.yaml, cfg/train/HumanoidPPO.yaml)
CFG_NAMES = {"HumanoidMJCF": "Humanoid"}


def cfg_name(task_name: str) -> str:
    """The name of `task_name`'s cfg/task/<name>.yaml and cfg/train/<name>PPO.yaml."""
    return CFG_NAMES.get(task_name, task_name)


# the JAX registry's entries still to port: none
NOT_PORTED: dict = {}


def get_task_class(name: str):
    if name not in TASK_MAP:
        raise KeyError(f"unknown task {name!r}; registered: {sorted(TASK_MAP)}")
    module, cls = TASK_MAP[name]
    return getattr(importlib.import_module(module), cls)


# reference env-block keys -> constructor kwargs (they shape the model, the
# obs space or the motion data, so they must reach __init__)
_CTOR_KEYS = {
    "observationType": "obs_type",
    "asymmetric_observations": "asymmetric_obs",
    "controlType": "control_type",
    # AMP (cfg/task/HumanoidAMP.yaml)
    "stateInit": "state_init",
    "numAMPObsSteps": "num_amp_obs_steps",
    "motion_file": "motion_file",
}
# reference env-block keys -> Task attribute names that don't follow plain
# camelCase -> snake_case (only the keys of the registered tasks' YAMLs;
# HumanoidAMP's hybridInitProb, localRootObs, terminationHeight and
# enableEarlyTermination need none).
# BallBalance's actionSpeedScale needs none: it maps to action_speed_scale.
_ATTR_ALIASES = {
    "episodeLength": "max_episode_length",
    "clipObservations": "clip_obs",
    "clipActions": "clip_actions",
    "controlFrequencyInv": "control_freq_inv",
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
_CONSUMED_KEYS = {"numEnvs", "numObservations", "numStates", "numActions", "envSpacing",
                  "enableDebugVis", "aggregateMode", *_CTOR_KEYS}


def apply_cfg_env(task, env_cfg: dict, *, warn_unknown: bool = True):
    """Drive task attributes from a reference-shaped task YAML env block
    (`cfg/task/<X>.yaml: env:`): every key maps to the camelCase->snake_case
    attribute when the task defines it (distRewardScale -> dist_reward_scale,
    ...), plus the alias table above and the task's own ``cfg_aliases``.
    Keys that match nothing are WARNED
    about (config drift is otherwise invisible — a typo'd YAML key silently
    no-ops)."""
    import warnings
    aliases = {**_ATTR_ALIASES, **getattr(task, "cfg_aliases", {})}
    for k, v in (env_cfg or {}).items():
        if isinstance(v, dict) or k in _CONSUMED_KEYS:
            continue
        attr = aliases.get(k, _camel_to_snake(k))
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
    the YAML, but for the gravity of a task that fixes its own
    (``fixed_gravity``: Ingenuity's Mars gravity, which the reference sets in
    code whatever its YAML says)."""
    if not sim_cfg:
        return task
    dec = int(getattr(task, "decimation", 1))
    kw = {}
    if "dt" in sim_cfg:
        kw["dt"] = float(sim_cfg["dt"]) * dec
    if "substeps" in sim_cfg:
        kw["substeps"] = int(sim_cfg["substeps"]) * dec
    if "gravity" in sim_cfg and not task.fixed_gravity:
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
    heightfield) goes to the env. ``task.randomize`` goes to the task's
    constructor, and with it a ``task.randomization_params`` block replaces
    the task's own ``dr_config`` (domain randomisation, engine/dr.py). Blocks
    other than env, sim and task (the
    Factory YAMLs' ``rl`` and ``ctrl``) are not read, as the JAX package's
    ``make`` does not read them: a Factory task takes its class's
    controller (``tasks/factory.py _CTRL_YAML``)."""
    from thormang_isaacgym_tpu_torch.engine.env import VecEnv, resolve_device

    device = resolve_device(device)
    cls = get_task_class(task_name)
    kwargs = dict(overrides)
    stagger = bool(kwargs.pop("stagger_episodes", False))
    cfg = cfg or {}
    env_cfg = cfg.get("env", {}) or {}
    task_blk = cfg.get("task", {})
    if isinstance(task_blk, dict) and "randomize" in task_blk and "randomize" not in kwargs:
        kwargs["randomize"] = bool(task_blk["randomize"])
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
    # the YAML's randomization_params drive domain randomisation, over any
    # dr_config the task set itself
    if isinstance(task_blk, dict) and task_blk.get("randomize") \
            and isinstance(task_blk.get("randomization_params"), dict):
        task.dr_config = task_blk["randomization_params"]
    apply_cfg_sim(task, cfg.get("sim"))
    ground = task.ground_height_fn() if hasattr(task, "ground_height_fn") else None
    return VecEnv(task, ground_height_fn=ground, stagger_episodes=stagger)
