"""Carry weights and state across from the JAX package to the port.

Every function takes plain numpy data (a JAX pytree after
``jax.tree.map(np.asarray, tree)``), so this module imports neither JAX nor
the JAX package:

- :func:`model_params` — ``ModelParams`` leaves -> the port's ModelParams;
- :func:`load_actor_critic` — flax ``ActorCritic`` params (Dense ``kernel``
  (in, out) -> ``nn.Linear.weight`` (out, in), ``bias``, ``log_std``);
- :func:`rms_state` — ``RMSState`` (mean, var, count);
- :func:`train_state` — a JAX PPO ``TrainState`` (params, optax Adam
  moments and count, lr, normalizers, epoch) into a port TrainState;
- :func:`heightfield` — an ``engine.terrain.Heightfield`` (heights, scales,
  origin) -> the port's Heightfield on `device`;
- :func:`anymal_terrain_task_state` — an ``AnymalTerrainTaskState`` -> the
  port's (terrain level and type as int32).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.engine.terrain import Heightfield
from thormang_isaacgym_tpu_torch.learn.networks import ActorCritic
from thormang_isaacgym_tpu_torch.learn.normalize import RMSState
from thormang_isaacgym_tpu_torch.models.robot import ModelParams


def _leaf(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def model_params(leaves, device="cpu") -> ModelParams:
    """leaves: a JAX ModelParams (numpy leaves) or a dict of its fields."""
    get = leaves.get if isinstance(leaves, dict) else (lambda k: getattr(leaves, k))
    return ModelParams(**{f.name: _leaf(get(f.name), device)
                          for f in dataclasses.fields(ModelParams)})


def _named_linears(model: ActorCritic) -> dict:
    named = {f"trunk_{i}": m for i, m in enumerate(model.trunk)}
    if model.vtrunk is not None:
        named.update({f"vtrunk_{i}": m for i, m in enumerate(model.vtrunk)})
    named["mu"] = model.mu
    named["value"] = model.value
    return named


def load_actor_critic(model: ActorCritic, flax_params: dict) -> ActorCritic:
    """Copy flax ActorCritic params ({'params': {...}} or the inner dict)
    into `model` in place; returns it."""
    p = flax_params.get("params", flax_params)
    with torch.no_grad():
        for name, lin in _named_linears(model).items():
            lin.weight.copy_(_leaf(p[name]["kernel"], lin.weight.device).t())
            lin.bias.copy_(_leaf(p[name]["bias"], lin.bias.device))
        model.log_std.copy_(_leaf(p["log_std"], model.log_std.device))
    return model


def _flat_like_torch(model: ActorCritic, tree: dict) -> list:
    """The flax-shaped `tree` (same structure as the params) as a list of
    tensors in the order of model.parameters()."""
    t = tree.get("params", tree)
    by_param = {}
    for name, lin in _named_linears(model).items():
        by_param[id(lin.weight)] = np.array(t[name]["kernel"]).T
        by_param[id(lin.bias)] = np.array(t[name]["bias"])
    by_param[id(model.log_std)] = np.array(t["log_std"])
    return [torch.as_tensor(np.ascontiguousarray(by_param[id(p)]), device=p.device)
            for p in model.parameters()]


def rms_state(rms, device="cpu") -> RMSState:
    return RMSState(_leaf(rms.mean, device, torch.float32), _leaf(rms.var, device, torch.float32),
                    _leaf(rms.count, device, torch.float32))


def _find_adam(opt_state):
    """The optax ScaleByAdamState (count, mu, nu) inside a chain state."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def train_state(ppo, jax_ts):
    """A JAX ``learn.ppo.TrainState`` (numpy leaves) -> the port's
    TrainState for `ppo` (a port PPO on the same task and config)."""
    ts = ppo.init(ppo.cfg.seed)
    dev = ppo.device
    load_actor_critic(ts.model, jax_ts.params)
    adam = _find_adam(jax_ts.opt_state)
    if adam is not None:
        ts.adam_m = _flat_like_torch(ts.model, adam.mu)
        ts.adam_v = _flat_like_torch(ts.model, adam.nu)
        ts.adam_step = int(np.array(adam.count))
    ts.lr = _leaf(jax_ts.lr, dev, torch.float32)
    ts.obs_rms = rms_state(jax_ts.obs_rms, dev)
    ts.value_rms = rms_state(jax_ts.value_rms, dev)
    ts.epoch = int(np.array(jax_ts.epoch))
    return ts


def heightfield(hf, device="cpu") -> Heightfield:
    """hf: an object with the JAX Heightfield's fields (heights, h_scale,
    v_scale, origin)."""
    return Heightfield(np.asarray(hf.heights), hf.h_scale, hf.v_scale,
                       tuple(np.asarray(hf.origin, np.float32)), device=device)


def anymal_terrain_task_state(leaves, device="cpu"):
    """leaves: a JAX AnymalTerrainTaskState (numpy leaves) or a dict of its
    fields."""
    from thormang_isaacgym_tpu_torch.tasks.anymal_terrain import AnymalTerrainTaskState
    get = leaves.get if isinstance(leaves, dict) else (lambda k: getattr(leaves, k))
    ints = ("terrain_level", "terrain_type")
    return AnymalTerrainTaskState(**{
        f.name: _leaf(get(f.name), device, torch.int32 if f.name in ints else torch.float32)
        for f in dataclasses.fields(AnymalTerrainTaskState)})
