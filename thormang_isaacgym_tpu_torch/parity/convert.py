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
- :func:`train_state_from_leaves` — the same from the ordered leaves of a
  JAX checkpoint (``jax.tree.leaves(TrainState)``, npz ``arr_0..arr_N``);
- :func:`heightfield` — an ``engine.terrain.Heightfield`` (heights, scales,
  origin) -> the port's Heightfield on `device`;
- :func:`anymal_terrain_task_state` — an ``AnymalTerrainTaskState`` -> the
  port's (terrain level and type as int32);
- :func:`humanoid_task_state` — a ``HumanoidTaskState`` -> the port's.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

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


def _flax_leaves(model: ActorCritic) -> list:
    """(name, shape) of the flax params' leaves in ``jax.tree.leaves``
    order (dict keys sorted; a Dense layer's bias before its kernel)."""
    out = []
    for name, lin in sorted(_named_linears(model).items()):
        out.append(((name, "bias"), tuple(lin.bias.shape)))
        out.append(((name, "kernel"), tuple(lin.weight.shape[::-1])))
    out.append((("log_std",), tuple(model.log_std.shape)))
    return sorted(out)


def train_state_from_leaves(ppo, leaves):
    """The leaves of a JAX PPO checkpoint (``runtime/checkpoint.py``: the
    ``TrainState`` leaves in ``jax.tree.leaves`` order, numpy) -> the port's
    TrainState for `ppo`. The order: params; the Adam state's count, mu and
    nu (each shaped like params); lr; obs_rms, value_rms and states_rms
    (mean, var, count); epoch. A leaf count or shape that does not match
    `ppo`'s config raises ValueError."""
    template = ppo.init(ppo.cfg.seed).model
    params = _flax_leaves(template)
    states = max(int(getattr(ppo.env.task, "num_states", 0) or 0), 1)
    n_obs = ppo.env.num_obs
    shapes = ([s for _, s in params] + [()] + [s for _, s in params] * 2 + [()]
              + [(n_obs,), (n_obs,), (), (), (), (), (states,), (states,), (), ()])
    leaves = [np.asarray(x) for x in leaves]
    if len(leaves) != len(shapes):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template expects "
                         f"{len(shapes)} — config/model mismatch")
    for i, (x, shape) in enumerate(zip(leaves, shapes)):
        if x.shape != shape:
            raise ValueError(f"checkpoint leaf {i} has shape {x.shape}, template expects "
                             f"{shape} — config/model mismatch")
    it = iter(leaves)

    def tree():
        t = {}
        for path, _ in params:
            node = t
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = next(it)
        return {"params": t}

    p = tree()
    count = next(it)
    adam = SimpleNamespace(count=count, mu=tree(), nu=tree())
    lr = next(it)
    rms = [SimpleNamespace(mean=next(it), var=next(it), count=next(it)) for _ in range(3)]
    jax_ts = SimpleNamespace(params=p, opt_state=(adam,), lr=lr, obs_rms=rms[0],
                             value_rms=rms[1], epoch=next(it))
    return train_state(ppo, jax_ts)


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


def humanoid_task_state(leaves, device="cpu"):
    """leaves: a JAX HumanoidTaskState (numpy leaves) or a dict of its
    fields."""
    from thormang_isaacgym_tpu_torch.tasks.humanoid import HumanoidTaskState
    get = leaves.get if isinstance(leaves, dict) else (lambda k: getattr(leaves, k))
    return HumanoidTaskState(**{f.name: _leaf(get(f.name), device, torch.float32)
                                for f in dataclasses.fields(HumanoidTaskState)})
