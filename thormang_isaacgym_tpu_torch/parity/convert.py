"""Carry weights and state across from the JAX package to the port.

Every function takes plain numpy data (a JAX pytree after
``jax.tree.map(np.asarray, tree)``), so this module imports neither JAX nor
the JAX package:

- :func:`model_params` — ``ModelParams`` leaves -> the port's ModelParams;
- :func:`load_actor_critic` — flax ``ActorCritic`` or ``ActorCriticRNN``
  params, with a ``ValueNet`` the asymmetric ``{"ac", "cv"}`` (Dense
  ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in), ``bias``,
  ``log_std``; an LSTM cell's eight Dense leaves -> its two Linears; the
  LayerNorm's ``scale`` -> ``weight``);
- :func:`rms_state` — ``RMSState`` (mean, var, count);
- :func:`train_state` — a JAX PPO ``TrainState`` (params, optax Adam
  moments and count, lr, the three normalizers, epoch) into a port
  TrainState;
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
from thormang_isaacgym_tpu_torch.learn.normalize import RMSState
from thormang_isaacgym_tpu_torch.models.robot import ModelParams


def _leaf(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def model_params(leaves, device="cpu") -> ModelParams:
    """leaves: a JAX ModelParams (numpy leaves) or a dict of its fields."""
    get = leaves.get if isinstance(leaves, dict) else (lambda k: getattr(leaves, k))
    return ModelParams(**{f.name: _leaf(get(f.name), device)
                          for f in dataclasses.fields(ModelParams)})


def _dense(prefix, lin) -> list:
    """A flax Dense (kernel (in, out), bias) onto an nn.Linear."""
    out = [(lin.weight, [(prefix + ("kernel",), tuple(lin.weight.shape[::-1]))],
            lambda xs: xs[0].T)]
    if lin.bias is not None:
        out.append((lin.bias, [(prefix + ("bias",), tuple(lin.bias.shape))], lambda xs: xs[0]))
    return out


def _lstm(prefix, cell) -> list:
    """A flax OptimizedLSTMCell's eight Dense leaves onto the cell's two
    Linears: the input kernels ii, if, ig, io concatenated into ``ih`` and
    the hidden kernels and biases hi, hf, hg, ho into ``hh``."""
    H = cell.hh.weight.shape[1]
    n_in = cell.ih.weight.shape[1]

    def cat_t(xs):
        return np.concatenate(xs, axis=-1).T

    def cat(xs):
        return np.concatenate(xs, axis=-1)

    return [(cell.ih.weight, [(prefix + ("i" + g, "kernel"), (n_in, H)) for g in "ifgo"], cat_t),
            (cell.hh.weight, [(prefix + ("h" + g, "kernel"), (H, H)) for g in "ifgo"], cat_t),
            (cell.hh.bias, [(prefix + ("h" + g, "bias"), (H,)) for g in "ifgo"], cat)]


def _specs(model, value_net=None) -> list:
    """(torch parameter, [(flax path, flax shape), ...], combine) for every
    parameter of `model` (ActorCritic or ActorCriticRNN) and `value_net`, in
    the order of ``TrainState.parameters()``: ``combine`` maps the flax
    leaves (numpy, in the listed order) onto the parameter. The paths start
    at the root of the JAX params: ``("params", ...)``, or with a value net
    ``("ac", "params", ...)`` and ``("cv", "params", ...)``."""
    root = ("ac", "params") if value_net is not None else ("params",)
    by_param = {}
    for i, lin in enumerate(model.trunk):
        by_param.update({id(p): e for p, *e in _dense(root + (f"trunk_{i}",), lin)})
    for i, lin in enumerate(getattr(model, "vtrunk", None) or ()):
        by_param.update({id(p): e for p, *e in _dense(root + (f"vtrunk_{i}",), lin)})
    for i, cell in enumerate(getattr(model, "lstm", ())):
        by_param.update({id(p): e for p, *e in _lstm(root + (f"lstm_{i}",), cell)})
    ln = getattr(model, "rnn_ln", None)
    if ln is not None:
        by_param[id(ln.weight)] = ([(root + ("rnn_ln", "scale"), tuple(ln.weight.shape))],
                                   lambda xs: xs[0])
        by_param[id(ln.bias)] = ([(root + ("rnn_ln", "bias"), tuple(ln.bias.shape))],
                                 lambda xs: xs[0])
    for name in ("mu", "value", "sigma"):
        if getattr(model, name, None) is not None:
            by_param.update({id(p): e for p, *e in _dense(root + (name,), getattr(model, name))})
    if model.log_std is not None:
        by_param[id(model.log_std)] = ([(root + ("log_std",), tuple(model.log_std.shape))],
                                       lambda xs: xs[0])
    params = list(model.parameters())
    if value_net is not None:
        cv = ("cv", "params")
        for i, lin in enumerate(value_net.cv):
            by_param.update({id(p): e for p, *e in _dense(cv + (f"cv_{i}",), lin)})
        by_param.update({id(p): e for p, *e in _dense(cv + ("cv_value",), value_net.cv_value)})
        params += list(value_net.parameters())
    return [(p, *by_param[id(p)]) for p in params]


def _get(tree, path):
    """A copy of the leaf at `path` (the port's tensors must not share the
    caller's arrays: Adam updates its moments in place)."""
    for k in path:
        tree = tree[k]
    return np.array(tree)


def _flat_like_torch(model, tree: dict, value_net=None) -> list:
    """The flax-shaped `tree` (the structure of the JAX params) as a list of
    tensors in the order of the port's parameters (``_specs``)."""
    return [torch.as_tensor(np.ascontiguousarray(combine([_get(tree, path) for path, _ in leaves])),
                            device=p.device)
            for p, leaves, combine in _specs(model, value_net)]


def load_actor_critic(model, flax_params: dict, value_net=None):
    """Copy flax params (ActorCritic or ActorCriticRNN; with `value_net`, the
    asymmetric ``{"ac": ..., "cv": ...}``) into the port's modules in place;
    returns `model`."""
    with torch.no_grad():
        for p, x in zip((p for p, _, _ in _specs(model, value_net)),
                        _flat_like_torch(model, flax_params, value_net)):
            p.copy_(x)
    return model


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
    load_actor_critic(ts.model, jax_ts.params, ts.value_net)
    adam = _find_adam(jax_ts.opt_state)
    if adam is not None:
        ts.adam_m = _flat_like_torch(ts.model, adam.mu, ts.value_net)
        ts.adam_v = _flat_like_torch(ts.model, adam.nu, ts.value_net)
        ts.adam_step = int(np.array(adam.count))
    ts.lr = _leaf(jax_ts.lr, dev, torch.float32)
    ts.obs_rms = rms_state(jax_ts.obs_rms, dev)
    ts.value_rms = rms_state(jax_ts.value_rms, dev)
    ts.states_rms = rms_state(jax_ts.states_rms, dev)
    ts.epoch = int(np.array(jax_ts.epoch))
    return ts


def _flax_leaves(ts) -> list:
    """(path, shape) of the flax params' leaves of `ts`'s networks in
    ``jax.tree.leaves`` order (dict keys sorted; a Dense layer's bias before
    its kernel; ``ac`` before ``cv``)."""
    return sorted(leaf for _, leaves, _ in _specs(ts.model, ts.value_net) for leaf in leaves)


def train_state_from_leaves(ppo, leaves):
    """The leaves of a JAX PPO checkpoint (``runtime/checkpoint.py``: the
    ``TrainState`` leaves in ``jax.tree.leaves`` order, numpy) -> the port's
    TrainState for `ppo`. The order: params; the Adam state's count, mu and
    nu (each shaped like params); lr; obs_rms, value_rms and states_rms
    (mean, var, count); epoch. A leaf count or shape that does not match
    `ppo`'s config raises ValueError."""
    params = _flax_leaves(ppo.init(ppo.cfg.seed))
    states = max(ppo.num_states, 1)
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
        return t

    p = tree()
    count = next(it)
    adam = SimpleNamespace(count=count, mu=tree(), nu=tree())
    lr = next(it)
    rms = [SimpleNamespace(mean=next(it), var=next(it), count=next(it)) for _ in range(3)]
    jax_ts = SimpleNamespace(params=p, opt_state=(adam,), lr=lr, obs_rms=rms[0],
                             value_rms=rms[1], states_rms=rms[2], epoch=next(it))
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
