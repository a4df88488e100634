"""Checkpoint save / restore of a PPO ``TrainState`` (the rl_games
``runs/<name>/nn/*.pth`` equivalent). Port of
``thormang_isaacgym_tpu/runtime/checkpoint.py``.

The port writes one npz of named arrays: ``model/<state_dict key>``, with
an asymmetric critic ``value_net/<state_dict key>``, ``adam_m/<parameter>``
and ``adam_v/<parameter>`` (the value net's as ``value_net.<parameter>``),
``adam_step``, ``lr``, ``obs_rms/*``, ``value_rms/*`` and ``states_rms/*``
(mean, var, count), ``epoch`` and ``gen_state`` (the generator of action
noise and minibatch permutations). An AMP state adds ``disc/<state_dict
key>`` (its parameters in the Adam moments as ``disc.<parameter>``),
``amp_rms/*``, ``replay``, ``replay_count`` and ``replay_ptr``.
Restoring it and running one more iteration gives the uninterrupted run's
numbers (the env state is the caller's; it is reproducible from the seed).

``load_train_state`` also reads a JAX checkpoint: its arrays are
``arr_0..arr_N``, the ``TrainState`` leaves in ``jax.tree.leaves`` order,
carried across by ``parity.convert.train_state_from_leaves``.
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.learn.normalize import RMSState


def _modules(ts) -> dict:
    """The networks of `ts` by name, in the order of ``ts.parameters()``."""
    mods = {"model": ts.model, "value_net": ts.value_net, "disc": getattr(ts, "disc", None)}
    return {k: m for k, m in mods.items() if m is not None}


def _param_names(ts) -> list:
    """Names of ``ts.parameters()``, in its order."""
    return [n if k == "model" else f"{k}.{n}"
            for k, m in _modules(ts).items() for n, _ in m.named_parameters()]


def _arrays(ts) -> dict:
    out = {f"{k}/{n}": v for k, m in _modules(ts).items() for n, v in m.state_dict().items()}
    names = _param_names(ts)
    out.update({f"adam_m/{n}": m for n, m in zip(names, ts.adam_m)})
    out.update({f"adam_v/{n}": v for n, v in zip(names, ts.adam_v)})
    for rms in ("obs_rms", "value_rms", "states_rms"):
        for f in ("mean", "var", "count"):
            out[f"{rms}/{f}"] = getattr(getattr(ts, rms), f)
    if hasattr(ts, "replay"):
        out.update({f"amp_rms/{f}": getattr(ts.amp_rms, f) for f in ("mean", "var", "count")})
        out.update(replay=ts.replay, replay_count=np.int64(ts.replay_count),
                   replay_ptr=np.int64(ts.replay_ptr))
    out["lr"] = ts.lr
    out["adam_step"] = np.int64(ts.adam_step)
    out["epoch"] = np.int64(ts.epoch)
    out["gen_state"] = ts.gen.get_state()
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def save_train_state(path: str, ts) -> None:
    """Write `ts` to `path` (its directory is made)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **_arrays(ts))
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_train_state(path: str, ppo):
    """A TrainState for `ppo` (a port PPO or AMPPPO on the checkpoint's task
    and config) holding the checkpoint at `path`, a port or a JAX one. A count
    or shape of arrays that does not match the config raises ValueError."""
    with open(path, "rb") as f:
        npz = np.load(io.BytesIO(f.read()))
        arrays = {k: npz[k] for k in npz.files}
    if "arr_0" in arrays:
        from thormang_isaacgym_tpu_torch.parity.convert import train_state_from_leaves
        return train_state_from_leaves(ppo, [arrays[f"arr_{i}"] for i in range(len(arrays))])
    ts = ppo.init()
    want = _arrays(ts)
    if sorted(arrays) != sorted(want):
        raise ValueError(f"checkpoint has {len(arrays)} arrays, template expects "
                         f"{len(want)} — config/model mismatch")
    for k, v in want.items():
        if k != "gen_state" and arrays[k].shape != v.shape:
            raise ValueError(f"checkpoint array {k!r} has shape {arrays[k].shape}, template "
                             f"expects {v.shape} — config/model mismatch")
    dev = ppo.device

    def t(k):
        return torch.as_tensor(arrays[k], device=dev)

    with torch.no_grad():
        for name, module in _modules(ts).items():
            prefix = name + "/"
            module.load_state_dict({k[len(prefix):]: t(k) for k in arrays if k.startswith(prefix)})
    names = _param_names(ts)
    ts.adam_m = [t(f"adam_m/{n}") for n in names]
    ts.adam_v = [t(f"adam_v/{n}") for n in names]
    ts.adam_step = int(arrays["adam_step"])
    ts.lr = t("lr")
    ts.obs_rms, ts.value_rms, ts.states_rms = (
        RMSState(t(f"{r}/mean"), t(f"{r}/var"), t(f"{r}/count"))
        for r in ("obs_rms", "value_rms", "states_rms"))
    ts.epoch = int(arrays["epoch"])
    ts.gen.set_state(torch.as_tensor(arrays["gen_state"]))
    if hasattr(ts, "replay"):
        ts.amp_rms = RMSState(t("amp_rms/mean"), t("amp_rms/var"), t("amp_rms/count"))
        ts.replay = t("replay")
        ts.replay_count, ts.replay_ptr = int(arrays["replay_count"]), int(arrays["replay_ptr"])
    return ts
