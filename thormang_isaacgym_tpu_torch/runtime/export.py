"""Policy export. Port of ``thormang_isaacgym_tpu/runtime/export.py`` (the
reference's ``export.py``: the policy's clamped mean through torch.jit and
ONNX, with a 100-sample numeric parity set, ``export.py:134-200``).

It writes the JAX package's files under its names, into ``export_dir``:

- ``<name>_weights.npz``: the actor-critic's weights under the JAX
  package's flax keys (``params/trunk_<i>/kernel`` (in, out),
  ``params/trunk_<i>/bias``, ``params/mu/...``, ``params/log_std``, ...: the
  inverse of ``parity/convert.py``), and, for a policy that normalises its
  observations (``normalize_input``), ``obs_rms/mean`` and ``obs_rms/var``;
- ``<name>_policy.pt2``: a ``torch.export`` program of the deterministic
  policy (observations (N, num_obs) -> actions), in place of JAX's
  StableHLO text; ``torch.export.load`` reloads it;
- ``<name>_parity_obs.npy``: ``num_parity`` observations of
  ``np.random.RandomState(0)``, and ``<name>_parity_out.npy`` the policy's
  actions on them;
- ``<name>_meta.json``: num_obs, num_actions, units, activation.

:func:`numpy_policy_forward` re-runs the policy from the npz without torch.
It applies the ``obs_rms`` normaliser where the npz has one (clip +/-5, eps
1e-5, as ``learn/normalize.rms_normalize``); JAX's leaves it out, so it
disagrees with its own parity set for a ``normalize_input`` policy whose
``obs_rms`` is not the identity, and the JAX npz has no ``obs_rms`` keys.
JAX's function reads the port's npz unchanged.

The export computes in float32 (no bf16 autocast). An LSTM policy raises, as
the port's play does.

Usage:
  python -m thormang_isaacgym_tpu_torch.runtime.export task=Ant train=AntPPO \\
      checkpoint=runs/Ant/nn/last.ckpt [export_dir=exports] [device=cpu]
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from thormang_isaacgym_tpu_torch.learn.normalize import RMSState, rms_normalize
from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
from thormang_isaacgym_tpu_torch.parity.convert import _specs
from thormang_isaacgym_tpu_torch.runtime.checkpoint import load_train_state
from thormang_isaacgym_tpu_torch.tasks import make
from thormang_isaacgym_tpu_torch.utils.config import load_config


class _Policy(torch.nn.Module):
    """The deterministic policy of `ts` as a module: the clamped mean of the
    actor on the (normalised) observations."""

    def __init__(self, ppo: PPO, ts):
        super().__init__()
        self.model = ts.model
        self.normalize = bool(ppo.cfg.normalize_input)
        self.register_buffer("rms_mean", ts.obs_rms.mean.detach().clone())
        self.register_buffer("rms_var", ts.obs_rms.var.detach().clone())

    def forward(self, obs):
        if self.normalize:
            obs = rms_normalize(RMSState(self.rms_mean, self.rms_var, None), obs)
        mu, _, _ = self.model(obs)
        return torch.clamp(mu, -1.0, 1.0)


def flax_weights(ppo: PPO, ts) -> dict:
    """The actor-critic's weights under the JAX package's flax keys, "/"
    joined (a Dense layer's ``kernel`` is the Linear's weight transposed)."""
    out = {}
    for p, leaves, _ in _specs(ts.model, ts.value_net):
        (path, _shape), = leaves
        x = p.detach().float().cpu().numpy()
        out["/".join(path)] = np.ascontiguousarray(x.T if path[-1] == "kernel" else x)
    return out


def export_policy(ppo: PPO, ts, out_dir: str, name: str, num_parity: int = 100) -> np.ndarray:
    """Write the export of `ts`'s policy (module docstring) and return the
    parity outputs (num_parity, num_actions)."""
    if ppo.is_rnn:
        raise NotImplementedError("export of an LSTM policy: its deterministic play has no carry "
                                  "in the JAX package, so there is none to export")
    os.makedirs(out_dir, exist_ok=True)
    flat = flax_weights(ppo, ts)
    if ppo.cfg.normalize_input:
        flat["obs_rms/mean"] = ts.obs_rms.mean.detach().cpu().numpy()
        flat["obs_rms/var"] = ts.obs_rms.var.detach().cpu().numpy()
    np.savez(os.path.join(out_dir, f"{name}_weights.npz"), **flat)

    policy = _Policy(ppo, ts).eval()
    dev = ppo.device
    example = torch.zeros(2, ppo.env.num_obs, device=dev)
    batch = torch.export.Dim("batch")
    with torch.no_grad():
        program = torch.export.export(policy, (example,), dynamic_shapes=({0: batch},))
    torch.export.save(program, os.path.join(out_dir, f"{name}_policy.pt2"))

    rng = np.random.RandomState(0)
    obs = rng.randn(num_parity, ppo.env.num_obs).astype(np.float32)
    with torch.no_grad():
        out = policy(torch.as_tensor(obs, device=dev)).float().cpu().numpy()
    np.save(os.path.join(out_dir, f"{name}_parity_obs.npy"), obs)
    np.save(os.path.join(out_dir, f"{name}_parity_out.npy"), out)
    meta = dict(num_obs=ppo.env.num_obs, num_actions=ppo.env.num_actions,
                units=list(ppo.cfg.units), activation=ppo.cfg.activation)
    with open(os.path.join(out_dir, f"{name}_meta.json"), "w") as f:
        json.dump(meta, f)
    return out


def numpy_policy_forward(weights: dict, meta: dict, obs: np.ndarray) -> np.ndarray:
    """The exported MLP in numpy (the onnxruntime side of the reference's
    ``export.py:184-199``), with the ``obs_rms`` normaliser where the npz
    has one."""
    def elu(x):
        return np.where(x > 0, x, np.exp(np.minimum(x, 0)) - 1)

    act = {"elu": elu, "relu": lambda x: np.maximum(x, 0), "tanh": np.tanh}[meta["activation"]]
    x = obs
    if "obs_rms/mean" in weights:
        x = np.clip((x - weights["obs_rms/mean"]) / np.sqrt(weights["obs_rms/var"] + 1e-5),
                    -5.0, 5.0)
    for i in range(len(meta["units"])):
        x = act(x @ weights[f"params/trunk_{i}/kernel"] + weights[f"params/trunk_{i}/bias"])
    mu = x @ weights["params/mu/kernel"] + weights["params/mu/bias"]
    return np.clip(mu, -1.0, 1.0)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = load_config(argv)
    task_name = cfg["task_name"]
    env = make(task_name, num_envs=2, seed=int(cfg.get("seed", 42)),
               cfg=cfg.get("task") or None, device=cfg.get("device"))
    ppo_cfg = PPOConfig.from_rlgames(cfg["train"]) if cfg["train"] else PPOConfig()
    ppo = PPO(env, dataclasses.replace(ppo_cfg, mixed_precision=False), device=env.device)
    ts = ppo.init(0)
    ckpt = cfg.get("checkpoint")
    if ckpt:
        ts = load_train_state(ckpt, ppo)
    out_dir = cfg.get("export_dir", "exports")
    export_policy(ppo, ts, out_dir, task_name)
    print(f"exported policy to {out_dir}/")


if __name__ == "__main__":
    main()
