"""Data parallelism of the PPO learners over the env axis. Port of
``thormang_isaacgym_tpu/parallel/mesh.py``.

JAX shards the env axis over a device mesh with ``shard_map`` and
``pmean``s the gradients inside one program. The port runs one process per
rank (``parallel/distributed.py``); its "mesh" is the process group:

- rollouts are rank-local: each rank steps its own envs, the global ids
  [rank B, (rank + 1) B) of a run of ``world x B`` envs, so its random
  streams are those rows' (``VecEnv.env_id0``);
- after each minibatch's backward pass the learner averages the gradients
  and every loss term and the KL over the ranks (``PPO.reduce``), all in one
  flat buffer: one all-reduce per minibatch step, not one per parameter;
- the learning rate adapts on that averaged KL, so it stays the same on
  every rank, as do the parameters and the Adam moments;
- the RMS normalisers and the advantage normalisation stay rank-local, as
  JAX updates them from the shard's own batch, without a ``pmean``;
- each rank's generator (action noise, minibatch permutations) is seeded
  with seed + 1 + rank: the reference's ``cfg.seed += rank``.

It serves every learner the CLIs build: PPO (MLP and LSTM), MAPPO, AMPPPO
and each task's PPO of ``learn/multitask.py``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

ENV_AXIS = "env"


def make_mesh(ranks=None):
    """The process group over `ranks` (default every rank): the port's mesh
    of the env axis. The process group must be initialized
    (``parallel/distributed.py maybe_initialize``)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: launch through "
                           "parallel/distributed.py maybe_initialize")
    return dist.group.WORLD if ranks is None else dist.new_group(list(ranks))


def all_reduce_mean(tensors: list, group) -> list:
    """The mean over `group`'s ranks of each tensor, in one all-reduce of
    one flat float32 buffer."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def flat_parameters(ts) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in ts.parameters()])


def _broadcast_from_first(x: torch.Tensor, group) -> None:
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)


def check_replicas(ts, group) -> None:
    """Raise RuntimeError unless every rank's parameters equal rank 0's
    (bit for bit): a collective, called by every rank of `group`."""
    mine = flat_parameters(ts)
    ref = mine.clone()
    _broadcast_from_first(ref, group)
    bad = torch.tensor([0.0 if torch.equal(mine, ref) else 1.0], device=mine.device)
    dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=group)
    if float(bad) > 0:
        raise RuntimeError(f"the parameters of {int(float(bad))} rank(s) differ from rank 0's")


def shard_ppo(ppo, group=None):
    """Make `ppo` (a PPO, MAPPO or AMPPPO over this rank's envs) a data-
    parallel learner over `group` (default ``make_mesh()``).

    Returns (train_iter, init_fn):
      train_iter(ts, env_state) -> (ts, env_state, metrics): metrics are this
        rank's local values (the losses and KL are the ranks' mean);
      init_fn(seed, env_seed=seed) -> (ts, env_state): the parameters
        broadcast from rank 0, the generator seeded seed + 1 + rank, and this
        rank's envs reset as rows [rank B, (rank + 1) B) of a reset of the
        whole run.
    """
    group = make_mesh() if group is None else group
    rank = dist.get_rank(group)
    ppo.group = group
    ppo.env.env_id0 = rank * ppo.env.num_envs

    def init_fn(seed: int, env_seed: int | None = None):
        ts = ppo.init(seed)
        flat = flat_parameters(ts)
        _broadcast_from_first(flat, group)
        with torch.no_grad():
            i = 0
            for p in ts.parameters():
                p.copy_(flat[i:i + p.numel()].reshape(p.shape))
                i += p.numel()
        ts.gen.manual_seed(int(seed) + 1 + rank)
        return ts, ppo.env.reset(seed if env_seed is None else env_seed)

    return ppo.train_iteration, init_fn
