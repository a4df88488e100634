"""Multi-process launch: the torchrun equivalent. Port of
``thormang_isaacgym_tpu/parallel/distributed.py``.

One process per rank, each with its own envs (``host_local_batch``) and its
own copy of the learner; ``parallel/mesh.py`` averages the gradients over
the ranks. Launch each rank with the JAX CLI's keys:

  python -m thormang_isaacgym_tpu_torch.runtime.train task=Ant multi_host=true \\
      coordinator=127.0.0.1:29500 num_processes=2 process_id=<rank>

or under torchrun, whose ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` stand in for them (the counterpart of
JAX's values coming from the environment on a TPU pod):

  torchrun --nproc_per_node=2 -m thormang_isaacgym_tpu_torch.runtime.train task=Ant

Each rank takes ``cuda:(LOCAL_RANK % device_count)``. The backend follows
from the layout: NCCL when every rank on the host has a card of its own,
gloo when ranks share a card (NCCL refuses two ranks on one GPU) or run on
the CPU; gloo all-reduces CUDA tensors through the host.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from thormang_isaacgym_tpu_torch.engine.env import resolve_device


def _requested(cfg: dict) -> str | None:
    """'keys' (the JAX CLI's keys), 'torchrun' (its environment) or None."""
    if cfg.get("multi_host") or os.environ.get("THORMANG_MULTI_HOST"):
        return "keys"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and "RANK" in os.environ:
        return "torchrun"
    return None


def maybe_initialize(cfg: dict) -> dict:
    """Join the process group when a multi-process run is requested.

    Returns {initialized, process_id, num_processes, device, backend}:
    ``device`` is the rank's device (``cfg["device"]`` if given, else its
    card), ``backend`` the group's (None when not initialized)."""
    how = _requested(cfg)
    if how is None:
        return {"initialized": False, "process_id": 0, "num_processes": 1,
                "device": resolve_device(cfg.get("device")), "backend": None}
    if how == "keys":
        rank = int(cfg.get("process_id", os.environ.get("RANK", 0)))
        world = int(cfg.get("num_processes", os.environ.get("WORLD_SIZE", 1)))
        coord = cfg.get("coordinator") or "{}:{}".format(
            os.environ.get("MASTER_ADDR", "127.0.0.1"), os.environ.get("MASTER_PORT", "29500"))
        init_method = f"tcp://{coord}"
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if cfg.get("device") is not None:
        device = resolve_device(cfg["device"])
    else:
        device = resolve_device("cuda")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    own_card = device.type == "cuda" and local_world <= torch.cuda.device_count()
    backend = "nccl" if own_card else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return {"initialized": True, "process_id": dist.get_rank(),
            "num_processes": dist.get_world_size(), "device": device, "backend": backend}


def host_local_batch(global_batch: int) -> int:
    """The env count this rank owns: the run's global count over its ranks
    (each rank steps only its own envs, as the reference's rank-local sims)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"num_envs {global_batch} is not a multiple of the {n} ranks")
    return global_batch // n
