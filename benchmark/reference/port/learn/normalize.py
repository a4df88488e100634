"""Running mean/std normalization (rl_games' RunningMeanStd). Port of
``thormang_isaacgym_tpu/learn/normalize.py``: a state dataclass updated with
batched parallel-variance (Chan) moments."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RMSState:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(shape=(), device="cpu") -> "RMSState":
        return RMSState(torch.zeros(shape, device=device), torch.ones(shape, device=device),
                        torch.tensor(1e-4, device=device))


def rms_update(state: RMSState, batch: torch.Tensor) -> RMSState:
    """batch: (N, *shape)."""
    bmean = batch.mean(dim=0)
    bvar = batch.var(dim=0, unbiased=False)
    bcount = batch.shape[0]
    delta = bmean - state.mean
    tot = state.count + bcount
    new_mean = state.mean + delta * (bcount / tot)
    m2 = state.var * state.count + bvar * bcount + delta ** 2 * state.count * bcount / tot
    return RMSState(new_mean, m2 / tot, tot)


def rms_normalize(state: RMSState, x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x - state.mean) / torch.sqrt(state.var + 1e-5), -5.0, 5.0)


def rms_denormalize(state: RMSState, x: torch.Tensor) -> torch.Tensor:
    return x * torch.sqrt(state.var + 1e-5) + state.mean
