"""Actor-critic MLP (rl_games' ``actor_critic`` network). Port of the
``ActorCritic`` of ``thormang_isaacgym_tpu/learn/networks.py``:

- MLP trunk of ``units`` with ``activation`` (shared unless ``separate``)
- continuous head: linear mu and a state-independent log_std parameter
  (rl_games fixed_sigma), clamped to [-5, 2]
- value head: linear scalar

Layer names follow the flax module (trunk_i, vtrunk_i, mu, value, log_std) so
parity/convert.py maps weights one to one. Mixed precision is bf16 autocast
around the call (learn/ppo.py), outputs are float32.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default Dense kernel init: a normal truncated at 2 sigma with
    variance 1/fan_in (inverse-CDF sampling)."""
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), 0.5 * math.erfc(-2.0 / math.sqrt(2.0))
    u = lo + (hi - lo) * torch.rand(w.shape, generator=generator)
    with torch.no_grad():
        w.copy_(torch.special.ndtri(u) * std)
    return w


class ActorCritic(nn.Module):
    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (512, 512, 512),
                 activation: str = "elu", separate: bool = False,
                 sigma_init: float = 0.0, seed: int = 0):
        super().__init__()
        self.act = getattr(nn.functional, activation)
        self.separate = separate

        def mlp():
            dims = [num_obs] + list(units)
            return nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

        self.trunk = mlp()
        self.vtrunk = mlp() if separate else None
        width = units[-1] if units else num_obs
        self.mu = nn.Linear(width, num_actions)
        self.value = nn.Linear(width, 1)
        self.log_std = nn.Parameter(torch.full((num_actions,), float(sigma_init)))
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, gen)
                nn.init.zeros_(m.bias)

    def _run(self, layers, x):
        for layer in layers:
            x = self.act(layer(x))
        return x

    def forward(self, obs: torch.Tensor):
        """obs (B, num_obs) -> (mu, log_std, value) float32."""
        trunk = self._run(self.trunk, obs)
        vtrunk = self._run(self.vtrunk, obs) if self.separate else trunk
        mu = self.mu(trunk)
        value = self.value(vtrunk)[..., 0]
        # exp(2 log_std) in the KL overflows float32 past ~44; bound it
        log_std = torch.clamp(self.log_std, -5.0, 2.0).expand(mu.shape)
        return mu.float(), log_std.float(), value.float()
