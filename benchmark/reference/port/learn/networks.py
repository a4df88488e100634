"""Actor-critic networks (rl_games' ``actor_critic`` network). Port of
``thormang_isaacgym_tpu/learn/networks.py``:

- ``ActorCritic``: an MLP trunk of ``units`` with ``activation`` (shared
  unless ``separate``), a linear mu, a linear value, and a log_std that is a
  state-independent parameter (rl_games fixed_sigma) or, with
  ``fixed_sigma=False``, a linear ``sigma`` head on the trunk; clamped to
  [-5, 2]
- ``ActorCriticRNN``: the rl_games ``rnn:`` block, LSTM layers between the
  trunk and the heads (or before the trunk with ``before_mlp``), the input
  concatenated to the trunk's output with ``concat_input``, a LayerNorm on
  the LSTM's output with ``layer_norm``; mu, value and sigma read the last
  features, so, as in the JAX package, ``separate`` does nothing here (the
  value head reads the LSTM's output, unlike rl_games' separate critic)
- ``ValueNet``: the asymmetric critic over the privileged states, an MLP of
  the actor's ``units`` and ``activation`` and a linear value
- ``AMPDiscriminator``: the rl_games ``disc:`` block of AMP, an MLP of
  ``units`` and ``activation`` and a final one-unit layer ``disc_logits``
  (the layer the logit-weight regulariser of learn/amp.py reads)

Layer names follow the flax modules (trunk_i, vtrunk_i, mu, value, sigma,
log_std, lstm_l, rnn_ln, cv_i, cv_value, disc_i, disc_logits) so
parity/convert.py maps weights one to one. An LSTM layer is flax's
``OptimizedLSTMCell``: gates i, f, g, o;
the input kernels without bias and the hidden kernels with it, here each
four concatenated into one Linear (``ih``, ``hh``); no forget-gate bias.
The carry is a (layers, 2, B, units) float32 tensor of (c, h) per layer.
Mixed precision is bf16 autocast around the call (learn/ppo.py); outputs and
the carry are float32.
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


def _mlp(dims: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))


def _init_linears(module: nn.Module, seed: int) -> None:
    """lecun-normal kernels and zero biases, from one seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class _Heads(nn.Module):
    """mu, value and the log_std parameter or sigma head on `width` features
    (made after the trunk, so parameters and init draws follow it)."""

    def _add_heads(self, width: int, num_actions: int, fixed_sigma: bool, sigma_init: float):
        self.mu = nn.Linear(width, num_actions)
        self.value = nn.Linear(width, 1)
        if fixed_sigma:
            self.log_std = nn.Parameter(torch.full((num_actions,), float(sigma_init)))
            self.sigma = None
        else:
            self.log_std = None
            self.sigma = nn.Linear(width, num_actions)

    def heads(self, x: torch.Tensor, vx: torch.Tensor):
        mu = self.mu(x)
        value = self.value(vx)[..., 0]
        log_std = self.log_std.expand(mu.shape) if self.sigma is None else self.sigma(x)
        # exp(2 log_std) in the KL overflows float32 past ~44; bound it
        return mu.float(), torch.clamp(log_std, -5.0, 2.0).float(), value.float()


class ActorCritic(_Heads):
    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (512, 512, 512),
                 activation: str = "elu", separate: bool = False, fixed_sigma: bool = True,
                 sigma_init: float = 0.0, seed: int = 0):
        super().__init__()
        self.act = getattr(nn.functional, activation)
        self.separate = separate
        self.trunk = _mlp([num_obs, *units])
        self.vtrunk = _mlp([num_obs, *units]) if separate else None
        self._add_heads(units[-1] if units else num_obs, num_actions, fixed_sigma, sigma_init)
        _init_linears(self, seed)

    def _run(self, layers, x):
        for layer in layers:
            x = self.act(layer(x))
        return x

    def forward(self, obs: torch.Tensor):
        """obs (B, num_obs) -> (mu, log_std, value) float32."""
        trunk = self._run(self.trunk, obs)
        vtrunk = self._run(self.vtrunk, obs) if self.separate else trunk
        return self.heads(trunk, vtrunk)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: z = (h W_h + b_h) + x W_i, gates i, f, g,
    o in that order; c' = f c + i g, h' = o tanh(c')."""

    def __init__(self, in_features: int, units: int):
        super().__init__()
        self.ih = nn.Linear(in_features, 4 * units, bias=False)
        self.hh = nn.Linear(units, 4 * units)

    def forward(self, c: torch.Tensor, h: torch.Tensor, x: torch.Tensor):
        z = self.hh(h) + self.ih(x)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return c, h


class ActorCriticRNN(_Heads):
    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (256, 128),
                 rnn_units: int = 256, rnn_layers: int = 1, before_mlp: bool = False,
                 concat_input: bool = False, layer_norm: bool = False, activation: str = "elu",
                 fixed_sigma: bool = True, sigma_init: float = 0.0, seed: int = 0):
        if before_mlp:
            rnn_in, width = num_obs, units[-1] if units else rnn_units
        else:
            rnn_in = (units[-1] if units else num_obs) + (num_obs if concat_input else 0)
            width = rnn_units
        super().__init__()
        self.act = getattr(nn.functional, activation)
        self.before_mlp, self.concat_input = before_mlp, concat_input
        self.rnn_units, self.rnn_layers = rnn_units, rnn_layers
        self.trunk = _mlp([rnn_units if before_mlp else num_obs, *units])
        self.lstm = nn.ModuleList(LSTMCell(rnn_in if k == 0 else rnn_units, rnn_units)
                                  for k in range(rnn_layers))
        self.rnn_ln = nn.LayerNorm(rnn_units, eps=1e-6) if layer_norm else None
        self._add_heads(width, num_actions, fixed_sigma, sigma_init)
        _init_linears(self, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        for cell in self.lstm:
            # flax's recurrent kernel init: orthogonal, per gate
            with torch.no_grad():
                for w in cell.hh.weight.view(4, rnn_units, rnn_units):
                    nn.init.orthogonal_(w, generator=gen)

    def zero_carry(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros(self.rnn_layers, 2, batch, self.rnn_units, device=device)

    def _run(self, x):
        for layer in self.trunk:
            x = self.act(layer(x))
        return x

    def forward(self, obs: torch.Tensor, carry: torch.Tensor):
        """obs (B, num_obs), carry (layers, 2, B, rnn_units) -> (mu, log_std,
        value, carry') float32."""
        x = obs
        if not self.before_mlp:
            x = self._run(x)
            if self.concat_input:
                x = torch.cat([x, obs.to(x.dtype)], -1)
        new = []
        for cell, (c, h) in zip(self.lstm, carry.unbind(0)):
            c, h = cell(c, h, x)
            x = h
            new.append(torch.stack([c.float(), h.float()]))
        if self.rnn_ln is not None:
            x = self.rnn_ln(x)
        if self.before_mlp:
            x = self._run(x)
        return (*self.heads(x, x), torch.stack(new))


class ValueNet(nn.Module):
    """The central value network of the asymmetric critic."""

    def __init__(self, num_states: int, units: Sequence[int] = (512, 512, 256),
                 activation: str = "elu", seed: int = 0):
        super().__init__()
        self.act = getattr(nn.functional, activation)
        self.cv = _mlp([num_states, *units])
        self.cv_value = nn.Linear(units[-1] if units else num_states, 1)
        _init_linears(self, seed)

    def forward(self, states: torch.Tensor) -> torch.Tensor:
        """states (B, num_states) -> value (B,) float32."""
        x = states
        for layer in self.cv:
            x = self.act(layer(x))
        return self.cv_value(x)[..., 0].float()


class AMPDiscriminator(nn.Module):
    """The AMP discriminator: an MLP of ``units`` with ``activation`` over the
    (normalised) AMP window, then ``disc_logits``, one logit per row."""

    def __init__(self, num_amp_obs: int, units: Sequence[int] = (1024, 512),
                 activation: str = "relu", seed: int = 0):
        super().__init__()
        self.act = getattr(nn.functional, activation)
        self.disc = _mlp([num_amp_obs, *units])
        self.disc_logits = nn.Linear(units[-1] if units else num_amp_obs, 1)
        _init_linears(self, seed)

    def kernels(self) -> list:
        """The weight matrices (flax's kernels, not the biases): the weight
        decay's terms; the last is ``disc_logits``'."""
        return [lin.weight for lin in self.disc] + [self.disc_logits.weight]

    def forward(self, amp_obs: torch.Tensor) -> torch.Tensor:
        """amp_obs (B, num_amp_obs) -> logits (B,) float32."""
        x = amp_obs
        for layer in self.disc:
            x = self.act(layer(x))
        return self.disc_logits(x)[..., 0].float()
