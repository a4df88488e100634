"""Floating-point operations of the PPO learner's networks (the port's
``learn/networks.py`` at the widths of a train config) and of one training
iteration, by the precision they run in.

A dense layer of `a` inputs and `b` outputs costs 2ab per row forward (its
bias, activation, gates and norms are left out: they are not matrix work);
a backward pass costs twice its forward, less the gradient of the
observations (and privileged states), which nothing asks for: a layer that
reads them costs 2ab backward, not 4ab. The counts follow the shapes only.

Published dense peaks of one NVIDIA H100 SXM: fp32 outside the tensor cores
67 TFLOP/s, TF32 495, bf16 989."""
from __future__ import annotations

PEAK_FLOP_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}


def _dense(dims) -> float:
    return float(sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])))


def policy_flops(num_obs: int, num_actions: int, units, rnn_units: int = 0,
                 rnn_layers: int = 1, before_mlp: bool = False, concat_input: bool = False,
                 separate: bool = False, fixed_sigma: bool = True) -> float:
    """One row's forward of ActorCritic / ActorCriticRNN: trunk, LSTM cells
    (input and recurrent matrices), mu, value and, unless fixed, sigma."""
    units = list(units)
    heads = num_actions + 1 + (0 if fixed_sigma else num_actions)
    if not rnn_units:
        width = units[-1] if units else num_obs
        trunk = _dense([num_obs, *units]) * (2 if separate else 1)
        return trunk + 2.0 * width * heads
    if before_mlp:
        rnn_in, width = num_obs, units[-1] if units else rnn_units
        trunk = _dense([rnn_units, *units])
    else:
        rnn_in = (units[-1] if units else num_obs) + (num_obs if concat_input else 0)
        width = rnn_units
        trunk = _dense([num_obs, *units])
    cells = sum(2.0 * 4 * rnn_units * ((rnn_in if k == 0 else rnn_units) + rnn_units)
                for k in range(rnn_layers))
    return trunk + cells + 2.0 * width * heads


def input_grad_flops(num_obs: int, num_actions: int, units, rnn_units: int = 0,
                     before_mlp: bool = False, concat_input: bool = False,
                     separate: bool = False, fixed_sigma: bool = True) -> float:
    """One row's backward work that autograd skips: the gradient of the
    observations through the layers that read them (the trunk's first layer,
    or the heads without a trunk, or the LSTM's input matrix)."""
    units = list(units)
    if rnn_units and (before_mlp or concat_input):
        return 2.0 * 4 * rnn_units * num_obs
    if units:
        return 2.0 * num_obs * units[0] * (2 if separate and not rnn_units else 1)
    if rnn_units:
        return 2.0 * 4 * rnn_units * num_obs
    return 2.0 * num_obs * (num_actions + 1 + (0 if fixed_sigma else num_actions))


def critic_flops(num_states: int, units) -> float:
    """One row's forward of the asymmetric critic's ValueNet."""
    units = list(units)
    return _dense([num_states, *units]) + 2.0 * (units[-1] if units else num_states)


def iteration_flops(cfg: dict, num_envs: int, num_obs: int, num_actions: int,
                    num_states: int = 0) -> dict:
    """The networks' operations of one train_iteration: the rollout's
    forward of every step and the bootstrap's, then for each mini-epoch a
    forward and a backward of every transition (an LSTM's sequences re-run
    from their stored carries count as one forward a transition), less the
    observations' gradient. `cfg` has the PPOConfig fields. Returns
    {precision: flops}."""
    per_row = policy_flops(num_obs, num_actions, cfg["units"], cfg.get("rnn_units", 0),
                           cfg.get("rnn_layers", 1), cfg.get("rnn_before_mlp", False),
                           cfg.get("rnn_concat_input", False), cfg.get("separate", False),
                           cfg.get("fixed_sigma", True))
    skipped = input_grad_flops(num_obs, num_actions, cfg["units"], cfg.get("rnn_units", 0),
                               cfg.get("rnn_before_mlp", False), cfg.get("rnn_concat_input", False),
                               cfg.get("separate", False), cfg.get("fixed_sigma", True))
    if num_states:
        per_row += critic_flops(num_states, cfg["units"])
        units = list(cfg["units"])
        skipped += 2.0 * num_states * (units[0] if units else 1)
    T = int(cfg["horizon_length"])
    rollout = per_row * num_envs * (T + 1)
    update = (3.0 * per_row - skipped) * num_envs * T * int(cfg["mini_epochs"])
    prec = "bf16" if cfg.get("mixed_precision") else "fp32"
    return {prec: rollout + update}
