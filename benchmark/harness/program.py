"""The system under test, the port ``thormang_isaacgym_tpu_torch``: built as
its training CLI builds it, and driven through ``PPO.train_iteration``.

This module is the one adapter between the benchmark and the program. The
window calls only the program's public API: ``make``, ``PPOConfig.
from_rlgames``, ``PPO``, ``PPO.init``, ``VecEnv.reset`` and ``PPO.
train_iteration``. :class:`Capture` wraps calls on the instances while
set-up drives the first iterations (nothing of the program is edited) and
keeps what the reference needs to follow them; it reads, besides the public
``TrainState.parameters()``, ``PPO.rollout``/``rollout_rnn`` and ``VecEnv.
step_fn``, two internals of ``learn/ppo.py``, named in ``HOOKS``:

- ``PPO._objective``: each optimizer step's loss;
- ``PPO._apply_grads`` and ``TrainState.adam_m``: the first gradient as
  Adam holds it after one step (its first moment over 1 - ``B1``).

:class:`ResetCapture` wraps ``VecEnv.step_fn`` alone for one iteration
after the window, for the envs that the masked reset restarts. The faults
of ``faults.py`` (control runs and tests only) wrap further internals."""
from __future__ import annotations

import dataclasses

import torch

B1 = 0.9   # Adam's first-moment decay, as ``PPO._apply_grads`` states it
HOOKS = ("_objective", "_apply_grads")   # the internals of PPO the capture reads
RESET_ROWS = 128   # envs restarted by the masked reset, kept a step at most
RESET_STEPS = 4    # env steps with such envs kept from the iteration after the window


def build(c: dict, task_cfg: dict, seed: int, device: str):
    """(env, ppo, PPOConfig) of the cell `c` on `device`."""
    import thormang_isaacgym_tpu_torch as tgt
    from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig

    env = tgt.make(c["config"]["task"], num_envs=int(c["traffic"]["num_envs"]), seed=seed,
                   cfg=task_cfg, device=device)
    cfg = PPOConfig.from_rlgames(c["traffic"]["train_cfg"])
    return env, PPO(env, cfg, device=device), cfg


def to_plain(x, idx, B: int):
    """A program value as plain data: dataclasses as dicts tagged with their
    module (below the package) and class, tensors that lead with the env
    axis cut to the rows `idx`, all on the host."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dim() >= 1 and t.shape[0] == B:
            t = t[idx]
        return t.to("cpu", copy=True)
    if dataclasses.is_dataclass(x):
        mod = type(x).__module__.split(".", 1)[1]
        out = {f.name: to_plain(getattr(x, f.name), idx, B) for f in dataclasses.fields(x)}
        out["__dc__"] = (mod, type(x).__name__)
        return out
    if isinstance(x, tuple):
        return tuple(to_plain(v, idx, B) for v in x)
    if isinstance(x, dict):
        return {k: to_plain(v, idx, B) for k, v in x.items()}
    return x


def _host(t):
    return None if t is None else t.detach().to("cpu", copy=True)


class Capture:
    """Records the first iterations of `ppo` on `env` for the reference;
    `idx` are the sampled envs whose states are kept around each step."""

    def __init__(self, env, ppo, idx: torch.Tensor, checked_steps=None, seed: int = 0):
        self.env, self.ppo, self.idx = env, ppo, idx
        # the env steps (counted from 0 over the followed iterations) whose
        # states are kept; None keeps every one
        self.checked = None if checked_steps is None else set(int(s) for s in checked_steps)
        self.n_steps = 0
        self.B = env.num_envs
        self.iters, self.steps, self.losses = [], [], []
        self.resets = ResetRows(self.B, idx.device, seed)
        self.grad1 = None
        self.reset_rows = None
        self.params0 = self.params3 = None

    def params(self, ts) -> list:
        return [_host(p) for p in ts.parameters()]

    def install(self):
        ppo, env, cap = self.ppo, self.env, self
        missing = [h for h in HOOKS if not hasattr(ppo, h)]
        if missing:
            raise AttributeError(f"the program's PPO has no {missing}: the capture reads them")
        roll_name = "rollout_rnn" if ppo.is_rnn else "rollout"
        roll, objective = getattr(ppo, roll_name), ppo._objective
        apply_grads, step_fn = ppo._apply_grads, env.step_fn

        def rollout(ts, env_state):
            first = dict(obs=_host(env_state.obs), states=_host(env_state.states),
                         done=_host(env_state.done))
            out = roll(ts, env_state)
            last, traj = out[0], out[1]
            rec = {k: _host(traj[k]) for k in ("obs", "reward", "done", "timeout", "action")}
            if ppo.asymmetric:
                rec["states"] = _host(traj["states"])
            rec.update(first=first, last=dict(obs=_host(last.obs), states=_host(last.states),
                                              done=_host(last.done)))
            cap.iters.append(rec)
            return out

        def obj(ts, mu, log_std, value, batch):
            total, aux = objective(ts, mu, log_std, value, batch)
            cap.losses.append(total.detach())
            return total, aux

        def grads(ts, g):
            apply_grads(ts, g)
            if cap.grad1 is None:
                cap.grad1 = [_host(m) / (1.0 - B1) for m in ts.adam_m]

        def step(state, actions):
            new = step_fn(state, actions)
            if cap.checked is None or cap.n_steps in cap.checked:
                cap.steps.append((to_plain(state, cap.idx, cap.B), _host(actions[cap.idx]),
                                  to_plain(new, cap.idx, cap.B)))
                cap.resets.add(state, actions, new)
            cap.n_steps += 1
            return new

        self._saved = _wrap([(ppo, roll_name, rollout), (ppo, "_objective", obj),
                             (ppo, "_apply_grads", grads), (env, "step_fn", step)])

    def remove(self):
        _unwrap(self._saved)
        self.losses = [float(x) for x in self.losses]

    def record(self, seed: int, num_envs: int) -> dict:
        """What the reference reads, all on the host."""
        return dict(seed=seed, num_envs=num_envs, idx=self.idx.cpu(), iters=self.iters,
                    steps=self.steps, reset_steps=self.resets.steps, losses=self.losses,
                    grad1=self.grad1,
                    reset_rows=self.reset_rows, params0=self.params0, params3=self.params3)


def _wrap(items: list) -> list:
    """Set each (object, name, function) as an instance attribute; what
    each replaced, for :func:`_unwrap`."""
    saved = []
    for obj, name, fn in items:
        saved.append((obj, name, obj.__dict__.get(name, _MISSING)))
        obj.__dict__[name] = fn
    return saved


def _unwrap(saved: list) -> None:
    for obj, name, prev in reversed(saved):
        if prev is _MISSING:
            del obj.__dict__[name]
        else:
            obj.__dict__[name] = prev


_MISSING = object()


class ResetRows:
    """The envs that an env step's masked reset restarts (done set before
    the step): up to ``RESET_ROWS`` of them a step, drawn from the seed and
    repeated to that count, with their states around the step."""

    def __init__(self, B: int, device, seed: int, max_steps: int | None = None):
        self.B, self.device, self.steps, self.max_steps = B, device, [], max_steps
        self.gen = torch.Generator().manual_seed((int(seed) + 2) % (2 ** 63))

    def add(self, state, actions, new) -> None:
        if self.max_steps is not None and len(self.steps) >= self.max_steps:
            return
        rows = torch.nonzero(state.done > 0).flatten().cpu()
        if not len(rows):
            return
        pick = rows[torch.randperm(len(rows), generator=self.gen)[:RESET_ROWS]]
        pick = pick.repeat(-(-RESET_ROWS // len(pick)))[:RESET_ROWS]
        idx = pick.to(self.device)
        self.steps.append(dict(ids=pick, pre=to_plain(state, idx, self.B),
                               action=_host(actions[idx]), post=to_plain(new, idx, self.B)))


class ResetCapture:
    """One iteration after the window: the envs its masked resets restart,
    in its first ``RESET_STEPS`` env steps that have any, for the reference
    to follow (``ResetRows``)."""

    def __init__(self, env, seed: int):
        self.env = env
        self.rows = ResetRows(env.num_envs, env.device, seed, RESET_STEPS)

    def __enter__(self):
        step_fn, rows = self.env.step_fn, self.rows

        def step(state, actions):
            new = step_fn(state, actions)
            rows.add(state, actions, new)
            return new

        self._saved = _wrap([(self.env, "step_fn", step)])
        return self.rows

    def __exit__(self, *exc):
        _unwrap(self._saved)
