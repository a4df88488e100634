"""How ``correct`` is decided: the reference follows the program's first
iterations (``reference/learner.py``) and, on a sample of envs and of env
steps drawn from the seed, the env step by step (``reference/envcheck.py``).
The numbers
compared, each a gap between the program and the reference:

- ``start_gap``: the reset's q, qd and observations of the sampled envs and
  the initial weights, largest absolute difference;
- ``q_gap``, ``obs_gap``: the 99th percentile over sampled env steps of the
  largest absolute difference of the state q and of the observations after
  the step (the physics kernel against the plain step, then the task);
- ``reward_gap``: the same of |dr| / (1 + |r|);
- ``done_mismatch``: the share of those env steps, and of the reset rows
  below, whose done differs; exact, so its limit is 0;
- ``reset_q_gap``, ``reset_obs_gap``: the largest absolute difference of q
  and of the observations over the reset rows: envs that the step's masked
  reset restarts (done set before it), from the sampled envs and, up to
  ``program.RESET_ROWS`` a step, from all envs, in the checked steps and in
  ``program.RESET_STEPS`` steps of one iteration after the window, each
  stepped by the reference from the program's recorded state;
- ``action_gap``: the largest absolute difference of the first iteration's
  actions (the policy's forward pass at the initial weights, the same
  noise); later iterations' actions carry every rounding of the updates
  before them, which the learner amplifies as far for a sound learner
  with its arithmetic ordered otherwise as for the control;
- ``loss_gap``: each optimizer step's loss, worst |dL| / max(|L|, median |L|);
- ``grad_gap``: the first gradient as Adam holds it after one step, by the
  worst leaf: the gap of the leaf norms over the larger of the reference's
  leaf norm and its median leaf norm;
- ``update_gap``: the parameters' change over the followed iterations, the
  same way.

Leaves whose reference gradient is under a thousandth of the median leaf's
(moved by round-off alone) are left out of both leaf numbers. A cell's
``limits/<cell>.json`` gives each compared number its limit; numbers it
does not list are printed and not compared."""
from __future__ import annotations

import math
import statistics

import torch

from benchmark.harness import spec as S

ORDER = ("start_gap", "q_gap", "obs_gap", "reward_gap", "done_mismatch", "reset_q_gap",
         "reset_obs_gap", "action_gap", "loss_gap", "grad_gap", "update_gap")
LEARNER = ("action_gap", "loss_gap", "grad_gap", "update_gap")


def sample_ids(seed: int, num_envs: int, n: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    return torch.sort(torch.randperm(num_envs, generator=g)[:n]).values


def sample_steps(seed: int, steps: int, n: int) -> list:
    """`n` of the followed iterations' `steps` env steps, drawn from the
    seed, always with the first."""
    g = torch.Generator().manual_seed((int(seed) + 1) % (2 ** 63))
    rest = (torch.randperm(steps - 1, generator=g)[:max(n - 1, 0)] + 1).tolist()
    return sorted([0] + rest)


def _maxabs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _max(x: torch.Tensor) -> float:
    return float(x.float().max()) if x.numel() else 0.0


def _p99(x: torch.Tensor) -> float:
    return float(torch.quantile(x.float(), 0.99)) if x.numel() else 0.0


def leaf_gap(prog: list, ref: list, keep: list) -> float:
    """Worst leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖) over `keep`."""
    pn = [float(p.float().norm()) for p in prog]
    rn = [float(r.float().norm()) for r in ref]
    med = statistics.median(rn[i] for i in keep)
    return max(abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in keep)


def learner_numbers(cap: dict, ref: dict) -> dict:
    """The learner's numbers of the program's capture `cap` against the
    reference learner's run `ref` (or of one reference run against another)."""
    rn = [float(g.float().norm()) for g in ref["grad1"]]
    med = statistics.median(rn)
    keep = [i for i, n in enumerate(rn) if n >= 1e-3 * med]
    dp = [a.float() - b.float() for a, b in zip(cap["params3"], cap["params0"])]
    dr = [a.float() - b.float() for a, b in zip(ref["params3"], ref["params0"])]
    lr = ref["losses"]
    lmed = statistics.median(abs(x) for x in lr)
    n = min(len(lr), len(cap["losses"]))
    loss_gap = max(abs(a - b) / max(abs(b), lmed, 1e-30)
                   for a, b in zip(cap["losses"][:n], lr[:n])) if n else math.inf
    if len(cap["losses"]) != len(lr):
        loss_gap = math.inf
    acts = cap["iters"][0]["action"] if "iters" in cap else cap["actions"][:ref["horizon"]]
    return dict(
        start_gap_weights=max(_maxabs(a, b) for a, b in zip(cap["params0"], ref["params0"])),
        action_gap=_maxabs(acts, ref["actions"][:ref["horizon"]]),
        loss_gap=loss_gap,
        grad_gap=leaf_gap(cap["grad1"], ref["grad1"], keep),
        update_gap=leaf_gap(dp, dr, keep),
        leaves_kept=len(keep), leaves=len(rn))


def env_numbers(cap: dict, task: str, task_cfg: dict, device) -> dict:
    """The env's numbers: the reference's reset of the sampled envs against
    the program's, then each recorded env step from the program's state."""
    from benchmark.reference import envcheck

    ids = cap["idx"]
    env = envcheck.build(task, task_cfg, cap["seed"], ids, device)
    s0 = envcheck.start(env, cap["seed"])
    r0 = cap["reset_rows"]
    start = max(_maxabs(s0.q.cpu(), r0["q"]), _maxabs(s0.qd.cpu(), r0["qd"]),
                _maxabs(s0.obs.cpu(), r0["obs"]))
    params = s0.params
    dq, dobs, drew, ddone, rq, robs = [], [], [], [], [], []
    for pre, action, post in cap["steps"]:
        out = envcheck.step(env, pre, action, params, device)
        params = out.params
        dq.append((out.q.cpu() - post["q"]).abs().amax(-1))
        dobs.append((out.obs.cpu() - post["obs"]).abs().amax(-1))
        r = out.reward.cpu()
        drew.append((r - post["reward"]).abs() / (1.0 + r.abs()))
        ddone.append((out.done.cpu() != post["done"]).float())
        restarted = pre["done"] > 0
        rq.append(dq[-1][restarted])
        robs.append(dobs[-1][restarted])
    kernel = kernel_counts(env, [pre["q"] for pre, _, _ in cap["steps"]],
                           [pre["qd"] for pre, _, _ in cap["steps"]], cap["num_envs"], device)
    sampled_resets = sum(len(x) for x in rq)
    del env
    steps = cap.get("reset_steps", [])
    if steps:
        renv = envcheck.build(task, task_cfg, cap["seed"], steps[0]["ids"], device)
        for st in steps:
            out = envcheck.step_rows(renv, st["pre"], st["action"], st["ids"], device)
            post = st["post"]
            rq.append((out.q.cpu() - post["q"]).abs().amax(-1))
            robs.append((out.obs.cpu() - post["obs"]).abs().amax(-1))
            ddone.append((out.done.cpu() != post["done"]).float())
    cat = torch.cat
    return dict(kernel_counts=kernel, start_gap_env=start, q_gap=_p99(cat(dq)),
                obs_gap=_p99(cat(dobs)), reward_gap=_p99(cat(drew)),
                done_mismatch=float(cat(ddone).mean()), reset_q_gap=_max(cat(rq)),
                reset_obs_gap=_max(cat(robs)), env_steps=len(cap["steps"]) * len(ids),
                reset_rows=sampled_resets + sum(len(set(st["ids"].tolist())) for st in steps),
                reset_steps=len(steps))


def active_shares(model, q: torch.Tensor, qd: torch.Tensor) -> dict:
    """The shares of the ground and pair contact candidates in contact at
    the states (q, qd): the inputs of the kernel's launches."""
    from benchmark.reference.port.ops import collide, contact
    from benchmark.reference.port.ops.kinematics import forward_kinematics

    frames = forward_kinematics(model, q, qd)
    out = dict(ground=0.0, pairs=0.0)
    c = contact.candidates(model)
    if len(c["geom"]):
        p, _ = contact.candidate_points(model, frames)
        r = torch.as_tensor(c["r"], device=q.device)
        out["ground"] = float((p[..., 2] - r < 0).float().mean())
    cands = collide.candidates(model, frames)
    if cands:
        out["pairs"] = float(torch.stack([d > 0 for *_, d, _ in cands]).float().mean())
    return out


def kernel_counts(env, qs: list, qds: list, num_envs: int, device) -> dict:
    """The kernel's operations and bytes a launch at `num_envs` envs, every
    candidate's force counted (``most``) and only those of the candidates in
    contact at the recorded states (``needed``)."""
    from benchmark.counts import kernel as K

    task = env.task
    tb = getattr(task, "net_torque_bodies", None)
    if tb is not None:
        ntq = len(set(int(b) for b in tb))
    else:
        ntq = task.model.nb if getattr(task, "uses_net_torque", False) else 0
    attractors = tuple(getattr(task, "attractors", None) or ())
    active = active_shares(task.model, torch.cat(qs).to(device), torch.cat(qds).to(device))
    n = task.sim_params.substeps
    return dict(active=active,
                most=K.launch(task.model, n, num_envs, ntq, attractors),
                needed=K.launch(task.model, n, num_envs, ntq, attractors, active))


def numbers(cap: dict, c: dict, device, control: str | None = None,
            witness: bool = False) -> dict:
    """Every number of a run (the program's capture against the reference).
    With `control` the learner's numbers are also read for the control:
    the reference in that lower precision against the reference. With
    `witness`, for a sound learner whose arithmetic is ordered otherwise:
    the reference with every dense layer's product summed in two halves of
    its inputs (``precision.lowered("split")``) against the reference."""
    from benchmark.reference import learner, precision

    precision.strict_fp32()
    dims = dict(num_envs=cap["num_envs"], num_obs=cap["dims"]["num_obs"],
                num_actions=cap["dims"]["num_actions"], num_states=cap["dims"]["num_states"])
    ref = learner.follow(c["traffic"]["train_cfg"], dims, cap["seed"], cap["iters"], device)
    out = learner_numbers(cap, ref)
    out.update(env_numbers(cap, c["config"]["task"], S.task_cfg(c), device))
    out["start_gap"] = max(out.pop("start_gap_weights"), out.pop("start_gap_env"))
    if control:
        with precision.lowered(control):
            low = learner.follow(c["traffic"]["train_cfg"], dims, cap["seed"], cap["iters"],
                                 device)
        ctl = learner_numbers(low, ref)
        out["control"] = {k: ctl[k] for k in LEARNER}
    if witness:
        with precision.lowered("split"):
            other = learner.follow(c["traffic"]["train_cfg"], dims, cap["seed"], cap["iters"],
                                   device)
        wit = learner_numbers(other, ref)
        out["witness"] = {k: wit[k] for k in LEARNER}
    return out


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, lines): every number beside its limit; correct when each
    limited number is finite and within its limit."""
    lim = limits.get("limits", {})
    ok, lines = True, []
    for k in ORDER:
        if k not in nums:
            continue
        v = nums[k]
        if k in lim:
            good = math.isfinite(v) and v <= lim[k]
            ok &= good
            lines.append((k, v, lim[k], good))
        else:
            lines.append((k, v, None, True))
    if not lim:
        ok = False
    return ok, lines
