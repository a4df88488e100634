"""The traced part of a ``--trace 1`` run, in iterations of its own:

1. unprofiled whole iterations, timed by the host clock between
   synchronisations (the iteration time ``step_mfu`` divides by);
2. iterations with synchronising spans around the rollout, each env step
   and the whole iteration (``rollout.ms``, ``env.step_ms``,
   ``learner.update_ms``);
3. iterations under ``torch.profiler`` with host labels around the same
   calls, from which the device's kernels are read: the fused kernel's
   device time and launches, every kernel's launches, the union of the
   device's busy intervals, the longest idle gaps and what the host was
   doing in each.

The spans are the benchmark's own, wrapped around calls on the instances;
nothing of the program is edited."""
from __future__ import annotations

import collections
import time

import torch

KERNEL = "fused_step_kernel"
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def _sync():
    torch.cuda.synchronize()


class _Wrap:
    """Instance wrappers of the rollout and the env step, removed on exit."""

    def __init__(self, ppo, env, around):
        self.ppo, self.env, self.around = ppo, env, around
        self.roll_name = "rollout_rnn" if ppo.is_rnn else "rollout"

    def __enter__(self):
        roll, step = getattr(self.ppo, self.roll_name), self.env.step_fn
        around = self.around

        def rollout(*a):
            with around("bench.rollout"):
                return roll(*a)

        def env_step(*a):
            with around("bench.env_step"):
                return step(*a)

        self.ppo.__dict__[self.roll_name] = rollout
        self.env.step_fn = env_step
        return self

    def __exit__(self, *exc):
        del self.ppo.__dict__[self.roll_name]
        del self.env.__dict__["step_fn"]


def timed(ppo, ts, env_state, seconds: float, min_iters: int = 2):
    """Unprofiled whole iterations for `seconds` (at least `min_iters`):
    (ts, env_state, seconds of each)."""
    out = []
    t_end = time.perf_counter() + seconds
    while len(out) < min_iters or time.perf_counter() < t_end:
        _sync()
        t0 = time.perf_counter()
        ts, env_state, _ = ppo.train_iteration(ts, env_state)
        _sync()
        out.append(time.perf_counter() - t0)
    return ts, env_state, out


def spans(ppo, env, ts, env_state, seconds: float, min_iters: int = 2):
    """Iterations with synchronising spans: (ts, env_state, {span: [s]})."""
    rec = collections.defaultdict(list)

    class around:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            _sync()
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            _sync()
            rec[self.name].append(time.perf_counter() - self.t0)

    t_end = time.perf_counter() + seconds
    n = 0
    with _Wrap(ppo, env, around):
        while n < min_iters or time.perf_counter() < t_end:
            with around("bench.iteration"):
                ts, env_state, _ = ppo.train_iteration(ts, env_state)
            n += 1
    return ts, env_state, dict(rec)


def profiled(ppo, env, fused_step, ts, env_state, iters: int):
    """`iters` iterations under the profiler: (ts, env_state, record)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    launches0 = fused_step.launches if fused_step is not None else 0
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _sync()
    with profile(activities=acts) as prof:
        with _Wrap(ppo, env, record_function):
            _sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                with record_function("bench.iteration"):
                    ts, env_state, _ = ppo.train_iteration(ts, env_state)
            _sync()
            window_s = time.perf_counter() - t0
    launches = (fused_step.launches - launches0) if fused_step is not None else 0
    return ts, env_state, reduce_events(raw_events(prof), iters, window_s, launches)


def raw_events(prof):
    """(name, is_device, start_us, end_us) of every traced event, read from
    the profiler's raw results (building its FunctionEvents for tens of
    thousands of kernels takes longer than the run)."""
    from torch.autograd import DeviceType

    out = []
    try:
        events = prof.profiler.kineto_results.events()
        events[0].end_ns() if events else None
    except AttributeError:
        return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == DeviceType.CUDA or e.name.startswith("bench.")]
    for e in events:
        dt = e.device_type()
        if dt == DeviceType.CUDA or e.name().startswith("bench."):
            out.append((e.name(), dt == DeviceType.CUDA, e.start_ns() * 1e-3, e.end_ns() * 1e-3))
    return out


def _union(iv):
    """Merged [start, end) intervals of `iv`, sorted."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events, iters: int, window_s: float, launches: int) -> dict:
    """The profiler's events (``raw_events``) as the record's device part
    (times in s)."""
    dev, host = [], []
    for name, is_dev, s, e in events:
        if is_dev and name.startswith("bench."):
            continue    # the host labels' copies on the device's timeline
        (dev if is_dev else host).append((name, s, e))
    if not dev:
        return dict(device_events=0, iters=iters, window_s=window_s)
    it = [h for h in host if h[0] == "bench.iteration"]
    lo = min(h[1] for h in it) if it else min(d[1] for d in dev)
    hi = max(h[2] for h in it) if it else max(d[2] for d in dev)
    merged = _union([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in merged)
    by_name = collections.Counter()
    for n, s, e in dev:
        by_name[n] += (e - s) * 1e-6
    kern = [(s, e) for n, s, e in dev if KERNEL in n]
    n_kernels = sum(1 for n, _, _ in dev if not n.startswith(NOT_KERNELS))
    # the idle gaps between busy intervals inside the traced iterations,
    # each named by the innermost benchmark span the host was in at its start
    gaps = []
    prev = lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    depth = {"bench.env_step": 3, "bench.rollout": 2, "bench.iteration": 1}

    def label(t):
        best = ("bench.loop", 0)
        for n, s, e in host:
            if s <= t < e and depth.get(n, 0) > best[1]:
                best = (n, depth.get(n, 0))
        name = best[0]
        return "bench.update" if name == "bench.iteration" else name

    gaps.sort(key=lambda g: g[0] - g[1])
    top_gaps = [[label(s), (e - s) * 1e-6] for s, e in gaps[:10]]
    idle_by = collections.Counter()
    for s, e in gaps:
        if e - s > 0:
            idle_by[label(s)] += (e - s) * 1e-6
    return dict(
        device_events=len(dev), iters=iters, window_s=window_s,
        trace_span_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6,
        kernels=n_kernels, fused_events=len(kern),
        fused_device_s=sum(e - s for s, e in kern) * 1e-6, fused_launches=launches,
        device_ops=[[n, s] for n, s in by_name.most_common(10)],
        idle_gaps=top_gaps, idle_by_span=dict(idle_by))
