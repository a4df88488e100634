"""One run of one cell: set-up, the measured window, the reference check,
and the result line.

Set-up builds the env and the PPO learner as the port's training CLI does,
initialises them from the seed, and drives the first iterations through
``PPO.train_iteration`` while ``program.Capture`` keeps what the reference
needs; one more iteration then runs without the capture. The window starts
at a synchronisation and runs whole iterations, with ``PPO.train``'s metric
read every ``log_every`` iterations, until ``--seconds`` have passed, and
ends at the synchronisation after the last. After the window the program
is freed and the reference follows the captured iterations."""
from __future__ import annotations

import gc
import math
import sys
import time

import torch

from benchmark.harness import check, program, spec, trace

FOLLOWED = 3        # iterations the reference follows
LOG_EVERY = 10      # PPO.train's default metric cadence
FORBIDDEN = ("jax", "jaxlib", "flax", "thormang_isaacgym_tpu")
GIB = float(1 << 30)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def setup(c: dict, seed: int, device: str, fault: str | None = None):
    """(env, ppo, ts, env_state, record): built, followed iterations run and
    captured, one more iteration run."""
    from benchmark.harness import faults

    tcfg = spec.task_cfg(c)
    env, ppo, _ = program.build(c, tcfg, seed, device)
    if fault:
        faults.plant(fault, env, ppo)
    B = env.num_envs
    idx = check.sample_ids(seed, B, int(c["traffic"].get("sample_envs", 256)))
    steps = FOLLOWED * ppo.cfg.horizon_length
    checked = check.sample_steps(seed, steps, int(c["traffic"].get("env_steps_checked", steps)))
    cap = program.Capture(env, ppo, idx.to(device), checked, seed)
    ts = ppo.init(seed)
    cap.params0 = cap.params(ts)
    env_state = env.reset(seed)
    cap.reset_rows = program.to_plain(env_state, cap.idx, B)
    cap.install()
    try:
        for _ in range(FOLLOWED):
            ts, env_state, metrics = ppo.train_iteration(ts, env_state)
    finally:
        cap.remove()
    cap.params3 = cap.params(ts)
    rec = cap.record(seed, B)
    rec["dims"] = dict(num_obs=env.num_obs, num_actions=env.num_actions,
                       num_states=ppo.num_states)
    rec["first_metrics"] = {k: float(v) for k, v in metrics.items()}
    del cap
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ts, env_state, _ = ppo.train_iteration(ts, env_state)
    return env, ppo, ts, env_state, rec


def reset_iteration(env, ppo, ts, env_state, rec: dict):
    """One more iteration, after the window: the envs its masked resets
    restart join the record for the reference (``program.ResetCapture``)."""
    with program.ResetCapture(env, rec["seed"]) as rows:
        ts, env_state, _ = ppo.train_iteration(ts, env_state)
    rec["reset_steps"] = rec["reset_steps"] + rows.steps
    log(f"reset rows: {len(rec['reset_steps'])} env steps with envs the masked reset restarts")
    return ts, env_state


def _read_metrics(env_state, metrics) -> dict:
    """PPO.train's row: the iteration's metrics and the env metrics' means."""
    row = {k: float(v) for k, v in metrics.items()}
    for k, v in (env_state.metrics or {}).items():
        row[f"env/{k}"] = float(v.float().mean())
    return row


def window(ppo, ts, env_state, seconds: float, epoch0: int, device: str = "cuda"):
    """The measured window: (ts, env_state, iterations, seconds, failed)."""
    n, failed = 0, 0
    _sync(device)
    t0, cpu0 = time.perf_counter(), time.process_time()
    marks = []
    while True:
        ts, env_state, metrics = ppo.train_iteration(ts, env_state)
        n += 1
        marks.append(time.perf_counter())
        if (epoch0 + n - 1) % LOG_EVERY == 0:
            row = _read_metrics(env_state, metrics)
            failed += not all(math.isfinite(v) for v in row.values())
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    gaps = sorted(b - a for a, b in zip([t0] + marks[:-1], marks))
    if gaps:
        log("window iteration host seconds: min %.4f median %.4f max %.4f; process CPU "
            "seconds a wall second %.3f" % (gaps[0], gaps[len(gaps) // 2], gaps[-1],
                                           (time.process_time() - cpu0) / (marks[-1] - t0)))
    return ts, env_state, n, time.perf_counter() - t0, failed


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: str):
    if device == "cuda":
        torch.cuda.synchronize()


def run(c: dict, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", fault: str | None = None):
    """One run of the cell `c`: (exit code, result or None). The benchmark
    runs on "cuda"; the tests drive the rest of a run on "cpu" at a small
    size, where the window measures nothing of the card."""
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < c["chips"]):
        log(f"this cell needs {c['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2, None
    # one process with one intra-op thread: the host launches the work
    torch.set_num_threads(1)
    env, ppo, ts, env_state, rec = setup(c, seed, device, fault)
    fused_step = getattr(env, "physics_step", None)
    if not hasattr(fused_step, "launches"):
        fused_step = None
    B, T = env.num_envs, ppo.cfg.horizon_length
    _sync(device)
    setup_s = time.time() - t_start
    log(f"setup_s {setup_s:.4f}  (followed {FOLLOWED} + 1 iterations)")
    epoch0 = FOLLOWED + 1
    # set-up's objects out of the collector's way: a full collection in the
    # window then walks only what the window made
    gc.collect()
    gc.freeze()
    result_metrics, dev_extra, breakdown, record = {}, {}, None, None
    if not traced:
        ts, env_state, n, window_s, failed = window(ppo, ts, env_state, seconds, epoch0, device)
        attempted = n
    else:
        ts, env_state, record, n, failed = traced_part(c, env, ppo, fused_step, ts, env_state,
                                                       seconds)
        attempted = n
        window_s = record["window_s"]
        dev = record["device"]
        dev_extra = dict(busy_s=dev.get("busy_s", 0.0), window_s=dev["window_s"])
        breakdown = dict(device_ops=dev.get("device_ops", []), idle_gaps=dev.get("idle_gaps", []))
    free, total = torch.cuda.mem_get_info() if device == "cuda" else (0, 0)
    used = total - free
    max_alloc = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    reserved = torch.cuda.memory_reserved() if device == "cuda" else 0
    log(f"max_memory_allocated {max_alloc}  memory_reserved {reserved}  "
        f"mem_get_info used {used} of {total}")
    ts, env_state = reset_iteration(env, ppo, ts, env_state, rec)
    if not traced:
        steps = n * B * T
        result_metrics = dict(
            train_env_steps_per_s=dict(value=steps / window_s, unit="steps/s"),
            peak_mem_gib=dict(value=used / GIB, unit="GiB"),
            setup_s=dict(value=setup_s, unit="s"))
        log(f"window {window_s:.4f} s, {n} iterations, {steps} env steps")
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    device_info = dict(platform="gpu" if device == "cuda" else "cpu", kind=kind, count=1,
                       memory_peak_bytes=int(used), **dev_extra)
    # the program's state goes before the reference runs
    del env, ppo, ts, env_state, fused_step
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = check.numbers(rec, c, device)
    log(f"reference {time.perf_counter() - t_ref:.1f} s; reset rows compared {nums['reset_rows']} "
        f"({nums['reset_steps']} env steps after the window's iteration or the sample's)")
    if traced:
        record["kernel"] = kc = nums["kernel_counts"]
        log("kernel a launch: every candidate %.6g flop; in contact %.6g flop (ground %.4f, "
            "pairs %.4f of the candidates); %.6g bytes; bound %.6g s by %s" % (
                kc["most"]["flops"], kc["needed"]["flops"], kc["active"]["ground"],
                kc["active"]["pairs"], kc["needed"]["bytes"], kc["needed"]["bound_s"],
                kc["needed"]["bound_by"]))
        dev = record["device"]
        if dev.get("busy_s") and dev.get("iters"):
            log("device busy %.6f s an iteration (profiled %.6f s an iteration); unprofiled "
                "iteration median %.6f s" % (dev["busy_s"] / dev["iters"],
                                             dev["window_s"] / dev["iters"],
                                             sorted(record["iter_s"])[len(record["iter_s"]) // 2]))
        result_metrics = per_layer(c, record)
    correct, lines = check.judge(nums, c["limits"])
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules this benchmark may not load: {bad}")
        return 3, None
    checks = {k: dict(value=v, limit=lim) for k, v, lim, _ in lines}
    for k, v, lim, good in lines:
        log(f"check {k} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}")
    out = dict(correct=bool(correct), attempted=int(attempted), failed=int(failed),
               metrics=result_metrics, device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return 0, out


def traced_part(c, env, ppo, fused_step, ts, env_state, seconds: float):
    """The ``--trace 1`` window: unprofiled iterations, span iterations and
    profiled iterations, each in its own share of `seconds`."""
    tr = c["traffic"]
    t0 = time.perf_counter()
    ts, env_state, iter_s = trace.timed(ppo, ts, env_state, 0.4 * seconds)
    ts, env_state, spans = trace.spans(ppo, env, ts, env_state, 0.3 * seconds)
    ts, env_state, dev = trace.profiled(ppo, env, fused_step, ts, env_state,
                                        int(tr.get("profile_iters", 2)))
    n = len(iter_s) + len(spans["bench.iteration"]) + dev["iters"]
    B, T = env.num_envs, ppo.cfg.horizon_length
    record = dict(iter_s=iter_s, spans=spans, device=dev, window_s=time.perf_counter() - t0,
                  steps_per_iter=B * T, launches_per_iter=T * env.task.control_freq_inv,
                  counts=counts(c, env, ppo))
    return ts, env_state, record, n, 0


def counts(c, env, ppo) -> dict:
    """The operations of an iteration (networks by precision, kernel
    launches) from the benchmark's own counts, on the reference's model."""
    from benchmark.counts import kernel as K
    from benchmark.counts import networks as N
    import dataclasses

    cfg = dataclasses.asdict(ppo.cfg)
    net = N.iteration_flops(cfg, env.num_envs, env.num_obs, env.num_actions, ppo.num_states)
    return dict(net_flops=net, peaks=dict(N.PEAK_FLOP_PER_S), kernel_peak=K.FP32_FLOP_PER_S)


def per_layer(c: dict, record: dict) -> dict:
    """Each per-layer metric of the cell, read by its own reader; a reader
    that finds nothing leaves its metric out."""
    out = {}
    for m in c["per_layer"]:
        mod = spec.metric_reader(m["name"])
        v = mod.read(record)
        if v is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = dict(value=float(v), unit=m["unit"])
    mfu, idle = out.get("step_mfu"), out.get("device.idle_pct")
    if mfu and idle and mfu["value"] > 100.0 - idle["value"]:
        log(f"WARNING step_mfu {mfu['value']} exceeds the busy share "
            f"{100.0 - idle['value']}: the counts or the idle source are wrong")
    return out
