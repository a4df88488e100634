"""The port's tracer (``thormang_isaacgym_tpu_torch/utils/trace.py``): the
spans of a training iteration, their self times, the levels, and the table
of ``profile/spans.json``.

On the CPU: nesting and self time on synthetic spans (a scripted clock);
``off`` records nothing; one ``train_iteration`` of an MLP policy (Cartpole)
and of the asymmetric LSTM policy (ShadowHand with ShadowHandPPOAsymmLSTM,
narrowed) gives each span the count its config implies, with the self time
of ``learn.iteration`` under 5 % of its total; ``profile_table`` on
synthetic events charges kernels, device time and idle gaps to the innermost
span. On a card (skipped without one): a span's own stamps lie within 50 us
of the profiler's range of it, ``profile_table`` counts the profiler's
kernels and its idle time, ``fused.launch`` counts ``FusedStep.launches``,
and ``annotate`` adds no synchronising call. This file imports no JAX:
``python -m pytest tests/test_torch_trace.py --noconftest`` runs it on a
card machine."""
import dataclasses
import warnings

import pytest
import torch
from torch.autograd import DeviceType

import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn.ppo import PPO, PPOConfig
from thormang_isaacgym_tpu_torch.utils import trace
from thormang_isaacgym_tpu_torch.utils.config import load_config

ROOT = trace.ROOT


@pytest.fixture
def summary():
    """The process's tracer at ``summary``, put back after the test."""
    prev = trace.set_level("summary")
    yield
    trace.set_level(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def test_nesting_and_self_time(monkeypatch):
    ticks = iter([0, 5, 10, 20, 30, 45, 50, 60, 100, 130])
    monkeypatch.setattr(trace, "clock", lambda: next(ticks))
    tr = trace.Tracer()
    with tr.span("a.b"):                    # 0 .. 5, outside an iteration: kept nowhere
        pass
    with tr.span(ROOT):                     # 10 .. 130
        with tr.span("a.b"):                # 20 .. 50
            with tr.span("c.d"):            # 30 .. 45
                pass
        with tr.span("a.b"):                # 60 .. 100
            pass
    (rec,) = tr.iterations()
    assert (rec.index, rec.profiled, rec.start_ns, rec.end_ns, rec.events) == (0, False, 10,
                                                                               130, None)
    assert rec.spans == {"c.d": [1, 15, 15], "a.b": [2, 70, 55], ROOT: [1, 120, 50]}
    assert rec.count("a.b") == 2 and rec.total_ms("a.b") == 70e-6 and rec.count("e.f") == 0


def test_annotate_keeps_each_span_and_a_profiler_sees_it(summary):
    trace.set_level("annotate")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span(ROOT), trace.span("x.y"):
            pass
    trace.set_level("summary")
    with trace.span(ROOT):
        pass
    profiled, plain = trace.iterations()[-2:]
    assert profiled.profiled and not plain.profiled and plain.events is None
    assert [(n, p) for n, p, _, _ in profiled.events] == [("x.y", ROOT), (ROOT, None)]
    assert plain.index == profiled.index + 1
    ranges = {k[1]: k[2:4] for k in trace.profiler_events(prof) if k[0] == "span"}
    for name, _, start, end in profiled.events:
        assert abs(ranges[name][0] - start) < 1e6 and abs(ranges[name][1] - end) < 1e6


def test_off_records_nothing():
    tr = trace.Tracer("off")
    a, b = tr.span(ROOT), tr.span("x.y")
    assert a is b
    with a, tr.span("x.y"):
        pass
    assert tr.iterations() == [] and tr.names == set()
    with pytest.raises(ValueError):
        tr.set_level("verbose")


def _learner(task: str, argv: list, envs: int, device: str, **narrow):
    """(ppo, env, ts, env_state) of `task` at `envs` envs on `device`, the
    train config's fields in `narrow` replaced."""
    cfg = load_config([f"task={task}", *argv])
    env = tgt.make(task, num_envs=envs, seed=0, cfg=cfg["task"], device=device)
    ppo = PPO(env, dataclasses.replace(PPOConfig.from_rlgames(cfg["train"]), **narrow),
              device=device)
    return ppo, env, ppo.init(0), env.reset(0)


def expected_counts(ppo, env) -> dict:
    """Each span's count in one PPO iteration, from the config."""
    cfg, B = ppo.cfg, env.num_envs
    T = cfg.horizon_length
    if ppo.is_rnn:
        N = T // cfg.seq_len * B
        mb = max(1, min(cfg.minibatch_size, N * cfg.seq_len) // cfg.seq_len)
    else:
        N = T * B
        mb = min(cfg.minibatch_size, N)
    updates = cfg.mini_epochs * (N // mb)
    physics = T * env.task.control_freq_inv
    launched = physics if env.device.type == "cuda" else 0
    return {ROOT: 1, "ppo.rollout": 1, "ppo.policy": T + 1, "ppo.gae": 1, "ppo.batch": 1,
            "ppo.loss": updates, "ppo.backward": updates, "ppo.adam": updates,
            "ppo.reduce": 0, "env.step": T, "env.reset": T, "env.dr": T if env._dr_any else 0,
            "env.noise": 2 * T, "env.pre_physics": T, "env.physics": T, "env.post_physics": T,
            "fused.step": physics, "fused.pack": launched, "fused.launch": launched,
            "fused.unpack": launched}


CASES = {
    "mlp": ("Cartpole", [], 16, dict(units=(16,), minibatch_size=32, mini_epochs=2)),
    "lstm-asymm": ("ShadowHand", ["train=ShadowHandPPOAsymmLSTM",
                                  "task.env.asymmetric_observations=true"], 8,
                   dict(units=(16,), rnn_units=16, horizon_length=4, minibatch_size=16,
                        mini_epochs=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_an_iteration_gives_each_span_its_count(case, summary):
    task, argv, envs, narrow = CASES[case]
    ppo, env, ts, env_state = _learner(task, argv, envs, "cpu", **narrow)
    assert ppo.is_rnn == ppo.asymmetric == (case == "lstm-asymm")
    ppo.train_iteration(ts, env_state)
    rec = trace.iterations()[-1]
    want = expected_counts(ppo, env)
    assert {k: rec.count(k) for k in want} == want
    assert set(rec.spans) == {k for k, n in want.items() if n}
    _, total, own = rec.spans[ROOT]
    assert own < 0.05 * total


def test_profile_table_charges_the_innermost_span():
    ms = 1_000_000
    events = [
        ("span", ROOT, 0, 100 * ms, 0),
        ("span", "ppo.loss", 10 * ms, 40 * ms, 0),
        ("span", "ppo.adam", 50 * ms, 90 * ms, 0),
        ("span", "fused.launch", 60 * ms, 70 * ms, 0),
        ("launch", "cudaLaunchKernel", 15 * ms, 16 * ms, 7),     # in ppo.loss
        ("launch", "cudaLaunchKernel", 61 * ms, 62 * ms, 8),     # in fused.launch
        ("launch", "cudaLaunchKernel", 80 * ms, 81 * ms, 9),     # in ppo.adam
        ("launch", "cudaMemcpyAsync", 5 * ms, 6 * ms, 10),       # in the root alone
        ("kernel", "gemm", 20 * ms, 30 * ms, 7),
        ("kernel", "fused_step_kernel", 62 * ms, 85 * ms, 8),
        ("kernel", "adam", 85 * ms, 95 * ms, 9),
        ("kernel", "orphan", 96 * ms, 97 * ms, 99),              # no launch recorded
        ("device", "Memcpy HtoD", 6 * ms, 8 * ms, 10),
    ]
    t = trace.profile_table(events)
    rows = t["spans"]
    assert t["kernels"] == 4 == sum(r["kernels"] for r in rows.values())
    assert {k: r["kernels"] for k, r in rows.items() if r["kernels"]} == {
        "ppo.loss": 1, "fused.launch": 1, "ppo.adam": 1, trace.OUTSIDE: 1}
    assert rows["ppo.loss"]["device_ms"] == pytest.approx(10)
    assert rows["fused.launch"]["device_ms"] == pytest.approx(23)
    # busy [6, 8], [20, 30], [62, 95], [96, 97] inside [0, 100]; each gap goes whole to
    # the span open at its start: 0-6, 8-20, 95-96 and 97-100 to the root (ppo.loss opens
    # at 10, ppo.adam closes at 90), 30-62 to ppo.loss
    assert rows[ROOT]["idle_ms"] == pytest.approx(6 + 12 + 1 + 3)
    assert rows["ppo.loss"]["idle_ms"] == pytest.approx(32)
    assert t["idle_ms"] == pytest.approx(54) and t["window_ms"] == pytest.approx(100)
    assert rows[ROOT]["host_self_ms"] == pytest.approx(100 - 30 - 40)
    assert rows["ppo.adam"]["host_self_ms"] == pytest.approx(30)
    assert rows["fused.launch"]["host_self_ms"] == pytest.approx(10)


def _kineto(prof):
    return prof.profiler.kineto_results.events()


def test_card_span_stamps_kernels_and_idle_match_the_profiler(cuda, summary):
    """One profiled iteration of Cartpole at 256 envs at ``annotate``."""
    ppo, env, ts, env_state = _learner("Cartpole", [], 256, cuda)
    ts, env_state, _ = ppo.train_iteration(ts, env_state)    # builds and warms
    torch.cuda.synchronize()
    launches = env.physics_step.launches
    trace.set_level("annotate")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ts, env_state, _ = ppo.train_iteration(ts, env_state)
        torch.cuda.synchronize()
    trace.set_level("summary")
    rec = trace.iterations()[-1]
    assert rec.profiled and rec.count("fused.launch") == env.physics_step.launches - launches > 0
    assert {k: rec.count(k) for k in expected_counts(ppo, env)} == expected_counts(ppo, env)
    # the tracer's stamps against the profiler's ranges, span by span in order of start
    ranges = sorted((s, e, n) for kind, n, s, e, _ in trace.profiler_events(prof)
                    if kind == "span")
    own = sorted((s, e, n) for n, _, s, e in rec.events)
    assert [r[2] for r in ranges] == [o[2] for o in own]
    worst = max(max(abs(r[0] - o[0]), abs(r[1] - o[1])) for r, o in zip(ranges, own))
    print(f"largest stamp difference {worst} ns over {len(own)} spans")
    assert worst < 50_000
    # the kernels and the idle time of the table against the profiler's own
    table = trace.profile_table(trace.profiler_events(prof))
    device = [e for e in _kineto(prof) if e.device_type() == DeviceType.CUDA]
    assert not {e.name() for e in device} & trace.TRACER.names   # no copy of a span's range
    kernels = [e for e in device if not e.name().startswith(("Memcpy", "Memset"))]
    print(f"{len(kernels)} kernels, {table['spans']['ppo.adam']['kernels']} of them in ppo.adam")
    assert table["kernels"] == len(kernels) == sum(r["kernels"] for r in table["spans"].values())
    # every kernel found its launch inside the iteration
    assert table["spans"].get(trace.OUTSIDE, {"kernels": 0})["kernels"] == 0
    busy = sorted((e.start_ns(), e.end_ns()) for e in device)
    lo, hi = ranges[0][0], max(r[1] for r in ranges)
    covered, end = 0, lo
    for s, e in busy:
        s, e = max(s, end), min(e, hi)
        if e > s:
            covered += e - s
            end = e
    idle_ms = (hi - lo - covered) * 1e-6
    print(f"idle {table['idle_ms']} ms (profiler {idle_ms}) of {table['window_ms']} ms")
    assert table["idle_ms"] == pytest.approx(idle_ms, rel=0.01)


def test_card_annotate_adds_no_synchronising_call(cuda, summary):
    ppo, env, ts, env_state = _learner("Cartpole", [], 256, cuda)
    ts, env_state, _ = ppo.train_iteration(ts, env_state)
    syncs = {}
    # the first pass under the debug mode meets what torch does once
    for level in ("first", "off", "summary", "annotate"):
        trace.set_level("off" if level == "first" else level)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ts, env_state, _ = ppo.train_iteration(ts, env_state)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs[level] = sorted(f"{w.filename}:{w.lineno}" for w in caught
                              if "synchroniz" in str(w.message))
    print(f"synchronising calls an iteration: {syncs}")
    assert syncs["off"] == syncs["summary"] == syncs["annotate"]
