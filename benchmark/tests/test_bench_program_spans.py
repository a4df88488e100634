"""The program's own spans, read by ``harness/program_spans.py``: a
``--trace 1`` run on the CPU at a small size reports the six metrics that
read them, and ``timed`` reads nothing where the records' ``profiled`` flags
are not where a traced run's order puts them (the look for a card and the
traced part's synchronisations skipped: the CPU has no card)."""
import time

import pytest
import torch

from benchmark.harness import cell, program_spans
from benchmark.harness import trace as bench_trace
from benchmark.tests.small import small_cell
from thormang_isaacgym_tpu_torch.utils import trace

METRICS = ("rollout.policy_host_ms", "env.step_host_ms", "env.wrapper_host_ms",
           "learner.loss_host_ms", "learner.backward_host_ms", "learner.adam_host_ms")


def test_a_traced_run_reports_the_program_spans(monkeypatch):
    monkeypatch.setattr(bench_trace, "_sync", lambda: None)
    code, out = cell.run(small_cell("shadowhand-ppo"), 2**31 + 29, 0.2, True, time.time(),
                         device="cpu")
    assert code == 0 and out["correct"]
    for m in METRICS:
        assert out["metrics"][m]["value"] > 0, m


def _iterations(profiled: list):
    """One tracer record for each flag of `profiled`, its iteration run
    under the profiler where the flag is set."""
    for p in profiled:
        if p:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                with trace.span(trace.ROOT), trace.span("ppo.adam"):
                    pass
        else:
            with trace.span(trace.ROOT), trace.span("ppo.adam"):
                pass


RECORD = dict(iter_s=[0.1, 0.1, 0.1], spans={"bench.iteration": [0.1, 0.1]},
              device=dict(iters=2))


@pytest.mark.parametrize("profiled, found", [
    ([False] * 5 + [True] * 2 + [False], True),        # as a traced run orders them
    ([False] * 4 + [True] * 2 + [False] * 2, False),   # one iteration more after the window
    ([False] * 5 + [True] * 3 + [False], False),       # a profiled one more
    ([False] * 6 + [True] * 2, False),                 # no iteration after the window
])
def test_timed_reads_only_the_unprofiled_iterations(profiled, found):
    prev = trace.set_level("summary")
    try:
        _iterations(profiled)
    finally:
        trace.set_level(prev)
    recs = program_spans.timed(RECORD)
    if found:
        last = trace.iterations()[-1].index
        assert [r.index for r in recs] == [last - 7, last - 6, last - 5]
        assert program_spans.median_ms(RECORD, "ppo.adam") >= 0.0
        assert program_spans.median_ms(RECORD, "ppo.loss") is None
    else:
        assert recs is None and program_spans.median_ms(RECORD, "ppo.adam") is None


def test_timed_reads_nothing_from_a_short_deque(monkeypatch):
    monkeypatch.setattr(trace.TRACER, "records", type(trace.TRACER.records)(maxlen=4))
    _iterations([False] * 5 + [True] * 2 + [False])
    assert program_spans.timed(RECORD) is None
