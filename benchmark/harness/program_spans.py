"""The program's own spans in a ``--trace 1`` run: the one benchmark file
that reads the port's tracer (``thormang_isaacgym_tpu_torch/utils/trace.py``).

The tracer keeps a record of each ``train_iteration`` (the last 1,024): each
span name's count and host time. A traced run's iterations after set-up come
in this order: the unprofiled ones (``len(record["iter_s"])``,
``trace.timed``), the span iterations (``len(record["spans"]["bench.
iteration"])``), the profiled ones (``record["device"]["iters"]``) and the
one iteration after the window (``cell.reset_iteration``). The readers take
the unprofiled ones, whose place is checked by the records' ``profiled``
flags: set on exactly the profiled iterations. A mismatch, a deque too short
or a program without the tracer reads nothing (None)."""
from __future__ import annotations

import statistics


def timed(record: dict):
    """The tracer's records of the run's unprofiled iterations, or None."""
    n_timed = len(record.get("iter_s") or ())
    n_spans = len((record.get("spans") or {}).get("bench.iteration") or ())
    n_prof = int((record.get("device") or {}).get("iters") or 0)
    if not n_timed or not n_spans or not n_prof:
        return None
    try:
        from thormang_isaacgym_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = trace.iterations()[-(n_timed + n_spans + n_prof + 1):]
    expect = [False] * (n_timed + n_spans) + [True] * n_prof + [False]
    if [r.profiled for r in recs] != expect or any(
            b.index != a.index + 1 for a, b in zip(recs, recs[1:])):
        return None
    return recs[:n_timed]


def median_ms(record: dict, name: str, per_span: bool = False):
    """The median over the unprofiled iterations of the host ms of the
    span `name` an iteration, or (`per_span`) a span; None where there is
    none."""
    recs = timed(record)
    if not recs or not all(r.count(name) for r in recs):
        return None
    return statistics.median(r.total_ms(name) / (r.count(name) if per_span else 1)
                             for r in recs)
