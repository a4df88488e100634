"""GAE, the normalisers and the minibatch updates of one iteration, ms: the
synchronised iteration span less the rollout span of the same iteration
(median over the span iterations)."""
import statistics

LAYER = "PPO update"
UNIT = "ms"
MOVES = "train_env_steps_per_s"


def read(record):
    spans = record.get("spans") or {}
    it, ro = spans.get("bench.iteration"), spans.get("bench.rollout")
    if not it or not ro or len(it) != len(ro):
        return None
    return 1e3 * statistics.median(a - b for a, b in zip(it, ro))
