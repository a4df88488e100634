"""The rollout (``PPO.rollout``: the policy's forward passes, the action
noise and the env steps) of one iteration, ms: a span that synchronises at
both ends (median over the span iterations)."""
import statistics

LAYER = "Rollout and policy"
UNIT = "ms"
MOVES = "train_env_steps_per_s"


def read(record):
    s = (record.get("spans") or {}).get("bench.rollout")
    return 1e3 * statistics.median(s) if s else None
