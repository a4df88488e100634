"""One control step of the env (``VecEnv.step_fn``: resets, domain
randomisation, the task's pre- and post-physics, the physics wrapper and
kernel), ms: a span that synchronises at both ends (median)."""
import statistics

LAYER = "Task and env"
UNIT = "ms"
MOVES = "train_env_steps_per_s"


def read(record):
    s = (record.get("spans") or {}).get("bench.env_step")
    return 1e3 * statistics.median(s) if s else None
