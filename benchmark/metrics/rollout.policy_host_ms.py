"""The policy at each rollout step and the last value (normalise, forward,
sample), host ms an iteration: the program's span ``ppo.policy`` (median
over the unprofiled iterations)."""
from benchmark.harness import program_spans

LAYER = "Rollout and policy"
UNIT = "ms"
MOVES = "train_env_steps_per_s"


def read(record):
    return program_spans.median_ms(record, "ppo.policy")
