"""The minibatches' gradient clip and Adam steps (``PPO._apply_grads``),
host ms an iteration: the program's span ``ppo.adam`` (median over the
unprofiled iterations)."""
from benchmark.harness import program_spans

LAYER = "PPO update"
UNIT = "ms"
MOVES = "train_env_steps_per_s"


def read(record):
    return program_spans.median_ms(record, "ppo.adam")
