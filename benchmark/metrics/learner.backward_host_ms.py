"""The minibatches' backward passes (``PPO.grads``), host ms an iteration:
the program's span ``ppo.backward`` (median over the unprofiled
iterations)."""
from benchmark.harness import program_spans

LAYER = "PPO update"
UNIT = "ms"
MOVES = "train_env_steps_per_s"


def read(record):
    return program_spans.median_ms(record, "ppo.backward")
