"""One control step of the env (``VecEnv.step_fn``), host ms: the program's
span ``env.step`` over its count (median over the unprofiled iterations)."""
from benchmark.harness import program_spans

LAYER = "Task and env"
UNIT = "ms"
MOVES = "train_env_steps_per_s"


def read(record):
    return program_spans.median_ms(record, "env.step", per_span=True)
