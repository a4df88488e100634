"""One call of the physics wrapper (``FusedStep``: pack, launch, unpack),
host ms: the program's span ``fused.step`` over its count (median over the
unprofiled iterations)."""
from benchmark.harness import program_spans

LAYER = "Physics wrapper"
UNIT = "ms"
MOVES = "train_env_steps_per_s"


def read(record):
    return program_spans.median_ms(record, "fused.step", per_span=True)
