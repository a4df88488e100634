from benchmark.reference.port.ops.sim import (  # noqa: F401
    Controls, SimParams, build_step_fn, zero_controls,
)
