from thormang_isaacgym_tpu_torch.ops.sim import (  # noqa: F401
    Controls, SimParams, build_step_fn, zero_controls,
)
