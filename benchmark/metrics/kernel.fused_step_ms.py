"""The physics kernel's device time a launch, ms: the profiler's device
time of ``fused_step_kernel`` over the profiled iterations divided by its
launches, counted by ``FusedStep.launches`` and checked against the
kernel's events."""
LAYER = "Physics kernel"
UNIT = "ms"
MOVES = "train_env_steps_per_s"


def read(record):
    dev = record.get("device") or {}
    n = dev.get("fused_launches", 0)
    if not n or dev.get("fused_events") != n:
        return None
    return 1e3 * dev["fused_device_s"] / n
