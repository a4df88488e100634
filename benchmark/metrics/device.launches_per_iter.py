"""CUDA kernels launched in one training iteration, counted from the
profiler (memory copies and sets left out)."""
LAYER = "Device"
UNIT = "launches"
MOVES = "train_env_steps_per_s"


def read(record):
    dev = record.get("device") or {}
    if not dev.get("kernels") or not dev.get("iters"):
        return None
    return dev["kernels"] / dev["iters"]
