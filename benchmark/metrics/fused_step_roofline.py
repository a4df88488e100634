"""The physics kernel's share of its roofline: the least time of a launch
(the larger of its needed fp32 operations over 67 TFLOP/s and its bytes
over 3.35 TB/s, ``counts/kernel.py``) over its measured device time a
launch."""
LAYER = "Physics kernel"
UNIT = "%"
MOVES = "train_env_steps_per_s"


def read(record):
    dev, kernel = record.get("device") or {}, record.get("kernel")
    n = dev.get("fused_launches", 0)
    if not kernel or not n or dev.get("fused_events") != n or not dev.get("fused_device_s"):
        return None
    return 100.0 * kernel["needed"]["bound_s"] / (dev["fused_device_s"] / n)
