"""The device's idle share, %: 1 less the device's busy time of one
iteration (the union of its operations' intervals in the profiled
iterations, over their count) over the wall time of one unprofiled whole
iteration (median).

The profiler's own host work (about 20 us a launch) stretches the
profiled iterations' wall time, by 1.4-2.1x at 18k-74k launches an
iteration, while the device's work stays as it is; so the busy time is
read from the profiled iterations and the wall time from the unprofiled
ones. Not clamped: a busy time over the iteration's wall time is a fault
of the reading and shows as a negative share."""
import statistics

LAYER = "Device"
UNIT = "%"
MOVES = "train_env_steps_per_s"


def read(record):
    dev, iters = record.get("device") or {}, record.get("iter_s")
    if not dev.get("busy_s") or not dev.get("iters") or not iters:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["iters"] / statistics.median(iters))
