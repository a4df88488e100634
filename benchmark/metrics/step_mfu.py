"""The whole training iteration's share of the card's peak: the counted
operations of an iteration, each part at the peak of the precision it runs
in (the networks' forward and backward passes, ``counts/networks.py``; the
physics kernel's fp32 operations that these inputs need,
``counts/kernel.py``), as the least time they could take, over the wall
time of an unprofiled whole iteration (median)."""
import statistics

LAYER = "Training iteration"
UNIT = "%"
MOVES = "train_env_steps_per_s"


def read(record):
    counts, kernel, iters = record.get("counts"), record.get("kernel"), record.get("iter_s")
    if not counts or not kernel or not iters:
        return None
    peaks = counts["peaks"]
    least = sum(f / peaks[p] for p, f in counts["net_flops"].items())
    least += kernel["needed"]["flops"] * record["launches_per_iter"] / counts["kernel_peak"]
    return 100.0 * least / statistics.median(iters)
