"""A cell cut to a size the CPU runs in seconds, for the tests: the
program's path on the CPU is its plain step, so what the tests drive there
is the harness, the capture, the reference and the judgement."""
import copy

from benchmark.harness import spec


def small_cell(name: str, envs: int = 16, minibatch: int = 32) -> dict:
    c = copy.deepcopy(spec.cell(name))
    c["traffic"]["num_envs"] = envs
    c["traffic"]["sample_envs"] = min(8, envs)
    c["traffic"]["train_cfg"]["params"]["config"]["minibatch_size"] = minibatch
    return c
