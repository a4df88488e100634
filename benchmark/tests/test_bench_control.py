"""The control, on the card: the reference in the precision one step below
the cell's (TF32 for the hand jobs' float32 learners) fails the cell's
limits where the program does not, at 4096 envs (the benchmark runs 16384;
``control.py`` reads the control at that size). On the CPU: the witness of
sound arithmetic in another order is the same product."""
import copy

import pytest

from benchmark import control
from benchmark.harness import check, spec


@pytest.mark.card
@pytest.mark.parametrize("name", ["shadowhand-ppo", "shadowhand-lstm-asymm"])
def test_control_fails_the_limits(card, name):
    c = copy.deepcopy(spec.cell(name))
    c["traffic"]["num_envs"] = 4096
    conf = c["traffic"]["train_cfg"]["params"]["config"]
    conf["minibatch_size"] = conf["minibatch_size"] * 4096 // 16384
    r = control.reading(c, 2**31 + 23, card, None, control.control_kind(c))
    ok, _ = check.judge(r, c["limits"])
    assert ok, r
    low, _ = check.judge(dict(r, **r["control"]), c["limits"])
    assert not low, r["control"]


def test_split_witness_is_the_same_product_in_another_order():
    import torch

    from benchmark.reference import precision

    g = torch.Generator().manual_seed(3)
    x, w, b = (torch.randn(64, 211, generator=g), torch.randn(512, 211, generator=g),
               torch.randn(512, generator=g))
    plain = torch.nn.functional.linear(x, w, b)
    with precision.lowered("split"):
        split = torch.nn.functional.linear(x, w, b)
    assert torch.nn.functional.linear(x, w, b).equal(plain)   # restored on the way out
    assert torch.allclose(split, plain, rtol=1e-5, atol=1e-4) and not split.equal(plain)
