"""The benchmark's frozen counts reproduce the kernel figures the port's
records give (ShadowHand at 16384 envs: 71.8 MB, 4,511 MFLOP a launch;
HumanoidMJCF at 4096: 15.29 MB, 315.0 MFLOP), on models built by the
reference, and the networks' counts follow the dense layers' shapes."""
import pytest
import torch

from benchmark.counts import networks as N
from benchmark.harness import check, spec
from benchmark.reference.port.tasks import make


def _env(cell):
    c = spec.cell(cell)
    return make(c["config"]["task"], num_envs=2, seed=1, cfg=spec.task_cfg(c), device="cpu")


# the records' figures, each within half a unit of its last digit
@pytest.mark.parametrize("cell,envs,mb,mb_tol,mflop,mflop_tol", [
    ("shadowhand-ppo", 16384, 71.8, 0.05, 4511, 0.5),
    ("humanoid-ppo-16k", 4096, 15.29, 0.005, 315.0, 0.05)])
def test_kernel_counts_reproduce_the_records(cell, envs, mb, mb_tol, mflop, mflop_tol):
    env = _env(cell)
    q = env.reset(1).q
    out = check.kernel_counts(env, [q], [torch.zeros(q.shape[0], env.model.nv)], envs, "cpu")
    most, needed = out["most"], out["needed"]
    assert most["bytes"] / 1e6 == pytest.approx(mb, abs=mb_tol)
    assert most["flops"] / 1e6 == pytest.approx(mflop, abs=mflop_tol)
    assert most["bound_by"] == "operations"
    # counting only the candidates in contact never counts more
    assert needed["flops"] <= most["flops"] and needed["bytes"] == most["bytes"]
    assert 0.0 <= out["active"]["ground"] <= 1.0 and 0.0 <= out["active"]["pairs"] <= 1.0


def test_network_counts():
    # ShadowHandPPO: 211 -> 512 -> 512 -> 256 -> 128, mu of 20 and a value
    dense = 2 * (211 * 512 + 512 * 512 + 512 * 256 + 256 * 128) + 2 * 128 * 21
    assert N.policy_flops(211, 20, (512, 512, 256, 128)) == dense
    cfg = dict(units=(512, 512, 256, 128), horizon_length=8, mini_epochs=5,
               mixed_precision=False)
    it = N.iteration_flops(cfg, 16384, 211, 20)
    # the backward skips the observations' gradient through the first layer
    assert it == {"fp32": dense * 16384 * 9 + (3 * dense - 2 * 211 * 512) * 16384 * 8 * 5}
    # an LSTM of 1024 before a 512 MLP: the two gate matrices and the trunk
    lstm = N.policy_flops(211, 20, (512,), rnn_units=1024, before_mlp=True)
    assert lstm == 2 * 4 * 1024 * (211 + 1024) + 2 * 1024 * 512 + 2 * 512 * 21
    assert N.input_grad_flops(211, 20, (512,), rnn_units=1024, before_mlp=True) \
        == 2 * 4 * 1024 * 211
