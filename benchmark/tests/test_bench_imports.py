"""What the benchmark loads: a run (driven on the CPU at a small size) loads
no module whose top-level name is jax, jaxlib, flax or thormang_isaacgym_tpu,
and the reference loads nothing of the program (thormang_isaacgym_tpu_torch),
its names compared whole."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN = """
import sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {root!r} + "/benchmark")
from benchmark.tests.small import small_cell
from benchmark.harness import cell
code, out = cell.run(small_cell("humanoid-ppo-16k"), 2**31 + 5, 0.2, False, time.time(),
                     device="cpu")
assert code == 0 and out["correct"], (code, out)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REF = """
import sys, torch
sys.path.insert(0, {root!r})
from benchmark.reference import envcheck, learner, precision
from benchmark.reference.port.tasks import make
env = make("HumanoidMJCF", num_envs=2, seed=1, device="cpu")
s = env.step(env.reset(1), torch.zeros(2, env.num_actions))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(code: str) -> set:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(RUN)
    assert "thormang_isaacgym_tpu_torch" in names          # the program ran
    assert not names & {"jax", "jaxlib", "flax", "thormang_isaacgym_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REF)
    assert "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "thormang_isaacgym_tpu",
                        "thormang_isaacgym_tpu_torch"}
