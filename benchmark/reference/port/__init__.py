"""benchmark.reference.port — the PyTorch/CUDA port of thormang_isaacgym_tpu.

The same robotics-RL framework (URDF assets -> batched articulated model,
Featherstone dynamics + joint drives + ground contact, vectorized tasks, PPO)
on PyTorch, with the physics step in one hand-written CUDA kernel for NVIDIA
Hopper (``csrc/fused_step.cu``). Entry points run on CUDA unless the caller
passes ``device="cpu"``:

    import benchmark.reference.port as tgt
    env = tgt.make("Ant", num_envs=4096, seed=42)
"""

__version__ = "0.1.0"


def make(task_name: str, num_envs: int | None = None, seed: int = 42, **overrides):
    """Create a task environment by registry name (see tasks.make)."""
    from benchmark.reference.port.tasks import make as _make

    return _make(task_name, num_envs=num_envs, seed=seed, **overrides)
