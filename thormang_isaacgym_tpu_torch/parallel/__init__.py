from thormang_isaacgym_tpu_torch.parallel.mesh import ENV_AXIS, make_mesh, shard_ppo  # noqa: F401
