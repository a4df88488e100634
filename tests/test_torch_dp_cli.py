"""The training CLI run data parallel: two processes over gloo on the CPU
(``multi_host=true`` with the JAX CLI's keys), Cartpole at 64 envs in all,
2 iterations. Both exit 0; rank 0 alone writes the run directory (its
metrics count the run's global env steps); the replicas agree at each
logging epoch (``check_replicas`` raises otherwise), and rank 0's last
checkpoint holds finite weights."""
import json
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_cli_two_ranks_rank0_writes(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env.pop("RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "thormang_isaacgym_tpu_torch.runtime.train", "task=Cartpole",
         "num_envs=64", "max_iterations=2", "device=cpu", "train.params.network.mlp.units=[32,32]",
         "multi_host=true", f"coordinator={coord}", "num_processes=2", f"process_id={r}",
         f"output_root={tmp_path / f'r{r}'}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True, cwd=ROOT)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"data parallel: rank {r}/2 on cpu over gloo" in out
    assert not (tmp_path / "r1").exists()
    run = tmp_path / "r0" / "Cartpole"
    assert {p.name for p in run.iterdir()} >= {"config.yaml", "metrics.jsonl", "nn", "summaries"}
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    horizon = 16                                   # cfg/train/CartpolePPO.yaml
    assert [r["env_steps"] for r in rows] == [horizon * 64, 2 * horizon * 64]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    with np.load(run / "nn" / "last.ckpt") as z:
        assert all(np.isfinite(z[k]).all() for k in z.files if k.startswith("model/"))
