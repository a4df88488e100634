"""Data-parallel training of the port (parallel/, PPO.reduce) against the JAX
package's semantics, with two gloo processes on the CPU as
tests/test_multihost.py runs JAX's.

- The learner: one ``train_iteration`` (one minibatch of each rank's whole
  batch, two mini-epochs, so the update does not depend on the permutation)
  on fixed halves of a batch, on stand-in envs. The reference is JAX's own
  ``train_iteration`` built with ``axis_name`` and mapped over the two
  halves with ``jax.vmap(..., axis_name=...)``: its ``pmean`` of the
  gradients and losses, its rank-local normalisers and advantage
  normalisation, its lr adapted on the averaged KL. Each rank's losses, KL,
  lr, normalisers and parameters must match JAX's half (atol = rtol = 1e-5,
  parameters 1e-4, tests/test_torch_ppo.py's gradient tolerance), and the
  two ranks' parameters must be equal bit for bit. Cases: the MLP (obs and
  value normalisation), the LSTM with an asymmetric critic, and AMPPPO (its
  ring one repeated row and its demo windows fixed, so no draw matters).
- A rank's reset equals its rows of a single process's reset of all the
  envs (Ant, 2 x 4 envs), bit for bit.
- ``MultiTaskPPO(mesh=group)`` runs one iteration over Cartpole and Ant and
  leaves the ranks' parameters equal.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from collections import namedtuple
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from thormang_isaacgym_tpu.learn import amp as jamp
from thormang_isaacgym_tpu.learn import ppo as jppo
from thormang_isaacgym_tpu.learn.normalize import rms_update as jrms_update
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn import amp as tamp
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.runtime.checkpoint import save_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
PTOL = dict(atol=1e-4, rtol=1e-4)
AXIS = "env"
WORLD = 2
T, BL = 8, 6                 # horizon, envs per rank

# the JAX env state the stubbed rollouts return, carried through vmap
End = namedtuple("End", "obs states done last_episode_return")

_WORKER = r"""
import json, os, sys
from types import SimpleNamespace
import numpy as np
import torch
import torch.distributed as dist

from thormang_isaacgym_tpu_torch.learn import amp as tamp
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.parallel.distributed import maybe_initialize
from thormang_isaacgym_tpu_torch.parallel.mesh import make_mesh, shard_ppo, flat_parameters
from thormang_isaacgym_tpu_torch.runtime.checkpoint import load_train_state

work, coord, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
info = maybe_initialize(dict(multi_host=True, coordinator=coord, num_processes=2,
                             process_id=rank, device="cpu"))
assert info["initialized"] and info["backend"] == "gloo" and info["num_processes"] == 2
group = make_mesh()
torch.set_num_threads(1)


def t(x):
    return torch.as_tensor(np.array(x))


def learner(case):
    spec = json.load(open(os.path.join(work, case + ".json")))
    data = dict(np.load(os.path.join(work, f"{case}_r{rank}.npz")))
    kw = spec["cfg"]
    kw["units"] = tuple(kw["units"])
    task = SimpleNamespace(num_states=spec["n_states"], num_agents=1)
    if spec["amp"]:
        demo = t(data.pop("demo"))
        task.num_amp_obs = demo.shape[1]
        task.fetch_amp_obs_demo = lambda gen, n: demo[:n]
        kw["disc_units"] = tuple(kw["disc_units"])
        ppo = tamp.AMPPPO(SimpleNamespace(num_obs=spec["n_obs"], num_actions=spec["n_act"],
                                          num_envs=spec["B"], task=task, device="cpu"),
                          tamp.AMPConfig(**kw), device="cpu")
    else:
        ppo = tppo.PPO(SimpleNamespace(num_obs=spec["n_obs"], num_actions=spec["n_act"],
                                       num_envs=spec["B"], task=task, device="cpu"),
                       tppo.PPOConfig(**kw), device="cpu")
    train_iter, _ = shard_ppo(ppo, group)
    ts = load_train_state(os.path.join(work, case + ".ckpt"), ppo)
    end = SimpleNamespace(obs=t(data.pop("end_obs")), done=t(data.pop("end_done")),
                          last_episode_return=t(data.pop("end_ret")),
                          states=t(data.pop("end_states")) if "end_states" in data else None)
    last = t(data.pop("last")) if "last" in data else None
    traj = {k: t(v) for k, v in data.items()}
    if ppo.is_rnn:
        ppo.rollout_rnn = lambda ts_, es: (end, traj, last)
    else:
        ppo.rollout = lambda ts_, es: (end, traj)
    ts, _, m = train_iter(ts, end)
    out = {f"m_{k}": v.numpy() for k, v in m.items()}
    out["params"] = flat_parameters(ts).numpy()
    for r in ("obs_rms", "value_rms", "states_rms") + (("amp_rms",) if spec["amp"] else ()):
        for f in ("mean", "var", "count"):
            out[f"{r}_{f}"] = getattr(getattr(ts, r), f).numpy()
    if spec["amp"]:
        out["replay"] = ts.replay.numpy()
    np.savez(os.path.join(work, f"{case}_out_r{rank}.npz"), **out)


def reset():
    import thormang_isaacgym_tpu_torch as tgt
    env = tgt.make("Ant", num_envs=4, seed=3, device="cpu")
    ppo = tppo.PPO(env, tppo.PPOConfig(units=(16,), mixed_precision=False), device="cpu")
    _, init_fn = shard_ppo(ppo, group)
    ts, es = init_fn(5)
    np.savez(os.path.join(work, f"reset_out_r{rank}.npz"), q=es.q.numpy(), qd=es.qd.numpy(),
             obs=es.obs.numpy(), gen=ts.gen.get_state().numpy(),
             params=flat_parameters(ts).numpy())


def multitask():
    import thormang_isaacgym_tpu_torch as tgt
    from thormang_isaacgym_tpu_torch.learn.multitask import MultiTaskPPO
    cfg = tppo.PPOConfig(units=(16,), horizon_length=4, minibatch_size=16, mini_epochs=1,
                         mixed_precision=False)
    names = ("Cartpole", "Ant")
    mt = MultiTaskPPO({n: tgt.make(n, num_envs=4, seed=0, device="cpu") for n in names},
                      {n: cfg for n in names}, mesh=group, device="cpu")
    tss, ess = mt.init(7)
    tss, ess, mets = mt.train_iteration(tss, ess)
    np.savez(os.path.join(work, f"multitask_out_r{rank}.npz"),
             **{n: flat_parameters(tss[n]).numpy() for n in names},
             **{f"{n}_kl": mets[n]["kl"].numpy() for n in names},
             **{f"{n}_id0": np.int64(mt.algos[n].env.env_id0) for n in names})


for case in sys.argv[4:]:
    {"reset": reset, "multitask": multitask}.get(case, lambda: learner(case))()
dist.barrier()
dist.destroy_process_group()
print("WORKER_OK", rank)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_workers(work, cases):
    """The WORLD worker processes of `cases`, started (``_finish_workers``
    waits for them)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    env.pop("RANK", None)
    return [subprocess.Popen([sys.executable, "-c", _WORKER, str(work), coord, str(r), *cases],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
            for r in range(WORLD)]


def _finish_workers(procs, work, cases, timeout=240):
    """Each rank's outputs of `cases`, once both workers exit cleanly."""
    outs = []
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in out, f"rank {r} failed:\n{out}"
    return [{c: dict(np.load(os.path.join(work, f"{c}_out_r{r}.npz"))) for c in cases}
            for r in range(WORLD)]


def _train_yaml(name):
    with open(os.path.join(ROOT, "cfg", "train", f"{name}.yaml")) as f:
        return yaml.safe_load(f)


def _traj(rng, n_obs, n_act, n_states, B=BL, amp_dim=0):
    f = np.float32
    mu = rng.normal(size=(T, B, n_act)).astype(f)
    log_std = np.full((T, B, n_act), -0.3, f)
    done = (rng.uniform(size=(T, B)) < 0.2).astype(f)
    out = dict(obs=(rng.normal(size=(T, B, n_obs)) * 2 + 0.5).astype(f),
               action=(mu + np.exp(log_std) * rng.normal(size=mu.shape)).astype(f),
               logp=(rng.normal(size=(T, B)) - 4).astype(f),
               value=rng.normal(size=(T, B)).astype(f),
               mu=(mu + 0.05 * rng.normal(size=mu.shape)).astype(f), log_std=log_std,
               reward=rng.normal(size=(T, B)).astype(f), done=done,
               timeout=(done * (rng.uniform(size=(T, B)) < 0.5)).astype(f))
    if n_states:
        out["states"] = rng.normal(size=(T, B, n_states)).astype(f)
    if amp_dim:
        out["amp_obs"] = (rng.normal(size=(T, B, amp_dim)) * 1.5 + 0.3).astype(f)
    return out


def _end(rng, n_obs, n_states, B=BL):
    f = np.float32
    return dict(end_obs=rng.normal(size=(B, n_obs)).astype(f),
                end_done=(rng.uniform(size=B) < 0.3).astype(f),
                end_ret=rng.normal(size=B).astype(f),
                **({"end_states": rng.normal(size=(B, n_states)).astype(f)} if n_states else {}))


def _jax_end(halves, n_states):
    """The two halves' end states stacked on the vmapped axis."""
    st = lambda k: jnp.asarray(np.stack([h[k] for h in halves]))  # noqa: E731
    return End(st("end_obs"), st("end_states") if n_states else None, st("end_done"),
               st("end_ret"))


def _setup(work, case, jp, jts, tp, spec, halves, extra=None):
    """Write the port's state, config and each rank's half for the workers."""
    save_train_state(os.path.join(work, case + ".ckpt"),
                     convert.train_state(tp, jax.tree.map(np.asarray, jts)))
    with open(os.path.join(work, case + ".json"), "w") as f:
        json.dump(dict(spec, cfg=dataclasses.asdict(tp.cfg)), f)
    for r, h in enumerate(halves):
        np.savez(os.path.join(work, f"{case}_r{r}.npz"), **h, **(extra or {}))


def _perturbed(jp, jts, rng, n_obs, n_states, key_tree="params"):
    """jts with every weight off its init and the normalisers off identity."""
    f32 = jnp.float32
    jrms = jax.jit(jrms_update)
    jts = dataclasses.replace(jts, params=jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.05, f32), jts.params))
    return dataclasses.replace(
        jts, obs_rms=jrms(jts.obs_rms, jnp.asarray(rng.normal(size=(64, n_obs)) * 2 + 1, f32)),
        value_rms=jrms(jts.value_rms, jnp.asarray(rng.normal(size=64) * 3, f32)),
        states_rms=jrms(jts.states_rms, jnp.asarray(
            rng.normal(size=(64, max(n_states, 1))) * 2 - 1, f32)))


def _mlp_case(work):
    n_obs, n_act = 11, 3
    y = _train_yaml("AntPPO")
    kw = dict(units=(32, 16), horizon_length=T, minibatch_size=T * BL, mini_epochs=2,
              mixed_precision=False, normalize_input=True, normalize_value=True,
              value_bootstrap=True, kl_threshold=0.008)
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(y), **kw)
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(y), **kw)
    task = SimpleNamespace(num_states=0, num_agents=1)
    jp = jppo.PPO(SimpleNamespace(num_obs=n_obs, num_actions=n_act, num_envs=BL, task=task),
                  jcfg, axis_name=AXIS)
    tp = tppo.PPO(SimpleNamespace(num_obs=n_obs, num_actions=n_act, num_envs=BL, task=task,
                                  device="cpu"), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    jts = _perturbed(jp, jax.jit(jp.init)(jax.random.key(0)), rng, n_obs, 0)
    halves = [dict(**_traj(rng, n_obs, n_act, 0), **_end(rng, n_obs, 0)) for _ in range(WORLD)]
    _setup(work, "mlp", jp, jts, tp, dict(n_obs=n_obs, n_act=n_act, n_states=0, B=BL, amp=False),
           halves)

    def ref():
        es = (_jax_end(halves, 0), {k: jnp.asarray(np.stack([h[k] for h in halves]))
                                    for k in halves[0] if not k.startswith("end_")})
        jp.rollout = lambda ts_, es_, key: (es_[0], es_[1])
        fn = jax.vmap(lambda e, k: jp.train_iteration(jts, e, k), in_axes=(0, 0), axis_name=AXIS)
        return jax.jit(fn)(es, jax.random.split(jax.random.key(1), WORLD))
    return ref, ("obs_rms", "value_rms"), tp


def _lstm_case(work):
    n_obs, n_act, n_states, H = 9, 2, 7, 12
    y = _train_yaml("ShadowHandPPOAsymmLSTM")
    kw = dict(units=(16,), rnn_units=H, horizon_length=T, seq_len=4, minibatch_size=T * BL,
              mini_epochs=2, mixed_precision=False, normalize_input=True, normalize_value=True)
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(y), **kw)
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(y), **kw)
    task = SimpleNamespace(num_states=n_states, num_agents=1)
    jp = jppo.PPO(SimpleNamespace(num_obs=n_obs, num_actions=n_act, num_envs=BL, task=task),
                  jcfg, axis_name=AXIS)
    tp = tppo.PPO(SimpleNamespace(num_obs=n_obs, num_actions=n_act, num_envs=BL, task=task,
                                  device="cpu"), tcfg, device="cpu")
    assert tp.is_rnn and tp.asymmetric
    rng = np.random.default_rng(1)
    jts = _perturbed(jp, jax.jit(jp.init)(jax.random.key(1)), rng, n_obs, n_states)
    halves = []
    for _ in range(WORLD):
        h = dict(**_traj(rng, n_obs, n_act, n_states), **_end(rng, n_obs, n_states))
        h["carry"] = (rng.normal(size=(T, 1, 2, BL, H)) * 0.5).astype(np.float32)
        h["last"] = (rng.normal(size=(1, 2, BL, H)) * 0.5).astype(np.float32)
        halves.append(h)
    _setup(work, "lstm", jp, jts, tp, dict(n_obs=n_obs, n_act=n_act, n_states=n_states, B=BL,
                                           amp=False), halves)

    def ref():
        traj = {k: jnp.asarray(np.stack([h[k] for h in halves])) for k in halves[0]
                if not k.startswith("end_") and k != "last"}
        last = jnp.asarray(np.stack([h["last"] for h in halves]))
        es = (_jax_end(halves, n_states), traj, last)
        # JAX's carry: a list over layers of (c, h) pairs
        jp.rollout_rnn = lambda ts_, e, key: (e[0], e[1], [(e[2][0, 0], e[2][0, 1])])
        fn = jax.vmap(lambda e, k: jp.train_iteration(jts, e, k), in_axes=(0, 0), axis_name=AXIS)
        return jax.jit(fn)(es, jax.random.split(jax.random.key(1), WORLD))
    return ref, ("obs_rms", "value_rms", "states_rms"), tp


def _amp_case(work):
    n_obs, n_act, W = 10, 3, 6
    N = T * BL
    y = _train_yaml("HumanoidAMPPPO")
    kw = dict(units=(32, 16), disc_units=(24, 16), horizon_length=T, minibatch_size=N,
              mini_epochs=2, amp_replay_buffer_size=N, amp_replay_keep_prob=1.0,
              lr_schedule="adaptive", mixed_precision=False)
    jcfg = dataclasses.replace(jamp.AMPConfig.from_rlgames(y), **kw)
    tcfg = dataclasses.replace(tamp.AMPConfig.from_rlgames(y), **kw)
    rng = np.random.default_rng(2)
    demo = (rng.normal(size=(N, 2 * W)) * 0.7 + 0.8).astype(np.float32)
    jtask = SimpleNamespace(num_states=0, num_agents=1, num_amp_obs=2 * W,
                            fetch_amp_obs_demo=lambda key, n: jnp.asarray(demo[:n]))
    ttask = SimpleNamespace(num_states=0, num_agents=1, num_amp_obs=2 * W,
                            fetch_amp_obs_demo=lambda gen, n: torch.as_tensor(demo[:n]))
    jp = jamp.AMPPPO(SimpleNamespace(num_obs=n_obs, num_actions=n_act, num_envs=BL, task=jtask),
                     jcfg, axis_name=AXIS)
    tp = tamp.AMPPPO(SimpleNamespace(num_obs=n_obs, num_actions=n_act, num_envs=BL, task=ttask,
                                     device="cpu"), tcfg, device="cpu")
    jts = _perturbed(jp, jax.jit(jp.init)(jax.random.key(2)), rng, n_obs, 0)
    row = rng.normal(size=2 * W).astype(np.float32)
    jts = dataclasses.replace(
        jts, amp_rms=jax.jit(jrms_update)(jts.amp_rms, jnp.asarray(
            rng.normal(size=(64, 2 * W)) * 1.2 - 0.4, jnp.float32)),
        replay=jnp.tile(jnp.asarray(row), (N, 1)), replay_count=jnp.asarray(N, jnp.int32),
        replay_ptr=jnp.asarray(5, jnp.int32))
    halves = [dict(**_traj(rng, n_obs, n_act, 0, amp_dim=2 * W), **_end(rng, n_obs, 0))
              for _ in range(WORLD)]
    _setup(work, "amp", jp, jts, tp, dict(n_obs=n_obs, n_act=n_act, n_states=0, B=BL, amp=True),
           halves, extra=dict(demo=demo))

    def ref():
        es = (_jax_end(halves, 0), {k: jnp.asarray(np.stack([h[k] for h in halves]))
                                    for k in halves[0] if not k.startswith("end_")})
        jp.rollout = lambda ts_, e, key: (e[0], e[1])
        fn = jax.vmap(lambda e, k: jp.train_iteration(jts, e, k), in_axes=(0, 0), axis_name=AXIS)
        return jax.jit(fn)(es, jax.random.split(jax.random.key(1), WORLD))
    return ref, ("obs_rms", "value_rms", "amp_rms"), tp


CASES = {"mlp": _mlp_case, "lstm": _lstm_case, "amp": _amp_case}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every case's JAX reference, and the workers' outputs of every case,
    the reset and the multi-task iteration (one launch of two processes)."""
    work = tmp_path_factory.mktemp("dp")
    refs = {name: make(work) for name, make in CASES.items()}
    cases = [*CASES, "reset", "multitask"]
    procs = _start_workers(work, cases)
    try:
        # the JAX references compile while the workers run
        want = {name: (ref(), rms, tp) for name, (ref, rms, tp) in refs.items()}
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return want, _finish_workers(procs, work, cases)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_data_parallel_step_matches_jax(dp_runs, case):
    refs, outs = dp_runs
    (jts2, _, jm), rms, tp = refs[case]
    ts = tp.init(0)
    for r in range(WORLD):
        out = outs[r][case]
        for k in jm:
            _close(out[f"m_{k}"], jm[k][r], msg=f"rank {r} {k}")
        for name in rms:
            for f in ("mean", "var", "count"):
                _close(out[f"{name}_{f}"], getattr(getattr(jts2, name), f)[r],
                       msg=f"rank {r} {name}.{f}")
        # the parameters: JAX's shard r (the same on both shards after pmean)
        params = jax.tree.map(lambda x: np.asarray(x)[r], jts2.params)
        want = convert._flat_like_torch(ts.model, params, ts.value_net, getattr(ts, "disc", None))
        _close(out["params"], np.concatenate([w.reshape(-1).numpy() for w in want]), PTOL,
               msg=f"rank {r} params")
    # the losses and KL are the ranks' mean: equal on both ranks; the
    # rollout's own metrics are each rank's
    for k in ("kl", "a_loss", "v_loss", "lr"):
        np.testing.assert_array_equal(outs[0][case][f"m_{k}"], outs[1][case][f"m_{k}"])
    assert outs[0][case]["m_reward_mean"] != outs[1][case]["m_reward_mean"]
    np.testing.assert_array_equal(outs[0][case]["params"], outs[1][case]["params"])
    # the normalisers are rank-local
    assert not np.array_equal(outs[0][case]["obs_rms_mean"], outs[1][case]["obs_rms_mean"])


def test_rank_reset_is_a_slice_of_the_whole_reset(dp_runs):
    _, outs = dp_runs
    env = tgt.make("Ant", num_envs=4 * WORLD, seed=3, device="cpu")
    whole = env.reset(5)
    for r in range(WORLD):
        out = outs[r]["reset"]
        rows = slice(4 * r, 4 * r + 4)
        for k in ("q", "qd", "obs"):
            np.testing.assert_array_equal(out[k], getattr(whole, k)[rows].numpy(), err_msg=k)
    np.testing.assert_array_equal(outs[0]["reset"]["params"], outs[1]["reset"]["params"])
    # each rank's generator: seed + 1 + rank
    for r in range(WORLD):
        want = torch.Generator().manual_seed(5 + 1 + r).get_state().numpy()
        np.testing.assert_array_equal(outs[r]["reset"]["gen"], want)


def test_multitask_over_a_process_group(dp_runs):
    _, outs = dp_runs
    a, b = outs[0]["multitask"], outs[1]["multitask"]
    for n in ("Cartpole", "Ant"):
        np.testing.assert_array_equal(a[n], b[n])
        np.testing.assert_array_equal(a[f"{n}_kl"], b[f"{n}_kl"])
        assert np.isfinite(a[n]).all() and np.isfinite(a[f"{n}_kl"])
        assert (int(a[f"{n}_id0"]), int(b[f"{n}_id0"])) == (0, 4)


def test_jax_shard_ppo_keeps_a_normaliser_per_shard():
    """The data-parallel normaliser state, read from JAX's own ``shard_ppo``
    (not the vmap above): two iterations of Cartpole (8 envs, 4 a device)
    on 2 of the 8 virtual CPU devices. ``out_specs`` declares the train
    state replicated, but each device keeps the buffer its shard computed:
    the parameters are equal on both devices (the gradients are
    ``pmean``ed), the normalisers are not, and each counts only its own
    shard's T x 4 rows an iteration (1e-4 + 2 x 16; 1e-4 + 2 x 32 had they
    been one global state). So the port's rank-local normalisers are
    JAX's."""
    from jax.sharding import Mesh

    import thormang_isaacgym_tpu as tgx
    from thormang_isaacgym_tpu.parallel.mesh import ENV_AXIS, shard_ppo
    cfg = jppo.PPOConfig(units=(16, 16), horizon_length=4, minibatch_size=16, mini_epochs=1,
                         mixed_precision=False, normalize_input=True, normalize_value=True)
    ppo = jppo.PPO(tgx.make("Cartpole", num_envs=8, seed=0), cfg, axis_name=ENV_AXIS)
    train_iter, init = shard_ppo(ppo, Mesh(np.array(jax.devices()[:2]), (ENV_AXIS,)))
    ts, es = init(jax.random.key(0))
    for i in range(2):
        ts, es, _ = train_iter(ts, es, jax.random.key(i + 1))

    def shards(x):
        return [np.asarray(s.data) for s in sorted(x.addressable_shards, key=lambda s: s.device.id)]

    for name in ("obs_rms", "value_rms"):
        rms = getattr(ts, name)
        mean = shards(rms.mean)
        assert len(mean) == 2 and not np.array_equal(mean[0], mean[1]), name
        np.testing.assert_allclose(shards(rms.count), [1e-4 + 2 * 16] * 2, rtol=1e-6)
    for leaf in jax.tree.leaves(ts.params):
        a, b = shards(leaf)
        np.testing.assert_array_equal(a, b)
