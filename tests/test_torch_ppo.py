"""Port parity for learn/ and parity/convert.py: a JAX PPO ``TrainState`` is
carried across, then the forward pass, ``gaussian_logprob`` / ``kl`` /
entropy, GAE (with the timeout bootstrap), ``_loss`` and its gradients, one
optimizer step (global-norm clip + Adam) from a carried-over Adam state, and
the adaptive learning rate agree on identical batches (float32,
mixed_precision=False; rtol 1e-5 with atol 1e-5, gradients atol 1e-4).
Then a few Cartpole ``train_iteration``s on the CPU give finite metrics, the
Cartpole learning curve of tests/test_ppo.py is reached (marked slow), and
``act_deterministic`` is the clamped policy mean."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import thormang_isaacgym_tpu as tgx
from thormang_isaacgym_tpu.learn import ppo as jppo
from thormang_isaacgym_tpu.learn.normalize import rms_update as jrms_update
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.learn import ppo as tppo
from thormang_isaacgym_tpu_torch.parity import convert

B, T = 8, 6
CFG = dict(horizon_length=T, minibatch_size=B * T, mini_epochs=2, learning_rate=3e-4,
           units=(32, 16), kl_threshold=0.008, mixed_precision=False, normalize_input=True,
           normalize_value=True, value_bootstrap=True, truncate_grads=True,
           bounds_loss_coef=0.01, entropy_coef=0.01, reward_shaper_scale=0.01)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.as_tensor(np.array(x))


def _batch(rng, n_obs, n_act):
    f = np.float32
    mu = rng.normal(size=(B * T, n_act)).astype(f)
    log_std = np.full((B * T, n_act), -0.3, f)
    action = (mu + np.exp(log_std) * rng.normal(size=mu.shape)).astype(f)
    return dict(obs=rng.normal(size=(B * T, n_obs)).astype(f) * 2, action=action,
                logp=rng.normal(size=B * T).astype(f) - 8, value=rng.normal(size=B * T).astype(f),
                mu=mu + 0.05 * rng.normal(size=mu.shape).astype(f), log_std=log_std,
                adv=rng.normal(size=B * T).astype(f), ret=rng.normal(size=B * T).astype(f))


@pytest.fixture(scope="module")
def ref():
    """JAX PPO on Ant: a TrainState with updated normalizers, and its outputs
    on one seeded batch."""
    rng = np.random.default_rng(0)
    jenv = tgx.make("Ant", num_envs=B, seed=0)
    jp = jppo.PPO(jenv, jppo.PPOConfig(**CFG))
    ts = jp.init(jax.random.key(0))
    ts = dataclasses.replace(
        ts, obs_rms=jrms_update(ts.obs_rms, jnp.asarray(rng.normal(size=(64, 60)) * 3 + 1, jnp.float32)),
        value_rms=jrms_update(ts.value_rms, jnp.asarray(rng.normal(size=64) * 2, jnp.float32)),
        lr=jnp.asarray(1e-4))
    batch = _batch(rng, jenv.num_obs, jenv.num_actions)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.value_and_grad(jp._loss, has_aux=True)(ts.params, ts, jb)
    traj = dict(reward=rng.normal(size=(T, B)).astype(np.float32),
                value=rng.normal(size=(T, B)).astype(np.float32),
                done=(rng.uniform(size=(T, B)) < 0.2).astype(np.float32),
                timeout=(rng.uniform(size=(T, B)) < 0.1).astype(np.float32))
    last_value = rng.normal(size=B).astype(np.float32)
    adv, ret = jp.compute_gae(ts, {k: jnp.asarray(v) for k, v in traj.items()}, jnp.asarray(last_value))
    fwd = jp.network.apply(ts.params, jb["obs"])
    # an Adam state two steps in (moments and count carried across), then one
    # minibatch step on the batch with the clip inactive and active
    warm = dataclasses.replace(ts, lr=jnp.asarray(1e-2))
    params, opt_state = warm.params, warm.opt_state
    for _ in range(2):
        g = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), params)
        upd, opt_state = jp.optimizer.update(g, opt_state, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: u * warm.lr, upd))
    warm = dataclasses.replace(warm, params=params, opt_state=opt_state)
    g_warm = jax.grad(lambda p: jp._loss(p, warm, jb)[0])(warm.params)
    g_norm = float(optax.global_norm(g_warm))
    steps = {}
    for case, grad_norm in (("unclipped", 10.0 * g_norm), ("clipped", 0.25 * g_norm)):
        jpc = jppo.PPO(jenv, jppo.PPOConfig(**{**CFG, "grad_norm": grad_norm}))
        upd, st = jpc.optimizer.update(g_warm, warm.opt_state, warm.params)
        new = optax.apply_updates(warm.params, jax.tree.map(lambda u: u * warm.lr, upd))
        adam = convert._find_adam(st)
        steps[case] = dict(grad_norm=grad_norm, params=jax.tree.map(np.asarray, new),
                           mu=jax.tree.map(np.asarray, adam.mu), nu=jax.tree.map(np.asarray, adam.nu),
                           count=int(adam.count))
    kls = [float("nan"), float("inf"), 1e-3, 8e-3, 3e-2]
    lrs = [float(jp._adaptive_lr(jnp.asarray(2e-4), jnp.asarray(k))) for k in kls]
    return dict(ts=jax.tree.map(np.asarray, ts), batch=batch, loss=loss, aux=aux,
                grads=jax.tree.map(np.asarray, grads), traj=traj, last_value=last_value,
                gae=(adv, ret), fwd=fwd, kls=kls, lrs=lrs,
                warm=jax.tree.map(np.asarray, warm), steps=steps)


@pytest.fixture(scope="module")
def port(ref):
    env = tgt.make("Ant", num_envs=B, seed=0, device="cpu")
    ppo = tppo.PPO(env, tppo.PPOConfig(**CFG), device="cpu")
    return ppo, convert.train_state(ppo, ref["ts"])


def test_convert_carries_weights_and_state(ref, port):
    _, ts = port
    jp = ref["ts"].params["params"]
    np.testing.assert_array_equal(ts.model.trunk[0].weight.detach().numpy(), jp["trunk_0"]["kernel"].T)
    np.testing.assert_array_equal(ts.model.mu.bias.detach().numpy(), jp["mu"]["bias"])
    np.testing.assert_array_equal(ts.model.log_std.detach().numpy(), jp["log_std"])
    np.testing.assert_array_equal(ts.obs_rms.mean.numpy(), ref["ts"].obs_rms.mean)
    assert float(ts.value_rms.count) == pytest.approx(float(ref["ts"].value_rms.count))
    assert float(ts.lr) == pytest.approx(1e-4)
    assert len(ts.adam_m) == len(list(ts.model.parameters())) and ts.adam_step == 0


def test_forward_matches_jax(ref, port):
    _, ts = port
    with torch.no_grad():
        got = ts.model(_t(ref["batch"]["obs"]))
    for g, w in zip(got, ref["fwd"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_gaussian_logprob_kl_entropy_match_jax(ref):
    b = ref["batch"]
    mu1, ls1 = b["mu"] * 0.9, b["log_std"] + 0.1
    pairs = [
        (tppo.gaussian_logprob(_t(b["mu"]), _t(b["log_std"]), _t(b["action"])),
         jppo.gaussian_logprob(b["mu"], b["log_std"], b["action"])),
        (tppo.gaussian_kl(_t(b["mu"]), _t(b["log_std"]), _t(mu1), _t(ls1)),
         jppo.gaussian_kl(b["mu"], b["log_std"], mu1, ls1)),
        (tppo.gaussian_entropy(_t(ls1)), jppo.gaussian_entropy(ls1)),
    ]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_gae_matches_jax(ref, port):
    ppo, _ = port
    adv, ret = ppo.compute_gae({k: _t(v) for k, v in ref["traj"].items()}, _t(ref["last_value"]))
    np.testing.assert_allclose(adv.numpy(), np.asarray(ref["gae"][0]), **TOL)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ref["gae"][1]), **TOL)


def test_loss_and_grads_match_jax(ref, port):
    ppo, ts = port
    loss, aux = ppo._loss(ts, {k: _t(v) for k, v in ref["batch"].items()})
    np.testing.assert_allclose(float(loss.detach()), float(ref["loss"]), **TOL)
    for k, v in ref["aux"].items():
        np.testing.assert_allclose(float(aux[k]), float(v), err_msg=k, **TOL)
    params = list(ts.model.parameters())
    grads = torch.autograd.grad(loss, params)
    want = convert._flat_like_torch(ts.model, ref["grads"])
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", ["unclipped", "clipped"])
def test_optimizer_step_matches_optax(ref, port, case):
    ppo, _ = port
    want = ref["steps"][case]
    ts = convert.train_state(ppo, ref["warm"])
    assert ts.adam_step == 2 and float(ts.lr) == pytest.approx(1e-2)
    loss, _ = ppo._loss(ts, {k: _t(v) for k, v in ref["batch"].items()})
    grads = torch.autograd.grad(loss, list(ts.model.parameters()))
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
    assert (norm > want["grad_norm"]) == (case == "clipped")
    cfg = ppo.cfg
    ppo.cfg = dataclasses.replace(cfg, grad_norm=want["grad_norm"])
    try:
        ppo._apply_grads(ts, grads)
    finally:
        ppo.cfg = cfg
    assert ts.adam_step == want["count"] == 3
    for got, key in ((list(ts.model.parameters()), "params"), (ts.adam_m, "mu"), (ts.adam_v, "nu")):
        for g, w in zip(got, convert._flat_like_torch(ts.model, want[key])):
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), err_msg=key, **TOL)


def test_adaptive_lr_matches_jax(ref, port):
    ppo, _ = port
    got = [float(ppo._adaptive_lr(torch.tensor(2e-4), torch.tensor(k))) for k in ref["kls"]]
    np.testing.assert_allclose(got, ref["lrs"], rtol=1e-6)
    assert got[0] < 2e-4 and got[1] < 2e-4          # non-finite KL counts as too high


def test_separate_critic_network_matches_jax():
    """cfg/train/AnymalTerrainPPO.yaml's network (separate actor and critic
    trunks, 512-256-128 elu, fixed sigma) on AnymalTerrain's 188 obs: the
    forward pass, the loss and its gradients against JAX, in float32."""
    import os
    import yaml
    with open(os.path.join(os.path.dirname(__file__), "..", "cfg", "train",
                           "AnymalTerrainPPO.yaml")) as f:
        train = yaml.safe_load(f)
    small = dict(horizon_length=T, minibatch_size=B * T, mixed_precision=False)
    jcfg = dataclasses.replace(jppo.PPOConfig.from_rlgames(train), **small)
    tcfg = dataclasses.replace(tppo.PPOConfig.from_rlgames(train), **small)
    assert tcfg.separate and tcfg.units == (512, 256, 128) and tcfg.critic_coef == 2
    assert (tcfg.normalize_value, tcfg.value_bootstrap, tcfg.fixed_sigma) == (True, True, True)
    kw = dict(num_levels=2, num_types=4)
    jenv = tgx.make("AnymalTerrain", num_envs=B, seed=0, **kw)
    jp = jppo.PPO(jenv, jcfg)
    rng = np.random.default_rng(5)
    jts = jp.init(jax.random.key(1))
    jts = dataclasses.replace(
        jts, obs_rms=jrms_update(jts.obs_rms, jnp.asarray(rng.normal(size=(64, 188)), jnp.float32)),
        value_rms=jrms_update(jts.value_rms, jnp.asarray(rng.normal(size=64) * 2, jnp.float32)))
    batch = _batch(rng, 188, 12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = jp.network.apply(jts.params, jb["obs"])
    (loss, aux), grads = jax.value_and_grad(jp._loss, has_aux=True)(jts.params, jts, jb)

    env = tgt.make("AnymalTerrain", num_envs=B, seed=0, device="cpu", **kw)
    ppo = tppo.PPO(env, tcfg, device="cpu")
    ts = convert.train_state(ppo, jax.tree.map(np.asarray, jts))
    assert ts.model.vtrunk is not None and ts.model.vtrunk[0].weight.shape == (512, 188)
    with torch.no_grad():
        got = ts.model(_t(batch["obs"]))
    for g, w in zip(got, fwd):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    tloss, taux = ppo._loss(ts, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss.detach()), float(loss), **TOL)
    for k, v in aux.items():
        np.testing.assert_allclose(float(taux[k].detach()), float(v), err_msg=k, **TOL)
    tgrads = torch.autograd.grad(tloss, list(ts.model.parameters()))
    for g, w in zip(tgrads, convert._flat_like_torch(ts.model, jax.tree.map(np.asarray, grads))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=1e-4)


def test_cartpole_train_iterations_finite():
    env = tgt.make("Cartpole", num_envs=16, seed=0, device="cpu")
    ppo = tppo.PPO(env, tppo.PPOConfig(horizon_length=8, minibatch_size=64, mini_epochs=2,
                                       units=(32, 32), mixed_precision=False), device="cpu")
    ts = ppo.init(0)
    state = env.reset(0)
    w0 = ts.model.mu.weight.detach().clone()
    for _ in range(3):
        ts, state, metrics = ppo.train_iteration(ts, state)
        for k, v in metrics.items():
            assert np.isfinite(float(v)), (k, v)
    assert ts.epoch == 3 and ts.adam_step == 3 * 2 * 2
    assert not torch.equal(w0, ts.model.mu.weight)


@pytest.mark.slow
def test_cartpole_learns():
    """(slow: about 30-50 s on the CPU, most of it the Cartpole op path's 1920
    env steps.) The learning curve of tests/test_ppo.py's ``test_cartpole_learns`` on
    the port, with its config (128 envs, horizon 32, minibatch 2048, 4
    mini-epochs, lr 3e-4, units (64, 64), KL threshold 0.008, reward scale
    1.0, 60 epochs, logged every 5): the best reward_mean above 0.85 (a
    random policy gives about 0.3-0.6 a step), and fewer early dones at the
    end than at the start."""
    env = tgt.make("Cartpole", num_envs=128, seed=0, device="cpu")
    ppo = tppo.PPO(env, tppo.PPOConfig(horizon_length=32, minibatch_size=2048, mini_epochs=4,
                                       learning_rate=3e-4, units=(64, 64), kl_threshold=0.008,
                                       mixed_precision=False, reward_shaper_scale=1.0),
                   device="cpu")
    ts, state = ppo.init(3), env.reset(3)
    history = []
    for epoch in range(60):
        ts, state, metrics = ppo.train_iteration(ts, state)
        if epoch % 5 == 0 or epoch == 59:
            history.append({k: float(metrics[k]) for k in ("reward_mean", "episode_done_frac")})
    first, best = history[0]["reward_mean"], max(h["reward_mean"] for h in history)
    assert best > 0.85, (first, best, [h["reward_mean"] for h in history])
    last_done = history[-1]["episode_done_frac"]
    assert last_done < history[0]["episode_done_frac"] + 1e-6 or last_done < 0.01


def test_act_deterministic_bounded_and_mean():
    """act_deterministic: the policy mean on normalized obs, clamped to
    [-1, 1], as JAX's (tests/test_ppo.py ``test_deterministic_play_action_bounded``)."""
    env = tgt.make("Cartpole", num_envs=8, seed=0, device="cpu")
    ppo = tppo.PPO(env, tppo.PPOConfig(units=(64, 64), mixed_precision=False,
                                       normalize_input=True), device="cpu")
    ts = ppo.init(0)
    obs = torch.as_tensor(np.random.RandomState(0).randn(8, 4).astype(np.float32)) * 10
    with torch.no_grad():
        ts.model.mu.weight.mul_(50.0)                # push some means past the bounds
    act = ppo.act_deterministic(ts, obs)
    mu, _, _ = ppo._policy(ts, obs)
    assert float(act.abs().max()) <= 1.0 and float(mu.abs().max()) > 1.0
    torch.testing.assert_close(act, torch.clamp(mu, -1.0, 1.0), rtol=0, atol=0)
