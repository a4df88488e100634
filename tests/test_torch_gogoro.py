"""The Gogoro tasks of the port (tasks/gogoro.py, gogoro_paper.py,
gogoro_combined.py) against the JAX package's, on a generated stand-in URDF.

The reference's scooter and combined URDFs are not in the repository, so
each test writes a stand-in (``stand_in_urdf``) into its tmp directory: a
floating scooter frame with the scooter's joints (``base_x/y/z``,
``steering_joint``, ``front_wheel_joint``, ``rear_wheel_joint``) and wheel
links ``front``/``back`` whose collision is a mesh, replaced by both
packages' mesh overrides; the 31 THORMANG joints of ``JOINTS_POS`` on small
primitives, ``head_p_link`` among them; 39 DOFs, as the real scooter's. The
combined stand-in adds the four freewheel joints (0.2 kg placeholder
freewheels), the two handle prismatics with ``l/r_steering_handle_end``
links, the hands' fixed ``l/r_arm_end_link``s and 0.1 kg placeholder wheels.
The same file goes to both packages as ``asset_path=``.

- ``_build_model``'s tables (every default), the counts, names and the
  tasks' indices agree; ``randomize`` sets JAX's ``dr_config``.
- A missing URDF raises FileNotFoundError naming the path, from the class
  and from ``make``.
- Reset (JAX's draws, from its own key splits, fed through ``reset_from``),
  ``pre_physics`` (JAX's steering noise and push draws fed across),
  ``post_physics`` (JAX's frame noise and command draws fed across; the
  JAX functions jitted: op by op, the combined rider's IK alone compiles
  ~400 primitives one by one, ~25 s, and jitted it agrees with that within
  1e-6) and ``observation_noise`` (both settings of
  ``reproduce_ref_obs_bug``) agree at atol 1e-5 (the combined rider's IK
  deltas 1e-4: a 6 x 6 solve) for all three tasks.
- The host-C++ build of the kernel agrees with the plain step on the
  stand-in's cylinder wheels on the ground (tests/test_torch_fused.py's
  tolerances) over five steps, each from the plain version's state, as
  tests/test_torch_fused.py holds its STEPWISE cases: the free front
  wheel's regularised friction (friction_vel 0.1 m/s) amplifies last-bit
  differences 20- to 50-fold a step, so free running the versions part in
  the third step (the wheel's rate: 4e-5, 8e-4, 0.035, then 1.2 rad/s).
- The golden ``gogoro_4env_30step.npz`` (recorded on the real asset) is
  compared by shapes: 30 steps of 4 envs through ``make`` give its obs,
  reward, done and final q / qd shapes, finite.
"""
import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thormang_isaacgym_tpu.tasks import gogoro as jg
from thormang_isaacgym_tpu.tasks import gogoro_combined as jgc
from thormang_isaacgym_tpu.tasks import gogoro_paper as jgp
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.ops import fused
from thormang_isaacgym_tpu_torch.ops.kinematics import forward_kinematics
from thormang_isaacgym_tpu_torch.tasks import gogoro as tg
from thormang_isaacgym_tpu_torch.tasks import gogoro_combined as tgc
from thormang_isaacgym_tpu_torch.tasks import gogoro_paper as tgp
from test_torch_fused import _assert_close, _host_call, host_kernel  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
B = 6
TASKS = {"Gogoro": (jg.Gogoro, tg.Gogoro, False), "GogoroPaper": (jgp.GogoroPaper, tgp.GogoroPaper,
                                                                   False),
         "GogoroCombined": (jgc.GogoroCombined, tgc.GogoroCombined, True)}


def _inertial(m):
    i = max(m * 0.01, 1e-4)
    return (f'<inertial><mass value="{m}"/><inertia ixx="{i}" iyy="{i}" izz="{i}" '
            f'ixy="0" ixz="0" iyz="0"/></inertial>')


def _link(name, m, geom=""):
    col = f"<collision>{geom}</collision>" if geom else ""
    return f'<link name="{name}">{_inertial(m)}{col}</link>'


def _joint(name, kind, parent, child, xyz, axis="0 0 1", lim=(-1.5, 1.5)):
    return (f'<joint name="{name}" type="{kind}"><parent link="{parent}"/>'
            f'<child link="{child}"/><origin xyz="{xyz}"/><axis xyz="{axis}"/>'
            f'<limit lower="{lim[0]}" upper="{lim[1]}" effort="100" velocity="100"/></joint>')


def _fixed(name, parent, child, xyz):
    return (f'<joint name="{name}" type="fixed"><parent link="{parent}"/>'
            f'<child link="{child}"/><origin xyz="{xyz}"/></joint>')


def _capsule(r, length, xyz="0 0 0", rpy="0 0 0"):
    return (f'<origin xyz="{xyz}" rpy="{rpy}"/>'
            f'<geometry><capsule radius="{r}" length="{length}"/></geometry>')


def _wheel_mesh(combined):
    # the scooter's collision origin rpy(1.5708, 0, 0); the combined asset's
    # xyz (-0.731969, 0, -0.201999)
    origin = '<origin xyz="-0.731969 0 -0.201999" rpy="0 0 0"/>' if combined else \
        '<origin xyz="0 0 0" rpy="1.5708 0 0"/>'
    return origin + '<geometry><mesh filename="package://gogoro/meshes/wheel_V3.obj"/></geometry>'


def stand_in_urdf(combined: bool) -> str:
    """The stand-in scooter (module docstring)."""
    wheel_m = 0.1 if combined else 5.0
    parts = [
        _link("frame", 60.0, '<origin xyz="0 0 0.35"/><geometry><box size="1.0 0.25 0.3"/>'
                             '</geometry>'),
        _joint("steering_joint", "revolute", "frame", "fork", "0.55 0 0.45", lim=(-0.6, 0.6)),
        _link("fork", 3.0, _capsule(0.03, 0.4, "0 0 -0.1")),
        _joint("front_wheel_joint", "revolute", "fork", "front", "0.05 0 -0.28", "0 1 0",
               (-1e4, 1e4)),
        _link("front", wheel_m, _wheel_mesh(combined)),
        _joint("rear_wheel_joint", "revolute", "frame", "back", "-0.55 0 0.17", "0 1 0",
               (-1e4, 1e4)),
        _link("back", wheel_m, _wheel_mesh(combined)),
        _joint("kickstand_joint", "revolute", "frame", "kickstand", "-0.2 0.1 0.25", "1 0 0",
               (0.0, 0.0)),
        _link("kickstand", 0.5),
        _joint("fender_joint", "revolute", "fork", "fender", "0.05 0 -0.05", "0 1 0", (0.0, 0.0)),
        _link("fender", 0.3),
        _joint("base_x", "prismatic", "frame", "seat_x", "-0.1 0 0.55", "1 0 0", (-0.2, 0.2)),
        _link("seat_x", 0.2),
        _joint("base_y", "prismatic", "seat_x", "seat_y", "0 0 0", "0 1 0", (-0.2, 0.2)),
        _link("seat_y", 0.2),
        _joint("base_z", "prismatic", "seat_y", "seat_z", "0 0 0", "0 0 1", (-0.2, 0.2)),
        _link("seat_z", 8.0, '<geometry><sphere radius="0.08"/></geometry>'),
        _joint("torso_y", "revolute", "seat_z", "chest", "0 0 0.15"),
        _link("chest", 10.0, '<origin xyz="0 0 0.15"/><geometry><box size="0.2 0.3 0.3"/>'
                             '</geometry>'),
        _joint("head_y", "revolute", "chest", "head_y_link", "0 0 0.35"),
        _link("head_y_link", 0.5),
        _joint("head_p", "revolute", "head_y_link", "head_p_link", "0 0 0.05", "0 1 0"),
        _link("head_p_link", 2.0, '<origin xyz="0 0 0.08"/><geometry><sphere radius="0.1"/>'
                                  '</geometry>'),
    ]
    for s, y in (("l", 0.2), ("r", -0.2)):
        arm = ("sh_p1", "sh_r", "sh_p2", "el_y", "wr_r", "wr_y", "wr_p", "grip")
        axes = ("0 1 0", "1 0 0", "0 1 0", "0 0 1", "1 0 0", "0 0 1", "0 1 0", "0 0 1")
        parent, xyz = "chest", f"0 {y} 0.25"
        for k, (jn, ax) in enumerate(zip(arm, axes)):
            child = f"{s}_arm_{jn}_link"
            parts.append(_joint(f"{s}_arm_{jn}", "revolute", parent, child, xyz, ax, (-2.5, 2.5)))
            parts.append(_link(child, 0.6, _capsule(0.03, 0.1, "0.05 0 0", "0 1.5708 0")))
            parent, xyz = child, "0.12 0 0" if k < 6 else "0.05 0 0"
        if combined:
            parts.append(_fixed(f"{s}_arm_end_joint", f"{s}_arm_wr_p_link", f"{s}_arm_end_link",
                                "0.08 0 0"))
            parts.append(_link(f"{s}_arm_end_link", 0.05))
        leg = ("hip_y", "hip_r", "hip_p", "kn_p", "an_p", "an_r")
        laxes = ("0 0 1", "1 0 0", "0 1 0", "0 1 0", "0 1 0", "1 0 0")
        parent, xyz = "seat_z", f"0 {y / 2} -0.05"
        for jn, ax in zip(leg, laxes):
            child = f"{s}_leg_{jn}_link"
            parts.append(_joint(f"{s}_leg_{jn}", "revolute", parent, child, xyz, ax, (-2.5, 2.5)))
            parts.append(_link(child, 1.0, _capsule(0.03, 0.02, "0 0 -0.03")))
            parent, xyz = child, "0 0 -0.06"
    if combined:
        for s, y in (("l", 0.3), ("r", -0.3)):
            parts += [
                _fixed(f"{s}_holder_joint", "frame", f"{s}_metal_freewheel_holder",
                       f"-0.55 {y} 0.2"),
                _link(f"{s}_metal_freewheel_holder", 0.2),
                _joint(f"{s}_metal_freewheel_holder_TO_{s}_dummy", "revolute",
                       f"{s}_metal_freewheel_holder", f"{s}_dummy", "0 0 0", "0 0 1"),
                _link(f"{s}_dummy", 0.1),
                _joint(f"dummy_TO_{s}_free_wheel", "revolute", f"{s}_dummy", f"{s}_free_wheel",
                       "0 0 -0.1", "0 1 0", (-1e4, 1e4)),
                _link(f"{s}_free_wheel", 0.2,
                      '<origin xyz="0 0 0" rpy="1.5708 0 0"/>'
                      '<geometry><cylinder radius="0.1" length="0.05"/></geometry>'),
                _joint(f"{s}_handle_prismatic_joint", "prismatic", "fork",
                       f"{s}_steering_handle_end", f"-0.1 {y} 0.35", "0 1 0", (-0.1, 0.1)),
                _link(f"{s}_steering_handle_end", 0.3),
            ]
    name = "gogoro_combined_stand_in" if combined else "scooter_stand_in"
    return f'<?xml version="1.0"?><robot name="{name}">' + "".join(parts) + "</robot>"


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("gogoro_assets")
    out = {}
    for combined in (False, True):
        p = d / ("combined.urdf" if combined else "scooter.urdf")
        p.write_text(stand_in_urdf(combined))
        out[combined] = str(p)
    return out


@pytest.fixture(scope="module")
def tasks(assets):
    """{name: (JAX task, port task)} on the stand-ins, B envs."""
    return {name: (jcls(num_envs=B, seed=0, asset_path=assets[comb]),
                   tcls(num_envs=B, seed=0, asset_path=assets[comb], device="cpu"))
            for name, (jcls, tcls, comb) in TASKS.items()}


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **tol)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("name", sorted(TASKS))
def test_build_model_tables_match_jax(tasks, name):
    jt, tt = tasks[name]
    jm, tm = jt.model, tt.model
    assert (tm.nb, tm.nj, tm.nq, tm.nv, tm.ng) == (jm.nb, jm.nj, jm.nq, jm.nv, jm.ng)
    # the real assets' DOFs: the scooter's 39, the combined asset's 45
    assert tm.nj == (45 if name == "GogoroCombined" else 39)
    assert tm.joint_names == jm.joint_names and tm.body_names == jm.body_names
    assert sorted(tm._defaults) == sorted(jm._defaults)
    for k in jm._defaults:
        _close(np.asarray(tm._defaults[k], np.float64), np.asarray(jm._defaults[k], np.float64),
               msg=k)
    for g, h in zip(tm.geoms, jm.geoms):
        assert (g.body, g.gtype) == (h.body, h.gtype)
        _close(np.r_[g.size, g.pos, g.quat], np.r_[h.size, h.pos, h.quat], msg="geom")
    assert sum(g.gtype == 3 for g in tm.geoms) >= 2          # the wheels' cylinders
    for attr in ("sid", "rid", "base_dofs", "head_body", "pris_ids", "arm_ids", "handle_body",
                 "num_obs", "num_actions", "max_episode_length", "_col0"):
        if hasattr(jt, attr):
            assert getattr(tt, attr) == getattr(jt, attr), attr
    if name == "GogoroCombined":
        for s in "lr":
            (b, p, q), (jb, jp, jq) = tt.hand_site[s], jt.hand_site[s]
            assert b == jb
            _close(np.r_[p, q], np.r_[jp, jq])
    assert dataclasses.asdict(tt.sim_params) == dataclasses.asdict(jt.sim_params)


def test_missing_asset_raises_and_dr_config(assets):
    for cls, path in ((tg.Gogoro, "scooter_V13.urdf"), (tgp.GogoroPaper, "scooter_V13.urdf"),
                      (tgc.GogoroCombined, "gogoro_and_thormang3_Light_freewheels.urdf")):
        with pytest.raises(FileNotFoundError, match=path):
            cls(num_envs=2, device="cpu")
    with pytest.raises(FileNotFoundError, match="/nowhere.urdf"):
        tgt.make("Gogoro", num_envs=2, device="cpu", asset_path="/nowhere.urdf")
    j = jg.Gogoro(num_envs=2, asset_path=assets[False], randomize=True)
    t = tg.Gogoro(num_envs=2, asset_path=assets[False], randomize=True, device="cpu")
    assert t.dr_config == j.dr_config and tg.Gogoro(
        num_envs=2, asset_path=assets[False], device="cpu").dr_config is None


def _keys(seed=0):
    return jax.random.split(jax.random.key(seed), B)


def _jax_draws(name, keys):
    """JAX's reset draws from its own key splits (tasks/gogoro*.py reset_fn)."""
    def one(key):
        if name == "GogoroCombined":
            ks = jax.random.split(key, 3)
            return dict(speed_cmd=jg._uniform(ks[0], (), 0.6, 1.0),
                        pris=jg._uniform(ks[1], (5,), -0.06, 0.06))
        ks = jax.random.split(key, 10)
        if name == "Gogoro":
            n = jg.NOISES
            return dict(speed_cmd=jg._uniform(ks[0], (), *n["speed_range"]),
                        yaw_target=jg._uniform(ks[1], (), -jnp.pi, jnp.pi),
                        yaw_off=jg._uniform(ks[2], (), -1.57, 1.57),
                        steer_offset=jg._normal(ks[3], (), *n["steering_offset"]),
                        speed_offset=jg._uniform(ks[4], (), *n["speed_sensor_offset"]),
                        imu_offset=jg._normal(ks[5], (), *n["seat_offset_xr_range"]),
                        damp=jg._uniform(ks[6], (), *n["steering_damping_range"]),
                        seat=jnp.stack([jg._normal(jax.random.fold_in(ks[7], i), (), *n[r])
                                        for i, r in enumerate(("seat_offset_x_range",
                                                               "seat_offset_y_range",
                                                               "seat_offset_z_range"))]))
        n = jgp.PAPER_NOISES
        return dict(speed_cmd=jg._uniform(ks[0], (), *n["speed_range"]),
                    yaw_target=jg._uniform(ks[1], (), -jnp.pi, jnp.pi),
                    yaw_off=jg._uniform(ks[2], (), -1.57, 1.57),
                    delay=jax.random.randint(ks[3], (), 0, jgp.DELAY_W).astype(jnp.int32),
                    imu_x=jg._uniform(ks[4], (), *n["imu_x_offset"]),
                    speed_offset=jg._uniform(ks[5], (), *n["speed_sensor_offset"]),
                    damp=jg._uniform(ks[6], (), *n["steering_damping_range"]),
                    spawn_roll=jg._uniform(ks[7], (), *n["spawn_x_angle"]))
    return jax.vmap(one)(keys)


def _jax_reset(jt, keys):
    params0 = jt.model.default_params().batch(B)
    return jax.vmap(jt.reset_fn)(keys, params0, jt.default_task_state(jax.random.key(0)))


def _port_reset(tt, draws):
    d = {k: _t(v) for k, v in draws.items()}
    return tt.reset_from(d, tt.model.default_params("cpu").batch(B))


@pytest.mark.parametrize("name", sorted(TASKS))
def test_reset_matches_jax(tasks, assets, name):
    jt, tt = tasks[name]
    keys = _keys()
    jq, jqd, jparams, jtask = _jax_reset(jt, keys)
    q, qd, params, task = _port_reset(tt, _jax_draws(name, keys))
    _close(q, jq, msg="q")
    _close(qd, jqd, msg="qd")
    for f in ("drive_damping", "dof_locked_pos", "dof_locked"):
        _close(getattr(params, f), getattr(jparams, f), msg=f)
    for f in dataclasses.fields(task):
        _close(getattr(task, f.name), getattr(jtask, f.name), msg=f.name)
    # the port's own draws lie in the same ranges
    env = tgt.make(name, num_envs=64, seed=1, device="cpu", asset_path=assets[TASKS[name][2]])
    s = env.reset(3)
    if name != "GogoroCombined":
        lo, hi = (5.0, 20.0) if name == "GogoroPaper" else (4.0, 13.0)
        assert bool(((s.task.speed_cmd >= lo) & (s.task.speed_cmd < hi)).all())
        assert float(s.task.speed_cmd.std()) > 1.0
    else:
        assert bool((s.task.prismatic.abs() <= 0.06).all())


def _state(name, jt, tt, seed=1):
    """(JAX state, port state) after a reset, off the spawn pose: root
    tilted and moving, joints off the pose, a progress of 300 in some envs
    (the command resampling), history and windows filled."""
    rng = np.random.default_rng(seed)
    keys = _keys(seed)
    jq, jqd, jparams, jtask = _jax_reset(jt, keys)
    q = np.array(jq)
    quat = q[:, 3:7] + rng.normal(size=(B, 4)).astype(np.float32) * 0.1
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += rng.normal(size=(B, q.shape[1] - 7)).astype(np.float32) * 0.1
    qd = rng.normal(size=np.shape(jqd)).astype(np.float32)
    progress = np.array([0, 9, 299, 300, 19, 300][:B], np.int32)
    task = jax.tree.map(np.array, jtask)
    if name == "Gogoro":
        task = dataclasses.replace(task, steer_cmd=rng.uniform(-0.5, 0.5, B).astype(np.float32),
                                   action_history=rng.uniform(-1, 1, (B, 5)).astype(np.float32))
    elif name == "GogoroPaper":
        task = dataclasses.replace(
            task, command_history=rng.uniform(-0.5, 0.5, (B, 5)).astype(np.float32),
            obs_clean=rng.normal(size=(B, 20, 8)).astype(np.float32),
            obs_noisy=rng.normal(size=(B, 20, 8)).astype(np.float32),
            cur_command=rng.uniform(-0.5, 0.5, B).astype(np.float32))
    js = SimpleNamespace(q=jnp.asarray(q), qd=jnp.asarray(qd), progress=jnp.asarray(progress),
                         key=jax.random.key(seed + 10), metrics={},
                         task=jax.tree.map(jnp.asarray, task))
    ttask = type(tt.default_task_state())(**{f.name: _t(getattr(task, f.name))
                                             for f in dataclasses.fields(task)})
    ts = SimpleNamespace(q=_t(q), qd=_t(qd), progress=_t(progress).long(), metrics={}, task=ttask,
                         seed=0, global_step=torch.tensor(5), env_id0=0)
    return js, ts


@pytest.mark.parametrize("name", sorted(TASKS))
def test_pre_physics_matches_jax(tasks, name, monkeypatch):
    jt, tt = tasks[name]
    js, ts = _state(name, jt, tt)
    a = np.random.default_rng(4).uniform(-1.2, 1.2, (B, 1)).astype(np.float32)
    if name == "Gogoro":
        noise = jg._normal(jax.random.fold_in(js.key, 101), (B,),
                           *jg.NOISES["steering_action_noise"])
        monkeypatch.setattr(tt, "steer_noise", lambda state: _t(noise))
    if name == "GogoroPaper":
        k1, k2 = jax.random.split(jax.random.fold_in(js.key, 303))
        draws = dict(x=jg._uniform(k1, (B,), -30.0, 30.0), z=-jax.random.uniform(k2, (B,)) * 30.0)
        monkeypatch.setattr(tt, "push_draws", lambda state: {k: _t(v) for k, v in draws.items()})
    jctrl, jw, jtask = jax.jit(lambda d, a: jt.pre_physics(SimpleNamespace(**d), a))(
        vars(js), jnp.asarray(a))
    ctrl, w, task = tt.pre_physics(ts, _t(a))
    tol = dict(atol=1e-4, rtol=1e-4) if name == "GogoroCombined" else TOL
    for k in range(3):
        _close(ctrl[k], jctrl[k], tol, msg=f"ctrl {k}")
    _close(w, jw, msg="wrench")
    for f in dataclasses.fields(task):
        _close(getattr(task, f.name), getattr(jtask, f.name), msg=f.name)
    if name == "GogoroPaper":                          # pushed envs: the first half at step 9
        assert float(np.abs(np.asarray(jw)).sum()) > 0
    if name == "GogoroCombined":                       # the IK moved the arms
        arm = list(tt.arm_ids["l"])
        assert float((ctrl[0][:, arm] - ts.q[:, 7:][:, arm]).abs().max()) > 1e-3


@pytest.mark.parametrize("name", sorted(TASKS))
def test_post_physics_matches_jax(tasks, name, monkeypatch):
    jt, tt = tasks[name]
    js, ts = _state(name, jt, tt, seed=2)
    if name == "Gogoro":
        k1, k2 = jax.random.split(jax.random.fold_in(js.key, 202))
        res = (jg._uniform(k1, (B,), 4.0, 13.0),
               jg.Q.wrap_to_pi(jg._uniform(k2, (B,), -jnp.pi, jnp.pi)))
        monkeypatch.setattr(tt, "resample", lambda state, lo, hi: tuple(_t(x) for x in res))
    if name == "GogoroPaper":
        n = jgp.PAPER_NOISES
        ks = jax.random.split(jax.random.fold_in(js.key, 404), 4)
        frame = dict(imu_filter=jg._uniform(ks[0], (B, 2), *n["imu_filter_noise"]),
                     imu=jg._uniform(ks[1], (B, 2), *n["imu_noise"]),
                     speed=jg._uniform(ks[2], (B,), *n["speed_sensor_noise"]),
                     delta_yaw=jg._uniform(ks[3], (B,), *n["imu_filter_noise"]))
        k1, k2 = jax.random.split(jax.random.fold_in(js.key, 505))
        res = (jg._uniform(k1, (B,), *n["speed_range"]),
               jg.Q.wrap_to_pi(jg._uniform(k2, (B,), -jnp.pi, jnp.pi)))
        monkeypatch.setattr(tt, "frame_noise", lambda state: {k: _t(v) for k, v in frame.items()})
        monkeypatch.setattr(tt, "resample", lambda state, lo, hi: tuple(_t(x) for x in res))
    jobs, jrew, jdone, jtask, jm = jax.jit(lambda d: jt.post_physics(SimpleNamespace(**d), d["task"]))(
        vars(js))
    obs, rew, done, task, m = tt.post_physics(ts, ts.task)
    _close(obs, jobs, msg="obs")
    _close(rew, jrew, msg="reward")
    _close(done, jdone, msg="done")
    for f in dataclasses.fields(task):
        _close(getattr(task, f.name), getattr(jtask, f.name), msg=f.name)
    assert sorted(m) == sorted(jm)
    for k in jm:
        _close(m[k], jm[k], msg=k)
    if name != "GogoroCombined":                       # the command resampled at step 300
        assert not np.allclose(np.asarray(jtask.speed_cmd), np.asarray(js.task.speed_cmd))


@pytest.mark.parametrize("bug", [False, True])
def test_observation_noise_matches_jax(tasks, bug, monkeypatch):
    jt, tt = tasks["Gogoro"]
    jt.reproduce_ref_obs_bug = tt.reproduce_ref_obs_bug = bug
    try:
        js, ts = _state("Gogoro", jt, tt, seed=3)
        obs = np.random.default_rng(5).normal(size=(B, 6)).astype(np.float32) * 2
        key = jax.random.key(7)
        n = jg.NOISES
        ks = jax.random.split(key, 5)
        draws = dict(roll=jg._normal(ks[0], (B,), *n["imu_filter_noise"]),
                     d_roll=jg._normal(ks[1], (B,), *n["imu_noise"]),
                     d_yaw=jg._normal(ks[2], (B,), *n["imu_noise"]),
                     speed=jg._normal(ks[3], (B,), *n["speed_sensor_noise"]),
                     delta_yaw=jg._normal(ks[4], (B,), *n["imu_filter_noise"]))
        monkeypatch.setattr(tt, "obs_noise_draws", lambda rng: {k: _t(v) for k, v in draws.items()})
        want = jt.observation_noise(key, jnp.asarray(obs), js.task)
        got = tt.observation_noise(None, _t(obs), ts.task)
        _close(got, want)
    finally:
        jt.reproduce_ref_obs_bug = tt.reproduce_ref_obs_bug = False
    # the paper variant adds none on the output
    jp_, tp_ = tasks["GogoroPaper"]
    assert torch.equal(tp_.observation_noise(None, _t(obs), None), _t(obs))


def test_combined_ik_and_hand_error_match_jax(tasks):
    jt, tt = tasks["GogoroCombined"]
    js, ts = _state("GogoroCombined", jt, tt, seed=4)
    ju = jax.jit(jax.vmap(jt._ik_deltas))(js.q, js.qd)
    u = tt._ik_deltas(ts.q, ts.qd)
    for a, b in zip(u, ju):
        _close(a, b, dict(atol=1e-4, rtol=1e-4))
    _close(tt._hand_err(ts.q, ts.qd), jax.jit(jt._hand_err)(js.q, js.qd))
    # a DLS step from the pose shrinks both hands' error
    err0 = tt._hand_err(ts.q, ts.qd)
    q1 = ts.q.clone()
    for s, du in zip("lr", u):
        q1[:, [7 + i for i in tt.arm_ids[s]]] += du
    assert float(tt._hand_err(q1, ts.qd).mean()) < float(err0.mean())


def _ground_state(tt, rng, n):
    """n scooter states with both wheels on the ground (the reset pose, the
    frame a few mm lower, tilted a little, rolling)."""
    env_q = tt.reset_from({k: _t(v) for k, v in _jax_draws(
        type(tt).__name__, jax.random.split(jax.random.key(9), n)).items()},
        tt.model.default_params("cpu").batch(n))[0].numpy()
    q = env_q.copy()
    q[:, 2] -= rng.uniform(0.0, 0.01, n)
    roll = rng.normal(size=n) * 0.05
    half = np.stack([np.cos(roll / 2), np.sin(roll / 2), 0 * roll, 0 * roll], -1)
    w1, v1 = half[:, :1], half[:, 1:]
    w2, v2 = q[:, 3:4], q[:, 4:7]
    q[:, 3:7] = np.concatenate([w2 * w1 - np.sum(v2 * v1, -1, keepdims=True),
                                w2 * v1 + w1 * v2 + np.cross(v2, v1)], -1)
    qd = rng.normal(size=(n, tt.model.nv)) * 0.1
    qd[:, 3] += 2.0                                   # rolling forward
    return torch.as_tensor(q, dtype=torch.float32), torch.as_tensor(qd, dtype=torch.float32)


def test_host_kernel_matches_plain_on_the_wheels(host_kernel, tasks):  # noqa: F811
    _, tt = tasks["Gogoro"]
    m = tt.model
    n = 32
    rng = np.random.default_rng(6)
    step = fused.build_fused_step_fn(m, tt.sim_params, ground=0.0, need_torque=True)
    params = m.default_params("cpu").batch(n)
    q, qd = _ground_state(tt, rng, n)
    ctrl, _, _ = tt.pre_physics(SimpleNamespace(
        task=tt.reset_from({k: _t(v) for k, v in _jax_draws(
            "Gogoro", jax.random.split(jax.random.key(9), n)).items()}, params)[3],
        seed=0, global_step=torch.tensor(1), env_id0=0, q=q), torch.zeros(n, 1))
    w = torch.zeros(n, m.nb, 6)
    qa, qda, qb, qdb = q, qd, q, qd
    touched = 0.0
    wheels = [m.body_id("front"), m.body_id("back")]
    for _ in range(5):
        qa, qda = qb, qdb                             # each step from the plain state
        qa, qda, na = _host_call(host_kernel, step, params, qa, qda, ctrl, w)
        qb, qdb, nb_ = step.plain(params, qb, qdb, ctrl, w)
        _assert_close((qa, qda, na), (qb, qdb, nb_))
        on = (nb_[:, wheels, :3].abs().amax(-1) > 0).all(-1)
        touched = max(touched, float(on.float().mean()))
    assert touched > 0.5, touched                     # both wheels on the ground


def test_golden_shapes_and_make(assets):
    with np.load(os.path.join(ROOT, "tests", "goldens", "gogoro_4env_30step.npz")) as z:
        shapes = {k: z[k].shape for k in z.files}
    env = tgt.make("Gogoro", num_envs=4, seed=0, device="cpu", asset_path=assets[False])
    s = env.reset(0)
    obs, rew, done = [], [], []
    for _ in range(30):
        s = env.step(s, torch.zeros(4, 1))
        obs.append(s.obs)
        rew.append(s.reward)
        done.append(s.done)
    got = dict(obs=torch.stack(obs), reward=torch.stack(rew), done=torch.stack(done),
               final_q=s.q, final_qd=s.qd)
    assert {k: tuple(v.shape) for k, v in got.items()} == shapes
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    for name in ("GogoroPaper", "GogoroCombined"):
        env = tgt.make(name, num_envs=2, seed=0, device="cpu",
                       asset_path=assets[name == "GogoroCombined"])
        s = env.step(env.reset(0), torch.zeros(2, 1))
        assert tuple(s.obs.shape) == (2, env.num_obs) and bool(torch.isfinite(s.obs).all())
