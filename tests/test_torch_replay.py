"""The port's replay and live viewer (runtime/replay.py, runtime/viewer.py)
against the JAX package's.

- A ``StateLogger`` file written by either package loads in the other (the
  same npz: ``qs``, ``dt``).
- ``_geom_frames`` (every geom's world position and orientation from the
  port's forward kinematics) matches JAX's on Ant, ShadowHand and
  HumanoidMJCF q rows off their reset pose (atol 1e-5; a quaternion up to
  its sign).
- The ``render_html`` payload matches JAX's numerically (atol 2e-4: both
  round positions to 4 decimals).
- ``frame_shapes`` (the GIF's schematic: circles, segments, squares in the
  view's plane) matches the geometry JAX's ``render_video`` draws, computed
  from JAX's geom frames by its formulas; ``render_video`` writes a GIF of
  one frame for every ``every``-th logged state.
- A ``LiveViewer`` on a local port serves ``/state`` equal to JAX's
  viewer's for the same q; a POST of ``escape`` makes the next ``render``
  raise ``ViewerClosed``; subscribed keys arrive through ``query_events``.
"""
import functools
import json
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from thormang_isaacgym_tpu.core import quat as JQ
from thormang_isaacgym_tpu.ops import kinematics as jkin
from thormang_isaacgym_tpu.runtime import replay as jreplay
from thormang_isaacgym_tpu.runtime import viewer as jviewer
import thormang_isaacgym_tpu_torch as tgt
from thormang_isaacgym_tpu_torch.models.robot import GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE
from thormang_isaacgym_tpu_torch.runtime import replay as treplay
from thormang_isaacgym_tpu_torch.runtime import viewer as tviewer
from test_torch_twins import _jax_model

TASKS = ("Ant", "ShadowHand", "HumanoidMJCF")


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_kinematics():
    """JAX's replay and viewer (``_geom_frames``) with the JAX package's
    forward kinematics jitted once a model: op by op, each of its
    primitives compiles alone on its first call (ShadowHand's ~5 s)."""
    jitted = {}

    def fk(model, q, qd):
        if id(model) not in jitted:
            jitted[id(model)] = (model, jax.jit(functools.partial(jkin.forward_kinematics, model)))
        return jitted[id(model)][1](q, qd)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreplay, "forward_kinematics", fk)
        yield


@pytest.fixture(scope="module")
def models():
    """{task: (JAX model, port model, q rows (3, nq) off the reset pose)}."""
    out = {}
    rng = np.random.default_rng(0)
    for name in TASKS:
        env = tgt.make(name, num_envs=3, seed=0, device="cpu")
        jmodel = _jax_model(name)
        m = env.task.model
        q = env.reset(0).q.numpy().copy()
        nf = 7 * m.n_floating
        q[:, nf:] += rng.normal(size=(3, m.nj)).astype(np.float32) * 0.3
        if m.floating:
            quat = rng.normal(size=(3, 4)).astype(np.float32)
            q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
            q[:, 0:3] += rng.normal(size=(3, 3)).astype(np.float32)
        out[name] = (jmodel, m, q)
    return out


def test_state_logger_files_load_across(models, tmp_path):
    jmodel, m, q = models["Ant"]
    tlog = treplay.StateLogger(m, dt=0.05)
    jlog = jreplay.StateLogger(jmodel, dt=0.05)
    for row in q:
        tlog.add(torch.as_tensor(row))
        jlog.add(row)
    tlog.save(str(tmp_path / "port.npz"))
    jlog.save(str(tmp_path / "jax.npz"))
    a = jreplay.StateLogger.load(jmodel, str(tmp_path / "port.npz"))
    b = treplay.StateLogger.load(m, str(tmp_path / "jax.npz"))
    for log in (a, b):
        assert len(log) == 3 and log.dt == pytest.approx(0.05)
        np.testing.assert_array_equal(np.stack(log.qs), q)


def _quat_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 1e-5, (a, b)


@pytest.mark.parametrize("task", TASKS)
def test_geom_frames_match_jax(models, task):
    jmodel, m, q = models[task]
    assert len(m.geoms) == len(jmodel.geoms)
    for row in q:
        want = jreplay._geom_frames(jmodel, row)
        got = treplay._geom_frames(m, row)
        for (gp, gq, gt, gs), (jp, jq, jt, js) in zip(got, want):
            assert gt == jt and tuple(gs) == tuple(js)
            np.testing.assert_allclose(gp, jp, atol=1e-5)
            _quat_close(gq, jq)


def test_render_html_payload_matches_jax(models, tmp_path):
    def payload(path):
        text = open(path).read()
        return json.loads(text.split("const F=", 1)[1].split(", dt=", 1)[0])

    for task in ("Ant", "ShadowHand"):
        jmodel, m, q = models[task]
        tlog, jlog = treplay.StateLogger(m), jreplay.StateLogger(jmodel)
        for row in q:
            tlog.add(row)
            jlog.add(row)
        treplay.render_html(tlog, str(tmp_path / "t.html"), every=2)
        jreplay.render_html(jlog, str(tmp_path / "j.html"), every=2)
        got, want = payload(tmp_path / "t.html"), payload(tmp_path / "j.html")
        assert len(got) == len(want) == 2
        for fg, fw in zip(got, want):
            assert [g[0] for g in fg] == [g[0] for g in fw]
            for g, w in zip(fg, fw):
                np.testing.assert_allclose(g, w, atol=2e-4)


def _jax_shapes(geoms, view):
    """The geometry JAX's render_video draws (its formulas, replay.py)."""
    ix, iy = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}[view]
    out = []
    for gp, gq, gtype, size in geoms:
        if gtype == GEOM_SPHERE:
            out.append(("circle", gp[ix], gp[iy], size[0]))
        elif gtype in (GEOM_CAPSULE, GEOM_CYLINDER):
            axis = np.asarray(JQ.rotate(jnp.asarray(gq), jnp.asarray([0.0, 0.0, 1.0])))
            a, b = gp - axis * size[1], gp + axis * size[1]
            out.append(("segment", a[ix], a[iy], b[ix], b[iy], size[0]))
        else:
            out.append(("square", gp[ix], gp[iy], float(np.linalg.norm(size)) * 0.8))
    return out


@pytest.mark.parametrize("view", ["xz", "xy"])
def test_video_geometry_matches_jax_and_gif_frames(models, tmp_path, view):
    for task in ("Ant", "ShadowHand"):
        jmodel, m, q = models[task]
        got = treplay.frame_shapes(treplay._geom_frames(m, q[0]), view)
        want = _jax_shapes(jreplay._geom_frames(jmodel, q[0]), view)
        assert [s[0] for s in got] == [s[0] for s in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[1:], np.asarray(w[1:], np.float64), atol=1e-5)
    log = treplay.StateLogger(models["Ant"][1], dt=0.02)
    for i in range(5):
        log.add(models["Ant"][2][i % 3])
    path = treplay.render_video(log, str(tmp_path / "v.gif"), every=2, view=view)
    with Image.open(path) as im:
        assert im.n_frames == 3 and im.size == (360, 270)


def test_live_viewer_state_matches_jax_and_escape_closes(models):
    jmodel, m, q = models["Ant"]
    sim = SimpleNamespace(dt=0.0166)
    tv = tviewer.LiveViewer(SimpleNamespace(task=SimpleNamespace(model=m, sim_params=sim)),
                            env_index=1, announce=False)
    jv = jviewer.LiveViewer(SimpleNamespace(task=SimpleNamespace(model=jmodel, sim_params=sim)),
                            env_index=1, announce=False)
    try:
        tv.enable_viewer_sync = jv.enable_viewer_sync = False
        tv.subscribe_keyboard_event("r", "reset")
        tv.render(SimpleNamespace(q=torch.as_tensor(q)))
        jv.render(SimpleNamespace(q=jnp.asarray(q)))
        for v in (tv, jv):
            v.add_debug_line([0.0, 0.0, 0.0], [1.0, 2.0, 3.0])
        got = json.loads(urllib.request.urlopen(tv.url + "state", timeout=10).read())
        want = json.loads(urllib.request.urlopen(jv.url + "state", timeout=10).read())
        assert got.keys() == want.keys() and got["dt"] == want["dt"]
        assert got["lines"] == want["lines"] and got["sync"] == want["sync"] is False
        assert [g[0] for g in got["geoms"]] == [g[0] for g in want["geoms"]]
        for g, w in zip(got["geoms"], want["geoms"]):
            np.testing.assert_allclose(g, w, atol=2e-4)
        # the geometry is env 1's
        assert got["geoms"] == treplay.encode_geoms(m, q[1])
        page = urllib.request.urlopen(tv.url, timeout=10).read().decode()
        assert "<canvas" in page and m.name in page
        for key in ("r", "escape"):
            req = urllib.request.Request(tv.url + "key", data=json.dumps({"key": key}).encode(),
                                         method="POST")
            urllib.request.urlopen(req, timeout=10).read()
        assert tv.query_events() == [("reset", "r"), ("QUIT", "escape")]
        with pytest.raises(tviewer.ViewerClosed):
            tv.render(SimpleNamespace(q=torch.as_tensor(q)))
    finally:
        tv.close()
        jv.close()
