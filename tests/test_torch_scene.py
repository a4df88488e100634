"""Port parity for models/scene.py: ``compose`` and ``scene_q`` against the JAX
package's on BallBalance's bot + ball and on the pair-capsule scene of
tests/test_fused.py (body order, parents, actors, joint frames, root flags
and base poses, geoms, every ``_defaults`` leaf, q layout). Exact equality:
the two are the same host-side bookkeeping on the same URDF strings.
``parity/convert.model_params`` carries a composed scene's batched JAX
ModelParams across to the port's, leaf for leaf and dtype for dtype."""
import dataclasses

import jax
import numpy as np
import pytest

from thormang_isaacgym_tpu.models import load_urdf as jax_load_urdf
from thormang_isaacgym_tpu.models.scene import compose as jax_compose
from thormang_isaacgym_tpu.models.scene import scene_q as jax_scene_q
from thormang_isaacgym_tpu.tasks import ball_balance as jbb
from thormang_isaacgym_tpu_torch.models import load_urdf
from thormang_isaacgym_tpu_torch.models.scene import compose, scene_q
from thormang_isaacgym_tpu_torch.parity import convert
from thormang_isaacgym_tpu_torch.tasks import ball_balance as tbb

from test_torch_fused import pair_capsule_scene


def _scenes(name):
    """(JAX scene, port scene)."""
    if name == "pair_capsule":
        return pair_capsule_scene(jax_load_urdf, jax_compose), pair_capsule_scene(load_urdf, compose)

    def bot(mod, load, comp):
        return comp([(load(mod.make_bbot_urdf()), (0, 0, mod.TRAY_H, 1, 0, 0, 0), "bbot/"),
                     (load(mod.BALL_URDF), (0.2, 0, 1.0, 1, 0, 0, 0), "ball/")],
                    name="ball_balance")
    return bot(jbb, jax_load_urdf, jax_compose), bot(tbb, load_urdf, compose)


@pytest.mark.parametrize("name", ["ball_balance", "pair_capsule"])
def test_compose_matches_jax(name):
    jm, tm = _scenes(name)
    for f in ("name", "body_names", "parent", "joint_names", "joint_type", "dof_index",
              "floating", "n_roots", "root_floating", "root_base_pose", "body_actor"):
        assert getattr(tm, f) == getattr(jm, f), f
    for f in ("joint_axis", "joint_pos", "joint_quat"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)),
                                      err_msg=f)
    assert (tm.nq, tm.nv, tm.nj, tm.nb, tm.ng, tm.n_floating) == \
        (jm.nq, jm.nv, jm.nj, jm.nb, jm.ng, jm.n_floating)
    for gt, gj in zip(tm.geoms, jm.geoms, strict=True):
        assert (gt.body, gt.gtype, gt.name) == (gj.body, gj.gtype, gj.name)
        np.testing.assert_array_equal(np.asarray(gt.size + gt.pos + gt.quat),
                                      np.asarray(gj.size + gj.pos + gj.quat))
    assert set(tm._defaults) == set(jm._defaults)
    for k, v in jm._defaults.items():
        np.testing.assert_array_equal(tm._defaults[k], np.asarray(v), err_msg=k)
        assert tm._defaults[k].dtype == np.asarray(v).dtype, k
    if name == "ball_balance":
        assert tm.nq == 20 and tm.nv == 18 and tm.nb == 8 and tm.ng == 8
        assert tm.roots_floating == (True, True)
        assert tm.body_names[:2] == ("bbot/tray", "ball/ball")
    else:                                    # the bar is a fixed root with a base pose
        assert tm.roots_floating == (True, True, True, False)
        assert tm.root_base_pose[3] == (0, 0, 0.6, 0.7071068, 0, 0.7071068, 0)


def test_scene_q_matches_jax():
    jm, tm = _scenes("ball_balance")
    roots = [(0, 0, 0.5, 1, 0, 0, 0), (0.1, -0.2, 1.0, 0.6, 0.8, 0, 0)]
    jq = np.linspace(-0.5, 0.5, tm.nj)
    np.testing.assert_array_equal(scene_q(tm, roots, jq).numpy(),
                                  np.asarray(jax_scene_q(jm, roots, jq)))
    with pytest.raises(ValueError):
        scene_q(tm, roots[:1], jq)


def test_convert_carries_scene_params():
    jm, tm = _scenes("ball_balance")
    got = convert.model_params(jax.tree.map(np.asarray, jm.default_params().batch(3)))
    want = tm.default_params().batch(3)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f.name)
