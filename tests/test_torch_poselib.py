"""Port parity for learn/poselib.py and the file side of learn/motion_lib.py
against the JAX package (both numpy: equal bit for bit unless a tolerance is
named).

- The reference-format clip in the repository,
  assets/amp/motions/amp_humanoid_walk.npy (90 frames at 30 fps on the AMP
  skeleton of 15 joints): ``SkeletonMotion.from_file`` in both packages,
  and each package's ``to_file`` read back by the other, as a motion and as
  a single-frame SkeletonState.
- ``load_motion_file`` on it: the MotionLib clip of both packages.
- ``retarget`` and ``project_joints`` onto the AMP skeleton from a renamed,
  scaled and turned copy of it, through ``load_motion_file`` with a
  retarget config (the reference's schema).
- ``default_motion_lib`` on the file, on a directory of an .npy and an
  .npz, and on a missing path (the gait clip), against JAX's stacked
  arrays (an .fbx file goes through learn/fbx.py: tests/test_torch_fbx.py).
- ``plot_skeleton_motion`` writes a PNG of a SkeletonState.
"""
import json
import os

import numpy as np
import torch

from thormang_isaacgym_tpu.learn import motion_lib as jml
from thormang_isaacgym_tpu.learn import poselib as jpl
from thormang_isaacgym_tpu_torch.learn import motion_lib as tml
from thormang_isaacgym_tpu_torch.learn import poselib as tpl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALK = os.path.join(ROOT, "assets", "amp", "motions", "amp_humanoid_walk.npy")


def _same_motion(a, b):
    assert list(a.skeleton.node_names) == list(b.skeleton.node_names)
    np.testing.assert_array_equal(a.skeleton.parent_indices, b.skeleton.parent_indices)
    np.testing.assert_array_equal(a.skeleton.local_translation, b.skeleton.local_translation)
    np.testing.assert_array_equal(a.local_rotation, b.local_rotation)
    np.testing.assert_array_equal(a.root_translation, b.root_translation)
    assert a.fps == b.fps


def _same_clip(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_walk_npy_round_trip_across_packages(tmp_path):
    t, j = tpl.SkeletonMotion.from_file(WALK), jpl.SkeletonMotion.from_file(WALK)
    assert (t.num_frames, len(t.skeleton.node_names), t.fps) == (90, 15, 30.0)
    _same_motion(t, j)
    single = tpl.SkeletonMotion(t.skeleton, t.local_rotation[:1], t.root_translation[:1], t.fps)
    for name, m in (("motion", t), ("state", single)):
        tp, jp = str(tmp_path / f"t_{name}.npy"), str(tmp_path / f"j_{name}.npy")
        m.to_file(tp)
        jpl.SkeletonMotion(m.skeleton, m.local_rotation, m.root_translation, m.fps).to_file(jp)
        # xyzw on disk, float32: each package reads the other's file as its own
        _same_motion(tpl.SkeletonMotion.from_file(jp), jpl.SkeletonMotion.from_file(jp))
        _same_motion(tpl.SkeletonMotion.from_file(tp), jpl.SkeletonMotion.from_file(tp))
        d = np.load(tp, allow_pickle=True).item()
        assert d["__name__"] == ("SkeletonMotion" if name == "motion" else "SkeletonState")
        np.testing.assert_allclose(d["rotation"]["arr"][..., [3, 0, 1, 2]],
                                   m.local_rotation[0] if name == "state" else m.local_rotation,
                                   atol=1e-7)


def test_load_motion_file_on_walk_npy_matches_jax():
    got, want = tpl.load_motion_file(WALK), jpl.load_motion_file(WALK)
    _same_clip(got, want)
    assert got["dof_pos"].shape == (90, 28) and got["key_pos"].shape == (90, 4, 3)


def _source(tmp_path):
    """A source skeleton: the walk's, joints renamed ``src_<name>``, bones
    scaled 1.2, its tpose frame 0 with the root turned about z; the retarget
    config maps it back onto the AMP skeleton (whose tpose is the walk's
    frame 0)."""
    walk = tpl.SkeletonMotion.from_file(WALK)
    sk = tpl.Skeleton([f"src_{n}" for n in walk.skeleton.node_names],
                      walk.skeleton.parent_indices.copy(),
                      walk.skeleton.local_translation * 1.2)
    turn = tpl._from_angle_axis(np.array([0.4]), (0.0, 0.0, 1.0))
    rot = walk.local_rotation.copy()
    rot[:, 0] = tpl._qmul(np.broadcast_to(turn, rot[:, 0].shape), rot[:, 0])
    src = tpl.SkeletonMotion(sk, rot, walk.root_translation * 1.2, walk.fps)
    src_tpose = tpl.SkeletonMotion(sk, rot[:1], src.root_translation[:1], walk.fps)
    tgt_tpose = tpl.SkeletonMotion(walk.skeleton, walk.local_rotation[:1],
                                   walk.root_translation[:1], walk.fps)
    paths = {}
    for name, m in (("source", src), ("source_tpose", src_tpose), ("target_tpose", tgt_tpose)):
        paths[name] = str(tmp_path / f"{name}.npy")
        m.to_file(paths[name])
    mapping = {f"src_{n}": n for n in walk.skeleton.node_names
               if not n.endswith(("hand", "lower_arm"))}
    cfg = dict(source_tpose=paths["source_tpose"], target_tpose=paths["target_tpose"],
               joint_mapping=mapping, rotation=[0.0, 0.0, -0.19866933, 0.98006658], scale=0.8,
               root_height_offset=0.02, trim_frame_beg=3, trim_frame_end=80)
    return paths, cfg


def test_retarget_and_project_joints_match_jax(tmp_path):
    paths, cfg = _source(tmp_path)
    args = {}
    for pkg in (tpl, jpl):
        src = pkg.SkeletonMotion.from_file(paths["source"])
        args[pkg] = (src, pkg.SkeletonMotion.from_file(cfg["source_tpose"]),
                     pkg.SkeletonMotion.from_file(cfg["target_tpose"]))
    kw = dict(root_height_offset=0.02, trim=(3, 80))
    got = tpl.retarget(*args[tpl], cfg["joint_mapping"], cfg["rotation"], cfg["scale"], **kw)
    want = jpl.retarget(*args[jpl], cfg["joint_mapping"], cfg["rotation"], cfg["scale"], **kw)
    assert got.num_frames == 77
    _same_motion(got, want)
    _same_motion(tpl.project_joints(got), jpl.project_joints(want))
    # the whole ingestion with the config as a file: a non-AMP skeleton retargets
    cfg_path = str(tmp_path / "retarget.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    _same_clip(tpl.load_motion_file(paths["source"], retarget_cfg=cfg_path),
               jpl.load_motion_file(paths["source"], retarget_cfg=cfg_path))


def test_default_motion_lib_matches_jax(tmp_path):
    d = tmp_path / "clips"
    d.mkdir()
    np.save(d / "a_walk.npy", np.load(WALK, allow_pickle=True), allow_pickle=True)
    tml.save_clip(str(d / "b_gait.npz"), tml.make_gait_clip(fps=60, n_cycles=2))
    fields = ("root_pos", "root_rot", "dof_pos", "root_vel", "root_ang_vel", "dof_vel", "key_pos",
              "dt", "num_frames", "lengths", "weights")
    for path, motions in ((WALK, 1), (str(d), 2), (str(tmp_path / "missing.npy"), 1)):
        got, want = tml.default_motion_lib(path), jml.default_motion_lib(path)
        assert got.num_motions() == want.num_motions() == motions
        for k in fields:
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                          err_msg=f"{path}: {k}")
        assert isinstance(got.root_pos, torch.Tensor) and got.root_pos.dtype == torch.float32


def test_plot_skeleton_motion_writes_a_png(tmp_path):
    walk = tpl.SkeletonMotion.from_file(WALK)
    state = tpl.SkeletonMotion(walk.skeleton, walk.local_rotation[:1], walk.root_translation[:1])
    out = tpl.plot_skeleton_motion(state, str(tmp_path / "tpose.png"))
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
